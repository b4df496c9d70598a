// Trajectory evaluation: ATE (Horn/Umeyama SE3 or Sim3 alignment) and RPE —
// the native counterpart of the TUM RGB-D benchmark scripts the reference
// tells users to evaluate with (reference README.md:95-167,
// System.h:97-113 save-format docs). Exposed through ctypes
// (tpuslam/io/native.py) and the standalone tpuslam-evaluate CLI
// (tools/evaluate_trajectory.py).
//
// Inputs are pose arrays of camera CENTERS (world-frame positions), matched
// by the caller (timestamp association lives in Python where the file
// formats are parsed).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// 3x3 symmetric Jacobi eigen-decomposition (enough for the Umeyama SVD of a
// 3x3 via eigen of A^T A; cyclic sweeps converge fast for 3x3).
void jacobi3(double a[3][3], double v[3][3], double w[3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) v[i][j] = (i == j) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 50; ++sweep) {
    double off = std::fabs(a[0][1]) + std::fabs(a[0][2]) + std::fabs(a[1][2]);
    if (off < 1e-15) break;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        if (std::fabs(a[p][q]) < 1e-18) continue;
        double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 3; ++k) {
          double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < 3; ++k) {
          double apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < 3; ++k) {
          double vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
  for (int i = 0; i < 3; ++i) w[i] = a[i][i];
}

void matmul3(const double a[3][3], const double b[3][3], double out[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += a[i][k] * b[k][j];
      out[i][j] = s;
    }
}

double det3(const double a[3][3]) {
  return a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1]) -
         a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0]) +
         a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]);
}

}  // namespace

extern "C" {

// Umeyama alignment of est (n,3) onto gt (n,3); fix_scale=1 forces s=1
// (SE3). Writes scale, R (row-major 3x3), t (3) and returns the aligned
// RMSE (the ATE). n >= 3 required; returns -1 on failure.
double tpuslam_ate(const double* est, const double* gt, int64_t n,
                   int fix_scale, double* scale_out, double* R_out,
                   double* t_out) {
  if (n < 3) return -1.0;
  double mu_e[3] = {0, 0, 0}, mu_g[3] = {0, 0, 0};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      mu_e[d] += est[3 * i + d];
      mu_g[d] += gt[3 * i + d];
    }
  for (int d = 0; d < 3; ++d) {
    mu_e[d] /= n;
    mu_g[d] /= n;
  }
  // Cross-covariance C = sum (g - mu_g)(e - mu_e)^T / n, est variance.
  double C[3][3] = {{0}}, var_e = 0;
  for (int64_t i = 0; i < n; ++i) {
    double de[3], dg[3];
    for (int d = 0; d < 3; ++d) {
      de[d] = est[3 * i + d] - mu_e[d];
      dg[d] = gt[3 * i + d] - mu_g[d];
      var_e += de[d] * de[d];
    }
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) C[r][c] += dg[r] * de[c];
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) C[r][c] /= n;
  var_e /= n;

  // SVD of C via eigen-decompositions of C^T C and C C^T.
  double CtC[3][3], CCt[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double s1 = 0, s2 = 0;
      for (int k = 0; k < 3; ++k) {
        s1 += C[k][r] * C[k][c];
        s2 += C[r][k] * C[c][k];
      }
      CtC[r][c] = s1;
      CCt[r][c] = s2;
    }
  double V[3][3], U[3][3], wv[3], wu[3];
  double tmp1[3][3], tmp2[3][3];
  std::memcpy(tmp1, CtC, sizeof(tmp1));
  std::memcpy(tmp2, CCt, sizeof(tmp2));
  jacobi3(tmp1, V, wv);
  jacobi3(tmp2, U, wu);
  // Sort eigenpairs descending; align U columns with C V / sigma.
  int order_v[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (wv[order_v[j]] > wv[order_v[i]]) {
        int t = order_v[i];
        order_v[i] = order_v[j];
        order_v[j] = t;
      }
  double Vs[3][3], sigma[3];
  for (int c = 0; c < 3; ++c) {
    int oc = order_v[c];
    sigma[c] = std::sqrt(std::fmax(wv[oc], 0.0));
    for (int r = 0; r < 3; ++r) Vs[r][c] = V[r][oc];
  }
  // U column c = C * Vs_c / sigma_c (robust for sigma>0; fall back to the
  // eigenvector of CCt otherwise).
  double Us[3][3];
  for (int c = 0; c < 3; ++c) {
    if (sigma[c] > 1e-12) {
      for (int r = 0; r < 3; ++r) {
        double s = 0;
        for (int k = 0; k < 3; ++k) s += C[r][k] * Vs[k][c];
        Us[r][c] = s / sigma[c];
      }
    } else if (c == 2 && sigma[0] > 1e-12 && sigma[1] > 1e-12) {
      // Planar trajectories: rank-2 C. Complete U with the cross product
      // of the two valid columns (eigenvalues sort descending, so only the
      // last column can be degenerate in this case).
      Us[0][c] = Us[1][0] * Us[2][1] - Us[2][0] * Us[1][1];
      Us[1][c] = Us[2][0] * Us[0][1] - Us[0][0] * Us[2][1];
      Us[2][c] = Us[0][0] * Us[1][1] - Us[1][0] * Us[0][1];
    } else {
      // Degenerate (colinear/degenerate) input: identity-ish fallback.
      Us[0][c] = c == 0 ? 1 : 0;
      Us[1][c] = c == 1 ? 1 : 0;
      Us[2][c] = c == 2 ? 1 : 0;
    }
  }
  // R = U S V^T with S = diag(1,1,det(U V^T)) to force a proper rotation.
  double Vt[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) Vt[r][c] = Vs[c][r];
  double UVt[3][3];
  matmul3(Us, Vt, UVt);
  double d = det3(UVt);
  double S[3] = {1.0, 1.0, d < 0 ? -1.0 : 1.0};
  double R[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += Us[r][k] * S[k] * Vt[k][c];
      R[r][c] = s;
    }
  double trDS = sigma[0] * S[0] + sigma[1] * S[1] + sigma[2] * S[2];
  double s_al = fix_scale ? 1.0 : (var_e > 1e-15 ? trDS / var_e : 1.0);

  double t_al[3];
  for (int d2 = 0; d2 < 3; ++d2) {
    double s = 0;
    for (int k = 0; k < 3; ++k) s += R[d2][k] * mu_e[k];
    t_al[d2] = mu_g[d2] - s_al * s;
  }

  double se = 0;
  for (int64_t i = 0; i < n; ++i) {
    double err = 0;
    for (int d2 = 0; d2 < 3; ++d2) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += R[d2][k] * est[3 * i + k];
      double a = s_al * s + t_al[d2] - gt[3 * i + d2];
      err += a * a;
    }
    se += err;
  }
  if (scale_out) *scale_out = s_al;
  if (R_out)
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) R_out[3 * r + c] = R[r][c];
  if (t_out)
    for (int d2 = 0; d2 < 3; ++d2) t_out[d2] = t_al[d2];
  return std::sqrt(se / n);
}

// RPE: RMS translational drift of relative motions over a fixed frame
// delta, comparing est vs gt camera centers (translation-only form of the
// KITTI/TUM relative metrics).
double tpuslam_rpe(const double* est, const double* gt, int64_t n,
                   int64_t delta) {
  if (n <= delta || delta < 1) return -1.0;
  double se = 0;
  int64_t m = 0;
  for (int64_t i = 0; i + delta < n; ++i, ++m) {
    double err = 0;
    for (int d = 0; d < 3; ++d) {
      double de = est[3 * (i + delta) + d] - est[3 * i + d];
      double dg = gt[3 * (i + delta) + d] - gt[3 * i + d];
      err += (de - dg) * (de - dg);
    }
    se += err;
  }
  return std::sqrt(se / m);
}

}  // extern "C"
