// Minimal PNG decoder for grayscale SLAM inputs (8-bit gray, gray+alpha,
// RGB and RGBA, and 16-bit gray; non-interlaced). Two entry points:
//
// - tpuslam_decode_png_gray decodes straight to float32 grayscale, the
//   format the tracker consumes, replacing the reference's cv::imread +
//   cvtColor path (reference Examples/*/: image loading; reference
//   src/Tracking.cc:256-269 grayscale conversion). Colour becomes the float
//   luma 0.299 R + 0.587 G + 0.114 B.
// - tpuslam_decode_png_raw returns the defiltered samples as they are
//   stored (16-bit samples big-endian), with their channel count and bit
//   depth, so the caller can apply its own grayscale rule.
//
// zlib handles the inflate; this file implements the container walk and the
// five PNG filters. Written for clarity over generality: no interlace, no
// palette, no ancillary-chunk handling beyond skipping.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  uint32_t u32() {
    if (off + 4 > n) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[off]) << 24) | (uint32_t(p[off + 1]) << 16) |
                 (uint32_t(p[off + 2]) << 8) | uint32_t(p[off + 3]);
    off += 4;
    return v;
  }
};

inline uint8_t paeth(int a, int b, int c) {
  int pp = a + b - c;
  int pa = abs(pp - a), pb = abs(pp - b), pc = abs(pp - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

// Walk the chunks, inflate and defilter. On success returns 0 and fills
// *img (malloc'd, h rows of w * channels * bit_depth / 8 bytes).
int decode_raw(const uint8_t* data, size_t len, uint8_t** img_out, uint32_t* width,
               uint32_t* height, int* channels_out, int* bit_depth_out) {
  if (len < 8 || memcmp(data, "\x89PNG\r\n\x1a\n", 8) != 0) return -1;
  Reader r{data, len};
  r.off = 8;

  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0;
  uint8_t* idat = nullptr;
  size_t idat_len = 0, idat_cap = 0;

  while (r.ok && r.off + 8 <= r.n) {
    uint32_t clen = r.u32();
    if (r.off + 4 > r.n) break;
    char ctype[5] = {0};
    memcpy(ctype, r.p + r.off, 4);
    r.off += 4;
    if (r.off + clen + 4 > r.n) break;
    const uint8_t* cdata = r.p + r.off;

    if (strcmp(ctype, "IHDR") == 0 && clen >= 13) {
      w = (uint32_t(cdata[0]) << 24) | (cdata[1] << 16) | (cdata[2] << 8) | cdata[3];
      h = (uint32_t(cdata[4]) << 24) | (cdata[5] << 16) | (cdata[6] << 8) | cdata[7];
      bit_depth = cdata[8];
      color_type = cdata[9];
      if (cdata[12] != 0) { free(idat); return -2; }  // interlaced unsupported
    } else if (strcmp(ctype, "IDAT") == 0) {
      if (idat_len + clen > idat_cap) {
        idat_cap = (idat_len + clen) * 2 + 4096;
        idat = (uint8_t*)realloc(idat, idat_cap);
      }
      memcpy(idat + idat_len, cdata, clen);
      idat_len += clen;
    } else if (strcmp(ctype, "IEND") == 0) {
      r.off += clen + 4;
      break;
    }
    r.off += clen + 4;  // skip data + CRC
  }
  if (!w || !h || !idat) { free(idat); return -3; }

  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default: free(idat); return -4;  // palette unsupported
  }
  if (bit_depth != 8 && !(bit_depth == 16 && color_type == 0)) {
    free(idat);
    return -5;
  }
  const int bpp = channels * (bit_depth / 8);
  const size_t stride = size_t(w) * bpp;
  const size_t raw_len = (stride + 1) * h;

  uint8_t* raw = (uint8_t*)malloc(raw_len);
  uLongf dst_len = raw_len;
  int zrc = uncompress(raw, &dst_len, idat, idat_len);
  free(idat);
  if (zrc != Z_OK || dst_len != raw_len) { free(raw); return -6; }

  // Defilter into `img`.
  uint8_t* img = (uint8_t*)malloc(stride * h);
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = raw + y * (stride + 1) + 1;
    uint8_t* dst = img + y * stride;
    const uint8_t* up = y ? img + (y - 1) * stride : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: free(raw); free(img); return -7;
      }
      dst[x] = uint8_t(v);
    }
  }
  free(raw);
  *img_out = img;
  *width = w;
  *height = h;
  *channels_out = channels;
  *bit_depth_out = bit_depth;
  return 0;
}

}  // namespace

extern "C" {

// Decode a PNG byte buffer to float32 grayscale.
// On success returns 0 and fills *out (malloc'd, caller frees via
// tpuslam_free), *width, *height. scale16: multiplier applied to 16-bit
// samples (e.g. TUM depth factor), 8-bit samples are returned as 0..255.
int tpuslam_decode_png_gray(const uint8_t* data, size_t len, float** out,
                            int* width, int* height, float scale16) {
  uint8_t* img = nullptr;
  uint32_t w = 0, h = 0;
  int channels = 0, bit_depth = 0;
  int rc = decode_raw(data, len, &img, &w, &h, &channels, &bit_depth);
  if (rc != 0) return rc;

  float* outf = (float*)malloc(sizeof(float) * w * h);
  if (bit_depth == 16) {  // 16-bit grayscale (TUM depth images)
    for (size_t i = 0; i < size_t(w) * h; ++i) {
      uint16_t v = (uint16_t(img[2 * i]) << 8) | img[2 * i + 1];
      outf[i] = float(v) * scale16;
    }
  } else if (channels == 1) {
    for (size_t i = 0; i < size_t(w) * h; ++i) outf[i] = float(img[i]);
  } else if (channels == 2) {
    for (size_t i = 0; i < size_t(w) * h; ++i) outf[i] = float(img[2 * i]);
  } else {
    // BT.601 luma like cv::cvtColor BGR2GRAY/RGB2GRAY.
    for (size_t i = 0; i < size_t(w) * h; ++i) {
      const uint8_t* px = img + i * channels;
      outf[i] = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
    }
  }
  free(img);
  *out = outf;
  *width = int(w);
  *height = int(h);
  return 0;
}

// Decode a PNG byte buffer to its defiltered samples: *out (malloc'd,
// freed via tpuslam_free) holds height rows of width * channels samples of
// bit_depth / 8 bytes each, 16-bit samples big-endian as the file stores
// them. Returns 0, or the negative code of tpuslam_decode_png_gray.
int tpuslam_decode_png_raw(const uint8_t* data, size_t len, uint8_t** out, int* width,
                           int* height, int* channels, int* bit_depth) {
  uint32_t w = 0, h = 0;
  int rc = decode_raw(data, len, out, &w, &h, channels, bit_depth);
  if (rc != 0) return rc;
  *width = int(w);
  *height = int(h);
  return 0;
}

void tpuslam_free(void* p) { free(p); }

}  // extern "C"
