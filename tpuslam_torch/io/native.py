"""ctypes bindings for the port's host library (csrc_host/*.cc, built by
_build.build_host at first use). Port of tpuslam/io/native.py.

Exposes the C++ PNG decoder (float luma, and the raw samples that
io/datasets.load_grayscale turns into grey), the threaded dataset
prefetcher, the quadtree selection oracle, ATE/RPE and a CPU FAST+NMS. The
library is compiled from the package's own sources (g++, zlib); a failed
build raises, and there is no other backend to fall back to.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from tpuslam_torch import _build

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_F32 = np.ctypeslib.ndpointer(np.float32)
_F64 = np.ctypeslib.ndpointer(np.float64)
_I32 = np.ctypeslib.ndpointer(np.int32)
_SIGNATURES = {
    # name: (restype, argtypes)
    "tpuslam_decode_png_gray": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t,
                                               ctypes.POINTER(_FP), _IP, _IP, ctypes.c_float]),
    "tpuslam_decode_png_raw": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t,
                                              ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                              _IP, _IP, _IP, _IP]),
    "tpuslam_free": (None, [ctypes.c_void_p]),
    "tpuslam_prefetch_create": (ctypes.c_void_p, [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_int, ctypes.c_float]),
    "tpuslam_prefetch_next": (ctypes.c_long, [ctypes.c_void_p, ctypes.POINTER(_FP), _IP, _IP]),
    "tpuslam_release_frame": (None, [ctypes.c_void_p, _FP]),
    "tpuslam_prefetch_destroy": (None, [ctypes.c_void_p]),
    "tpuslam_distribute_quadtree": (ctypes.c_int, [_F32, _F32, _F32, ctypes.c_int, ctypes.c_float,
                                                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                                   ctypes.c_int, _I32]),
    "tpuslam_ate": (ctypes.c_double, [_F64, _F64, ctypes.c_int64, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_double), _F64, _F64]),
    "tpuslam_rpe": (ctypes.c_double, [_F64, _F64, ctypes.c_int64, ctypes.c_int64]),
    "tpuslam_fast_nms": (ctypes.c_int, [_F32, ctypes.c_int, ctypes.c_int, ctypes.c_float, _F32]),
}


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded host library (built on first call; raises if it cannot be)."""
    handle = ctypes.CDLL(_build.build_host()["path"])
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return handle


def native_available() -> bool:
    """True once the host library is built and loaded (building it now)."""
    return lib() is not None


def decode_png_gray(data: bytes, scale16: float = 1.0) -> np.ndarray:
    """PNG bytes -> (H, W) float32 grayscale: 8-bit samples as 0..255, colour
    as the float luma 0.299 R + 0.587 G + 0.114 B, 16-bit grey times
    scale16."""
    out = _FP()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib().tpuslam_decode_png_gray(data, len(data), ctypes.byref(out), ctypes.byref(w),
                                       ctypes.byref(h), ctypes.c_float(scale16))
    if rc != 0:
        raise ValueError(f"PNG decode failed (code {rc})")
    arr = np.ctypeslib.as_array(out, shape=(h.value, w.value)).copy()
    lib().tpuslam_free(out)
    return arr


def decode_png_raw(data: bytes) -> np.ndarray:
    """PNG bytes -> the stored samples: (H, W, C) uint8 for 8-bit grey
    (C=1), grey+alpha (2), RGB (3) and RGBA (4); (H, W, 1) uint16 for 16-bit
    grey. Other formats (palette, interlace, 1-4 bit) raise ValueError."""
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h, c, bits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib().tpuslam_decode_png_raw(data, len(data), ctypes.byref(out), ctypes.byref(w),
                                      ctypes.byref(h), ctypes.byref(c), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"PNG decode failed (code {rc})")
    nbytes = h.value * w.value * c.value * bits.value // 8
    raw = np.ctypeslib.as_array(out, shape=(nbytes,)).copy()
    lib().tpuslam_free(out)
    dtype = ">u2" if bits.value == 16 else np.uint8
    return raw.view(dtype).astype(np.dtype(dtype).newbyteorder("=")).reshape(h.value, w.value, c.value)


class NativePrefetcher:
    """Background-threaded, in-order image prefetcher over a path list,
    yielding (index, float32 grey as decode_png_gray gives it); a file
    that fails to decode is skipped."""

    def __init__(self, paths, n_threads: int = 2, capacity: int = 8, scale16: float = 1.0):
        self._lib = lib()
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._h = self._lib.tpuslam_prefetch_create(arr, len(self._paths), n_threads, capacity,
                                                    ctypes.c_float(scale16))

    def __iter__(self):
        while True:
            buf = _FP()
            w, h = ctypes.c_int(), ctypes.c_int()
            idx = self._lib.tpuslam_prefetch_next(self._h, ctypes.byref(buf), ctypes.byref(w),
                                                  ctypes.byref(h))
            if idx == -1:
                return
            if idx == -2:
                continue  # decode failure: skip the frame
            arr = np.ctypeslib.as_array(buf, shape=(h.value, w.value)).copy()
            self._lib.tpuslam_release_frame(self._h, buf)
            yield int(idx), arr

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tpuslam_prefetch_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def distribute_quadtree(xs, ys, responses, bounds, target: int) -> np.ndarray:
    """Exact sequential quadtree selection (ORBextractor's
    DistributeOctTree), the oracle for the per-cell selection. Returns a
    bool keep-mask."""
    xs = np.ascontiguousarray(xs, np.float32)
    ys = np.ascontiguousarray(ys, np.float32)
    rs = np.ascontiguousarray(responses, np.float32)
    if not xs.ndim == 1 or xs.shape != ys.shape or xs.shape != rs.shape:
        raise ValueError(f"distribute_quadtree: want three (N,) arrays, got {xs.shape}, {ys.shape}, {rs.shape}")
    keep = np.zeros(len(xs), np.int32)
    lib().tpuslam_distribute_quadtree(
        xs, ys, rs, len(xs), ctypes.c_float(bounds[0]), ctypes.c_float(bounds[1]),
        ctypes.c_float(bounds[2]), ctypes.c_float(bounds[3]), target, keep)
    return keep.astype(bool)


def _centres(name: str, est, gt):
    est = np.ascontiguousarray(est, np.float64)
    gt = np.ascontiguousarray(gt, np.float64)
    if not (est.shape == gt.shape and est.ndim == 2 and est.shape[1] == 3):
        raise ValueError(f"{name}: want two (N, 3) arrays, got {est.shape} and {gt.shape}")
    return est, gt


def evaluate_ate(est: np.ndarray, gt: np.ndarray, fix_scale: bool = False):
    """ATE RMSE after Umeyama (Horn) alignment of est (N, 3) camera centres
    onto gt (N, 3); fix_scale=True constrains s=1 (SE3). Returns (rmse,
    scale, R (3, 3), t (3,))."""
    est, gt = _centres("evaluate_ate", est, gt)
    scale = ctypes.c_double()
    R = np.zeros((3, 3), np.float64)
    t = np.zeros((3,), np.float64)
    rmse = lib().tpuslam_ate(est, gt, est.shape[0], int(fix_scale), ctypes.byref(scale), R, t)
    if rmse < 0:
        raise ValueError("evaluate_ate: need at least 3 matched poses")
    return float(rmse), float(scale.value), R, t


def evaluate_rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> float:
    """RMS translational relative-pose error over a frame delta."""
    est, gt = _centres("evaluate_rpe", est, gt)
    out = lib().tpuslam_rpe(est, gt, est.shape[0], delta)
    if out < 0:
        raise ValueError("evaluate_rpe: need more poses than delta")
    return float(out)


def fast_nms_native(img: np.ndarray, min_th: float) -> np.ndarray:
    """Dense FAST-9/16 score + 3x3 NMS of one (H, W) image on the host:
    the semantics of ops/fast.py's plain version."""
    im = np.ascontiguousarray(img, np.float32)
    if im.ndim != 2:
        raise ValueError(f"fast_nms_native: want one (H, W) image, got {im.shape}")
    out = np.empty_like(im)
    if lib().tpuslam_fast_nms(im, im.shape[0], im.shape[1], float(min_th), out) != 0:
        raise RuntimeError("tpuslam_fast_nms failed")
    return out
