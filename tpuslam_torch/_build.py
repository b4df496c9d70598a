"""Build and load the package's CUDA kernels (csrc/*.cu), and its host
library (csrc_host/*.cc), at first use.

nvcc compiles every source into an object file, all of them at once in
parallel, and links them into one shared library with a plain C interface,
which ctypes loads; no PyTorch headers are compiled, so a build takes
seconds. The library lands in `_build/` beside this file, named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one is
reused. Every C entry point returns `cudaGetLastError()` after its launch;
`check()` raises on a nonzero status.

The host library (the PNG decoder, the prefetcher, the quadtree oracle,
ATE/RPE and a CPU FAST+NMS; io/native.py binds it) is one g++ call over
csrc_host/*.cc, linked against zlib, into the same `_build/`, keyed the same
way. A failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
CSRC_HOST = os.path.join(_HERE, "csrc_host")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HOST_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared", "-pthread"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

MAX_LEVELS = 8  # csrc/fast_nms.cu kMaxLevels


class FastLevel(ctypes.Structure):
    """One level of csrc/fast_nms.cu's level table (struct FastLevel)."""

    _fields_ = [
        ("img", _P), ("out", _P), ("B", _I), ("H", _I), ("W", _I),
        ("tiles_x", _I), ("tiles_y", _I), ("tile0", _I), ("bias_step", _F), ("pad_", _I),
    ]


class FastLevels(ctypes.Structure):
    """csrc/fast_nms.cu's struct FastLevels, passed to the kernel by value."""

    _fields_ = [("lv", FastLevel * MAX_LEVELS), ("n_levels", _I), ("n_tiles", _I)]


# C signature of every entry point: (argtypes); all return int (cudaError_t).
_SIGNATURES = {
    # levels, min_th, stream
    "tpuslam_fast_nms_pyramid": [ctypes.POINTER(FastLevels), _F, _P],
    # atlas, corner, out, n, Ha, Wa, stream
    "tpuslam_gather_patches_u8": [_P, _P, _P, _I, _I, _I, _P],
    "tpuslam_gather_patches_f32": [_P, _P, _P, _I, _I, _I, _P],
    # R0, t0, pts, uvr, info, valid, R, t, inliers, n_inliers, B, n,
    # fx, fy, cx, cy, bf, chi2_mono, chi2_stereo, rounds, iters, stream
    "tpuslam_pose_lm": [_P] * 10 + [_I, _I] + [_F] * 7 + [_I, _I, _P],
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources(where: str = CSRC, pattern: str = "*.cu") -> list:
    srcs = sorted(glob.glob(os.path.join(where, pattern)))
    if not srcs:
        raise RuntimeError(f"no sources {pattern} under {where}")
    return srcs


def _lib_path(srcs, flags=NVCC_FLAGS, stem: str = "libtpuslam_torch") -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile csrc/*.cu (one nvcc per source, all started together) and
    link them, unless an up-to-date library exists.
    Returns {"path", "seconds", "log"}; raises if nvcc fails."""
    srcs = _sources()
    path = _lib_path(srcs)
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": "up to date"}
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, os.path.basename(s) + ".o") for s in srcs]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, p.returncode, log) for s, p, log in zip(srcs, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{os.path.basename(s)} ({rc}):\n{log}" for s, rc, log in failed))
        tmp = os.path.join(tmpdir, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build never loads half a file
    return {
        "path": path,
        "seconds": time.perf_counter() - t0,
        "log": "".join(logs).strip(),
    }


def build_host() -> dict:
    """Compile and link csrc_host/*.cc with g++ (and zlib), unless an
    up-to-date library exists. Returns {"path", "seconds", "log"}; raises if
    g++ is missing or fails."""
    srcs = _sources(CSRC_HOST, "*.cc")
    path = _lib_path(srcs, HOST_FLAGS, "libtpuslam_host")
    if os.path.exists(path):
        return {"path": path, "seconds": 0.0, "log": "up to date"}
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the host library needs a C++17 compiler and zlib")
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, "lib.so")
        out = subprocess.run([cxx, *HOST_FLAGS, *srcs, "-o", tmp, "-lz"], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed ({out.returncode}):\n{out.stderr}")
        os.replace(tmp, path)
    return {"path": path, "seconds": time.perf_counter() - t0, "log": out.stderr.strip()}


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    handle = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.tpuslam_cuda_error_string.argtypes = [ctypes.c_int]
    handle.tpuslam_cuda_error_string.restype = ctypes.c_char_p
    return handle


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        msg = lib().tpuslam_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
