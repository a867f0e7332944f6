"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface.  At first use each is compiled by its
own ``nvcc`` for Hopper (``sm_90a``), all at once, and the objects are linked
into one shared library under ``slam_plus_plus_tpu_torch/build/``
(git-ignored), loaded with ctypes; a library newer than every source is
reused.  Nothing is built when this
module is imported, and there is no fallback: a missing compiler or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libslampp_kernels.so")
SOURCES = ("p2c.cu", "panel.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C entry points -> argument types; every entry returns cudaGetLastError()
_SIGNATURES = {
    "slampp_p2c_f32": (_P, _P, _P, _P, _P, _L, _P),
    "slampp_p2c_f64": (_P, _P, _P, _P, _P, _L, _P),
    "slampp_panels_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _P),
    "slampp_panels_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "slam_plus_plus_tpu_torch are built from source at "
                           "first use and need the CUDA toolkit")
    return path


def _fresh() -> bool:
    if not os.path.exists(LIB_PATH):
        return False
    built = os.path.getmtime(LIB_PATH)
    return all(os.path.getmtime(os.path.join(CSRC, s)) <= built for s in SOURCES)


def _run(cmd, what: str):
    """Run one nvcc command; (its seconds, its output), or raise."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}):\n{proc.stderr}")
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def build(force: bool = False):
    """Compile the kernels unless the library is fresh.

    Returns (library path, seconds spent building, {source: seconds of its
    own nvcc}, compiler output)."""
    if _fresh() and not force:
        return LIB_PATH, 0.0, {}, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{s}.{tag}.o") for s in SOURCES]
    tmp = f"{LIB_PATH}.{tag}"
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            done = list(pool.map(
                lambda s, o: _run([nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)], s),
                SOURCES, objs))
        _run([nvcc, "-shared", "-o", tmp, *objs], "the link")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, LIB_PATH)   # atomic: concurrent builders never see half a file
    return (LIB_PATH, time.perf_counter() - t0,
            {s: secs for s, (secs, _) in zip(SOURCES, done)}, "".join(out for _, out in done))


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    path = build()[0]
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (launch refused, no
    kernel image for the card, ...)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on t's device, as a pointer value."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
