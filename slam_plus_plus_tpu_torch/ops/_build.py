"""Build and load the port's native code: the CUDA kernels (``csrc/*.cu``)
and the host C++ libraries.

The kernel sources have a plain C interface.  At first use each is compiled
by its own ``nvcc`` for Hopper (``sm_90a``), all at once, and the objects are
linked into one shared library under ``slam_plus_plus_tpu_torch/build/``
(git-ignored), loaded with ctypes.  The host libraries (HOST_LIBS: the g2o
reader and the incremental replay engine, compiled from ``native/`` where
they are, and the port's C API) are built by ``g++`` into the same
directory.  A library newer than every source is reused; a new one is
written to a file named for its process and renamed into place, so
concurrent builds never load half a file.  Nothing is built when this
module is imported, and there is no fallback: a missing compiler or a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import sysconfig
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NATIVE = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libslampp_kernels.so")
SOURCES = ("p2c.cu", "panel.cu", "clique.cu")
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
    "slampp_clique_forward_f32": (_P,) * 18 + (_I,) * 7 + (_P,),
    "slampp_clique_forward_f64": (_P,) * 18 + (_I,) * 7 + (_P,),
    "slampp_clique_back_f32": (_P,) * 6 + (_I,) * 3 + (_P,),
    "slampp_clique_back_f64": (_P,) * 6 + (_I,) * 3 + (_P,),
}


#: the host compiler of HOST_LIBS (a name on PATH or a path)
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
#: host library -> its C++ sources.  The reader and the engine are plain C++
#: beside the JAX package (they import nothing of it); the C API embeds
#: CPython and drives the port's BA facade.
HOST_LIBS = {
    "reader": (os.path.join(NATIVE, "g2o_reader.cpp"),),
    "engine": (os.path.join(NATIVE, "inc_engine.cpp"),),
    "ba_c_api": (os.path.join(CSRC, "ba_c_api.cpp"),),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "slam_plus_plus_tpu_torch are built from source at "
                           "first use and need the CUDA toolkit")
    return path


def _fresh(lib: str, sources) -> bool:
    if not os.path.exists(lib):
        return False
    built = os.path.getmtime(lib)
    return all(os.path.getmtime(s) <= built for s in sources)


def _run(cmd, what: str, tool: str = "nvcc"):
    """Run one compiler command; (its seconds, its output), or raise."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} failed on {what} ({proc.returncode}):\n{proc.stderr}")
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def build(force: bool = False):
    """Compile the kernels unless the library is fresh.

    Returns (library path, seconds spent building, {source: seconds of its
    own nvcc}, compiler output)."""
    if _fresh(LIB_PATH, [os.path.join(CSRC, s) for s in SOURCES]) and not force:
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


def host_lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libslampp_{name}.so")


def python_embed_flags():
    """Compiler and linker flags that embed this interpreter, from
    sysconfig (python3-config may be missing): its include directory, its
    library directory (also as the run path) and its library."""
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"Python.h not found in {include}: the C API embeds the "
                           f"interpreter and needs its headers")
    libdir = sysconfig.get_config_var("LIBDIR")
    ldlib = sysconfig.get_config_var("LDLIBRARY")        # libpython3.X.so or .a
    return [f"-I{include}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-l{ldlib[3:].split('.so')[0].split('.a')[0]}",
            *(sysconfig.get_config_var("LIBS") or "").split()]


def build_host(name: str, force: bool = False):
    """Compile HOST_LIBS[name] with CXX unless its library is fresh; returns
    (library path, seconds spent building)."""
    sources = HOST_LIBS[name]
    lib = host_lib_path(name)
    if _fresh(lib, sources) and not force:
        return lib, 0.0
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the host libraries of "
                           f"slam_plus_plus_tpu_torch are built from source at first use")
    extra = python_embed_flags() if name == "ba_c_api" else []
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        secs, _ = _run([cxx, *CXX_FLAGS, "-o", tmp, *sources, *extra], name, CXX)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, secs


@functools.cache
def load_host(name: str) -> ctypes.CDLL:
    """A host library, built on first use (its argument types are its
    binding's to declare)."""
    return ctypes.CDLL(build_host(name)[0])


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
