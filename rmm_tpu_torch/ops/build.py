"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each kernel library is one source (with the headers it includes from
``csrc/*.cuh``) compiled into a shared library with a plain C interface,
loaded through ctypes (no PyTorch headers, so a build takes seconds). One
source may make two libraries under different macros: the column
attention's float32 and bf16 builds. Builds happen at first use into the
git-ignored ``_build/``; :func:`build_all` starts every compiler at once
(the host graph engine's ``g++`` included) and waits for all of them.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading

from ..graph import build as graph_build
from ..utils import native

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
KERNEL_SOURCES = {
    "column_attention": os.path.join(_CSRC, "column_attention.cu"),
    "column_attention_bf16": os.path.join(_CSRC, "column_attention.cu"),
}
#: the macros a library is built with beyond NVCC_FLAGS
KERNEL_MACROS = {"column_attention_bf16": ["-DRMM_ATTENTION_BF16"]}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source and need the CUDA toolkit")
    return path


def start_cuda_build(src: str, out_dir: str = native.BUILD_DIR,
                     name: str | None = None,
                     macros: list[str] = ()) -> native.Build:
    """Starts ``nvcc`` on the CUDA source ``src`` with the kernels' flags
    and ``macros``, the package's headers (``csrc/*.cuh``) on its include
    path; the library lands in ``out_dir`` under ``name`` (the source's
    by default) and a hash of the sources and flags (``wait()`` on the
    result gives its path as ``.out``)."""
    name = name or os.path.splitext(os.path.basename(src))[0]
    flags = [*NVCC_FLAGS, *macros]
    headers = sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                     if f.endswith(".cuh"))
    out = os.path.join(out_dir, os.path.basename(
        native.library_path(name, [src, *headers], flags)))
    os.makedirs(out_dir, exist_ok=True)
    return native.Build([_nvcc(), *flags, "-I", _CSRC, src], out)


def _start(name: str) -> native.Build:
    return start_cuda_build(KERNEL_SOURCES[name], name=name,
                            macros=KERNEL_MACROS.get(name, []))


def build_all() -> dict[str, str]:
    """Compile every kernel and the graph engine in parallel; returns each
    build's compiler output (empty when the library was already built)."""
    builds = {name: _start(name) for name in KERNEL_SOURCES}
    builds["graph_engine"] = graph_build.start_build()
    return {name: b.wait() for name, b in builds.items()}


def load_kernel(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, compiled first if needed."""
    with _lock:
        if name not in _libs:
            build = _start(name)
            build.wait()
            _libs[name] = ctypes.CDLL(build.out)
        return _libs[name]
