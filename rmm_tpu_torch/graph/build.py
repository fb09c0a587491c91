"""Build and load the host graph engine (``csrc/graph_engine.cpp``, the
port's own copy of the JAX package's engine) through ctypes."""
from __future__ import annotations

import ctypes
import os
import threading

from ..utils import native

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "graph_engine.cpp")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native"]
_lock = threading.Lock()
_lib = None


def start_build() -> native.Build:
    out = native.library_path("rmmgraph", [_SRC], _FLAGS)
    return native.Build(["g++", *_FLAGS, _SRC], out)


def load_library() -> ctypes.CDLL:
    """Load the engine, compiling it first if needed; raises if the build
    fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build = start_build()
        build.wait()
        lib = ctypes.CDLL(build.out)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.rmm_graph_create.restype = ctypes.c_void_p
        lib.rmm_graph_create.argtypes = [i64p, i64p, i64p, ctypes.c_int64,
                                         ctypes.c_int64]
        lib.rmm_graph_destroy.argtypes = [ctypes.c_void_p]
        lib.rmm_in_degrees.argtypes = [ctypes.c_void_p, i64p]
        tail = [ctypes.c_int64, i64p, ctypes.c_int32, ctypes.c_uint64,
                ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
                i64p, i64p, i64p]
        lib.rmm_sample_from_edges.restype = ctypes.c_int64
        lib.rmm_sample_from_edges.argtypes = [ctypes.c_void_p, i64p, i64p,
                                              i64p, *tail]
        lib.rmm_sample_from_nodes.restype = ctypes.c_int64
        lib.rmm_sample_from_nodes.argtypes = [ctypes.c_void_p, i64p, *tail]
        lib.rmm_negative_sample.restype = None
        lib.rmm_negative_sample.argtypes = [
            i64p, i64p, ctypes.c_int64, i64p, i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, i64p, i64p]
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.rmm_ports.restype = None
        lib.rmm_ports.argtypes = [i64p, i64p, i64p, ctypes.c_int64,
                                  ctypes.c_int64, f64p, f64p]
        _lib = lib
        return _lib
