"""Build native libraries (the C++ graph engine, the CUDA kernels) at first
use, from the sources in the package, into the git-ignored ``_build/``.

Each library's file name carries a hash of its sources and flags, so an
edited source is rebuilt and a stale library is never loaded. A build
writes to a temporary name and renames it into place, so processes that
build at the same time never load a half-written file. A failed build
raises with the compiler's output.
"""
from __future__ import annotations

import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def library_path(name: str, sources: list[str], flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


class Build:
    """One compiler process writing ``out`` (nothing to do if it exists)."""

    def __init__(self, cmd: list[str], out: str):
        self.out = out
        self.log = ""
        self.proc = None
        if os.path.exists(out):
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.tmp = f"{out}.{os.getpid()}.tmp"
        self.proc = subprocess.Popen(cmd + ["-o", self.tmp],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def wait(self) -> str:
        """Wait for the compiler; returns its output, raises on failure."""
        if self.proc is not None:
            self.log, _ = self.proc.communicate()
            rc, self.proc = self.proc.returncode, None
            if rc != 0:
                raise RuntimeError(
                    f"build of {os.path.basename(self.out)} failed "
                    f"(exit {rc}):\n{self.log}")
            os.replace(self.tmp, self.out)
        return self.log
