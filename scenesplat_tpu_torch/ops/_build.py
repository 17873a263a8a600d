"""Build and binding of the port's hand-written CUDA kernels.

Each kernel is one source file under ``csrc/`` with a plain C interface. It
is compiled with ``nvcc`` for ``sm_90a`` at first use into a shared library
under ``build/kernels/`` at the root of the checkout, named by a hash of its
source, the headers it includes from ``csrc/`` and the compiler flags (an
edited source or header rebuilds), and loaded with ``ctypes``. The
compiler's register and spill report (``-Xptxas -v``) goes to a ``.log``
file beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(cand)


class KernelLibrary:
    """One kernel source and its shared library. ``declare(lib)`` sets the
    ``argtypes`` and ``restype`` of the library's C functions once loaded."""

    def __init__(self, source: Path, declare: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        """The shared library's path, keyed by a hash of the source, the
        headers it includes from its own directory and the flags."""
        text = self.source.read_bytes()
        headers = re.findall(rb'^#include "([^"]+)"', text, re.M)
        text += b"".join((self.source.parent / h.decode()).read_bytes() for h in headers)
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{digest.hexdigest()[:16]}.so"

    def log_path(self) -> Path:
        return self.path().with_suffix(".log")

    def build(self) -> float:
        """Compile the kernel unless this source is already built; returns
        the seconds spent (0.0 when the library was there)."""
        lib = self.path()
        if lib.exists():
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                              capture_output=True, text=True)
        self.log_path().write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        return time.perf_counter() - t0

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(str(self.path()))
            self._declare(lib)
            self._lib = lib
        return self._lib
