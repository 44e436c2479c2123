"""Build and load of the package's CUDA kernels, shared by their wrappers.

`nvcc` compiles one source of `csrc/` on first use into
`retinanet_torch/_build/`, a shared library with a plain C interface that is
loaded with ctypes. The file is named by a hash of the source and the flags,
so an edit rebuilds it. Importing a wrapper needs no `nvcc`; a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc(source: Path) -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"nvcc not found: {source} is built with the CUDA "
                       "toolkit")


class CudaLibrary:
    """One source of `csrc/`, its built library, and the count of kernel
    launches that its wrapper keeps.

    `declare(lib)` sets the argtypes and restype of every exported function
    once the library is loaded. `build()` may be called from several threads
    (one `nvcc` per source, all started together)."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def build(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._build()
            return self._lib

    def _build(self) -> ctypes.CDLL:
        source = self.source.read_bytes()
        tag = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
        path = BUILD_DIR / f"lib{self.name}_{tag}.so"
        start = time.perf_counter()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [find_nvcc(self.source), *NVCC_FLAGS, "-o", tmp,
                     str(self.source)],
                    capture_output=True, text=True, timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {self.source}:\n{proc.stdout}"
                        f"{proc.stderr}")
                self.build_log = proc.stdout + proc.stderr
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(path))
        self._declare(lib)
        self.build_seconds = time.perf_counter() - start
        return lib


def device_index(device) -> int:
    """The ordinal of a CUDA `torch.device` for `cudaSetDevice`."""
    import torch
    return (device.index if device.index is not None
            else torch.cuda.current_device())
