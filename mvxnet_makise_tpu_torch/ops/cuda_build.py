"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under the
package's ``build/`` directory (listed in ``.gitignore``), then bound with
ctypes.  A library is built on first use, or ahead of time by
:func:`build_all`, which starts one ``nvcc`` per source at once.  The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and never confused with an old build.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises on a nonzero
code and counts the launch.
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
from typing import Dict, List, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


class CudaKernel:
    """One CUDA source compiled into its own shared library.

    ``functions`` maps each exported C function to its ctypes argtypes;
    every function returns an ``int`` CUDA error code.  ``launches``
    counts the launches made through :meth:`launch`.
    """

    def __init__(self, name: str, source: str,
                 functions: Dict[str, Sequence]):
        self.name = name
        self.source = os.path.join(CSRC, source)
        self.functions = dict(functions)
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    @property
    def library_path(self) -> str:
        h = hashlib.sha256()
        with open(self.source, "rb") as f:
            h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:12]}.so")

    def build_command(self, output: str) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", output, self.source]

    def start_build(self):
        """Start nvcc if the library is not built yet.  Returns
        ``(process, temporary output, start time)`` or None."""
        if os.path.exists(self.library_path):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(self.build_command(tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def finish_build(self, started) -> None:
        proc, tmp, t0 = started
        log, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - t0
        self.build_log = log
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {self.source} (exit {proc.returncode}):\n"
                f"{log}")
        # rename into place: concurrent processes never load a
        # half-written library
        os.replace(tmp, self.library_path)

    def library(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                started = self.start_build()
                if started is not None:
                    self.finish_build(started)
                lib = ctypes.CDLL(self.library_path)
                for fn, argtypes in self.functions.items():
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = ctypes.c_int
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def launch(self, function: str, *args) -> None:
        """Call one exported launcher; raise if CUDA reports an error."""
        lib = self.library()
        code = getattr(lib, function)(*args)
        if code != 0:
            msg = lib.kernel_error_string(code).decode()
            raise RuntimeError(
                f"{self.name}: {function} failed with CUDA error {code} "
                f"({msg})")
        self.launches += 1


def build_all(kernels: Sequence[CudaKernel]) -> Dict[str, dict]:
    """Build every kernel's library, one nvcc per source, all started
    together.  Returns per-kernel build facts (seconds, command, the
    compiler's register/spill report)."""
    started = {k.name: k.start_build() for k in kernels}
    info = {}
    for k in kernels:
        if started[k.name] is not None:
            k.finish_build(started[k.name])
        k.library()
        info[k.name] = {
            "seconds": k.build_seconds,
            "cmd": " ".join(k.build_command(k.library_path)),
            "ptxas": [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln or "spill" in ln],
        }
    return info


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device`` as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
