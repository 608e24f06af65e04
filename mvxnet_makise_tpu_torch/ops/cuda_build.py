"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library
(:class:`CudaLibrary`) under the package's ``build/`` directory (listed in
``.gitignore``), then bound with ctypes.  A library is built on first use,
or ahead of time by :func:`build_all`, which starts one ``nvcc`` per
source at once.  A source may hold several kernels; each is a
:class:`CudaKernel` with its own count of launches.  The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and never confused with an old build.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises on a nonzero
code and counts the launch.  Each library also keeps what its last entry
point launched (``csrc/launch_record.cuh``): grid, block, shared memory
and the registers ptxas gave each kernel, which
:meth:`CudaKernel.launch` reads back into ``last_launch``.
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
# fields of one launch in the record of csrc/launch_record.cuh (a library
# built before the record had ``launch_fields`` lacks the last)
LAUNCH_FIELDS = (("grid", 3), ("block", 3), ("shared_bytes", 1),
                 ("registers", 1), ("local_bytes", 1),
                 ("static_shared_bytes", 1), ("blocks_per_sm", 1))
_MAX_LAUNCHES = 4


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


class CudaLibrary:
    """One CUDA source compiled into its own shared library.

    ``functions`` maps each exported C function to its ctypes argtypes;
    every function returns an ``int`` CUDA error code.
    """

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.name = os.path.splitext(source)[0]
        self.source = os.path.join(CSRC, source)
        self.functions = dict(functions)
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    @property
    def library_path(self) -> str:
        h = hashlib.sha256()
        # the source and the headers it may include
        for path in [self.source] + sorted(
                os.path.join(CSRC, n) for n in os.listdir(CSRC)
                if n.endswith(".cuh")):
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:12]}.so")

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
                lib.last_launches.argtypes = [ctypes.c_void_p, ctypes.c_int]
                lib.last_launches.restype = ctypes.c_int
                self._lib = lib
        return self._lib


def read_launches(lib) -> List[dict]:
    """What a loaded library's last entry point launched, one dict per
    kernel (see ``LAUNCH_FIELDS``)."""
    fields = LAUNCH_FIELDS if hasattr(lib, "launch_fields") \
        else LAUNCH_FIELDS[:-1]
    width = sum(n for _, n in fields)
    buf = (ctypes.c_int * (width * _MAX_LAUNCHES))()
    n = lib.last_launches(buf, _MAX_LAUNCHES)
    out = []
    for k in range(n):
        vals, rec = list(buf[k * width:(k + 1) * width]), {}
        for name, count in fields:
            rec[name] = vals[:count] if count > 1 else vals[0]
            vals = vals[count:]
        out.append(rec)
    return out


class CudaKernel:
    """One kernel of a :class:`CudaLibrary`, with its own count of
    launches: :meth:`launch` adds one each time it launches."""

    def __init__(self, name: str, library: CudaLibrary):
        self.name = name
        self.library = library
        self.launches = 0
        self.last_launch: List[dict] = []

    def launch(self, function: str, *args, device) -> None:
        """Call one exported launcher with ``device`` (the card its
        tensors lie on; -1 leaves the current card) made the current card
        while it runs; raise if CUDA reports an error.  The C entry points
        launch on the stream they are given and query the current card's
        attributes: a launch on another card than the current one would
        run on the current card, on pointers of the other."""
        import torch

        lib = self.library.library()
        with torch.cuda.device(device):
            code = getattr(lib, function)(*args)
            if code != 0:
                msg = lib.kernel_error_string(code).decode()
                raise RuntimeError(
                    f"{self.name}: {function} failed with CUDA error "
                    f"{code} ({msg})")
            self.last_launch = read_launches(lib)
        self.launches += 1


def build_all(kernels: Sequence[CudaKernel]) -> Dict[str, dict]:
    """Build the libraries of ``kernels``, one nvcc per source, all
    started together.  Returns per-library build facts (seconds, command,
    the compiler's register/spill report)."""
    libs = list({id(k.library): k.library for k in kernels}.values())
    started = [(lib, lib.start_build()) for lib in libs]
    info = {}
    for lib, s in started:
        if s is not None:
            lib.finish_build(s)
        lib.library()
        info[lib.name] = {
            "seconds": lib.build_seconds,
            "cmd": " ".join(lib.build_command(lib.library_path)),
            "ptxas": [ln.strip() for ln in lib.build_log.splitlines()
                      if "registers" in ln or "spill" in ln],
        }
    return info


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device`` as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
