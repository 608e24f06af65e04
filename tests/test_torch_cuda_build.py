"""PyTorch port: the CUDA build helper (``ops/cuda_build.py``) on the CPU.

No compiler or card is needed: a library's file name must follow its
source and the headers the sources include, a launch must be counted and
its record read back, and a CUDA error must raise.  The card tests
(``test_torch_gpu.py``) and ``chip_smoke.py`` build and run the real
libraries.
"""

import ctypes
import os

import pytest

from mvxnet_makise_tpu_torch.ops import column_merge, cuda_build, gather
from mvxnet_makise_tpu_torch.ops import scatter_grid


def _tree(tmp_path, header="// v1\n"):
    csrc = tmp_path / "csrc"
    csrc.mkdir(exist_ok=True)
    (csrc / "k.cu").write_text('#include "launch_record.cuh"\n')
    (csrc / "launch_record.cuh").write_text(header)
    return csrc


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    csrc = _tree(tmp_path)
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    lib = cuda_build.CudaLibrary("k.cu", {})
    first = lib.library_path
    assert first == lib.library_path
    assert os.path.dirname(first) == str(tmp_path / "build")
    (csrc / "launch_record.cuh").write_text("// v2\n")
    assert lib.library_path != first
    (csrc / "launch_record.cuh").write_text("// v1\n")
    assert lib.library_path == first


class _FakeLib:
    """Stands in for a loaded library: one launcher that returns ``code``
    and a launch record of two kernels."""

    ROWS = [[10, 2, 4, 80, 4, 1, 14080, 96, 0, 0, 2],
            [11, 1, 1, 32, 32, 1, 0, 24, 0, 4224, 1]]

    def __init__(self, code=0):
        self.code = code

    def launch_me(self, *args):
        return self.code

    def launch_fields(self):
        return len(self.ROWS[0])

    def last_launches(self, buf, capacity):
        width = self.launch_fields()
        rows = self.ROWS
        for k, row in enumerate(rows[:capacity]):
            for i, v in enumerate(row):
                buf[k * width + i] = v
        return min(len(rows), capacity)

    def kernel_error_string(self, code):
        return b"invalid argument"


def test_launch_counts_and_records(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC", str(_tree(tmp_path)))
    lib = cuda_build.CudaLibrary("k.cu", {})
    lib._lib = _FakeLib()
    kernel = cuda_build.CudaKernel("k", lib)
    assert kernel.launches == 0 and kernel.last_launch == []
    kernel.launch("launch_me", ctypes.c_int(1), device=-1)
    kernel.launch("launch_me", ctypes.c_int(1), device=-1)
    assert kernel.launches == 2
    assert kernel.last_launch == [
        {"grid": [10, 2, 4], "block": [80, 4, 1], "shared_bytes": 14080,
         "registers": 96, "local_bytes": 0, "static_shared_bytes": 0,
         "blocks_per_sm": 2},
        {"grid": [11, 1, 1], "block": [32, 32, 1], "shared_bytes": 0,
         "registers": 24, "local_bytes": 0, "static_shared_bytes": 4224,
         "blocks_per_sm": 1}]


class _OldLib(_FakeLib):
    """A library built before the record had ``launch_fields`` and its
    blocks per SM (another build compared by ``kernel_ab.py``)."""

    ROWS = [row[:-1] for row in _FakeLib.ROWS]
    launch_fields = property()   # absent: hasattr is False

    def last_launches(self, buf, capacity):
        for k, row in enumerate(self.ROWS[:capacity]):
            for i, v in enumerate(row):
                buf[k * len(row) + i] = v
        return min(len(self.ROWS), capacity)


def test_launch_record_of_a_library_without_blocks_per_sm():
    assert not hasattr(_OldLib(), "launch_fields")
    assert cuda_build.read_launches(_OldLib()) == [
        {"grid": [10, 2, 4], "block": [80, 4, 1], "shared_bytes": 14080,
         "registers": 96, "local_bytes": 0, "static_shared_bytes": 0},
        {"grid": [11, 1, 1], "block": [32, 32, 1], "shared_bytes": 0,
         "registers": 24, "local_bytes": 0, "static_shared_bytes": 4224}]


def test_launch_error_raises_and_is_not_counted(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC", str(_tree(tmp_path)))
    lib = cuda_build.CudaLibrary("k.cu", {})
    lib._lib = _FakeLib(code=1)
    kernel = cuda_build.CudaKernel("k", lib)
    with pytest.raises(RuntimeError, match="CUDA error 1 .invalid argument"):
        kernel.launch("launch_me", device=-1)
    assert kernel.launches == 0 and kernel.last_launch == []


@pytest.mark.parametrize("module", [column_merge, gather, scatter_grid])
def test_every_kernel_source_keeps_a_launch_record(module):
    """``CudaLibrary.library`` binds ``last_launches`` in every library,
    so each kernel source must include the record's header, and each of
    its launchers must clear and fill the record."""
    libraries = {k.library for k in getattr(module, "KERNELS",
                                            (module.KERNEL,))}
    for library in libraries:
        with open(library.source) as f:
            src = f.read()
        assert '#include "launch_record.cuh"' in src
        assert src.count("clear_launches();") >= 1
        assert src.count("record_launch(") >= src.count("<<<")


@pytest.mark.parametrize("module", [column_merge, gather, scatter_grid])
def test_argument_tables_match_the_c_entry_points(module):
    """Each launcher the wrapper binds takes as many arguments in its
    source as the wrapper's ctypes table gives it, pointers where the
    source has pointers: ctypes would pass a short table's missing
    arguments as garbage, and a pointer declared ``c_int`` cut to 32
    bits."""
    import re

    libraries = {k.library for k in getattr(module, "KERNELS",
                                            (module.KERNEL,))}
    for library in libraries:
        with open(library.source) as f:
            src = f.read()
        for fn, argtypes in library.functions.items():
            m = re.search(r"\bint\s+" + fn + r"\(([^)]*)\)\s*\{", src)
            assert m, f"{fn} not found in {library.source}"
            params = m.group(1).strip()
            macro = re.search(r"#define\s+" + params + r"\b((?:.*\\\n)*.*)",
                              src)
            if macro:     # a parameter list shared through a macro
                params = macro.group(1).replace("\\\n", " ")
            params = [p.strip() for p in params.split(",")]
            assert len(params) == len(argtypes), fn
            for p, t in zip(params, argtypes):
                assert ("*" in p) == (t is ctypes.c_void_p), (fn, p, t)
