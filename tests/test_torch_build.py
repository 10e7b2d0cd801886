"""The port's kernel build (antmmf_torch/ops/_build.py), as far as the CPU
reaches: the library's name is keyed by a digest of the compiler flags and of
every file under ``csrc/``, headers included, so an edited file never loads a
stale build. (``nvcc`` itself runs only on a machine with a GPU.)
"""

import os
import re
import shutil

import pytest

from antmmf_torch.ops import _build
from test_torch_task_trainer import one_torch_thread  # noqa: F401  (autouse, this module)

FILES = sorted(os.listdir(_build.CSRC))


def test_sources_and_the_shared_header_are_there():
    assert "attention_common.cuh" in FILES
    assert {"small_attention.cu", "flash_attention.cu", "int4_gemv.cu"} <= set(FILES)


def test_digest_is_stable_and_names_the_library(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    assert _build.source_digest(str(copy)) == _build.source_digest()
    assert re.fullmatch(r"[0-9a-f]{16}", _build.source_digest())


@pytest.mark.parametrize("name", FILES)
def test_digest_changes_with_any_file_under_csrc(name, tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    with open(copy / name, "ab") as f:
        f.write(b"\n// edited\n")
    assert _build.source_digest(str(copy)) != _build.source_digest()


def test_digest_changes_with_a_renamed_or_added_header(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    (copy / "extra.cuh").write_bytes(b"")
    assert _build.source_digest(str(copy)) != _build.source_digest()


@pytest.mark.parametrize("name", [n for n in FILES if n.endswith(".cu")])
def test_quoted_includes_resolve_inside_csrc(name):
    with open(os.path.join(_build.CSRC, name)) as f:
        included = re.findall(r'^#include "([^"]+)"', f.read(), flags=re.M)
    assert all(os.path.exists(os.path.join(_build.CSRC, inc)) for inc in included)


def test_ptxas_report_reads_registers_and_spills():
    log = """nvcc -gencode arch=compute_90a,code=sm_90a -c flash_attention.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_dq128_kernelE9FlashArgs' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118flash_dq128_kernelE9FlashArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 180 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_dkv128_kernelE9FlashArgs' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_dkv128_kernelE9FlashArgs
    24 bytes stack frame, 20 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 448 bytes cmem[0]
"""
    assert _build.ptxas_report(log) == {
        "_ZN12_GLOBAL__N_118flash_dq128_kernelE9FlashArgs":
            {"registers": 180, "spill_stores": 0, "spill_loads": 0},
        "_ZN12_GLOBAL__N_119flash_dkv128_kernelE9FlashArgs":
            {"registers": 255, "spill_stores": 20, "spill_loads": 16}}
