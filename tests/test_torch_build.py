"""The port's kernel build keys: runs on the CPU, needs no ``nvcc``.

A library is named by a hash of its source, every shared ``csrc/*.cuh``
header and the compiler flags, so an edited header (the wgmma / TMA
helpers the bf16 kernels include) never loads a stale library. A kernel
declared ``wgmma+tma`` in ``DESIGNS`` is one whose HGMMA / UTMALDG counts
``chip_smoke.py``'s build phase checks.
"""

import re
import shutil
from pathlib import Path

import pytest
import torch

from distributed_pytorch_tpu_torch.ops import _build
from distributed_pytorch_tpu_torch.ops import flash_attention as tflash

SOURCES = [tflash.KERNEL_SOURCE, tflash.BWD_KERNEL_SOURCE]


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def test_kernel_sources_include_the_shared_header():
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert headers, "no shared header in csrc/"
    for source in SOURCES:
        text = (_build.CSRC / source).read_text()
        assert any(f'#include "{h}"' in text for h in headers), source


@pytest.mark.parametrize("source", SOURCES)
def test_library_path_is_stable_for_the_same_tree(source, csrc_copy):
    assert _build.library_path(source, csrc_copy) == \
        _build.library_path(source, csrc_copy)
    assert _build.library_path(source, csrc_copy) == \
        _build.library_path(source)


@pytest.mark.parametrize("source", SOURCES)
def test_editing_a_header_changes_library_path(source, csrc_copy):
    before = _build.library_path(source, csrc_copy)
    header = sorted(csrc_copy.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(source, csrc_copy)
    assert after != before
    assert after.parent == before.parent == _build.BUILD_DIR
    assert after.name.startswith(source.split(".")[0] + "-")


@pytest.mark.parametrize("source", SOURCES)
def test_editing_the_source_changes_library_path(source, csrc_copy):
    before = _build.library_path(source, csrc_copy)
    path = csrc_copy / source
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.library_path(source, csrc_copy) != before


def test_sm90a_target_is_in_the_flags():
    """wgmma exists only for sm_90a; plain sm_90 would refuse it."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("source", SOURCES)
def test_tile_defines_change_library_path(source):
    """A tile override builds its own library beside the default one."""
    default = _build.library_path(source)
    tuned = _build.library_path(source, defines=("DPX_SM90_FWD_BK=128",))
    assert tuned != default and tuned.parent == default.parent


def test_tile_sweep_needs_a_card():
    import torch

    from distributed_pytorch_tpu_torch.ops import flash_tile_sweep
    if torch.cuda.is_available():
        pytest.skip("the sweep itself runs on the card")
    assert flash_tile_sweep.main() == 2
    assert tflash.BUILD_DEFINES == {tflash.KERNEL_SOURCE: (),
                                    tflash.BWD_KERNEL_SOURCE: ()}


def _global_functions(source: Path):
    """Names of the ``__global__`` functions defined in ``source``."""
    pattern = re.compile(r"__global__\s+void\s+"
                         r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    return set(pattern.findall(source.read_text()))


@pytest.mark.parametrize("kernel", sorted(tflash.DESIGNS))
def test_every_wgmma_design_is_checked_by_the_build_phase(kernel):
    """Every bf16 kernel is declared ``wgmma+tma``, and each (kernel,
    dtype) so declared names, in ``chip_smoke.SM90_KERNELS``, a
    ``__global__`` function defined in its source: the build phase then
    fails if that function shows no HGMMA or no UTMALDG, or spills."""
    import chip_smoke
    designs = tflash.DESIGNS[kernel]
    assert designs[torch.bfloat16] == "wgmma+tma"
    source = Path(chip_smoke.__file__).parent / chip_smoke.KERNELS[kernel][0]
    for dtype, design in designs.items():
        if design == "wgmma+tma":
            assert chip_smoke.SM90_KERNELS[kernel] in _global_functions(
                source), (kernel, dtype)


def test_build_phase_checks_only_declared_kernels():
    """No kernel is held to the wgmma checks without a declared design."""
    import chip_smoke
    assert set(chip_smoke.SM90_KERNELS) == {
        name for name, designs in tflash.DESIGNS.items()
        if "wgmma+tma" in designs.values()}
