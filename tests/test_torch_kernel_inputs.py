"""What the bf16 kernels' TMA descriptors are handed, checked on the CPU.

TMA reads a tile straight from the tensor's own strides when its base is
16-byte aligned and every stride but the last is a multiple of 16 bytes;
the wrapper copies only tensors that break that, and pads the float32
row terms (lse, delta) to a row stride that is a multiple of 4.
"""

import pytest
import torch

from distributed_pytorch_tpu_torch.ops import flash_attention as tflash


def _fused_views(b=2, s=100, h=4, d=64):
    x = torch.zeros(b, s, 3 * h * d, dtype=torch.bfloat16)
    return [t.reshape(b, s, h, d).transpose(1, 2)
            for t in x.split(h * d, dim=-1)]


def test_fused_projection_views_are_read_in_place():
    for t in _fused_views():
        assert not t.is_contiguous()
        assert tflash._tma_view(t) is t


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(1, 2, 9 * 64 + 1, dtype=torch.bfloat16)[..., 1:]
    .reshape(1, 2, 9, 64),
    lambda: torch.zeros(1, 2, 10, 68, dtype=torch.bfloat16)[..., :64],
], ids=["misaligned_base", "stride_not_16_bytes"])
def test_what_tma_cannot_read_is_copied_contiguous(make):
    t = make()
    got = tflash._tma_view(t)
    assert got is not t and got.is_contiguous()
    assert torch.equal(got, t)


def test_size_one_axes_take_their_contiguous_stride():
    t = torch.zeros(1, 12, 1, 64).as_strided((1, 12, 1, 64),
                                              (7, 64, 3, 1))
    assert tflash._strides(t) == (12 * 64, 64, 64)
    assert tflash._tma_view(t) is t
    q = _fused_views(b=3)[0]
    assert tflash._strides(q) == q.stride()[:3]


@pytest.mark.parametrize("s", [64, 70, 1000, 1001])
def test_row_terms_are_padded_to_a_multiple_of_4(s):
    lse = torch.randn(2, 3, s)
    ld = -(-s // 4) * 4
    got = tflash._rows(lse, ld)
    assert got.shape == (2, 3, ld) and got.is_contiguous()
    assert torch.equal(got[..., :s], lse)
    assert (got is lse) == (s == ld)
    if ld > s:
        assert not got[..., s:].any()
