"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m requires_cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: float32 |diff| <= 1e-4 (same f32 arithmetic, another
summation order); bfloat16 |diff| <= 2e-2 (p is rounded to bf16 before
the p.v product on both sides, so one rounding of p can differ).
"""

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu_torch.ops import flash_attention as tflash

pytestmark = pytest.mark.requires_cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# (name, b, h, h_kv, s_q, s_k, d, kwargs)
CASES = [
    ("causal", 1, 4, 4, 200, 200, 64, dict(causal=True)),
    ("full_ragged", 2, 2, 2, 70, 97, 64, dict(causal=False)),
    ("gqa_d128", 1, 4, 2, 130, 130, 128, dict(causal=True)),
    ("sq_lt_sk", 1, 2, 2, 64, 256, 64, dict(causal=True)),
    ("sq_gt_sk_nan_rows", 1, 2, 2, 100, 40, 64, dict(causal=True)),
    ("window", 1, 2, 2, 300, 300, 64, dict(causal=True, window=70)),
    ("causal_offset", 1, 2, 2, 129, 129, 64, dict(causal=True,
                                                   causal_offset=1)),
    ("diag_offset", 1, 2, 2, 128, 128, 64, dict(causal=True, diag_offset=96,
                                                 window=160)),
]


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")


def _inputs(device, dtype, b, h, h_kv, s_q, s_k, d, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, dtype)
    return mk(b, h, s_q, d), mk(b, h_kv, s_k, d), mk(b, h_kv, s_k, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_kernel_matches_plain_version(case, dtype, cuda_device):
    _, b, h, h_kv, s_q, s_k, d, kw = case
    q, k, v = _inputs(cuda_device, dtype, b, h, h_kv, s_q, s_k, d)
    before = tflash.LAUNCHES["flash_attention_fwd"]
    o, lse = tflash.flash_attention_fwd_cuda(q, k, v, **kw)
    assert tflash.LAUNCHES["flash_attention_fwd"] == before + 1
    o_ref, lse_ref = tflash.flash_attention_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    o, o_ref = o.float().cpu().numpy(), o_ref.float().cpu().numpy()
    np.testing.assert_array_equal(np.isnan(o), np.isnan(o_ref))
    np.testing.assert_allclose(np.nan_to_num(o), np.nan_to_num(o_ref),
                               atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               atol=TOL[dtype], rtol=0)


def test_flash_kernel_reads_strided_views(cuda_device):
    """q/k/v as (B, S, H, D) -> (B, H, S, D) views, as the model's fused
    qkv projection hands them over, without a copy."""
    x = torch.randn(1, 150, 3, 4, 64, device=cuda_device)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    o, _ = tflash.flash_attention_fwd_cuda(q, k, v, causal=True)
    o_ref, _ = tflash.flash_attention_fwd_reference(q, k, v, causal=True)
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=0)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _inputs(cuda_device, torch.float16, 1, 2, 2, 16, 16, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.flash_attention_fwd_cuda(q, k, v)
    q, k, v = _inputs(cuda_device, torch.float32, 1, 2, 2, 16, 16, 32)
    with pytest.raises(ValueError, match="head size"):
        tflash.flash_attention_fwd_cuda(q, k, v)
    q, k, v = _inputs(cuda_device, torch.float32, 1, 2, 2, 16, 16, 64)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tflash.flash_attention_with_lse(q, k, v, causal=True)
