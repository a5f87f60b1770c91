"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m requires_cuda \
        tests/test_torch_cuda_kernels.py

Tolerances: float32 |diff| <= 1e-4 (same f32 arithmetic, another
summation order); bfloat16 |diff| <= 2e-2 (p is rounded to bf16 before
the p.v product on both sides, so one rounding of p can differ). The
float32 backward's is scaled by the reference gradient's magnitude,
|diff| <= 1e-4 * max(1, max|ref|), since dK/dV sum over every query
row. The bfloat16 backward is held per 64-row tile of the sequence:
||diff|| / ||ref|| <= 1e-2 in every tile of every (batch, head), so a
zeroed or garbled tile of small late-row gradients cannot hide behind
the largest element.
"""

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu_torch.ops import flash_attention as tflash

pytestmark = pytest.mark.requires_cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_TILE_TOL = 1e-2

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


def _tile_rel_err(got, ref, block=64):
    """Largest ||got - ref|| / ||ref|| over the 64-row sequence tiles of
    every (batch, head); a tile whose reference is exactly zero must
    come out zero."""
    diff = got - ref
    pad = (-ref.shape[2]) % block
    diff, ref = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                 for t in (diff, ref))
    b, n, _, d = ref.shape
    dn, rn = (t.reshape(b, n, -1, block * d).norm(dim=-1)
              for t in (diff, ref))
    return torch.nan_to_num(dn / rn, nan=0.0,
                            posinf=float("inf")).max().item()


def _cotangents(o, lse, seed=1):
    """Seeded (dO, g_lse), zero on rows with no visible key (NaN O), as
    a caller weighting those rows to zero gives them."""
    rng = np.random.default_rng(seed)
    nan_rows = torch.isnan(o).any(dim=-1)
    do = torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(
        np.float32)).to(o.device, o.dtype)
    g_lse = torch.from_numpy(rng.standard_normal(tuple(lse.shape)).astype(
        np.float32)).to(lse.device)
    return do.masked_fill(nan_rows[..., None], 0), g_lse.masked_fill(
        nan_rows, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_bwd_kernels_match_plain_version(case, dtype, cuda_device):
    _, b, h, h_kv, s_q, s_k, d, kw = case
    q, k, v = _inputs(cuda_device, dtype, b, h, h_kv, s_q, s_k, d)
    o, lse = tflash.flash_attention_fwd_reference(q, k, v, **kw)
    do, g_lse = _cotangents(o, lse)
    before = dict(tflash.LAUNCHES)
    got = tflash.flash_attention_bwd_cuda(q, k, v, o, lse, do, g_lse, **kw)
    assert tflash.LAUNCHES["flash_attention_bwd_dkv"] == \
        before["flash_attention_bwd_dkv"] + 1
    assert tflash.LAUNCHES["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 1
    want = tflash.flash_attention_bwd_reference(q, k, v, o, lse, do, g_lse,
                                                **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        g, w = g.float().cpu(), w.float().cpu()
        assert torch.isfinite(g).all(), name
        if dtype == torch.bfloat16:
            assert _tile_rel_err(g, w) <= BWD_TILE_TOL, name
            continue
        tol = TOL[dtype] * max(1.0, w.abs().max().item())
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=tol, rtol=0,
                                   err_msg=name)


def test_flash_autograd_runs_the_kernels(cuda_device):
    """Gradients of a model-shaped use (strided q/k/v views of a fused
    projection, O read back through a transpose) go through the forward
    and both backward kernels, once each, and equal the plain path's."""
    x = torch.randn(2, 150, 3, 4, 64, device=cuda_device)
    cpu_x = x.detach().cpu().requires_grad_(True)
    x.requires_grad_(True)
    w = torch.randn(2, 150, 4 * 64, device=cuda_device)

    def loss(x):
        q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
        o = tflash.flash_attention(q, k, v, causal=True)
        return (o.transpose(1, 2).reshape(2, 150, -1)
                * w.to(o.device)).sum()

    before = dict(tflash.LAUNCHES)
    loss(x).backward()
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert tflash.LAUNCHES[name] == before[name] + 1, name
    loss(cpu_x).backward()
    torch.testing.assert_close(x.grad.cpu(), cpu_x.grad, atol=1e-4, rtol=0)


def test_remat_policies_through_the_kernels(cuda_device):
    """none / full / dots_saveable give the same gradients through the
    kernels; ``full`` launches the forward kernel once more per layer."""
    from distributed_pytorch_tpu_torch import TransformerLM

    tokens = torch.randint(0, 97, (2, 81), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(0))
    state, grads, fwd = None, {}, {}
    for policy in ("none", "full", "dots_saveable"):
        model = TransformerLM(vocab=97, dim=128, n_layers=2, n_heads=2,
                              max_seq=80, remat=policy,
                              attn_fn=tflash.make_flash_attn_fn(
                                  min_seq_flash=None), device=cuda_device)
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        before = tflash.LAUNCHES["flash_attention_fwd"]
        logits = model(tokens[:, :-1])
        torch.nn.functional.cross_entropy(
            logits.reshape(-1, 97), tokens[:, 1:].reshape(-1)).backward()
        torch.cuda.synchronize()
        fwd[policy] = tflash.LAUNCHES["flash_attention_fwd"] - before
        grads[policy] = [p.grad for p in model.parameters()]
    assert fwd == {"none": 2, "full": 4, "dots_saveable": 4}
    for policy in ("full", "dots_saveable"):
        for g, w in zip(grads[policy], grads["none"]):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_flash_kernel_reads_strided_views(cuda_device):
    """q/k/v as (B, S, H, D) -> (B, H, S, D) views, as the model's fused
    qkv projection hands them over, without a copy."""
    x = torch.randn(1, 150, 3, 4, 64, device=cuda_device)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    o, _ = tflash.flash_attention_fwd_cuda(q, k, v, causal=True)
    o_ref, _ = tflash.flash_attention_fwd_reference(q, k, v, causal=True)
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=0)


def _fused_qkv_views(device, b, s, h, d, seed=2):
    """bf16 q/k/v as (B, H, S, D) views of one fused projection
    (B, S, 3 H D) and dO as the transposed view of a (B, S, H, D)
    gradient, as the model hands them over: none contiguous."""
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in mk(b, s, 3 * h * d).split(h * d, dim=-1))
    do = mk(b, s, h, d).transpose(1, 2)
    assert not any(t.is_contiguous() for t in (q, k, v, do))
    return q, k, v, do


def test_bf16_forward_reads_ragged_fused_qkv_views(cuda_device):
    """S = 1000 (not a multiple of the 64-row tile), B = 2: the TMA
    descriptors run on the views' own strides and zero-fill past the
    sequence's end."""
    q, k, v, _ = _fused_qkv_views(cuda_device, 2, 1000, 4, 64)
    o, lse = tflash.flash_attention_fwd_cuda(q, k, v, causal=True)
    o_ref, lse_ref = tflash.flash_attention_fwd_reference(q, k, v,
                                                          causal=True)
    torch.cuda.synchronize()
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=0)


def test_bf16_bwd_kernels_read_ragged_fused_qkv_views(cuda_device):
    """The dK/dV and the dQ kernel on the same ragged fused-projection
    views, dO a transposed view: both read q, k, v and dO through TMA
    descriptors on the views' own strides. Every 64-row tile of dQ, dK
    and dV within BWD_TILE_TOL."""
    q, k, v, do = _fused_qkv_views(cuda_device, 2, 1000, 4, 64)
    o, lse = tflash.flash_attention_fwd_reference(q, k, v, causal=True)
    got = tflash.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    want = tflash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                causal=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float().cpu(), w.float().cpu()
        assert torch.isfinite(g).all(), name
        assert _tile_rel_err(g, w) <= BWD_TILE_TOL, name


def test_bf16_dq_is_deterministic(cuda_device):
    """Two bf16 dQ launches on the same inputs give bit-identical dQ
    (each element is summed by one warpgroup in a fixed order, no
    atomics): B = 2, GQA h = 12 over h_kv = 4, ragged S = 1000."""
    q, k, v = _inputs(cuda_device, torch.bfloat16, 2, 12, 4, 1000, 1000, 64)
    o, lse = tflash.flash_attention_fwd_cuda(q, k, v, causal=True)
    do, _ = _cotangents(o, lse)
    run = tflash.FlashBwdLaunch(q, k, v, o, lse, do, causal=True)
    before = tflash.LAUNCHES["flash_attention_bwd_dq"]
    run.launch_dq()
    first = run.dq.clone()
    run.dq.fill_(float("nan"))
    run.launch_dq()
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention_bwd_dq"] == before + 2
    assert torch.isfinite(first).all()
    assert torch.equal(first, run.dq)
    want, _, _ = tflash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                      causal=True)
    assert _tile_rel_err(first.float().cpu(), want.float().cpu()) <= \
        BWD_TILE_TOL


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _inputs(cuda_device, torch.float16, 1, 2, 2, 16, 16, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.flash_attention_fwd_cuda(q, k, v)
    q, k, v = _inputs(cuda_device, torch.float32, 1, 2, 2, 16, 16, 32)
    with pytest.raises(ValueError, match="head size"):
        tflash.flash_attention_fwd_cuda(q, k, v)
    q, k, v = _inputs(cuda_device, torch.float32, 1, 2, 2, 16, 16, 64)
    o, lse = tflash.flash_attention_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_bwd_cuda(q.cpu(), k, v, o, lse, o)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.flash_attention_bwd_cuda(q, k, v, o, lse, o.bfloat16())
