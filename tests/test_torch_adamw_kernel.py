"""The port's fused AdamW kernel (``csrc/adamw_fused.cu``), its plain
version and the dispatch of ``optim.adamw`` between the kernel and the
``torch._foreach_*`` chain.

On the CPU: the plain version (``adamw_fused.adamw_reference``), the
kernel's arithmetic in its order, equals the chain bit for bit; CPU
tensors and CPU DTensors take the chain, and the counts say so; a
DTensor's local shards follow its parameter's layout; the module
imports and the CPU path runs without ``nvcc``.

On the card (``requires_cuda``; skips without one; the file imports
neither JAX nor the JAX package):

    python -m pytest --noconftest -p no:cacheprovider -m requires_cuda \\
        tests/test_torch_adamw_kernel.py

the kernel against the chain on the same inputs after each of 10 steps:
mu and nu within 4 float32 ulps of the chain's, p within 4 float32 ulps
of the larger of |p| and |the step's change|. Both compute the same
float32 operations in the same order with the same roundings (on the
card torch divides by a Python scalar as a product with its float32
reciprocal, and so does the kernel), so equality is what they should
give. The plain version run on the card equals the kernel bit for bit.
Strided views and DTensors on a one-rank NCCL mesh take the kernel too,
and a parameter of a dtype it does not take is refused.
"""

import math
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu_torch import optim
from distributed_pytorch_tpu_torch.ops import _build
from distributed_pytorch_tpu_torch.ops import adamw_fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYPER = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
STEPS = 10
BF16 = torch.bfloat16
F32 = torch.float32
DTYPE_PAIRS = [(F32, F32), (BF16, BF16), (F32, BF16), (BF16, F32)]
PAIR_IDS = ["f32", "bf16", "f32_bf16grad", "bf16_f32grad"]
#: lengths off multiples of 4 and across work items (8192 elements)
SHAPES = [(7,), (33, 5), (1,), (3, 4, 5), (8192 * 2 + 5,), (64, 130)]
#: class keys of the benchmark's other kernel classes
OTHER_CLASSES = ("flash", "nccl", "gemm", "cutlass", "nvjet", "xmma",
                 "cublas")


def _bias(step):
    t = np.float32(step)
    return {"c1": float(np.float32(1.0) - np.float32(HYPER["b1"]) ** t),
            "c2": float(np.float32(1.0) - np.float32(HYPER["b2"]) ** t)}


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32)


def _randn(rng, shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


def _per_launch() -> int:
    """The tensors one launch takes, the kernel's own constant."""
    src = (_build.CSRC / adamw_fused.KERNEL_SOURCE).read_text()
    return int(re.search(r"constexpr int kMaxTensors = (\d+);",
                         src).group(1))


@pytest.mark.parametrize("p_dtype,g_dtype", DTYPE_PAIRS, ids=PAIR_IDS)
def test_plain_version_equals_the_foreach_chain_bitwise(p_dtype, g_dtype):
    rng = np.random.default_rng(0)
    shapes = SHAPES + [(0,)]
    chain = [_randn(rng, s).to(p_dtype) for s in shapes]
    plain = [p.clone() for p in chain]
    mom = {side: ([torch.zeros(s) for s in shapes],
                  [torch.zeros(s) for s in shapes]) for side in "ab"}
    for step in range(1, STEPS + 1):
        grads = [_randn(rng, s, 10.0 ** -(step % 4)).to(g_dtype)
                 for s in shapes]
        kw = dict(HYPER, **_bias(step))
        optim._adamw_foreach(grads, chain, *mom["a"], **kw)
        for p, g, m, v in zip(plain, grads, *mom["b"]):
            adamw_fused.adamw_reference(p, g, m, v, **kw)
        for x, y in zip(chain + mom["a"][0] + mom["a"][1],
                        plain + mom["b"][0] + mom["b"][1]):
            assert torch.equal(_bits(x), _bits(y)), step


def test_cpu_tensors_take_the_foreach_chain_and_are_counted():
    rng = np.random.default_rng(1)
    params = [_randn(rng, s) for s in SHAPES]
    opt = optim.adamw(**HYPER)
    state = opt.init(params)
    grads = [_randn(rng, s) for s in SHAPES]
    grads[1] = None
    adamw_fused.reset_launch_counts()
    opt.update(grads, state, params)
    assert adamw_fused.LAUNCHES == {"adamw_multi_tensor_apply": 0}
    assert adamw_fused.ELEMENTS == {
        "fused": 0, "foreach": sum(math.prod(s) for i, s in enumerate(SHAPES)
                                   if i != 1)}


def test_fusable_refuses_cpu_tensors_and_split_keeps_the_order():
    rng = np.random.default_rng(2)
    lists = [[_randn(rng, s) for s in SHAPES] for _ in range(4)]
    assert not any(adamw_fused.fusable(p, g, m, v)
                   for g, p, m, v in zip(*lists))
    fused, back, rest = adamw_fused.split(*lists)
    assert fused == {} and back == []
    assert all(a is b for got, want in zip(rest, lists)
               for a, b in zip(got, want))


def test_the_per_launch_table_fits_the_kernel_parameters():
    # 4 pointers, a length and a first item a tensor, within 32,764 bytes
    assert 600 <= _per_launch() and 6 * 8 * _per_launch() < 32764


def test_the_cpu_path_never_loads_the_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path loaded a kernel")
    monkeypatch.setattr(_build, "load", refuse)
    params = [torch.ones(5), torch.ones(2, 3)]
    opt = optim.adamw(**HYPER)
    opt.update([torch.ones(5), torch.ones(2, 3)], opt.init(params), params)
    assert params[0][0].item() < 1.0


def _python(code: str, **env) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, **env))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_the_module_imports_and_runs_on_the_cpu_without_nvcc(tmp_path):
    out = _python("""
        import shutil
        assert shutil.which("nvcc") is None
        import torch
        from distributed_pytorch_tpu_torch import optim
        from distributed_pytorch_tpu_torch.ops import _build, adamw_fused
        p = [torch.ones(4)]
        opt = optim.adamw(1e-2)
        opt.update([torch.ones(4)], opt.init(p), p)
        assert not _build._loaded
        print(adamw_fused.ELEMENTS["foreach"])
    """, PATH=str(tmp_path))
    assert out.split() == ["4"]


def test_dtensors_take_the_foreach_chain():
    out = _python("""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, distribute_tensor
        from distributed_pytorch_tpu_torch import optim
        from distributed_pytorch_tpu_torch.ops import adamw_fused
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        mesh = init_device_mesh("cpu", (1,))
        torch.manual_seed(0)
        plain = [torch.randn(6, 4), torch.randn(10)]
        grads = [torch.randn(6, 4), torch.randn(10)]
        dparams = [distribute_tensor(p.clone(), mesh, [Shard(0)])
                   for p in plain]
        dgrads = [distribute_tensor(g, mesh, [Shard(0)]) for g in grads]
        opt = optim.adamw(1e-2)
        opt.update(grads, opt.init(plain), plain)
        adamw_fused.reset_launch_counts()
        opt.update(dgrads, opt.init(dparams), dparams)
        for d, p in zip(dparams, plain):
            assert torch.equal(d.full_tensor(), p)
        print(adamw_fused.LAUNCHES["adamw_multi_tensor_apply"],
              adamw_fused.ELEMENTS["fused"], adamw_fused.ELEMENTS["foreach"])
        dist.destroy_process_group()
    """)
    assert out.split() == ["0", "0", "34"]


def test_dtensor_local_shards_follow_the_parameters_layout():
    out = _python("""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard, distribute_tensor)
        from distributed_pytorch_tpu_torch.ops import adamw_fused
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        mesh = init_device_mesh("cpu", (1,))
        p = distribute_tensor(torch.randn(6, 4), mesh, [Shard(0)])
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        g = DTensor.from_local(torch.randn(6, 4), mesh, [Partial()])
        ts = adamw_fused._locals(p, g, m, v)
        assert all(type(t) is torch.Tensor for t in ts)
        assert ts[0].data_ptr() == p.to_local().data_ptr()
        assert torch.equal(ts[1], g.to_local())
        bad = distribute_tensor(torch.zeros(6, 4), mesh, [Replicate()])
        for args in ((p, g, bad, v), (p, g.to_local(), m, v),
                     (p.to_local(), g, m, v)):
            try:
                adamw_fused._locals(*args)
            except ValueError:
                print("refused")
        dist.destroy_process_group()
    """)
    assert out.split() == ["refused"] * 3


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    """Decided at run time, never at import: skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")


def _at(x, offset: int = 0):
    """``x`` copied to the card at ``offset`` elements past a fresh
    allocation's (512-byte aligned) start: a contiguous view."""
    buf = torch.zeros(x.numel() + offset, dtype=x.dtype, device="cuda")
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def _ulps(x):
    return torch.from_numpy(np.spacing(np.abs(x.float().cpu().numpy())))


def _assert_close(ref, got, scale, what):
    diff = (ref.float() - got.float()).abs().cpu()
    bad = diff > 4 * _ulps(scale)
    assert not bad.any(), (what, int(bad.sum()), float(diff.max()))


def _check_step(chain, fused, before, what):
    """p, mu and nu of the kernel against the chain's after one step."""
    (cp, cm, cv), (fp, fm, fv) = chain, fused
    for a, b, p0 in zip(cp, fp, before):
        scale = torch.maximum(a.float().abs(), (p0.float() - a.float()).abs())
        _assert_close(a, b, scale, what + " p")
    for a, b in zip(cm + cv, fm + fv):
        _assert_close(a, b, a, what + " moments")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("p_dtype,g_dtype", DTYPE_PAIRS, ids=PAIR_IDS)
def test_kernel_matches_the_foreach_chain(p_dtype, g_dtype, cuda_device):
    rng = np.random.default_rng(3)
    # each shape once aligned and once 4 bytes (one float32) off 16
    cases = [(s, off) for s in SHAPES for off in (0, 1)]
    init = [_randn(rng, s).to(p_dtype) for s, _ in cases]
    chain = [_at(x, off) for x, (_, off) in zip(init, cases)]
    fused = [_at(x, off) for x, (_, off) in zip(init, cases)]
    # a frozen parameter (no gradient) and an empty one, left untouched
    frozen = _at(_randn(rng, (9,)).to(p_dtype))
    frozen0 = frozen.clone()
    empty = _at(torch.zeros(0, dtype=p_dtype))

    def zeros():
        return [_at(torch.zeros(s), off) for s, off in cases]
    c_mu, c_nu = zeros(), zeros()
    opt = optim.adamw(**HYPER)
    extra = opt.init([frozen, empty])
    state = optim.AdamWState(step=0, mu=zeros() + extra.mu,
                             nu=zeros() + extra.nu)
    adamw_fused.reset_launch_counts()
    for step in range(1, STEPS + 1):
        grads = [_at(_randn(rng, s, 10.0 ** -(step % 4)).to(g_dtype), off)
                 for s, off in cases]
        before = [p.clone() for p in chain]
        optim._adamw_foreach(grads, chain, c_mu, c_nu,
                             **dict(HYPER, **_bias(step)))
        empty_grad = torch.zeros(0, dtype=g_dtype, device="cuda")
        state = opt.update(grads + [None, empty_grad], state,
                           fused + [frozen, empty])
        torch.cuda.synchronize()
        _check_step((chain, c_mu, c_nu),
                    (fused, state.mu[:len(cases)], state.nu[:len(cases)]),
                    before, f"step {step}")
    assert adamw_fused.ELEMENTS == {
        "fused": STEPS * sum(x.numel() for x in init), "foreach": 0}
    assert adamw_fused.LAUNCHES["adamw_multi_tensor_apply"] == STEPS
    assert torch.equal(_bits(frozen), _bits(frozen0))
    assert not state.mu[-2].any() and not state.nu[-2].any()
    assert state.step == STEPS


@pytest.mark.requires_cuda
@pytest.mark.parametrize("p_dtype,g_dtype", DTYPE_PAIRS, ids=PAIR_IDS)
def test_plain_version_on_the_card_equals_the_kernel_bitwise(
        p_dtype, g_dtype, cuda_device):
    rng = np.random.default_rng(5)
    init = [_randn(rng, s).to(p_dtype) for s in SHAPES]
    plain = [_at(x) for x in init]
    fused = [_at(x) for x in init]
    mom = {side: ([_at(torch.zeros(s)) for s in SHAPES],
                  [_at(torch.zeros(s)) for s in SHAPES]) for side in "ab"}
    for step in range(1, STEPS + 1):
        grads = [_at(_randn(rng, s, 10.0 ** -(step % 4)).to(g_dtype))
                 for s in SHAPES]
        kw = dict(HYPER, **_bias(step))
        for p, g, m, v in zip(plain, grads, *mom["a"]):
            adamw_fused.adamw_reference(p, g, m, v, **kw)
        groups, back, rest = adamw_fused.split(grads, fused, *mom["b"])
        assert back == [] and rest == ([], [], [], [])
        adamw_fused.launch(groups, back, **kw)
        torch.cuda.synchronize()
        for x, y in zip(plain + mom["a"][0] + mom["a"][1],
                        fused + mom["b"][0] + mom["b"][1]):
            assert torch.equal(_bits(x), _bits(y)), step


@pytest.mark.requires_cuda
def test_a_list_longer_than_one_launch(cuda_device):
    per_launch = _per_launch()
    rng = np.random.default_rng(4)
    shapes = [(1 + i % 41,) for i in range(per_launch + 7)]
    init = [_randn(rng, s) for s in shapes]
    chain = [_at(x) for x in init]
    fused = [_at(x) for x in init]
    opt = optim.adamw(**HYPER)
    state = opt.init(fused)
    c_mu, c_nu = opt.init(chain)[1:]
    adamw_fused.reset_launch_counts()
    for step in range(1, STEPS + 1):
        grads = [_at(_randn(rng, s)) for s in shapes]
        before = [p.clone() for p in chain]
        optim._adamw_foreach(grads, chain, c_mu, c_nu,
                             **dict(HYPER, **_bias(step)))
        state = opt.update(grads, state, fused)
        torch.cuda.synchronize()
        _check_step((chain, c_mu, c_nu), (fused, state.mu, state.nu),
                    before, f"step {step}")
    assert adamw_fused.LAUNCHES["adamw_multi_tensor_apply"] == 2 * STEPS
    assert adamw_fused.ELEMENTS == {
        "fused": STEPS * sum(x.numel() for x in init), "foreach": 0}


@pytest.mark.requires_cuda
def test_strided_views_go_through_contiguous_copies(cuda_device):
    rng = np.random.default_rng(6)
    # every other column of a wider buffer, and a transposed weight
    def views(x):
        wide = torch.zeros(x.shape[0], 2 * x.shape[1], device="cuda")
        wide[:, ::2] = x.cuda()
        return [wide[:, ::2], x.t().contiguous().cuda().t()]
    init = _randn(rng, (33, 17))
    chain = [_at(init), _at(init)]
    fused = views(init)
    assert not any(p.is_contiguous() for p in fused)
    opt = optim.adamw(**HYPER)
    state = opt.init(fused)
    c_mu, c_nu = opt.init(chain)[1:]
    adamw_fused.reset_launch_counts()
    for step in range(1, STEPS + 1):
        g = _randn(rng, (33, 17))
        grads = views(g)
        before = [p.clone() for p in chain]
        optim._adamw_foreach([_at(g), _at(g)], chain, c_mu, c_nu,
                             **dict(HYPER, **_bias(step)))
        state = opt.update(grads, state, fused)
        torch.cuda.synchronize()
        _check_step((chain, c_mu, c_nu), (fused, state.mu, state.nu),
                    before, f"step {step}")
    assert adamw_fused.ELEMENTS == {"fused": STEPS * 2 * init.numel(),
                                    "foreach": 0}


@pytest.mark.requires_cuda
def test_a_cuda_parameter_the_kernel_cannot_take_is_refused(cuda_device):
    p = [torch.ones(8, dtype=torch.float16, device="cuda")]
    opt = optim.adamw(**HYPER)
    with pytest.raises(ValueError, match="fused AdamW kernel takes"):
        opt.update([torch.ones_like(p[0])], opt.init(p), p)


@pytest.mark.requires_cuda
def test_dtensors_on_the_card_take_the_kernel(cuda_device):
    """ZeRO's layout on a one-rank NCCL mesh: the kernel updates the local
    shards (a partial gradient laid out as its parameter first), bit for
    bit as on plain tensors, and nothing goes to the chain."""
    out = _python("""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Shard,
                                              distribute_tensor)
        from distributed_pytorch_tpu_torch import optim
        from distributed_pytorch_tpu_torch.ops import adamw_fused
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        mesh = init_device_mesh("cuda", (1,))
        gen = torch.Generator(device="cuda").manual_seed(0)
        shapes = [(6, 4), (10,), (1600, 33)]
        plain = [torch.randn(s, device="cuda", generator=gen)
                 for s in shapes]
        dparams = [distribute_tensor(p.clone(), mesh, [Shard(0)])
                   for p in plain]
        opt = optim.adamw(1e-2)
        ps, ds = opt.init(plain), opt.init(dparams)
        adamw_fused.reset_launch_counts()
        for step in range(3):
            grads = [torch.randn(s, device="cuda", generator=gen)
                     for s in shapes]
            dgrads = [DTensor.from_local(grads[0].clone(), mesh,
                                         [Partial()])] + [
                distribute_tensor(g, mesh, [Shard(0)]) for g in grads[1:]]
            ps = opt.update(grads, ps, plain)
            ds = opt.update(dgrads, ds, dparams)
        torch.cuda.synchronize()
        for d, p in zip(dparams + ds.mu + ds.nu, plain + ps.mu + ps.nu):
            assert type(d) is DTensor
            assert torch.equal(d.to_local().view(torch.int32),
                               p.view(torch.int32))
        print(adamw_fused.LAUNCHES["adamw_multi_tensor_apply"],
              adamw_fused.ELEMENTS["fused"], adamw_fused.ELEMENTS["foreach"])
        dist.destroy_process_group()
    """)
    n = 6 * 4 + 10 + 1600 * 33
    assert out.split() == ["6", str(2 * 3 * n), "0"]


@pytest.mark.requires_cuda
def test_the_kernels_profiler_name(cuda_device):
    from torch.profiler import ProfilerActivity, profile
    params = [_at(torch.ones(1000)), _at(torch.ones(3, 5))]
    opt = optim.adamw(**HYPER)
    state = opt.init(params)
    grads = [torch.ones_like(p) for p in params]
    opt.update(grads, state, params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.update(grads, state, params)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "adamw" in e.name.lower()
             and e.device_type == torch.autograd.DeviceType.CUDA]
    assert names, [e.name for e in prof.events()][:50]
    for name in names:
        assert "multi_tensor_apply" in name.lower(), name
        assert not any(k in name.lower() for k in OTHER_CLASSES), name
