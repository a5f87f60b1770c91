"""The yardstick against hand counts, and the window rate against a
stall inside the window."""

import itertools
import time

import pytest
import torch

from portbench import yardstick
from portbench.drivers import train


def test_model_flops_per_token_gpt2_xl_by_hand():
    # per layer 24 d^2 = 61,440,000; causal attention 4*S*d/2 = 3,276,800;
    # 48 layers; the vocabulary projection 2*1600*50257 = 160,822,400
    assert yardstick.model_flops_per_token(1600, 48, 50257, 1024) == \
        48 * (61_440_000 + 3_276_800) + 160_822_400 == 3_267_228_800


def test_forward_flops_at_a_context_by_hand():
    # 12 layers of 24*768^2 + 4*c*768 at c = 100, plus 2*768*50257
    assert yardstick.forward_flops_at(768, 12, 50257, 100) == \
        12 * (14_155_776 + 307_200) + 77_194_752


def test_visible_pairs_by_hand():
    assert yardstick.visible_pairs(4, 4) == 1 + 2 + 3 + 4
    assert yardstick.visible_pairs(2, 5) == 4 + 5
    assert yardstick.visible_pairs(3, 3, causal=False) == 9


def test_flash_costs_by_hand():
    # b=2, h=3, hkv=3, s=4 causal, d=8, bf16: 10 pairs per head
    flops, nbytes = yardstick.flash_cost(2, 3, 3, 4, 4, 8, 2)
    assert flops == 4 * 8 * 10 * 6
    # q read, O written (2 * 2*8*6*4) + k, v read (2 * 2*8*6*4) + lse
    assert nbytes == 2 * 8 * (6 * 4 * 2 + 6 * 4 * 2) + 4 * 6 * 4
    bwd = yardstick.flash_bwd_cost(2, 3, 3, 4, 4, 8, 2)
    q = 2 * 8 * 6 * 4
    assert bwd["dkv"] == (8 * 8 * 60, 2 * q + 2 * q + 2 * 96 + 2 * q)
    assert bwd["dq"] == (6 * 8 * 60, 2 * q + 2 * q + 2 * 96 + q)


def test_h100_peaks_and_bound():
    assert yardstick.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(ValueError):
        yardstick.peaks("cpu")
    # 989 GFLOP and no bytes: one millisecond at the bf16 peak
    assert yardstick.bound_s(989e9, 0, "H100") == pytest.approx(1e-3)
    assert yardstick.bound_s(0, 3.35e9, "H100") == pytest.approx(1e-3)


@pytest.mark.parametrize("name,cls", [
    ("void flash_fwd_kernel_sm90<__nv_bfloat16, 64>(Params)", "flash_fwd"),
    ("flash_bwd_dkv_kernel_sm90<__nv_bfloat16>", "flash_bwd_dkv"),
    ("flash_bwd_dq_kernel_sm90<__nv_bfloat16>", "flash_bwd_dq"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
     "<at::native::TensorListMetadata<3>>", "optimizer"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)", "nccl"),
    ("void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernel>",
     "other"),
    ("Memcpy HtoD (Pageable -> Device)", "other"),
])
def test_kernel_classes(name, cls):
    assert yardstick.classify(name) == cls


def test_percentile_is_nearest_rank_over_all_samples():
    assert yardstick.percentile(range(1, 21), 95) == 19
    assert yardstick.percentile(range(1, 101), 95) == 95
    assert yardstick.percentile([5.0], 95) == 5.0
    assert yardstick.percentile([], 95) is None
    # one late request in twenty moves the p95 off the rest
    assert yardstick.percentile([1.0] * 19 + [float("inf")], 95) == 1.0
    assert yardstick.percentile([1.0] * 18 + [9.0, 9.0], 95) == 9.0


def test_quartile_spread_by_hand():
    # statistics.quantiles([1..8], n=4) (exclusive) = 2.25, 4.5, 6.75
    assert yardstick.quartile_spread(range(1, 9)) == pytest.approx(4.5 / 4.5)


def test_union_and_gaps():
    ivs = [(0, 2), (1, 3), (5, 6), (8, 12)]
    assert yardstick.union_seconds(ivs, 0, 10) == 3 + 1 + 2
    assert yardstick.idle_gaps(ivs, 0, 10) == [(3, 5), (6, 8)]
    assert yardstick.idle_gaps([], 0, 1) == [(0, 1)]


class _FakeTrainer:
    """A train object whose step takes ``step_s`` of host time, and
    ``stall_s`` more once, at step ``stall_at``."""

    def __init__(self, step_s, stall_at=None, stall_s=0.0):
        self.model = self.state = None
        self.world, self.device = 1, torch.device("cpu")
        self.feed = itertools.repeat((torch.zeros(1), torch.zeros(1)))
        self.n, self.step_s = 0, step_s
        self.stall_at, self.stall_s = stall_at, stall_s

    def step(self, model, state, batch):
        self.n += 1
        time.sleep(self.step_s + (self.stall_s if self.n == self.stall_at
                                  else 0.0))
        return type("Out", (), {"opt_state": None,
                                "loss": torch.ones(1)})()


def _rate(tr):
    run = type("R", (), {"trace": False, "seconds": 0.6,
                         "mix": {"trace_steps": 0}})()
    w = train.window(tr, run)
    return w["steps"] / (w["t1"] - w["t0"]), w


def test_a_stall_inside_the_window_lowers_the_rate():
    steady, _ = _rate(_FakeTrainer(0.01))
    stalled, w = _rate(_FakeTrainer(0.01, stall_at=5, stall_s=0.3))
    # the stall is in the window's time and in no step's count: the rate
    # falls by about the stalled share of the window, where a median of
    # per-step times would not move
    assert w["steps"] > 5
    assert stalled < 0.75 * steady
