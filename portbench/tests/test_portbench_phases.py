"""The program's phase ranges on synthetic traces: ``portbench.phases``,
the readers that read it, and the trace reduction left as it was.

Times are microseconds, as the profiler gives them. Each trace is one
traced step: the benchmark's ``portbench.step`` around the program's
``dpx.dp_step`` > ``dpx.forward`` / ``dpx.backward`` / ``dpx.update``.
"""

import pytest

from portbench import harness, phases
from portbench.trace import Summary

CTX = {"kind": "train", "traced_steps": 1}
READERS = {"forward_ms_per_step.train": "forward",
           "backward_ms_per_step.train": "backward",
           "update_ms_per_step.train": "update"}

# host ops and device ops of one step without the program's ranges
HOST = [("portbench.loader", 0.0, 10.0),
        ("cudaMemcpyAsync", 2.0, 3.0),
        ("portbench.step", 10.0, 200.0),
        ("aten::mm", 20.0, 30.0), ("cudaLaunchKernel", 22.0, 24.0),
        ("autograd::engine::evaluate_function: MmBackward0", 60.0, 70.0),
        ("cudaLaunchKernel", 62.0, 64.0),
        ("aten::_foreach_add_", 150.0, 160.0),
        ("cudaLaunchKernel", 152.0, 154.0)]
DEVICE = [("Memcpy HtoD (Pageable -> Device)", 4.0, 6.0),
          ("sm90_xmma_gemm_bf16bf16_bf16f32", 30.0, 50.0),
          ("sm90_xmma_gemm_bf16bf16_bf16f32", 70.0, 110.0),
          ("void at::native::multi_tensor_apply_kernel<>", 160.0, 170.0)]
RANGES = [("dpx.dp_step", 11.0, 199.0), ("dpx.forward", 12.0, 40.0),
          ("dpx.backward", 40.0, 120.0), ("dpx.update", 120.0, 198.0)]


def _summary(ranges=(), device=DEVICE):
    return Summary(list(device), HOST + list(ranges), 0.0, 200.0)


def test_device_time_goes_to_the_range_open_at_its_launch():
    by_phase = phases.device_by_phase(_summary(RANGES))
    # the GEMM launched at 22 ran at 30-50 (forward), the one launched
    # from autograd's op at 62 while dpx.backward was open ran at 70-110,
    # the multi-tensor kernel launched at 152 inside dpx.update
    assert by_phase == pytest.approx({"dp_step": 70e-6, "forward": 20e-6,
                                      "backward": 40e-6, "update": 10e-6})


def test_a_launch_count_that_disagrees_refuses_the_match():
    extra = DEVICE + [("Memset (Device)", 180.0, 181.0)]
    assert phases.device_by_phase(_summary(RANGES, extra)) is None


def _long_step(per_phase, dropped=()):
    """One step of ``per_phase`` 1 us launches in each of forward,
    backward and update, each device op 1 us after its launch; the
    device ops at the indices in ``dropped`` missing from the trace."""
    host, device, t = [], [], 0.0
    ranges = []
    for phase in ("forward", "backward", "update"):
        t0 = t
        for _ in range(per_phase):
            host.append(("cudaLaunchKernel", t, t + 0.5))
            device.append(("sm90_xmma_gemm_bf16bf16_bf16f32",
                           t + 1.0, t + 2.0))
            t += 2.0
        ranges.append((f"dpx.{phase}", t0, t - 1.0))
    device = [d for i, d in enumerate(device) if i not in set(dropped)]
    return Summary(device, host + ranges, 0.0, t + 2.0)


def test_a_dropped_device_record_moves_one_op_at_each_phase_end():
    # the profiler lost forward's 10th op: from there each op is matched
    # to the launch before its own, so forward and backward each take
    # their successor's first op and update is one short
    by_phase = phases.device_by_phase(_long_step(1000, dropped=[9]))
    assert by_phase == pytest.approx({"forward": 1000e-6,
                                      "backward": 1000e-6,
                                      "update": 999e-6})


def test_more_dropped_records_than_the_share_refuse_the_match():
    allowed = int(phases.DROPPED_SHARE * 3000)
    assert phases.device_by_phase(
        _long_step(1000, dropped=range(allowed))) is not None
    assert phases.device_by_phase(
        _long_step(1000, dropped=range(allowed + 1))) is None


def test_idle_goes_to_the_range_open_at_the_gaps_midpoint():
    idle = phases.idle_by_phase(_summary(RANGES))
    # gaps 0-4, 6-30, 50-70, 110-160, 170-200; midpoints 2 (before the
    # step), 18 (forward), 60 (backward), 135 (update), 185 (update)
    assert idle == pytest.approx({"dp_step": (24 + 20 + 50 + 30) * 1e-6,
                                  "forward": 24e-6, "backward": 20e-6,
                                  "update": 80e-6})


def test_an_idle_gap_is_named_with_the_program_range():
    names = dict(_summary(RANGES).breakdown()["idle_gaps"])
    # the gap at 110-160 has no host op open at its midpoint but the
    # program's range, where the benchmark's span alone named it before
    assert names["portbench.step > dpx.update"] == pytest.approx(80e-6)
    assert "portbench.step > no host op" not in names
    plain = dict(_summary().breakdown()["idle_gaps"])
    assert plain["portbench.step > no host op"] == pytest.approx(104e-6)


def test_the_reduction_without_program_ranges_is_unchanged():
    """A fixed golden of every field ``Summary`` and ``breakdown()``
    report, on a trace without ``dpx.`` ranges."""
    s = _summary()
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(72e-6)
    assert s.by_class == pytest.approx({"other": 2e-6, "gemm": 60e-6,
                                        "optimizer": 10e-6})
    assert s.launches == {"other": 1, "gemm": 2, "optimizer": 1}
    assert s.by_name == pytest.approx({
        "Memcpy HtoD (Pageable -> Device)": 2e-6,
        "sm90_xmma_gemm_bf16bf16_bf16f32": 60e-6,
        "void at::native::multi_tensor_apply_kernel<>": 10e-6})
    assert s.idle_by_host == pytest.approx({
        "portbench.loader > cudaMemcpyAsync": 4e-6,
        "portbench.step > no host op": 24e-6 + 50e-6 + 30e-6,
        "portbench.step > autograd::engine::evaluate_function: "
        "MmBackward0": 20e-6})
    assert s.breakdown() == {
        "device_ops": [[n, v] for n, v in sorted(
            s.by_name.items(), key=lambda kv: -kv[1])],
        "idle_gaps": [[n, v] for n, v in sorted(
            s.idle_by_host.items(), key=lambda kv: -kv[1])]}


def test_program_ranges_move_no_existing_metric():
    plain, ranged = _summary(), _summary(RANGES)
    for field in ("window_s", "busy_s", "by_class", "launches", "by_name"):
        assert getattr(ranged, field) == getattr(plain, field)
    assert sum(ranged.idle_by_host.values()) == \
        pytest.approx(sum(plain.idle_by_host.values()))


@pytest.mark.parametrize("metric", sorted(READERS) +
                         ["step_idle_ms_per_step.train"])
def test_each_reader_is_silent_without_program_ranges(metric):
    read = harness.reader(metric)
    assert read(CTX, _summary()) is None
    assert read(CTX, None) is None
    # a data-parallel rank's reduced record keeps no host list
    assert read(CTX, Summary.from_record(_summary(RANGES).to_record())) \
        is None


@pytest.mark.parametrize("metric, phase", sorted(READERS.items()))
def test_each_phase_reader_reads_its_phase(metric, phase):
    ms = harness.reader(metric)(dict(CTX, traced_steps=2),
                                _summary(RANGES))
    want = {"forward": 20e-3, "backward": 40e-3, "update": 10e-3}[phase]
    assert ms == pytest.approx(want / 2)


def test_the_step_idle_reader():
    ms = harness.reader("step_idle_ms_per_step.train")(CTX, _summary(RANGES))
    assert ms == pytest.approx(124e-3)
