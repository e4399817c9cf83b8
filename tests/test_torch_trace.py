"""The port's trace utilities on the CPU: its own copy of the latency
histogram against the reference's (same edges, percentiles, wire shape
and Prometheus lines on the same samples), the interval union the
decode profile uses for device busy time, the card-only measuring
scripts refusing a machine without a card, and the int8 matmul sweep's
shapes and bound (the int8 training path's projections)."""

import numpy as np
import pytest

from batch_shipyard_tpu.trace import histogram as jhist
from batch_shipyard_tpu_torch.trace import (decode_sweep, int8_matmul_sweep,
                                            profiler_window, serve_compare)
from batch_shipyard_tpu_torch.trace import histogram as thist
from batch_shipyard_tpu_torch.trace.decode_profile import (
    PROFILER_WARMUP_STEPS, WINDOW, busy_us, window_kernels)


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_matches_reference(seed):
    samples = list(np.random.RandomState(seed).lognormal(3.0, 1.5, 500))
    mine = thist.LatencyHistogram.of(samples)
    want = jhist.LatencyHistogram.of(samples)
    assert mine.to_dict() == want.to_dict()
    assert mine.percentiles((50, 90, 99)) == want.percentiles((50, 90, 99))
    assert mine.prometheus_bucket_lines("x") == \
        want.prometheus_bucket_lines("x")
    # Reports of the two packages merge: the wire shape round-trips.
    back = thist.LatencyHistogram.from_dict(want.to_dict())
    assert back.merge(mine).to_dict() == \
        jhist.LatencyHistogram.merged([want, want]).to_dict()


def test_busy_us_is_the_union_of_intervals():
    assert busy_us([]) == 0.0
    assert busy_us([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0),
                    (5.5, 5.7)]) == pytest.approx(4.0)
    assert busy_us([(4.0, 5.0), (0.0, 1.0)]) == pytest.approx(2.0)


def test_window_kernels_leave_out_the_profilers_warmup():
    """The profile readings count the device kernels that start inside
    the host's window range, not the warm-up steps' kernels before it
    nor the range's own device annotation."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(name, device, start):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=start + 1))

    events = [event("warmup_kernel", DeviceType.CUDA, 1.0),
              event(WINDOW, DeviceType.CPU, 10.0),
              event(WINDOW, DeviceType.CUDA, 10.5),
              event("aten::mm", DeviceType.CPU, 11.0),
              event("kernel_a", DeviceType.CUDA, 12.0),
              event("kernel_b", DeviceType.CUDA, 10.0)]
    assert [e.name for e in window_kernels(events)] == ["kernel_a",
                                                       "kernel_b"]
    assert PROFILER_WARMUP_STEPS >= 1


@pytest.mark.parametrize("script, argv", [
    (decode_sweep, []), (decode_sweep, ["--dense-variant", "2x128"]),
    (int8_matmul_sweep, []), (profiler_window, []), (serve_compare, ["."]),
    (serve_compare, ["--phase", "train_int8", "."])])
def test_card_only_scripts_refuse_without_cuda(monkeypatch, capsys,
                                               script, argv):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert script.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_int8_matmul_sweep_shapes_are_a_layers_projections():
    """One layer's seven QuantDense projections of bench_transformer at
    its 32768 rows, and the least time of the qkvo shape: the fp32
    output's bytes at 3.35 TB/s (0.0504 ms), above its int8 operations
    at 1979 TOP/s (0.0347 ms)."""
    shapes = int8_matmul_sweep.SHAPES
    assert sum(count for _, count in shapes.values()) == 7
    assert int8_matmul_sweep.ROWS == 32768
    assert shapes["qkvo"] == ((1024, 1024), 4)
    assert shapes["down"] == ((2816, 1024), 1)
    assert int8_matmul_sweep.bound_ms(1024, 1024) == pytest.approx(
        0.050434598, rel=1e-6)


class _Range:
    def __init__(self, start):
        self.start, self.end = start, start + 1.0


class _Event:
    def __init__(self, name, start):
        self.name, self.time_range = name, _Range(start)


def test_train_profile_op_times_are_the_windows_ops():
    """op_us sums each host op's self device time inside the window, and
    leaves out the window itself, the events before it and the runtime's
    markers."""
    from torch.autograd import DeviceType

    from batch_shipyard_tpu_torch.trace import train_profile

    def event(name, start, us, device=DeviceType.CPU):
        e = _Event(name, start)
        e.device_type, e.self_device_time_total = device, us
        return e
    events = [event("aten::bmm", 0.0, 5.0),
              event(train_profile.WINDOW, 1.0, 0.0),
              event("aten::bmm", 2.0, 3.0), event("aten::bmm", 3.0, 4.0),
              event("aten::mm", 4.0, 2.0), event("aten::cat", 5.0, 0.0),
              event("Command Buffer Full", 6.0, 99.0),
              event("kernel", 7.0, 0.0, DeviceType.CUDA)]
    assert train_profile.op_us(events) == {"aten::bmm": 7.0, "aten::mm": 2.0}
    assert train_profile.op_us(events[:1]) == {}


@pytest.mark.parametrize("short_windows", [0, 1, 2, 3])
def test_train_profile_retakes_a_window_short_of_ring_kernels(
        monkeypatch, short_windows):
    """profile_steps retakes a window whose ring kernels fall short of
    the wrappers' launches (the profiler dropped some), up to
    PROFILE_ATTEMPTS windows; past them ring_us_by_axis refuses it."""
    import contextlib

    import torch

    from batch_shipyard_tpu_torch.ops import ring_collectives
    from batch_shipyard_tpu_torch.trace import train_profile
    symbol = train_profile.KERNEL_SYMBOLS["ring_permute"][0]
    windows = []

    class Group:
        axis = "sp"

        def wait_ns(self):
            return 0

    class Mesh:
        def distinct_groups(self):
            return [Group()]

        def check(self):
            pass

    class Harness:
        mesh = Mesh()

        def step(self, batch):
            if ring_collectives.copy_log is not None:
                ring_collectives.copy_log += [("ring_permute", "sp")] * 2

    def kernels(events):
        windows.append(None)
        n = 3 if len(windows) <= short_windows else 4
        return [_Event(f"{symbol}<float>", float(i)) for i in range(n)]
    monkeypatch.setattr(train_profile, "profile",
                        lambda **kw: contextlib.nullcontext(
                            type("P", (), {"events": lambda self: []})()))
    monkeypatch.setattr(train_profile, "record_function",
                        lambda name: contextlib.nullcontext())
    monkeypatch.setattr(train_profile, "window_kernels", kernels)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    if short_windows >= train_profile.PROFILE_ATTEMPTS:
        with pytest.raises(RuntimeError, match="profiler saw 3 ring"):
            train_profile.profile_steps(Harness(), {}, 2)
    else:
        out = train_profile.profile_steps(Harness(), {}, 2)
        assert out["ring_kernel_calls_per_step"]["ring_permute"] == 2
        assert out["ring_ms_per_step_by_axis"] == {"sp": 4 / 1e3 / 2}
    assert len(windows) == min(short_windows + 1,
                               train_profile.PROFILE_ATTEMPTS)
