"""The port's trace utilities on the CPU: its own copy of the latency
histogram against the reference's (same edges, percentiles, wire shape
and Prometheus lines on the same samples), the interval union the
decode profile uses for device busy time, and the card-only measuring
scripts refusing a machine without a card."""

import numpy as np
import pytest

from batch_shipyard_tpu.trace import histogram as jhist
from batch_shipyard_tpu_torch.trace import decode_sweep, serve_compare
from batch_shipyard_tpu_torch.trace import histogram as thist
from batch_shipyard_tpu_torch.trace.decode_profile import busy_us


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


@pytest.mark.parametrize("script, argv", [(decode_sweep, []),
                                          (serve_compare, ["."])])
def test_card_only_scripts_refuse_without_cuda(monkeypatch, capsys,
                                               script, argv):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert script.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
