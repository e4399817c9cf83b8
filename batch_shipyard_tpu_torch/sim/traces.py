"""Arrival curves shared with the fleet simulator.

The port's own copy of ``diurnal_arrivals`` from
batch_shipyard_tpu/sim/traces.py: the same construction, so the same
(seed, arguments) give the same floats. models/loadgen.py replays it
for ``arrival="diurnal"``. stdlib only.
"""

from __future__ import annotations

import math
import random


def diurnal_arrivals(seed: int, num: int, day_seconds: float,
                     peak_rate: float, trough_rate: float,
                     ) -> list[float]:
    """Arrival times of an inhomogeneous Poisson process whose rate
    swings sinusoidally between trough and peak over a virtual day of
    ``day_seconds`` (thinning against the peak envelope); deterministic
    per (seed, arguments)."""
    rng = random.Random(seed)
    arrivals: list[float] = []
    t = 0.0
    while len(arrivals) < num:
        t += rng.expovariate(peak_rate)
        phase = math.sin(2.0 * math.pi * t / day_seconds)
        rate = trough_rate + (peak_rate - trough_rate) * \
            (0.5 + 0.5 * phase)
        if rng.random() * peak_rate > rate:
            continue
        arrivals.append(t)
    return arrivals
