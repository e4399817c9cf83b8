"""Fixed log-bucket latency histograms, mergeable across replicas.

The port's own copy of batch_shipyard_tpu/trace/histogram.py (same
edges and wire shape, so the two packages' reports merge). Percentiles
of percentiles are meaningless; a histogram over a
FIXED geometric bucket ladder fixes that: every replica bins into the
same edges, so fleet-wide percentiles are computed after a lossless
counter merge, memory is O(buckets) regardless of traffic, and the
cumulative counts are exactly what Prometheus ``_bucket{le=...}``
export wants.

The ladder covers 0.25 ms .. ~35 min (0.25 * 2^23 ms) at 2x steps
(24 buckets + one overflow) — sub-bucket resolution is bounded at
2x, which is plenty
for p50/p90/p99 on serving latencies while keeping the wire/export
size trivial. Percentiles interpolate linearly inside the winning
bucket (lower edge for the overflow bucket), so p50 <= p90 <= p99
monotonicity holds by construction.
"""

from __future__ import annotations

from typing import Iterable, Optional

# Upper bucket edges in milliseconds: 0.25 * 2^k for k in [0, 24).
BUCKET_EDGES_MS: tuple[float, ...] = tuple(
    0.25 * (2.0 ** k) for k in range(24))


class LatencyHistogram:
    """Counts per fixed log bucket + exact sum/count/min/max."""

    __slots__ = ("counts", "overflow", "count", "total", "min", "max")

    def __init__(self) -> None:
        self.counts = [0] * len(BUCKET_EDGES_MS)
        self.overflow = 0
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value_ms: float) -> None:
        value_ms = max(0.0, float(value_ms))
        self.count += 1
        self.total += value_ms
        self.min = value_ms if self.min is None else min(self.min,
                                                         value_ms)
        self.max = value_ms if self.max is None else max(self.max,
                                                         value_ms)
        for k, edge in enumerate(BUCKET_EDGES_MS):
            if value_ms <= edge:
                self.counts[k] += 1
                return
        self.overflow += 1

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """In-place lossless merge (same fixed edges by construction);
        returns self for chaining."""
        self.counts = [a + b for a, b in zip(self.counts,
                                             other.counts)]
        self.overflow += other.overflow
        self.count += other.count
        self.total += other.total
        for bound, pick in (("min", min), ("max", max)):
            mine, theirs = getattr(self, bound), getattr(other, bound)
            if theirs is not None:
                setattr(self, bound,
                        theirs if mine is None else pick(mine, theirs))
        return self

    @classmethod
    def merged(cls, histograms: Iterable["LatencyHistogram"]
               ) -> "LatencyHistogram":
        out = cls()
        for histogram in histograms:
            out.merge(histogram)
        return out

    @classmethod
    def of(cls, values_ms: Iterable[float]) -> "LatencyHistogram":
        out = cls()
        for value in values_ms:
            out.observe(value)
        return out

    def percentile(self, pct: float) -> float:
        """Nearest-rank percentile with linear interpolation inside
        the winning bucket, clamped to the observed min/max so tiny
        samples don't report a bucket edge nobody hit. 0.0 when
        empty."""
        if not self.count:
            return 0.0
        import math
        rank = max(1, min(self.count,
                          math.ceil(pct / 100.0 * self.count)))
        seen = 0
        for k, edge in enumerate(BUCKET_EDGES_MS):
            if not self.counts[k]:
                continue
            if seen + self.counts[k] >= rank:
                lower = BUCKET_EDGES_MS[k - 1] if k else 0.0
                frac = (rank - seen) / self.counts[k]
                value = lower + (edge - lower) * frac
                break
            seen += self.counts[k]
        else:
            # Overflow bucket: its lower edge is the honest floor.
            value = BUCKET_EDGES_MS[-1]
        if self.min is not None:
            value = max(value, self.min)
        if self.max is not None:
            value = min(value, self.max)
        return value

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentiles(self, pcts: tuple = (50, 90, 99)) -> dict:
        return {f"p{p}": self.percentile(p) for p in pcts}

    # ------------------------------ wire -------------------------------

    def to_dict(self) -> dict:
        """JSON-safe transport shape (server /v1/stats -> router
        merge)."""
        return {"edges_ms": list(BUCKET_EDGES_MS),
                "counts": list(self.counts),
                "overflow": self.overflow,
                "count": self.count, "total_ms": self.total,
                "min_ms": self.min, "max_ms": self.max}

    @classmethod
    def from_dict(cls, data: Optional[dict]
                  ) -> Optional["LatencyHistogram"]:
        """Parse the wire shape; None (not a crash) on junk or a
        foreign bucket ladder — a replica running older code must not
        poison the fleet merge."""
        if not isinstance(data, dict):
            return None
        counts = data.get("counts")
        edges = data.get("edges_ms")
        if not isinstance(counts, list) or \
                len(counts) != len(BUCKET_EDGES_MS) or \
                list(edges or ()) != list(BUCKET_EDGES_MS):
            return None
        out = cls()
        try:
            out.counts = [max(0, int(c)) for c in counts]
            out.overflow = max(0, int(data.get("overflow", 0)))
            out.count = max(0, int(data.get("count", 0)))
            out.total = max(0.0, float(data.get("total_ms", 0.0)))
            out.min = (None if data.get("min_ms") is None
                       else float(data["min_ms"]))
            out.max = (None if data.get("max_ms") is None
                       else float(data["max_ms"]))
        except (TypeError, ValueError):
            return None
        return out

    # --------------------------- prometheus ----------------------------

    def prometheus_bucket_lines(self, name: str,
                                labels: Optional[dict] = None
                                ) -> list[str]:
        """Cumulative ``{name}_bucket{{le=...}}`` lines plus
        ``{name}_sum`` / ``{name}_count`` — the native Prometheus
        histogram exposition, so ``histogram_quantile()`` works on
        the scrape."""
        base = dict(labels or {})
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(base.items()))
        prefix = inner + "," if inner else ""
        lines = []
        cumulative = 0
        for edge, count in zip(BUCKET_EDGES_MS, self.counts):
            cumulative += count
            lines.append(f'{name}_bucket{{{prefix}le="{edge:g}"}} '
                         f"{cumulative}")
        lines.append(f'{name}_bucket{{{prefix}le="+Inf"}} '
                     f"{self.count}")
        suffix = "{" + inner + "}" if inner else ""
        lines.append(f"{name}_sum{suffix} {self.total:.6f}")
        lines.append(f"{name}_count{suffix} {self.count}")
        return lines
