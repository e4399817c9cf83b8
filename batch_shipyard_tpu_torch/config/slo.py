"""Serving SLO configuration: named request classes with TTFT/TPOT
targets, the engine's shed grace and its prefill-stall factor.

The port's own copy of the serving-SLO part of
batch_shipyard_tpu/config/settings.py (``SloClassSettings``,
``ServingSloSettings``, ``DEFAULT_SLO_CLASSES``,
``serving_slo_settings``): the same dataclasses, defaults and parsing
of a config mapping's ``serving.slo`` section, so that one config file
means the same thing to both packages. stdlib only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


def _get(conf: Optional[dict], *path: str, default: Any = None) -> Any:
    """``conf[path[0]][path[1]]...``, or ``default`` where a key is
    missing or the value is None."""
    node: Any = conf
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return default
        node = node[key]
    if node is None:
        return default
    return node


@dataclasses.dataclass(frozen=True)
class SloClassSettings:
    """One serving SLO class: per-request latency targets attached at
    admission (models/serving.Request). None disables that target."""
    name: str
    ttft_ms: Optional[float]
    tpot_ms: Optional[float]


@dataclasses.dataclass(frozen=True)
class ServingSloSettings:
    """Request-level SLO scheduling for the serving front end: named
    classes map to TTFT/TPOT targets, shed_grace_ms arms overload
    shedding in the engine, and tpot_stall_factor bounds admission's
    prefill-stall tolerance (models/serving.ContinuousBatcher)."""
    classes: tuple[SloClassSettings, ...]
    shed_grace_ms: Optional[float]
    tpot_stall_factor: float

    def class_targets(self) -> dict:
        """name -> {"ttft_ms": ..., "tpot_ms": ...}, the front end's
        slo_classes."""
        return {c.name: {"ttft_ms": c.ttft_ms, "tpot_ms": c.tpot_ms}
                for c in self.classes}


# Interactive chat, standard API traffic, and untargeted batch work.
DEFAULT_SLO_CLASSES = (
    SloClassSettings("interactive", ttft_ms=500.0, tpot_ms=100.0),
    SloClassSettings("standard", ttft_ms=2000.0, tpot_ms=250.0),
    SloClassSettings("batch", ttft_ms=None, tpot_ms=None),
)


def serving_slo_settings(config: Optional[dict]) -> ServingSloSettings:
    """Parse ``serving.slo`` from a config mapping; an absent section
    gives the default classes with shedding disarmed."""
    spec = _get(config, "serving", "slo", default={}) or {}
    entries = _get(spec, "classes")
    if entries is None:
        classes = DEFAULT_SLO_CLASSES
    else:
        classes = tuple(
            SloClassSettings(name=_get(entry, "name"),
                             ttft_ms=_get(entry, "ttft_ms"),
                             tpot_ms=_get(entry, "tpot_ms"))
            for entry in entries)
    return ServingSloSettings(
        classes=classes,
        shed_grace_ms=_get(spec, "shed_grace_ms"),
        tpot_stall_factor=_get(spec, "tpot_stall_factor", default=4.0))
