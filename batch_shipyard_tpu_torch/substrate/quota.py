"""GPU quota / capacity preflight (the `account quota` surface).

The port's counterpart of batch_shipyard_tpu/substrate/quota.py, with
its surface (``quota_report``, ``preflight_pool``, ``stockout_advisory``,
``_zone_region`` and a client with an injectable runner) asking what an
H100 pool needs instead of what a TPU slice does. Compute Engine splits
the answer across two gcloud surfaces:

  - ``gcloud compute accelerator-types list --filter=zone:Z``: the GPU
    types the zone OFFERS (``nvidia-h100-80gb`` for a3-highgpu,
    ``nvidia-h100-mega-80gb`` for a3-megagpu);
  - ``gcloud compute regions describe R``: the region's quotas, GPUs
    among them (``NVIDIA_H100_GPUS``, ``PREEMPTIBLE_NVIDIA_H100_GPUS``,
    ``NVIDIA_H100_MEGA_GPUS``, ...), each with its limit and usage.

A pool asks ``gpus_per_node`` × ``vm_count.dedicated`` GPUs of the
on-demand metric and ``gpus_per_node`` × ``vm_count.low_priority`` of
the preemptible one. Everything here is advisory: the preflight never
raises, warns on what it can prove and stays silent on what it cannot —
a wrong "you will be blocked" is worse than none. The reactive half
(classifying the actual allocation failure) lives in
substrate/gcloud_errors.py; pool add calls preflight_pool first so the
operator hears about a doomed request before the substrate spends
minutes discovering it.
"""

from __future__ import annotations

import json
from typing import Optional

from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

# A3 family -> (GCE accelerator type, on-demand GPU quota metric,
# preemptible GPU quota metric), from Compute Engine's public
# documentation of the A3 machine series and its GPU quotas.
_A3_GPUS: dict[str, tuple[str, str, str]] = {
    "a3-highgpu": ("nvidia-h100-80gb", "NVIDIA_H100_GPUS",
                   "PREEMPTIBLE_NVIDIA_H100_GPUS"),
    "a3-megagpu": ("nvidia-h100-mega-80gb", "NVIDIA_H100_MEGA_GPUS",
                   "PREEMPTIBLE_NVIDIA_H100_MEGA_GPUS"),
}


def gpu_type(vm_size: Optional[str]) -> Optional[tuple[str, str, str]]:
    """(accelerator type, quota metric, preemptible quota metric) of an
    A3 machine type, e.g. a3-highgpu-8g; None for any other size."""
    family = (vm_size or "").strip().lower().rsplit("-", 1)[0]
    return _A3_GPUS.get(family)


class GpuQuotaClient:
    """Thin gcloud wrapper; ``runner`` injects a fake
    (argv -> (rc, out, err)) for tests."""

    def __init__(self, project: str, runner=None) -> None:
        self.project = project
        self._runner = runner or util.subprocess_capture

    def _run(self, argv: list[str]):
        rc, out, err = self._runner(argv)
        if rc != 0:
            raise RuntimeError(
                f"{' '.join(argv[:4])}... failed ({rc}): "
                f"{str(err).strip()}")
        return out

    def accelerator_types(self, zone: str) -> list[str]:
        """GPU types offered in a zone (e.g. nvidia-h100-80gb)."""
        out = self._run([
            "gcloud", "compute", "accelerator-types", "list",
            f"--filter=zone:{zone}", f"--project={self.project}",
            "--format=json"])
        rows = json.loads(out) if out.strip() else []
        types = []
        for row in rows:
            # The filter matches the zone's URL by substring, so
            # us-central1-a would also take us-central1-ab; keep rows
            # whose zone is exactly this one.
            if row.get("zone") and \
                    str(row["zone"]).rsplit("/", 1)[-1] != zone:
                continue
            t = row.get("name", "").rsplit("/", 1)[-1]
            if t:
                types.append(t)
        return sorted(set(types))

    def quota_limits(self, region: Optional[str] = None) -> list[dict]:
        """The region's GPU quotas as {metric, unit, region, limit,
        usage} rows (limit -1 = unlimited). Unknown layouts yield []
        rather than raising."""
        if not region:
            return []
        out = self._run([
            "gcloud", "compute", "regions", "describe", region,
            f"--project={self.project}", "--format=json"])
        desc = json.loads(out) if out.strip() else {}
        limits = []
        for quota in desc.get("quotas", []) or []:
            metric = str(quota.get("metric", ""))
            if "GPU" not in metric.upper():
                continue
            try:
                limit = int(float(quota.get("limit", -1)))
                usage = int(float(quota.get("usage", 0)))
            except (TypeError, ValueError):
                continue
            limits.append({"metric": metric, "unit": "GPUs",
                           "region": desc.get("name") or region,
                           "limit": limit, "usage": usage})
        return limits

    def zones_with_accelerator(self, accelerator_type: str,
                               zones: list[str]) -> list[str]:
        """Which of the candidate zones offer the type — the
        'try zone X' advisory attached to stockout errors."""
        offering = []
        for zone in zones:
            try:
                if accelerator_type in self.accelerator_types(zone):
                    offering.append(zone)
            except RuntimeError:
                continue
        return offering


def _zone_region(zone: str) -> str:
    """us-central1-a -> us-central1."""
    return zone.rsplit("-", 1)[0] if zone.count("-") >= 2 else zone


def quota_report(client: GpuQuotaClient, zone: str) -> dict:
    """The `account quota` verb's payload: the GPU types the zone offers
    and the region's GPU quotas."""
    report: dict = {"project": client.project, "zone": zone}
    try:
        report["accelerator_types"] = client.accelerator_types(zone)
    except RuntimeError as exc:
        report["accelerator_types_error"] = str(exc)
    try:
        report["quota_limits"] = client.quota_limits(
            region=_zone_region(zone))
    except RuntimeError as exc:
        report["quota_limits_error"] = str(exc)
    return report


def _headroom(row: dict) -> Optional[int]:
    """GPUs still free under a quota row; None when unlimited."""
    if row["limit"] < 0:
        return None
    return max(0, row["limit"] - row.get("usage", 0))


def preflight_pool(pool, client: GpuQuotaClient,
                   zone: Optional[str] = None) -> list[str]:
    """Advisory warnings for a pool request: the GPU type not offered
    in the zone, or the requested GPUs exceeding what a quota leaves
    free. Never raises — preflight unavailability must not block pool
    add."""
    warnings: list[str] = []
    zone = zone or pool.zone
    if not zone:
        return warnings
    gpu = gpu_type(pool.vm_size)
    if gpu is None or pool.gpus_per_node <= 0:
        return [f"vm_size {pool.vm_size!r} is not a known A3 GPU "
                f"machine type; skipping quota preflight"]
    accel, metric, spot_metric = gpu
    on_demand = pool.gpus_per_node * pool.vm_count_dedicated
    spot = pool.gpus_per_node * pool.vm_count_low_priority
    try:
        offered = client.accelerator_types(zone)
        if accel not in offered:
            warnings.append(
                f"GPU type {accel} ({pool.vm_size}) is not offered in "
                f"zone {zone} (offered: {', '.join(offered) or 'none'})")
    except RuntimeError as exc:
        warnings.append(f"capacity preflight unavailable: {exc}")
        return warnings
    try:
        rows = {row["metric"]: row for row in client.quota_limits(
            region=_zone_region(zone))}
    except RuntimeError as exc:
        warnings.append(f"quota preflight unavailable: {exc}")
        return warnings

    def blocked(need: int, row: dict) -> str:
        return (f"request needs {need} {row['metric']} but quota "
                f"{row['metric']} in {row['region']} is {row['limit']} "
                f"({row.get('usage', 0)} in use) — the allocation will be "
                f"rejected; request a quota increase or shrink the pool")

    standard = rows.get(metric)
    free = _headroom(standard) if standard else None
    if on_demand and free is not None and on_demand > free:
        warnings.append(blocked(on_demand, standard))
    preemptible = rows.get(spot_metric)
    spot_free = _headroom(preemptible) if preemptible else None
    # Spot VMs fall back to the on-demand quota where the preemptible
    # one has no room, so only a request that fits neither is proven
    # to fail.
    if spot and spot_free is not None and spot > spot_free and (
            free is not None and on_demand + spot > free):
        warnings.append(blocked(spot, preemptible))
    return warnings


def stockout_advisory(client: GpuQuotaClient, accelerator_type: str,
                      failed_zone: str,
                      candidate_zones: list[str]) -> Optional[str]:
    """After a stockout, name zones that still offer the type
    (folded into the pool entity's allocation error record)."""
    try:
        zones = client.zones_with_accelerator(
            accelerator_type,
            [z for z in candidate_zones if z != failed_zone])
    except Exception:  # noqa: BLE001 - advisory only
        return None
    if not zones:
        return None
    return (f"zone {failed_zone} is out of {accelerator_type} "
            f"capacity; these zones offer the type: "
            f"{', '.join(zones)}")
