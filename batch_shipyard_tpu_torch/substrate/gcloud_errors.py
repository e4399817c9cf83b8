"""Table-driven classification of gcloud / Compute Engine API errors.

The port's copy of batch_shipyard_tpu/substrate/gcloud_errors.py, whose
table maps the payloads of ``gcloud compute tpus tpu-vm create`` and
queued-resource failures onto a stable taxonomy; every one of its rules
is kept, in its order. This package allocates A3 VMs through ``gcloud
compute instances create``, whose quota, stockout and machine-type
errors are worded differently (Compute Engine's public documentation of
them): those rules stand ahead of the generic rule that would otherwise
catch them.

  kind    — quota | stockout | permission | invalid_argument |
            conflict | not_found | unavailable | internal | unknown
  fatal   — retrying the SAME request cannot succeed (config/auth
            error)
  retry   — suggested recovery: none | backoff | other_zone

Rules are ordered; first match wins. Matching is case-insensitive
substring over the combined stderr/JSON text (a marker holding ``.*`` is
a regular expression) — gcloud is not consistent enough across versions
for anything stricter, which is why the table is the API and the tests
pin payloads against it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ErrorClass:
    kind: str
    fatal: bool
    retry: str           # none | backoff | other_zone
    rule: str            # the marker that matched (for logs)


# (marker, kind, fatal, retry) — ordered, first match wins.
_RULES: tuple[tuple[str, str, bool, str], ...] = (
    # Quota: permanent until the operator raises it.
    ("quota exceeded", "quota", True, "none"),
    ("quota_exceeded", "quota", True, "none"),
    ("exceeded quota", "quota", True, "none"),
    # Compute Engine names the metric between the words: "Quota
    # 'NVIDIA_H100_GPUS' exceeded.  Limit: 0.0 in region us-central1."
    # (reason "quotaExceeded" in the JSON body).
    ("quota '.*' exceeded", "quota", True, "none"),
    ("quotaexceeded", "quota", True, "none"),
    # Stockout/capacity: zone is dry; try elsewhere or wait. The
    # specific capacity phrasings come BEFORE the bare
    # RESOURCE_EXHAUSTED rule: GCP also returns RESOURCE_EXHAUSTED for
    # API rate limiting (HTTP 429), where other_zone would wrongly
    # abort the allocation — a bare status with no capacity wording
    # therefore backs off instead.
    ("no more capacity in the zone", "stockout", False, "other_zone"),
    ("does not have enough resources available",
     "stockout", False, "other_zone"),
    ("stockout", "stockout", False, "other_zone"),
    ("not enough available capacity", "stockout", False, "other_zone"),
    ("insufficient capacity", "stockout", False, "other_zone"),
    # Compute Engine's stockout codes. They hold no "resource_exhausted"
    # (the pool sits between the words), and the _WITH_DETAILS form's
    # message says the VM "is currently unavailable", which the
    # transient rule below would back off on.
    ("zone_resource_pool_exhausted", "stockout", False, "other_zone"),
    ("resource_exhausted", "unavailable", False, "backoff"),
    # Config errors BEFORE the generic not-found rules: "Accelerator
    # type v5p-8 was not found" is a fatal config error, and the
    # generic "was not found" rule would otherwise classify it as a
    # non-fatal not_found and poll to timeout.
    ("accelerator type .* not found", "invalid_argument", True,
     "none"),
    # A zone without A3 answers "The resource
    # 'projects/p/zones/z/machineTypes/a3-highgpu-8g' was not found";
    # likewise a missing GPU type or boot image.
    ("machinetypes/.* was not found", "invalid_argument", True, "none"),
    ("machine type with name .* does not exist", "invalid_argument",
     True, "none"),
    ("acceleratortypes/.* was not found", "invalid_argument", True,
     "none"),
    ("/images/.* was not found", "invalid_argument", True, "none"),
    ("is not a valid accelerator-type", "invalid_argument", True,
     "none"),
    ("invalid value for field", "invalid_argument", True, "none"),
    ("unsupported runtime version", "invalid_argument", True, "none"),
    # Conflict / not-found / transient BEFORE the permission rules:
    # GCP conflates wording ("does not have permission ... or it may
    # not exist"), and a merely-mentioned "permission" must not brick
    # a pool when a more specific transient marker is present.
    ("already exists", "conflict", False, "none"),
    ("alreadyexists", "conflict", False, "none"),
    ("not_found", "not_found", False, "none"),
    ("was not found", "not_found", False, "none"),
    ("unavailable", "unavailable", False, "backoff"),
    ("service is currently unavailable", "unavailable", False,
     "backoff"),
    ("deadline_exceeded", "unavailable", False, "backoff"),
    ("deadline exceeded", "unavailable", False, "backoff"),
    ("connection reset", "unavailable", False, "backoff"),
    ("internal error", "internal", False, "backoff"),
    ("internal_error", "internal", False, "backoff"),
    ("rate limit", "unavailable", False, "backoff"),
    # Auth/permission: fatal, operator action required. Specific
    # phrasings only — a bare "permission" substring is too greedy.
    ("permission denied", "permission", True, "none"),
    ("permission_denied", "permission", True, "none"),
    ("permission '", "permission", True, "none"),
    ("does not have permission", "permission", True, "none"),
    ("request had insufficient authentication",
     "permission", True, "none"),
    ("unauthenticated", "permission", True, "none"),
    # Config errors: fatal, same request can never work. (The
    # specific phrasings live above the not-found rules; the bare
    # status string stays down here below the permission rules.)
    ("invalid_argument", "invalid_argument", True, "none"),
)


def classify(payload: str) -> ErrorClass:
    """Classify a gcloud failure payload (stderr text, JSON error
    body, or both concatenated)."""
    text = payload.lower()
    for marker, kind, fatal, retry in _RULES:
        if ".*" in marker:
            if re.search(marker, text):
                return ErrorClass(kind, fatal, retry, marker)
        elif marker in text:
            return ErrorClass(kind, fatal, retry, marker)
    return ErrorClass("unknown", False, "backoff", "")


def is_preemption_state(state: Optional[str],
                        stopped_by_pool: bool = False) -> bool:
    """States that mean the machine was taken away (spot reclamation or
    maintenance) rather than stopped or deleted by the pool — the signal
    feeding node-recreate recovery.

    A Compute Engine instance that ``gcloud compute instances stop``
    halted shows ``TERMINATED``, the status a spot reclamation leaves
    too, so the status alone cannot tell a suspended pool from a
    reclaimed one: ``stopped_by_pool`` says the pool stopped this
    machine itself (its node row reads ``suspended``), and then no
    status is a preemption."""
    if stopped_by_pool:
        return False
    return (state or "").upper() in ("PREEMPTED", "TERMINATED",
                                     "SUSPENDED")
