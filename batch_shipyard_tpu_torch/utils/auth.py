"""Service-account credential handling for daemons and headless VMs.

The port's copy of batch_shipyard_tpu/utils/auth.py.

Reference analog: convoy/aad.py (device code / service principal /
MSI token machinery). The GCP redesign needs far less: interactive
use inherits gcloud's ambient user credentials, and headless daemons
(federation proxy VM, monitoring VM, slurm controller) authenticate
as a service account via its key file — this module makes that one
call idempotent and applies it to BOTH auth paths the framework uses:

  - Application Default Credentials (google-cloud-storage's GCS
    client): GOOGLE_APPLICATION_CREDENTIALS points at the key file;
  - the gcloud CLI (every substrate/provisioning call): the service
    account is activated once per process, after which all gcloud
    invocations run as it.

Impersonation (`service_account_email` without a key file) is exposed
as per-call gcloud args for operators who prefer short-lived tokens
over key distribution.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

_lock = threading.Lock()
_activated: set[str] = set()


def ensure_service_account(gcp, runner=None) -> bool:
    """Apply the configured service account (idempotent per key file).

    Sets GOOGLE_APPLICATION_CREDENTIALS for ADC consumers and runs
    `gcloud auth activate-service-account` so CLI-driven paths use the
    same identity. Returns True if a service account is active, False
    when no key file is configured (ambient credentials)."""
    key_file = getattr(gcp, "service_account_key_file", None) \
        if gcp is not None else None
    if not key_file:
        return False
    if not os.path.exists(key_file):
        raise FileNotFoundError(
            f"service_account_key_file does not exist: {key_file}")
    with _lock:
        # Plain assignment: ADC and gcloud must agree on the identity
        # (a leftover GOOGLE_APPLICATION_CREDENTIALS, or a second key
        # file in the same process, would otherwise split them).
        os.environ["GOOGLE_APPLICATION_CREDENTIALS"] = key_file
        if key_file in _activated:
            return True
        run = runner or util.subprocess_capture
        rc, _out, err = run([
            "gcloud", "auth", "activate-service-account",
            f"--key-file={key_file}"])
        if rc != 0:
            raise RuntimeError(
                f"service account activation failed: {err.strip()}")
        _activated.add(key_file)
        logger.info("activated service account from %s", key_file)
        return True


def gcloud_impersonation_args(gcp) -> list[str]:
    """Per-call gcloud args for impersonation (email configured, no
    key file): short-lived tokens minted by the caller's ambient
    identity instead of a distributed key."""
    email = getattr(gcp, "service_account_email", None) \
        if gcp is not None else None
    key_file = getattr(gcp, "service_account_key_file", None) \
        if gcp is not None else None
    if email and not key_file:
        return [f"--impersonate-service-account={email}"]
    return []


def access_token(runner=None) -> str:
    """Mint an access token for raw HTTP callers (the aad.py
    get_token analog) using whatever identity is active."""
    run = runner or util.subprocess_capture
    rc, out, err = run(["gcloud", "auth", "print-access-token"])
    if rc != 0:
        raise RuntimeError(f"token mint failed: {err.strip()}")
    return out.strip()
