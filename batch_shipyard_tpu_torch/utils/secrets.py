"""Secret indirection: resolve credential values from secret stores.

The port's copy of batch_shipyard_tpu/utils/secrets.py.

Reference analog: convoy/keyvault.py — any credential may be a KeyVault
secret id (parse_secret_ids :196, get_secret :176) and the whole
credentials file can live in KeyVault (:71). TPU-native mapping: GCP
Secret Manager is the cloud provider; ``env`` and ``file`` providers
cover air-gapped/test use. A value of the form::

    secret://<provider>/<name>

anywhere a credential string is accepted resolves through this module.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import yaml

from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

_SECRET_RE = re.compile(r"^secret://(?P<provider>[a-z_]+)/(?P<name>.+)$")


class SecretResolutionError(RuntimeError):
    pass


def is_secret_id(value: object) -> bool:
    return isinstance(value, str) and bool(_SECRET_RE.match(value))


def parse_secret_id(value: str) -> tuple[str, str]:
    match = _SECRET_RE.match(value)
    if not match:
        raise SecretResolutionError(f"not a secret id: {value!r}")
    return match.group("provider"), match.group("name")


def _resolve_env(name: str) -> str:
    value = os.environ.get(name)
    if value is None:
        raise SecretResolutionError(f"env secret {name!r} not set")
    return value


def _resolve_file(name: str, secrets_file: Optional[str]) -> str:
    if not secrets_file:
        raise SecretResolutionError(
            "file secret provider requires credentials.secrets.file")
    with open(secrets_file, "r", encoding="utf-8") as fh:
        data = yaml.safe_load(fh) or {}
    if name not in data:
        raise SecretResolutionError(
            f"secret {name!r} not in {secrets_file}")
    return str(data[name])


def _resolve_gcp(name: str, project: Optional[str]) -> str:
    """GCP Secret Manager via gcloud (network path; gated)."""
    import shutil
    if shutil.which("gcloud") is None:
        raise SecretResolutionError(
            "gcloud CLI required for gcp_secret_manager provider")
    cmd = ["gcloud", "secrets", "versions", "access", "latest",
           f"--secret={name}"]
    if project:
        cmd.append(f"--project={project}")
    rc, out, err = util.subprocess_capture(cmd)
    if rc != 0:
        raise SecretResolutionError(
            f"gcloud secret access failed: {err.strip()}")
    return out.rstrip("\n")


def resolve_secret(value: str, secrets_file: Optional[str] = None,
                   project: Optional[str] = None) -> str:
    """Resolve one secret:// id to its value."""
    provider, name = parse_secret_id(value)
    if provider == "env":
        return _resolve_env(name)
    if provider == "file":
        return _resolve_file(name, secrets_file)
    if provider == "gcp_secret_manager":
        return _resolve_gcp(name, project)
    raise SecretResolutionError(f"unknown secret provider {provider!r}")


def resolve_config_secrets(config: dict,
                           secrets_file: Optional[str] = None,
                           project: Optional[str] = None) -> dict:
    """Deep-resolve every secret:// string in a config dict."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if is_secret_id(node):
            return resolve_secret(node, secrets_file, project)
        return node
    return walk(config)


# ------------------------- store (keyvault add) -------------------------

def store_secret(secret_id: str, value: str,
                 secrets_file: Optional[str] = None,
                 project: Optional[str] = None) -> None:
    """Write a secret value under a secret:// id (the reference's
    `keyvault add` half, convoy/keyvault.py:112 store_credentials /
    :176 get_secret's sibling). Providers: ``file`` updates the YAML
    secrets file in place; ``gcp_secret_manager`` creates the secret
    (idempotently) and adds a new version via gcloud with the value
    on stdin — never in argv, so it cannot leak through process
    listings. The ``env`` provider is read-only by nature."""
    provider, name = parse_secret_id(secret_id)
    if provider == "env":
        raise SecretResolutionError(
            "env secrets are read-only (set the variable in the "
            "environment instead)")
    if provider == "file":
        if not secrets_file:
            raise SecretResolutionError(
                "file secret provider requires credentials.secrets."
                "file")
        data = {}
        if os.path.exists(secrets_file):
            with open(secrets_file, "r", encoding="utf-8") as fh:
                data = yaml.safe_load(fh) or {}
        data[name] = value
        tmp = secrets_file + ".tmp"
        with open(tmp, "w", encoding="utf-8",
                  opener=lambda p, f: os.open(p, f, 0o600)) as fh:
            yaml.safe_dump(data, fh, default_flow_style=False)
        os.replace(tmp, secrets_file)
        return
    if provider == "gcp_secret_manager":
        import shutil
        if shutil.which("gcloud") is None:
            raise SecretResolutionError(
                "gcloud CLI required for gcp_secret_manager provider")
        base = ["gcloud", "secrets"]
        if project:
            base.append(f"--project={project}")
        # Idempotent create; failure is fine when it already exists.
        util.subprocess_capture(
            base[:2] + ["create", name,
                        "--replication-policy=automatic"] + base[2:])
        rc, _out, err = util.subprocess_capture(
            base[:2] + ["versions", "add", name, "--data-file=-"] +
            base[2:], stdin_data=value)
        if rc != 0:
            raise SecretResolutionError(
                f"gcloud secret store failed: {err.strip()}")
        return
    raise SecretResolutionError(f"unknown secret provider {provider!r}")


def store_credentials_config(secret_id: str, credentials: dict,
                             secrets_file: Optional[str] = None,
                             project: Optional[str] = None) -> None:
    """Store an entire credentials.yaml under one secret id (the
    reference keeps whole credential files in KeyVault,
    convoy/keyvault.py:71/:112); fetch back with
    fetch_credentials_config."""
    store_secret(secret_id, yaml.safe_dump(credentials),
                 secrets_file=secrets_file, project=project)


def fetch_credentials_config(secret_id: str,
                             secrets_file: Optional[str] = None,
                             project: Optional[str] = None) -> dict:
    """Fetch a whole credentials.yaml stored via
    store_credentials_config."""
    raw = resolve_secret(secret_id, secrets_file=secrets_file,
                         project=project)
    data = yaml.safe_load(raw)
    if not isinstance(data, dict):
        raise SecretResolutionError(
            f"secret {secret_id} does not hold a credentials mapping")
    return data
