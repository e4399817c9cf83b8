"""General utilities: logging, shell wrapping, hashing, retry, CIDR math.

The port's copy of batch_shipyard_tpu/utils/util.py. The device probe
(``probe_cuda``, ``probe_default_devices``) counts torch's CUDA devices
in a subprocess where the reference counts JAX's.

Capability parity with the reference's convoy/util.py (logging setup
util.py:86, wrap_commands_in_shell :368, base64/hash helpers :396-509,
subprocess helpers :519-658, CIDR math :659) — re-implemented, not ported.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import ipaddress
import logging
import os
import random
import shlex
import subprocess
import sys
import time
from typing import Any, Callable, Iterable, Sequence

_LOGGER_FORMAT = (
    "%(asctime)s.%(msecs)03dZ %(levelname)s %(name)s:%(funcName)s:%(lineno)d "
    "%(message)s"
)
_LOGGER_DATEFMT = "%Y-%m-%dT%H:%M:%S"


def setup_logger(logger: logging.Logger, logfile: str | None = None,
                 verbose: bool = False) -> None:
    """Configure a logger with the framework's standard format."""
    logger.handlers.clear()
    handler: logging.Handler
    if logfile:
        handler = logging.FileHandler(logfile, encoding="utf-8")
    else:
        handler = logging.StreamHandler(sys.stderr)
    formatter = logging.Formatter(fmt=_LOGGER_FORMAT, datefmt=_LOGGER_DATEFMT)
    formatter.converter = time.gmtime
    handler.setFormatter(formatter)
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger("batch_shipyard_tpu_torch").handlers:
        setup_logger(logging.getLogger("batch_shipyard_tpu_torch"))
    return logger


def atomic_write(path: str, data: bytes) -> None:
    """Crash-safe file replace: write to a uniquely-named sibling
    temp file, flush + fsync, then os.replace. THE durability idiom
    every ledger/journal/metadata writer in the framework shares
    (state store DBs, the agent's slot ledger, the resilient-store
    WAL) — a crash at any instant leaves either the old content or
    the new, never a torn file behind a committed rename."""
    tmp = f"{path}.tmp.{os.getpid()}.{random.getrandbits(32):08x}"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def is_none_or_empty(value: Any) -> bool:
    return value is None or (hasattr(value, "__len__") and len(value) == 0)


def is_not_empty(value: Any) -> bool:
    return not is_none_or_empty(value)


def utcnow() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def datetime_utcnow_iso() -> str:
    return utcnow().strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def wrap_commands_in_shell(commands: Sequence[str], windows: bool = False,
                           wait: bool = True) -> str:
    """Wrap a list of shell commands into a single shell invocation string."""
    if windows:
        return 'cmd.exe /c "{}"'.format(" && ".join(commands))
    suffix = "; wait" if wait else ""
    return "/bin/bash -c 'set -e; set -o pipefail; {}{}'".format(
        "; ".join(commands), suffix)


def shell_quote(arg: str) -> str:
    return shlex.quote(arg)


def base64_encode_string(value: str) -> str:
    return base64.b64encode(value.encode("utf-8")).decode("ascii")


def base64_decode_string(value: str) -> str:
    return base64.b64decode(value).decode("utf-8")


def hash_string(value: str, algo: str = "sha256") -> str:
    return hashlib.new(algo, value.encode("utf-8")).hexdigest()


def hash_file(path: str, algo: str = "sha256") -> str:
    hasher = hashlib.new(algo)
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            hasher.update(chunk)
    return hasher.hexdigest()


def merge_dict(base: dict, overlay: dict) -> dict:
    """Recursively merge overlay into base, returning a new dict."""
    if not isinstance(base, dict) or not isinstance(overlay, dict):
        raise ValueError("merge_dict requires two dicts")
    result = dict(base)
    for key, value in overlay.items():
        if key in result and isinstance(result[key], dict) and isinstance(
                value, dict):
            result[key] = merge_dict(result[key], value)
        else:
            result[key] = value
    return result


def retry(fn: Callable[[], Any], attempts: int = 3,
          retryable: tuple[type[BaseException], ...] = (Exception,),
          initial_backoff: float = 0.25, max_backoff: float = 8.0,
          jitter: bool = True) -> Any:
    """Call fn with exponential backoff on retryable exceptions."""
    backoff = initial_backoff
    for attempt in range(attempts):
        try:
            return fn()
        except retryable:
            if attempt == attempts - 1:
                raise
            delay = backoff * (1 + random.random() if jitter else 1)
            time.sleep(min(delay, max_backoff))
            backoff = min(backoff * 2, max_backoff)


def subprocess_with_output(cmd: str | Sequence[str], shell: bool = False,
                           cwd: str | None = None,
                           env: dict[str, str] | None = None,
                           suppress_output: bool = False) -> int:
    """Run a subprocess, stream output, return exit code."""
    kwargs: dict[str, Any] = {}
    if suppress_output:
        kwargs["stdout"] = subprocess.DEVNULL
        kwargs["stderr"] = subprocess.DEVNULL
    proc = subprocess.Popen(cmd, shell=shell, cwd=cwd, env=env, **kwargs)
    return proc.wait()


def subprocess_capture(cmd: str | Sequence[str], shell: bool = False,
                       cwd: str | None = None,
                       env: dict[str, str] | None = None,
                       timeout: float | None = None,
                       stdin_data: str | None = None
                       ) -> tuple[int, str, str]:
    """Run a subprocess, capture stdout/stderr, return (rc, out, err).
    stdin_data feeds the child's stdin (secret values ride stdin, not
    argv, so they never appear in process listings)."""
    proc = subprocess.run(
        cmd, shell=shell, cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout, input=stdin_data)
    return proc.returncode, proc.stdout, proc.stderr


def subprocess_nowait(cmd: str | Sequence[str], shell: bool = False,
                      cwd: str | None = None,
                      env: dict[str, str] | None = None,
                      stdout=None, stderr=None) -> subprocess.Popen:
    return subprocess.Popen(
        cmd, shell=shell, cwd=cwd, env=env, stdout=stdout, stderr=stderr)


def subprocess_wait_all(procs: Iterable[subprocess.Popen]) -> list[int]:
    return [proc.wait() for proc in procs]


def explode_cidr(cidr: str) -> tuple[str, int]:
    """Split a CIDR into (network address, prefix length)."""
    net = ipaddress.ip_network(cidr, strict=False)
    return str(net.network_address), net.prefixlen


def cidr_hosts(cidr: str) -> int:
    """Number of usable host addresses in a CIDR block."""
    net = ipaddress.ip_network(cidr, strict=False)
    return max(net.num_addresses - 2, 0) if net.prefixlen < 31 else (
        net.num_addresses)


def ip_in_cidr(ip: str, cidr: str) -> bool:
    return ipaddress.ip_address(ip) in ipaddress.ip_network(cidr, strict=False)


def confirm_action(msg: str, assume_yes: bool = False) -> bool:
    """Prompt the user for confirmation unless assume_yes."""
    if assume_yes:
        return True
    if not sys.stdin.isatty():
        return False
    answer = input(f"{msg} [y/n]: ").strip().lower()
    return answer in ("y", "yes")


def env_bool(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def chunked(seq: Sequence[Any], size: int) -> Iterable[Sequence[Any]]:
    for idx in range(0, len(seq), size):
        yield seq[idx:idx + size]


def human_bytes(num: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(num) < 1024.0:
            return f"{num:.1f}{unit}"
        num /= 1024.0
    return f"{num:.1f}PiB"


# Run in the probe's subprocess: the CUDA device count and torch's CUDA
# version, one line of JSON. torch.cuda.device_count() asks the driver
# (initializing no context), which is where a wedged driver would block.
_PROBE_SCRIPT = (
    "import json, torch; "
    "print(json.dumps({'count': torch.cuda.device_count(), "
    "'cuda': torch.version.cuda, 'torch': torch.__version__}))")


def probe_cuda(timeout: float = 75.0) -> tuple[dict, str | None]:
    """Import torch and count its CUDA devices in a SUBPROCESS with a
    hard timeout, so a wedged driver can never hang the caller in-process
    (a device query that blocks in-process is unrecoverable). Returns
    ({"count", "cuda", "torch"}, None) on success or ({"count": 0},
    reason) on timeout or failure."""
    import json as _json
    import subprocess
    import sys as _sys

    try:
        proc = subprocess.run(
            [_sys.executable, "-c", _PROBE_SCRIPT],
            capture_output=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"count": 0}, (f"device init timed out after "
                              f"{timeout:.0f}s (wedged driver?)")
    if proc.returncode != 0:
        tail = proc.stderr.decode(errors="replace").strip()
        return {"count": 0}, (f"device init exited rc={proc.returncode}: "
                              f"{tail[-400:]}")
    try:
        info = _json.loads(proc.stdout.decode().strip().splitlines()[-1])
        info["count"] = int(info["count"])
    except (ValueError, IndexError, KeyError, TypeError):
        return {"count": 0}, "device probe printed no device count"
    return info, None


def probe_default_devices(timeout: float = 75.0
                          ) -> tuple[int, str | None]:
    """The count of torch's CUDA devices, probed as ``probe_cuda`` does:
    (count, None) on success or (0, reason) on timeout or failure."""
    info, error = probe_cuda(timeout)
    return info["count"], error
