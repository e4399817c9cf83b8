"""Validation-gated kernel dispatch: the port's own copy of
batch_shipyard_tpu/ops/kernel_select.py.

A marker file records, per check, whether a kernel passed on the card:
``{"chunked_cross_entropy": {"ok": true, "backend": "cuda"}}``. It is
read from ``$SHIPYARD_KERNEL_VALIDATION``, else ``KERNEL_VALIDATION.json``
at the repository root. An op whose kernel the CPU tests cannot run
gates its ``impl="auto"`` on that marker, so the kernel is chosen only
once a run on the card has proven it. Only a record with ``backend ==
"cuda"`` counts here (the JAX package's records say ``"tpu"``, and a
CUDA record does not count there). The port reads markers and never
writes one into the repository.
"""

from __future__ import annotations

import json
import os
import pathlib

import torch

MARKER_ENV = "SHIPYARD_KERNEL_VALIDATION"
DEFAULT_MARKER = (pathlib.Path(__file__).resolve().parents[2]
                  / "KERNEL_VALIDATION.json")
BACKEND = "cuda"


def kernel_validation(path: str | os.PathLike | None = None) -> dict:
    """The marker ({check_name: {ok, backend, ...}}), or {} when it is
    absent or unreadable: no proof means not proven."""
    path = path or os.environ.get(MARKER_ENV) or DEFAULT_MARKER
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def kernel_validated(name: str) -> bool:
    """True when check ``name`` passed on a CUDA card."""
    record = kernel_validation().get(name, {})
    return (isinstance(record, dict) and bool(record.get("ok"))
            and record.get("backend") == BACKEND)


def resolve_auto(name: str, device, kernel_impl: str = "kernel",
                 fallback: str = "plain") -> str:
    """impl='auto': the validated kernel for a CUDA device, the fallback
    for any other device or without a validated record."""
    if torch.device(device).type == "cuda" and kernel_validated(name):
        return kernel_impl
    return fallback
