"""Strict schema validation for user-facing YAML configs.

The port's copy of batch_shipyard_tpu/config/validator.py, with its
own copies of the eight schemas: a file either package's validator
accepts, the other's accepts too.

The reference delegates this to pykwalify (convoy/validator.py:112 +
schemas/*.yaml, strict_rule_validation) and treats schema validation as
the de-facto type system of the product (SURVEY.md section 4). pykwalify
is not available here, so this module implements a small, strict,
self-contained schema engine with the subset of semantics we need:

  - ``type``: map | seq | str | int | float | number | bool | any
  - map: ``mapping`` of key -> schema; unknown keys are errors unless
    ``allow_unknown: true``; per-key ``required: true``
  - seq: ``sequence`` holding the element schema
  - scalars: ``enum``, ``pattern`` (anchored regex), ``range`` {min,max}
  - ``nullable: true`` permits explicit nulls

Schemas live in batch_shipyard_tpu_torch/config/schemas/<config_type>.yaml.
"""

from __future__ import annotations

import enum
import functools
import pathlib
import re
from typing import Any

import yaml

_SCHEMA_DIR = pathlib.Path(__file__).parent / "schemas"


class ConfigType(enum.Enum):
    """The user-facing config file types (reference: validator.py:54)."""

    CREDENTIALS = "credentials"
    GLOBAL = "config"
    POOL = "pool"
    JOBS = "jobs"
    REMOTEFS = "fs"
    MONITOR = "monitor"
    FEDERATION = "federation"
    SLURM = "slurm"


class ValidationError(ValueError):
    """Raised when a config fails schema validation."""

    def __init__(self, config_type: str, errors: list[str]):
        self.config_type = config_type
        self.errors = errors
        msg = "{} config failed validation:\n  {}".format(
            config_type, "\n  ".join(errors))
        super().__init__(msg)


_SCALAR_TYPES: dict[str, tuple[type, ...]] = {
    "str": (str,),
    "int": (int,),
    "float": (float, int),
    "number": (int, float),
    "bool": (bool,),
}


def _check_scalar(value: Any, schema: dict, path: str,
                  errors: list[str]) -> None:
    stype = schema.get("type", "any")
    if stype != "any":
        expected = _SCALAR_TYPES[stype]
        # bool is a subclass of int in Python; reject bools for numerics.
        if isinstance(value, bool) and stype != "bool":
            errors.append(f"{path}: expected {stype}, got bool")
            return
        if not isinstance(value, expected):
            errors.append(
                f"{path}: expected {stype}, got {type(value).__name__}")
            return
    if "enum" in schema and value not in schema["enum"]:
        errors.append(
            "{}: value {!r} not one of {}".format(path, value, schema["enum"]))
    if "pattern" in schema:
        if not isinstance(value, str) or not re.fullmatch(
                schema["pattern"], value):
            errors.append(
                "{}: value {!r} does not match pattern {!r}".format(
                    path, value, schema["pattern"]))
    if "range" in schema and isinstance(value, (int, float)) and not (
            isinstance(value, bool)):
        rng = schema["range"]
        if "min" in rng and value < rng["min"]:
            errors.append(f"{path}: value {value} < min {rng['min']}")
        if "max" in rng and value > rng["max"]:
            errors.append(f"{path}: value {value} > max {rng['max']}")


def _validate_node(value: Any, schema: dict, path: str,
                   errors: list[str]) -> None:
    if value is None:
        if schema.get("nullable", False):
            return
        errors.append(f"{path}: null is not allowed")
        return
    stype = schema.get("type", "any")
    if stype == "map":
        if not isinstance(value, dict):
            errors.append(f"{path}: expected map, got {type(value).__name__}")
            return
        mapping = schema.get("mapping", {})
        if not schema.get("allow_unknown", False):
            for key in value:
                if key not in mapping:
                    errors.append(f"{path}.{key}: unknown key")
        for key, sub in mapping.items():
            if key in value:
                _validate_node(value[key], sub, f"{path}.{key}", errors)
            elif sub.get("required", False):
                errors.append(f"{path}.{key}: required key missing")
    elif stype == "seq":
        if not isinstance(value, list):
            errors.append(f"{path}: expected seq, got {type(value).__name__}")
            return
        elem = schema.get("sequence")
        if elem is not None:
            for idx, item in enumerate(value):
                _validate_node(item, elem, f"{path}[{idx}]", errors)
        if "range" in schema:
            rng = schema["range"]
            if "min" in rng and len(value) < rng["min"]:
                errors.append(
                    f"{path}: sequence shorter than min {rng['min']}")
            if "max" in rng and len(value) > rng["max"]:
                errors.append(f"{path}: sequence longer than max {rng['max']}")
    else:
        _check_scalar(value, schema, path, errors)


@functools.lru_cache(maxsize=None)
def _load_schema(config_type: str) -> dict:
    schema_file = _SCHEMA_DIR / f"{config_type}.yaml"
    if not schema_file.exists():
        raise FileNotFoundError(f"no schema for config type {config_type}")
    with open(schema_file, "r", encoding="utf-8") as fh:
        return yaml.safe_load(fh)


def validate(data: Any, schema: dict, root: str = "$") -> list[str]:
    """Validate data against an inline schema; return error list."""
    errors: list[str] = []
    _validate_node(data, schema, root, errors)
    return errors


def validate_config(config_type: ConfigType | str, data: Any,
                    raise_on_error: bool = True) -> list[str]:
    """Validate a config dict against its file-type schema."""
    name = (config_type.value if isinstance(config_type, ConfigType)
            else config_type)
    schema = _load_schema(name)
    errors = validate(data, schema, root=name)
    if errors and raise_on_error:
        raise ValidationError(name, errors)
    return errors
