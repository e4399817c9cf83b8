"""Config reference generator: schemas -> markdown.

The strict schemas are the single source of truth for the config
surface; this renders them as documentation so the reference can never
drift from the validator (the reference maintained 2.4k lines of
schema YAML and separate docs pages by hand).

The port's copy of batch_shipyard_tpu/cli/docsgen.py, over the port's
own schemas (the reference's keys), so it renders the same page apart
from the package its header names.

Usage: python -m batch_shipyard_tpu_torch.cli.docsgen > docs/03-config.md
"""

from __future__ import annotations

import io
import sys

import yaml

from batch_shipyard_tpu_torch.config.validator import _SCHEMA_DIR, ConfigType


def _describe(schema: dict) -> str:
    stype = schema.get("type", "any")
    parts = [stype]
    if "enum" in schema:
        def lit(v):
            # YAML literals, not Python reprs (True -> true); drop
            # the scalar document-end marker safe_dump appends.
            return yaml.safe_dump(
                v, default_flow_style=True).strip().split("\n")[0]
        parts.append("one of: " + ", ".join(
            f"`{lit(v)}`" for v in schema["enum"]))
    if "pattern" in schema:
        parts.append(f"pattern `{schema['pattern']}`")
    if "range" in schema:
        rng = schema["range"]
        bounds = []
        if "min" in rng:
            bounds.append(f">= {rng['min']}")
        if "max" in rng:
            bounds.append(f"<= {rng['max']}")
        parts.append(" and ".join(bounds))
    if schema.get("nullable"):
        parts.append("nullable")
    if schema.get("required"):
        parts.append("**required**")
    return "; ".join(parts)


def _walk(schema: dict, path: str, rows: list[tuple[str, str]]) -> None:
    stype = schema.get("type", "any")
    if stype == "map":
        if schema.get("allow_unknown"):
            rows.append((f"{path}.*", "map (free-form keys)"))
        for key, sub in schema.get("mapping", {}).items():
            _walk(sub, f"{path}.{key}", rows)
    elif stype == "seq":
        elem = schema.get("sequence")
        if elem is not None:
            _walk(elem, f"{path}[]", rows)
        else:
            rows.append((f"{path}[]", "seq"))
    else:
        rows.append((path, _describe(schema)))


def generate() -> str:
    out = io.StringIO()
    out.write(
        "# Configuration reference\n\n"
        "Generated from the strict validation schemas "
        "(`batch_shipyard_tpu_torch/config/schemas/`) — regenerate with\n"
        "`python -m batch_shipyard_tpu_torch.cli.docsgen > "
        "docs/03-config.md`.\n"
        "Unknown keys are rejected at load time.\n")
    for ct in ConfigType:
        with open(_SCHEMA_DIR / f"{ct.value}.yaml", "r",
                  encoding="utf-8") as fh:
            schema = yaml.safe_load(fh)
        out.write(f"\n## {ct.value}.yaml\n\n")
        rows: list[tuple[str, str]] = []
        _walk(schema, "", rows)
        out.write("| Key | Type / constraints |\n|---|---|\n")
        for path, desc in rows:
            out.write(f"| `{path.lstrip('.')}` | {desc} |\n")
    # Hand-maintained nuance lives in docs/_config_notes.md and is
    # appended verbatim: the tables above can regenerate without
    # losing it, and a note about a key the schemas dropped sticks
    # out instead of silently surviving inside a stale table row.
    notes = (_SCHEMA_DIR.parent.parent.parent / "docs"
             / "_config_notes.md")
    if not notes.exists():
        raise FileNotFoundError(
            f"{notes}: the hand-maintained Key notes section is "
            f"required — regenerating without it would silently drop "
            f"documented caveats (incl. the registry-password "
            f"plaintext warning)")
    out.write("\n" + notes.read_text(encoding="utf-8"))
    return out.getvalue()


if __name__ == "__main__":
    sys.stdout.write(generate())
