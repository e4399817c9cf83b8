"""State-store names the port uses: its copy of the part of
batch_shipyard_tpu/state/names.py that the pool hooks need (the goodput
and trace tables, the compile-cache seed keys). The values are the
reference's, so both packages read and write the same rows and
objects."""

from __future__ import annotations

TABLE_GOODPUT = "goodput"      # pk=pool_id, rk=f"{ts}${uniq}"
TABLE_TRACE = "trace"          # pk=pool_id, rk=f"{ts}${uniq}"


# Pool-wide compile-cache seeding (compilecache/seeding.py): one tar
# artifact per cache identity, a latest.json pointer read before
# download, and a lease so exactly one node uploads per identity.
def compile_cache_key(pool_id: str, identity: str) -> str:
    return f"compilecache/{pool_id}/{identity}.tar"


def compile_cache_latest_key(pool_id: str) -> str:
    return f"compilecache/{pool_id}/latest.json"


def compile_cache_lease_key(pool_id: str, identity: str) -> str:
    return f"compilecache/{pool_id}/{identity}.lock"
