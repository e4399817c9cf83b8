"""GPU machine-type oracle: VM size -> the H100s a node holds.

The port's counterpart of batch_shipyard_tpu/parallel/topology.py (the
TPU slice oracle) and of the reference's vm-size oracles (convoy
settings.py:717 is_gpu_pool, :749 get_gpu_type_from_vm_size). A GPU pool
is a flat set of nodes, each with its own cards: the table answers how
many H100 80GB a node of a machine type has. Table-driven, so a new
machine type is one line.
"""

from __future__ import annotations

from typing import Optional

# GCE's A3 machine types (public Compute Engine documentation).
_GPUS_PER_NODE: dict[str, int] = {
    "a3-highgpu-1g": 1,
    "a3-highgpu-2g": 2,
    "a3-highgpu-4g": 4,
    "a3-highgpu-8g": 8,
    "a3-megagpu-8g": 8,
}


def gpus_per_node(vm_size: Optional[str]) -> int:
    """The GPUs one node of ``vm_size`` holds: 0 for a size without
    GPUs (or no size at all)."""
    if not vm_size:
        return 0
    return _GPUS_PER_NODE.get(vm_size.strip().lower(), 0)


def machine_types() -> tuple[str, ...]:
    return tuple(_GPUS_PER_NODE)
