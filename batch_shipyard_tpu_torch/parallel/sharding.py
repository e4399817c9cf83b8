"""How the transformer's parameters map onto the mesh.

Counterpart of batch_shipyard_tpu/parallel/sharding.py. The reference
annotates each parameter with a PartitionSpec and lets XLA place the
shards; the port keeps the same rules and slices a full state dict into
this rank's tensor-parallel shard itself:

  - q/k/v/gate/up projections: columns over tp  -> P("fsdp", "tp")
  - o/down projections:        rows over tp     -> P("tp", "fsdp")
  - embedding:                 vocab over tp    -> P("tp", "fsdp")
  - norms/scales: replicated

A flax kernel is [in, out] and the port's Dense an nn.Linear whose
weight is [out, in], so a flax column split (contiguous heads or ff
units) is a split of the torch weight's rows, and a flax row split a
split of its columns.

What the port does differently, for now (ROADMAP queue 1):
- the embedding stays replicated across tp, and the loss runs over the
  full vocabulary on every tp rank (no vocab-parallel loss yet);
- fsdp does not shard parameters tensor by tensor: parallel/train.py
  holds the fp32 parameters and AdamW state of 1/fsdp of one flat bucket
  on each rank and gathers the parameters after each update;
- the fused kernels (qkv_kernel, gate_up_kernel) are [q|k|v] and
  [gate|up] concatenations, which a contiguous split would cut across q
  and k, so tp refuses fused_norm (models/transformer.py).
MoE's rules arrive with MoE.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional, Sequence

import torch

# (state-dict name pattern, the reference's PartitionSpec over the flax
# dims, the torch dim that tp splits in the port (None: replicated)).
TRANSFORMER_RULES = (
    (r".*(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$",
     ("fsdp", "tp"), 0),
    (r".*(qkv_kernel|gate_up_kernel)$", ("fsdp", "tp"), None),
    (r".*(o_proj|down_proj)\.weight$", ("tp", "fsdp"), 1),
    (r".*embed\.embedding$", ("tp", "fsdp"), None),
    (r".*(scale|bias)$", (), None),
)
_FUSED = re.compile(TRANSFORMER_RULES[1][0])


def tp_dim(name: str) -> Optional[int]:
    """The dim of the port's tensor ``name`` that tp splits, or None when
    the port holds it whole on every tp rank."""
    for pattern, _, dim in TRANSFORMER_RULES:
        if re.match(pattern, name):
            return dim
    return None


def shard_state_dict(state: Mapping[str, torch.Tensor], mesh
                     ) -> dict[str, torch.Tensor]:
    """This rank's tp shard of a full state dict: ``mesh`` (a
    parallel.mesh.RankMesh, or anything with ``sizes`` and ``coords``)
    gives tp and this rank's tp index; each split tensor keeps its
    contiguous 1/tp along tp_dim (a copy), the rest pass through."""
    tp, index = mesh.sizes["tp"], mesh.coords["tp"]
    if tp == 1:
        return dict(state)
    out = {}
    for name, tensor in state.items():
        if _FUSED.match(name):
            raise NotImplementedError(
                f"{name}: the fused [q|k|v] / [gate|up] kernels need a "
                f"head-wise regrouping under tp (ROADMAP queue 1: "
                f"fused_norm and int8 under tp)")
        dim = tp_dim(name)
        if dim is None:
            out[name] = tensor
            continue
        if tensor.shape[dim] % tp:
            raise ValueError(f"{name} {tuple(tensor.shape)}: dim {dim} is "
                             f"not divisible by tp={tp}")
        out[name] = tensor.chunk(tp, dim=dim)[index].clone()
    return out


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]]
                      ) -> dict[str, torch.Tensor]:
    """The inverse of shard_state_dict: the tp shards in tp order -> the
    full state dict (the replicated tensors from the first)."""
    full = {}
    for name, tensor in shards[0].items():
        dim = tp_dim(name)
        full[name] = (tensor if dim is None or len(shards) == 1 else
                      torch.cat([s[name] for s in shards], dim=dim))
    return full
