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

Checkpoints (the restore side; workloads/checkpoint.py writes and reads
the files). A rank's share of the global training state is a set of
``Piece``s: flat ranges of one tensor's tp shard, recorded against the
shard and not the global tensor (a flat range of an o/down shard, split
on dim 1, is strided in the global tensor). A rank holds
(``held_pieces``) its whole tp shard of every parameter and, of
``exp_avg`` and ``exp_avg_sq``, the ranges of its fsdp chunk of the
flat bucket (parallel/train.py). Tensors that tp does not split are
recorded whole (tp_count 1). ``written_pieces``: only ranks with dp,
ep and sp index 0 write; the parameters come from fsdp index 0, the
unsplit tensors from tp index 0, so nothing is written twice. On
restore (``restore_plan_for``) a rank whose tp matches the save reads
only the parts of the saved pieces that overlap what it holds
(restore_plan.range_reads: 1/M of the optimizer state after an fsdp
resize to M); with another tp it reads every piece of each split
tensor, builds the global tensor on the host and cuts its new shard
from it (``assemble``). Global shapes do not depend on the mesh, so a
checkpoint of other shapes is refused.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Mapping, Optional, Sequence

import torch

from batch_shipyard_tpu_torch.parallel import restore_plan

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


# ------------------------------ checkpoints ------------------------------

# The training state a checkpoint holds per parameter: the fp32 value and
# AdamW's two moments (torch.optim.AdamW's state names).
STATE_KINDS = ("param", "exp_avg", "exp_avg_sq")


@dataclasses.dataclass(frozen=True, order=True)
class Piece:
    """Elements [lo, hi) of the flattened tp shard ``tp_index`` of
    ``tp_count`` of tensor ``key``'s ``kind`` (STATE_KINDS)."""

    key: str
    kind: str
    tp_index: int
    tp_count: int
    lo: int
    hi: int

    @property
    def size(self) -> int:
        return self.hi - self.lo


def split_count(name: str, tp: int) -> int:
    """How many tp shards the port cuts tensor ``name`` into."""
    return tp if tp > 1 and tp_dim(name) is not None else 1


def shard_shape(name: str, shape: Sequence[int], count: int) -> tuple:
    """The shape of one of ``count`` tp shards of global ``shape``."""
    shape = list(shape)
    if count > 1:
        shape[tp_dim(name)] //= count
    return tuple(shape)


def global_shape(name: str, shape: Sequence[int], tp: int) -> tuple:
    """The global shape of a tensor whose tp shard is ``shape``."""
    shape = list(shape)
    if split_count(name, tp) > 1:
        shape[tp_dim(name)] *= tp
    return tuple(shape)


def fsdp_chunk(n_params: int, fsdp: int) -> int:
    """The elements of each fsdp chunk of a flat bucket of ``n_params``
    (whole 16-byte lanes of fp32); the last chunk ends at n_params."""
    return -(-n_params // (4 * fsdp)) * 4


def held_pieces(shapes: Mapping[str, Sequence[int]], sizes: Mapping,
                coords: Mapping) -> list[Piece]:
    """The pieces of the global state a rank at ``coords`` of a mesh of
    ``sizes`` holds, for global ``shapes`` in parameter order (the flat
    bucket's order): its tp shard of each parameter whole, then for each
    moment the ranges of its fsdp chunk, tensor by tensor."""
    tp = sizes["tp"]
    flat, offset = [], 0
    for name, shape in shapes.items():
        count = split_count(name, tp)
        n = math.prod(shard_shape(name, shape, count))
        flat.append((name, count, coords["tp"] if count > 1 else 0,
                     offset, n))
        offset += n
    chunk = fsdp_chunk(offset, sizes["fsdp"])
    start = coords["fsdp"] * chunk
    pieces = [Piece(name, "param", index, count, 0, n)
              for name, count, index, _, n in flat]
    for kind in STATE_KINDS[1:]:
        for name, count, index, at, n in flat:
            lo, hi = max(at, start), min(at + n, start + chunk)
            if hi > lo:
                pieces.append(Piece(name, kind, index, count, lo - at,
                                    hi - at))
    return pieces


def written_pieces(shapes: Mapping[str, Sequence[int]], sizes: Mapping
                   ) -> list[tuple[int, Piece]]:
    """(writer rank, piece) for every piece a checkpoint of a mesh of
    ``sizes`` holds, each once, writers in rank order."""
    from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
    out = []
    for rank in range(math.prod(sizes.values())):
        coords = mesh_mod.RankMesh(sizes, rank).coords
        if coords["dp"] or coords["ep"] or coords["sp"]:
            continue
        for piece in held_pieces(shapes, sizes, coords):
            if piece.kind == "param" and coords["fsdp"]:
                continue
            if piece.tp_count == 1 and coords["tp"]:
                continue
            out.append((rank, piece))
    return out


def check_shapes(saved: Mapping[str, Sequence[int]],
                 model: Mapping[str, Sequence[int]]) -> None:
    """Refuse a checkpoint whose global tensors differ from the model's:
    global shapes do not depend on the mesh, so it belongs to another
    model configuration."""
    if list(saved) != list(model):
        raise ValueError(
            f"checkpoint tensors {sorted(set(saved) ^ set(model))[:4]} "
            f"differ from the model's: this checkpoint belongs to a "
            f"different model config")
    for name, shape in saved.items():
        if tuple(shape) != tuple(model[name]):
            raise ValueError(
                f"reshard-on-restore shape mismatch: checkpoint leaf "
                f"{tuple(shape)} vs template {tuple(model[name])} "
                f"({name}) — global shapes are mesh-independent, so this "
                f"checkpoint belongs to a different model config")


@dataclasses.dataclass
class Need:
    """One held piece and the reads that fill it: record-local ranges of
    the layout's records. ``reslice``: the reads are whole saved tp
    shards of another tp count, assembled into the global tensor first."""

    piece: Piece
    reads: list
    reslice: bool


def restore_plan_for(mesh, layout: Mapping,
                     kinds: Sequence[str] = STATE_KINDS) -> dict:
    """What the rank at ``mesh.coords`` of ``mesh.sizes`` reads of a
    checkpoint whose ``layout`` (workloads/checkpoint.py: "tensors",
    "records") was saved on any mesh: {"needs": [Need], "elements_read",
    "read_fraction" (of every element the checkpoint holds, as the
    reference's host_restore_plan weighs it), "read_fraction_by_kind"}."""
    shapes = {t["name"]: t["shape"] for t in layout["tensors"]}
    records = layout["records"]
    by_tensor: dict = {}
    for i, rec in enumerate(records):
        by_tensor.setdefault((rec["key"], rec["kind"]), []).append(i)
    needs, read, total = [], {}, {}
    for rec in records:
        total[rec["kind"]] = total.get(rec["kind"], 0) + rec["hi"] - rec["lo"]
    for piece in held_pieces(shapes, mesh.sizes, mesh.coords):
        if piece.kind not in kinds:
            continue
        saved = by_tensor.get((piece.key, piece.kind), [])
        if saved and records[saved[0]]["tp_count"] == piece.tp_count:
            mine = [i for i in saved
                    if records[i]["tp_index"] == piece.tp_index]
            reads = [restore_plan.ShardRead(mine[r.shard], r.lo, r.hi,
                                            r.dst_lo)
                     for r in restore_plan.range_reads(
                         [(records[i]["lo"], records[i]["hi"])
                          for i in mine], piece.lo, piece.hi)]
            need = Need(piece, reads, reslice=False)
        else:
            need = Need(piece, [restore_plan.ShardRead(
                i, 0, records[i]["hi"] - records[i]["lo"], records[i]["lo"])
                for i in saved], reslice=True)
        if sum(r.hi - r.lo for r in need.reads) < (
                math.prod(shapes[piece.key]) if need.reslice
                else piece.size):
            raise ValueError(f"the checkpoint does not cover {piece}")
        needs.append(need)
        read[piece.kind] = read.get(piece.kind, 0) + sum(
            r.hi - r.lo for r in need.reads)
    elements = sum(read.values())
    return {"needs": needs, "elements_read": elements,
            "read_fraction": elements / max(sum(total.values()), 1),
            "read_fraction_by_kind": {
                kind: read.get(kind, 0) / total[kind] for kind in total
                if kind in kinds}}


def assemble(plan: Mapping, layout: Mapping,
             fetch: Callable[[int, int, int], torch.Tensor]
             ) -> dict[Piece, torch.Tensor]:
    """Build every held piece of ``plan`` on the host from ``fetch(record
    index, lo, hi)`` (a 1-D tensor of that record's elements [lo, hi)):
    in place from overlapping reads, or, for a reslice, by assembling
    the global tensor from its saved tp shards and cutting this rank's
    shard and range from it."""
    shapes = {t["name"]: tuple(t["shape"]) for t in layout["tensors"]}
    records = layout["records"]
    out = {}
    for need in plan["needs"]:
        piece = need.piece
        dtype = getattr(torch, records[need.reads[0].shard]["dtype"])
        if not need.reslice:
            buf = torch.empty(piece.size, dtype=dtype)
            for r in need.reads:
                buf[r.dst_lo:r.dst_lo + r.hi - r.lo] = fetch(r.shard, r.lo,
                                                             r.hi)
            out[piece] = buf
            continue
        shape = shapes[piece.key]
        count = records[need.reads[0].shard]["tp_count"]
        part = shard_shape(piece.key, shape, count)
        shards = [torch.empty(math.prod(part), dtype=dtype)
                  for _ in range(count)]
        for r in need.reads:
            rec = records[r.shard]
            shards[rec["tp_index"]][rec["lo"] + r.lo:rec["lo"] + r.hi] = \
                fetch(r.shard, r.lo, r.hi)
        full = (torch.cat([s.view(part) for s in shards], tp_dim(piece.key))
                if count > 1 else shards[0].view(shape))
        if piece.tp_count > 1:
            full = full.chunk(piece.tp_count,
                              tp_dim(piece.key))[piece.tp_index]
        out[piece] = full.reshape(-1)[piece.lo:piece.hi].clone()
    return out
