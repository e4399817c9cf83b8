"""Transformer training: model + AdamW -> a train step, on one card or
over a mesh of ranks; and the vision families' steps (``VisionHarness``,
``build_resnet_train``, ``build_vit_train``, ``build_diffusion_train``,
at the end: data parallel over every rank, the reference's optimizers).

Counterpart of batch_shipyard_tpu/parallel/train.py's
``build_transformer_train``. The reference jit-compiles a global-view
SPMD step over a mesh; the port runs the same step eagerly:

    hidden = TransformerLM(tokens, return_hidden=True)
    loss = lm_loss_chunked(hidden, embed.embedding, targets)
    AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)

The optimizer matches ``optax.adamw(3e-4, weight_decay=0.01)``: one
parameter group, so every leaf decays (the RMSNorm scales and the
embedding included), with the decay applied to the pre-update
parameter. On a CUDA device the model's attention is the flash kernels
K1 (forward) and K2 (backward); with ``fused_norm`` its norm-projections
are K9; with ``quantize_matmuls`` its projections quantize both operands
to int8 (K10) and multiply them on the int8 tensor cores (K11), with a
full-precision fp32 backward; the loss's ``auto`` takes the fused
cross-entropy kernels K3-K5 where the validation marker records them
(ops/kernel_select).

Over a mesh (parallel.mesh.RankMesh: dp, fsdp, sp and tp ranks, the
reference's axes): every rank draws the same global batch and trains
its block, rows ``data_index`` of the (dp, fsdp) blocks and columns of
its sp shard with their global RoPE positions (the reference's batch
sharding ``P(("dp", "fsdp"), "sp")``), on its tp shard of the model
(parallel/sharding.py; the Megatron all-reduces in models/transformer).
Its loss share is its block's target count over the global one, so the
sum over the data and fsdp ranks (every rank with this rank's tp index)
is the global mean, which every rank reports.

The parameters are sharded over fsdp, as the reference's specs shard
every matrix (``P("fsdp", "tp")``, ``P("tp", "fsdp")``), by unit
(sharding.fsdp_units: ``embed``, the embedding and the final norm, then
each ``layer_{i}``). A rank holds, in one flat fp32 buffer (``owned``),
its chunk of every unit, unit after unit, and nothing else of the
parameters: the model's own nn.Parameters are on ``meta`` and carry only
names and shapes. AdamW runs on ``owned``, so its state is this rank's
chunks too. With fsdp = 1 a chunk is the whole unit. The reference
leaves the gathers and the sums to XLA; the port's step:

1. the forward gathers the ``embed`` unit over the fsdp ring
   (ring_collectives.fsdp_gather, K13) once, and holds it to the end of
   the step: the lookup, the final norm and the tied loss read it, and
   its gradient is reduce-scattered (K14) last in the backward. Each
   layer gathers its unit (K13) as the block starts, inside the function
   remat recomputes: the recompute gathers it again, and nothing of it
   is saved for the backward, so with remat at most one gathered layer
   is alive at any moment (besides ``embed``). Without remat the
   block's saved tensors keep each layer's gathered unit alive until
   that layer's backward;
2. the backward reduce-scatters each unit's gradient over the fsdp ring
   (K14, as soon as the unit's gradient is whole) straight into this
   rank's chunk of the gradient row (``row``: the chunks in ``owned``'s
   order, a loss slot, zeros to whole lanes of the data ring); with
   fsdp = 1 it copies the gradient there. No parameter has a .grad;
3. with fused_norm under tp, sums the norm scales' gradients over the tp
   ring: K9's backward computes dscale = sum(xhat * dn) with dn = g
   w_r^T over this rank's columns only, so each rank holds a partial
   sum. The norm scales sit at the same offsets of every tp rank's row
   (tp shards have equal shapes), so the ranges of them in this rank's
   chunks are concatenated and all-reduced (ring_all_reduce) once;
4. sums the loss share over the fsdp ring (a ring_all_reduce of one
   element) into the loss slot, then all-reduces the row over the data
   ring, the dp x sp ranks with this rank's fsdp and tp indices
   (ring_all_reduce: K14 then K13; nothing when the ring has one rank);
5. runs AdamW on ``owned`` with the row's chunks as its gradient. No
   gather follows: the next forward gathers what it needs.

State export and import (workloads/checkpoint.py): ``state_pieces``
gives this rank's share of the global state as parallel/sharding.py
``Piece``s keyed by the state-dict names: of the fp32 parameters and of
AdamW's ``exp_avg`` and ``exp_avg_sq`` alike, the ranges of its chunks
(views of ``owned`` and of the optimizer state; one device: of each
parameter and its state), with AdamW's step count. ``load_state_pieces``
copies such pieces back into the existing tensors and creates AdamW's
state when no step has run yet (torch creates it lazily).
``state_dict`` gathers this rank's tp shard of every parameter whole.
Every ``step`` beats the task's progress file (agent/progress.py), as
the reference's step wrappers do.

Mixture of experts (``config.moe``; models/moe.py): the loss adds
``moe_aux_weight`` times the sum over the MoE layers of their aux, as the
reference's loss does. Each rank's aux is its tokens' share of the global
aux (the global density times its own tokens' probability sums over the
global token count), added to its loss share whole: the fsdp and data
rings' sums of the gradients and of the loss slot then give the
reference's aux gradient and value, the sum of the shares, neither the
share of one rank nor that sum times the ring's size. The ep ranks of a
data ring's member hold the same tokens and compute the same aux; they
are never summed with each other (the data ring has one ep index), so
the aux is not counted once per ep rank either. Expert weights are cut
over the ep ring (rank r holds experts [r E/ep, (r + 1) E/ep)) before the
fsdp units are laid out, so each ep rank's units, gradient row and AdamW
state hold its own experts; a replicated parameter's gradient is the same
on every ep rank, as on every tp rank (Megatron's f sums it over the ep
ring before it reaches them).

Apart from step 3, gradients are never summed over tp: a tp shard's
gradient is whole on its rank (the embedding's rows too: the
vocab-parallel lookup and loss give each rank its own rows' gradient),
and a replicated parameter's is the same on every tp rank (f's backward
sums the activation gradient before it reaches them). Weights are drawn
once at full shape from the seed (models/convert.init_params) and then
sharded, so every mesh starts from the same model.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional

import torch

from batch_shipyard_tpu_torch.agent import progress
from batch_shipyard_tpu_torch.device import resolve_device
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import moe as moe_mod
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.ops import ring_attention as ring
from batch_shipyard_tpu_torch.ops import ring_collectives
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import sharding


def row_length(owned: int, data: int = 1) -> int:
    """The gradient row's length: ``owned`` gradients, the loss slot,
    zeros to whole 16-byte fp32 lanes of every member of a data ring of
    ``data`` (K14's lanes, so its all-reduce needs no padding)."""
    lanes = sharding.LANE * data
    return -(-(owned + 1) // lanes) * lanes


class HeldState:
    """The checkpoint interface (workloads/checkpoint.py) of a harness
    with ``model``, ``optimizer``, ``mesh`` (None on one device) and
    ``state_kinds`` (sharding.STATE_KINDS for AdamW, SGD_STATE_KINDS):
    ``layout``, ``state_tensors``, ``held_pieces``, ``state_pieces`` and
    ``load_state_pieces`` over the pieces ``_piece_view`` names, by
    default whole parameters and their optimizer state."""

    @property
    def layout(self) -> tuple[dict, dict]:
        """(sizes, coords) of this rank's place on the mesh; one device
        is the mesh of one rank."""
        if self.mesh is None:
            sizes = mesh_mod.auto_axis_sizes(1)
            return sizes, mesh_mod.RankMesh(sizes, 0).coords
        return self.mesh.sizes, self.mesh.coords

    def state_tensors(self) -> dict[str, tuple[tuple, torch.dtype]]:
        """Every parameter's global shape and dtype, in parameter
        order."""
        sizes = self.layout[0]
        return {name: (sharding.global_shape(name, p.shape, sizes["tp"],
                                             sizes["ep"]), p.dtype)
                for name, p in self.model.named_parameters()}

    @functools.cached_property
    def _named(self) -> dict:
        return dict(self.model.named_parameters())

    def _piece_view(self, piece) -> torch.Tensor:
        """The live tensor elements a held piece names (a view)."""
        param = self._named[piece.key]
        flat = (param.detach() if piece.kind == "param"
                else self.optimizer.state[param][piece.kind])
        return flat.view(-1)[piece.lo:piece.hi]

    def held_pieces(self) -> list:
        """The parallel/sharding.py pieces of the global state this rank
        holds."""
        sizes, coords = self.layout
        shapes = {name: shape
                  for name, (shape, _) in self.state_tensors().items()}
        return sharding.held_pieces(shapes, sizes, coords, self.state_kinds)

    def state_pieces(self) -> dict:
        """{"step": the optimizer's step count, "pieces": {Piece: a view
        of the live tensor}} for every piece this rank holds; the
        optimizer's state is zeros before the first update."""
        self._ensure_state()
        return {"step": self.optimizer_step,
                "pieces": {piece: self._piece_view(piece)
                           for piece in self.held_pieces()}}

    def _ensure_state(self) -> None:
        """The optimizer's state as torch creates it at the first update:
        zero moments (AdamW, with a 0-d step count on the host) or a zero
        momentum buffer (SGD, whose first update from it is torch's first
        one: the gradient)."""
        group = self.optimizer.param_groups[0]
        for p in group["params"]:
            state = self.optimizer.state[p]
            if state:
                continue
            if "exp_avg" in self.state_kinds:
                state["step"] = torch.tensor(0.0)
            for kind in self.state_kinds[1:]:
                state[kind] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def load_state_pieces(self, pieces: Mapping, step: int) -> None:
        """Copy every held piece (``pieces``: Piece -> tensor, anywhere)
        into the live parameters and optimizer state, and set AdamW's
        step count. Raises unless ``pieces`` holds exactly this rank's
        pieces."""
        held = self.held_pieces()
        if set(pieces) != set(held):
            missing = sorted(set(held) - set(pieces))[:3]
            raise ValueError(f"state pieces do not match this rank's: "
                             f"missing {missing}")
        self._ensure_state()
        for piece in held:
            self._piece_view(piece).copy_(pieces[piece])
        for state in self.optimizer.state.values():
            if "step" in state:
                state["step"].fill_(float(step))


class TrainHarness(HeldState):
    """A model and its AdamW state on one device, or this rank's share
    of them over a ``mesh``. ``step(batch)`` runs one forward, backward
    and optimizer update on the global batch and returns ``{"loss": 0-d
    tensor}`` (the global mean loss) without waiting for the device
    (``float`` of the loss syncs). A ring timeout raises at the next ring
    launch, or at ``mesh.check()`` after a synchronise. Over a mesh the
    model's parameters (its tp shard) go into this rank's fsdp chunks
    and onto ``meta`` (the module doc)."""

    state_kinds = sharding.STATE_KINDS

    def __init__(self, model: tfm.TransformerLM, batch_size: int,
                 seq_len: int, learning_rate: float = 3e-4,
                 loss_impl: str = "auto",
                 mesh: Optional[mesh_mod.RankMesh] = None) -> None:
        self.model = model
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.loss_impl = loss_impl
        self.device = model.embed.embedding.device
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.units = None
        if self.mesh is None:
            trained = list(model.parameters())
        else:
            sizes = self.mesh.sizes
            if seq_len % sizes["sp"]:
                raise ValueError(f"seq_len {seq_len} is not divisible by "
                                 f"sp={sizes['sp']}")
            if batch_size % self.mesh.data_size:
                raise ValueError(
                    f"batch {batch_size} is not divisible by dp * fsdp = "
                    f"{self.mesh.data_size}")
            trained = [self._shard()]
        self.optimizer = torch.optim.AdamW(
            trained, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=0.01)

    def _shard(self) -> torch.Tensor:
        """This rank's chunk of every unit into ``owned`` (returned, the
        tensor AdamW updates), the gradient row, and per unit a leaf
        chunk (a view of ``owned``) and a sink (a view of the row); the
        model's parameters go onto meta."""
        params = {name: p.detach()
                  for name, p in self.model.named_parameters()}
        dtypes = {t.dtype for t in params.values()}
        if dtypes != {torch.float32}:
            raise ValueError(f"the mesh step keeps fp32 parameters, got "
                             f"{dtypes}")
        fsdp, index = self.mesh.sizes["fsdp"], self.mesh.coords["fsdp"]
        self.units = sharding.fsdp_units(
            {name: t.shape for name, t in params.items()}, fsdp)
        self._unit = {unit.name: unit for unit in self.units}
        self.owned_length = sum(unit.chunk for unit in self.units)
        data = self.mesh.groups["data"]
        owned = torch.empty(self.owned_length, device=self.device)
        self.row = torch.zeros(row_length(self.owned_length,
                                          1 if data is None else data.size),
                               device=self.device)
        self._chunks, self._sinks, self._owned_at = {}, {}, {}
        at = 0
        for unit in self.units:
            lo, hi = unit.span(index)
            owned[at:at + unit.chunk] = unit.flatten(params)[lo:hi]
            self._chunks[unit.name] = \
                owned[at:at + unit.chunk].detach().requires_grad_()
            self._sinks[unit.name] = self.row[at:at + unit.chunk]
            for name, _, offset in unit.params:
                self._owned_at[name] = at + offset - lo
            at += unit.chunk
        self.model.to("meta")
        # Step 3 of the module doc: this rank's ranges of the fused norm
        # scales in ``owned`` (the same on every tp rank).
        self._tp_partial = []
        if self.model.config.fused_norm:
            for piece in self.held_pieces():
                if piece.kind == "param" and \
                        piece.key.endswith("norm_scale"):
                    at = self._owned_at[piece.key]
                    self._tp_partial.append((at + piece.lo, at + piece.hi))
        return owned

    @property
    def resident_param_bytes(self) -> int:
        """The bytes of parameters this rank holds between steps: its
        chunks (lane padding included), or the whole model on one
        device."""
        if self.units is None:
            return sum(p.numel() * p.element_size()
                       for p in self.model.parameters())
        return self.owned_length * 4

    def gather(self, unit: str) -> dict:
        """Unit ``unit``'s parameters, {state-dict name: tensor}, as views
        of its flat gathered over the fsdp ring (step 1 of the module
        doc), differentiable into the gradient row."""
        flat = ring_collectives.fsdp_gather(
            self._chunks[unit], self.mesh.groups["fsdp"], self._sinks[unit])
        return self._unit[unit].views(flat)

    def loss_fn(self, tokens, targets, positions=None, share=None):
        """The mean loss of these tokens' targets, times ``share`` when
        given, plus moe_aux_weight times the MoE layers' aux shares (the
        module doc)."""
        config = self.model.config
        if self.units is None:
            hidden, aux = self.model(tokens, positions=positions,
                                     return_hidden=True, return_aux=True)
            embedding = self.model.embed.embedding
        else:
            # Gathered once, for the lookup, the final norm and the loss.
            head = self.gather("embed")
            hidden, aux = self.model(
                tokens, positions=positions, return_hidden=True,
                return_aux=True, params=lambda unit: head
                if unit == "embed" else self.gather(unit))
            embedding = head["embed.embedding"]
        loss = tfm.lm_loss_chunked(hidden, embedding, targets,
                                   impl=self.loss_impl,
                                   tp_group=config.tp_group)
        if share is not None:
            loss = loss * share
        if aux is not None:
            loss = loss + config.moe_aux_weight * aux
        return loss

    def sum_tp_partial_grads(self) -> None:
        """Step 3 of the module doc: the fused norm scales' gradients in
        the row summed over the tp ring, in place (nothing without
        fused_norm or tp). Every rank makes the one call, also where its
        chunks hold no norm scale."""
        config = self.model.config
        if not (config.fused_norm and config.tp > 1):
            return
        parts = [self.row[lo:hi] for lo, hi in self._tp_partial]
        summed = ring_collectives.ring_all_reduce(
            torch.cat(parts) if parts else self.row[:0], config.tp_group)
        for part, total in zip(parts, summed.split(
                [p.numel() for p in parts])):
            part.copy_(total)

    def shard(self, tokens, targets):
        """This rank's block of the global batch: (tokens, targets,
        positions, its share of the loss), the share being the block's
        target count over the global one."""
        sizes, coords = self.mesh.sizes, self.mesh.coords
        rows = self.batch_size // self.mesh.data_size
        width = self.seq_len // sizes["sp"]
        r0, c0 = self.mesh.data_index * rows, coords["sp"] * width
        block = (slice(r0, r0 + rows), slice(c0, c0 + width))
        positions = torch.arange(c0, c0 + width, dtype=torch.int32,
                                 device=self.device)
        local = targets[block]
        share = ((local != -1).sum().clamp(min=1).float() /
                 (targets != -1).sum().clamp(min=1).float())
        return tokens[block], local, positions, share

    def sum_grads(self, loss) -> tuple[torch.Tensor, torch.Tensor]:
        """Steps 3-4 of the module doc, after the backward of ``loss``
        (this rank's share): this rank's owned gradients and the loss,
        each summed over the fsdp and data ranks (the loss a copy: a view
        would keep the whole row alive as long as the caller keeps the
        loss)."""
        groups = self.mesh.groups
        self.sum_tp_partial_grads()
        share = loss.detach().reshape(1).float()
        if groups["fsdp"] is not None:
            share = ring_collectives.ring_all_reduce(share, groups["fsdp"])
        n = self.owned_length
        self.row[n:n + 1] = share
        row = ring_collectives.ring_all_reduce(self.row, groups["data"])
        return row[:n], row[n].clone()

    def step(self, batch: Mapping) -> dict:
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        targets = torch.as_tensor(batch["targets"], device=self.device)
        want = (self.batch_size, self.seq_len)
        if tuple(tokens.shape) != want or tuple(targets.shape) != want:
            raise ValueError(
                f"batch of {tuple(tokens.shape)} tokens and "
                f"{tuple(targets.shape)} targets; the harness was built "
                f"for {want}")
        self.optimizer.zero_grad(set_to_none=True)
        if self.mesh is None:
            loss = self.loss_fn(tokens, targets)
            loss.backward()
            self.optimizer.step()
            progress.beat()
            return {"loss": loss.detach()}
        # A unit whose gradient never arrived counts as zeros.
        self.row[:self.owned_length].zero_()
        tokens, targets, positions, share = self.shard(tokens, targets)
        loss = self.loss_fn(tokens, targets, positions, share)
        loss.backward()
        owned, = self.optimizer.param_groups[0]["params"]
        owned.grad, loss = self.sum_grads(loss)
        self.optimizer.step()
        progress.beat()
        return {"loss": loss}

    @torch.no_grad()
    def state_dict(self) -> dict:
        """This rank's tp shard of every parameter, whole, in state-dict
        order (copies). Over a mesh every unit is gathered over the fsdp
        ring: every rank of the ring must call it."""
        if self.units is None:
            return {name: t.clone()
                    for name, t in self.model.state_dict().items()}
        group, out = self.mesh.groups["fsdp"], {}
        for unit in self.units:
            chunk = self._chunks[unit.name].detach()
            flat = (chunk if group is None else
                    ring_collectives.ring_all_gather(chunk, group))
            out.update({name: t.clone()
                        for name, t in unit.views(flat).items()})
        return {name: out[name] for name, _ in self.model.named_parameters()}

    # ---------------------------- checkpoints ----------------------------

    @property
    def optimizer_step(self) -> int:
        """AdamW's step count (0 before the first update)."""
        for state in self.optimizer.state.values():
            return int(state["step"])
        return 0

    def _piece_view(self, piece) -> torch.Tensor:
        if self.units is None:
            return super()._piece_view(piece)
        owned, = self.optimizer.param_groups[0]["params"]
        flat = owned if piece.kind == "param" else \
            self.optimizer.state[owned][piece.kind]
        at = self._owned_at[piece.key]
        return flat[at + piece.lo:at + piece.hi]


def sequence_parallel_group(sp: int, device, world: Optional[int] = None
                            ) -> Optional[mesh_mod.RingGroup]:
    """This rank's ring of ``sp`` ranks, or None for sp == 1. With world
    / sp = dp > 1 it is one of dp such rings (the sp role of
    mesh.RankMesh.build); a step over them needs the whole mesh, so pass
    that to build_transformer_train."""
    if sp == 1:
        return None
    return mesh_mod.RankMesh.build(device, sp=sp, world=world,
                                   roles=("sp",)).groups["sp"]


def make_transformer_config(sp: int = 1,
                            group: Optional[mesh_mod.RingGroup] = None,
                            mesh: Optional[mesh_mod.RankMesh] = None,
                            **overrides) -> tfm.TransformerConfig:
    """A TransformerConfig whose attention and tensor parallelism match
    the mesh: with ``sp > 1``, ring attention (ops/ring_attention, its
    ``auto`` tier) over ``group`` (a RingGroup of sp ranks, by default
    the mesh's sp ring); with the mesh's tp > 1, Megatron tp over its tp
    ring; with ``moe``, the MoE layers' experts over its ep ring and their
    routing over its tokens ring (a mesh built with mesh.MOE_ROLES), or
    over ``group`` where that spans the world. ``overrides``
    (``fused_norm``, ``quantize_matmuls`` and ``moe`` among them) pass
    through."""
    attention_fn = overrides.pop("attention_fn", None)
    moe = overrides.get("moe") is not None
    if mesh is not None:
        sp = mesh.sizes["sp"]
        group = group or mesh.groups["sp"]
        overrides.setdefault("tp_group", mesh.groups["tp"])
        overrides.setdefault("ep_group", mesh.groups["ep"])
        tokens = mesh.groups.get("tokens")
        if moe and mesh.world > 1 and tokens is None and \
                mesh.data_size * sp > 1:
            raise ValueError("a MoE model's mesh needs its tokens ring "
                             "(RankMesh.build(roles=MOE_ROLES))")
        if moe and tokens is not None:
            overrides.setdefault("token_ranks",
                                 moe_mod.TokenRanks(tokens, sp))
    if sp > 1:
        if group is None or group.size != sp:
            raise ValueError(f"sp={sp} needs a RingGroup of {sp} ranks "
                             f"(sequence_parallel_group)")
        if moe and mesh is None:
            # An sp ring over the world: its ranks hold the tokens.
            overrides.setdefault("token_ranks",
                                 moe_mod.TokenRanks(group, sp))
        if attention_fn is None:
            attention_fn = functools.partial(ring.ring_attention,
                                             group=group)
    return tfm.TransformerConfig(attention_fn=attention_fn, **overrides)


def build_transformer_train(config: tfm.TransformerConfig,
                            batch_size: int, seq_len: int,
                            learning_rate: float = 3e-4, seed: int = 0,
                            device=None,
                            params: Optional[Mapping] = None,
                            loss_impl: str = "auto",
                            group: Optional[mesh_mod.RingGroup] = None,
                            mesh: Optional[mesh_mod.RankMesh] = None
                            ) -> TrainHarness:
    """The model on ``device`` (cuda unless "cpu" is named) with
    ``params`` (a full state dict, e.g. models.convert.params_from_flax)
    or weights drawn from ``seed`` (convert.init_params, the same on every
    rank), this rank's tp shard of them (parallel/sharding), and AdamW.
    ``loss_impl``: lm_loss_chunked's impl ('auto', 'kernel' or 'plain').
    ``mesh``: the RankMesh the config was made for
    (make_transformer_config); ``group``: an sp ring over the whole world
    instead (RankMesh.of_sp_group). Neither: one device."""
    if config.decode:
        raise ValueError("training needs decode=False")
    device = resolve_device(device)
    if mesh is None and group is not None:
        mesh = mesh_mod.RankMesh.of_sp_group(group)
    if params is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        params = convert.init_params(config, generator)
    if mesh is not None:
        if mesh.groups["tp"] is not config.tp_group or \
                mesh.groups["ep"] is not config.ep_group:
            raise ValueError("the config's tp_group or ep_group is not the "
                             "mesh's ring (make_transformer_config(mesh=...))")
        params = sharding.shard_state_dict(params, mesh)
    model = tfm.TransformerLM(config, device="meta")
    model.load_state_dict({name: t.to(device, copy=True)
                           for name, t in params.items()}, assign=True)
    return TrainHarness(model.train(), batch_size, seq_len, learning_rate,
                        loss_impl, mesh)


# ------------------------------ vision ------------------------------


class VisionHarness(HeldState):
    """A vision model and its optimizer on one device, or one replica over
    the data ring of a dp ``mesh`` (every rank holds the whole model and
    optimizer state; build_resnet_train / build_vit_train /
    build_diffusion_train). ``step(batch)`` takes this rank's rows of the
    global batch (``local_batch`` of ``batch_size``), runs the forward
    and backward of its share of the global mean loss, all-reduces the
    gradients and the loss over the data ring (one ring_all_reduce of one
    fp32 row: K14 then K13 on the card) and runs the optimizer; it
    returns ``{"loss": 0-d tensor}``, the global mean, without waiting
    for the device. A dp run on N ranks equals a one-rank run on the same
    global batch (each sum over ranks is one ring all-reduce, which every
    member gets bit for bit, so the replicas stay equal). ``loss_fn(self,
    batch)`` gives this rank's share. The checkpoint interface is
    HeldState's, over the optimizer's state kinds (``state_kinds``)."""

    def __init__(self, model: torch.nn.Module, optimizer, loss_fn,
                 batch_size: int, state_kinds,
                 mesh: Optional[mesh_mod.RankMesh] = None) -> None:
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.batch_size = batch_size
        self.state_kinds = state_kinds
        self.device = next(model.parameters()).device
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.group = None if self.mesh is None else self.mesh.groups["data"]
        world = 1 if self.mesh is None else self.mesh.world
        if batch_size % world:
            raise ValueError(f"batch {batch_size} is not divisible by dp = "
                             f"{world}")
        self.local_batch = batch_size // world
        # The data index's rows of the global batch.
        self.row0 = (0 if self.mesh is None else
                     self.mesh.data_index * self.local_batch)
        self.steps = 0
        self.grad_all_reduces = 0

    def step(self, batch: Mapping) -> dict:
        rows = len(next(iter(batch.values())))
        if rows != self.local_batch:
            raise ValueError(f"a batch of {rows} rows; this rank trains "
                             f"{self.local_batch} of {self.batch_size}")
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self, batch)
        loss.backward()
        loss = loss.detach()
        if self.group is not None:
            loss = self._sum_grads(loss)
        self.optimizer.step()
        self.steps += 1
        progress.beat()
        return {"loss": loss}

    def _sum_grads(self, loss: torch.Tensor) -> torch.Tensor:
        """Every parameter's gradient and the loss share, summed over the
        data ring in one row; the gradients become views of the sum."""
        params = list(self.model.parameters())
        row = torch.cat([(p.grad if p.grad is not None
                          else torch.zeros_like(p)).reshape(-1)
                         for p in params] + [loss.float().reshape(1)])
        row = ring_collectives.ring_all_reduce(row, self.group)
        self.grad_all_reduces += 1
        parts = row.split([p.numel() for p in params] + [1])
        for p, g in zip(params, parts):
            p.grad = g.view(p.shape)
        return parts[-1].reshape(()).clone()

    @torch.no_grad()
    def state_dict(self) -> dict:
        """Parameters and buffers (ResNet's running statistics), copies."""
        return {name: t.clone() for name, t in self.model.state_dict().items()}

    # ---------------------------- checkpoints ----------------------------

    @property
    def optimizer_step(self) -> int:
        """The optimizer's step count (SGD keeps none of its own)."""
        return self.steps

    def load_state_pieces(self, pieces: Mapping, step: int) -> None:
        super().load_state_pieces(pieces, step)
        self.steps = int(step)


def _vision_model(model: torch.nn.Module, init, seed: int, device,
                  params: Optional[Mapping]) -> torch.nn.Module:
    """``model`` (built on ``device``) with ``params`` (a state dict,
    e.g. models.convert.params_from_flax, buffers optional) or weights
    drawn by ``init`` from a generator seeded with ``seed`` (the same on
    every rank)."""
    if params is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        init(model, generator)
        return model
    missing, unexpected = model.load_state_dict(
        {name: torch.as_tensor(t) for name, t in params.items()},
        strict=False)
    buffers = {name for name, _ in model.named_buffers()}
    if unexpected or set(missing) - buffers:
        raise ValueError(f"params do not fit the model: missing "
                         f"{sorted(set(missing) - buffers)[:4]}, unexpected "
                         f"{sorted(unexpected)[:4]}")
    return model


def local_rows(harness: VisionHarness, tensor: torch.Tensor
                ) -> torch.Tensor:
    """This rank's rows of a tensor drawn for the global batch."""
    return tensor[harness.row0:harness.row0 + harness.local_batch]


def build_resnet_train(config=None, batch_size: int = 256,
                       learning_rate: float = 0.1, seed: int = 0,
                       device=None, params: Optional[Mapping] = None,
                       mesh: Optional[mesh_mod.RankMesh] = None
                       ) -> VisionHarness:
    """Data-parallel ResNet-50 training (the baseline workload):
    ``optax.sgd(0.1, momentum=0.9, nesterov=True)`` as torch's
    ``SGD(nesterov=True)`` (dampening 0: the same first and later steps),
    the running statistics as model buffers updated by every training
    forward (the reference carries its ``batch_stats`` beside the step;
    here they are harness state, outside the checkpoint, as in the
    reference). Over a dp ``mesh`` the batch norms sync their statistics
    over the data ring (models/resnet.py). Batch: {"images": [B, H, W, 3],
    "labels": [B]} of this rank's rows."""
    from batch_shipyard_tpu_torch.models import resnet as resnet_mod
    config = config or resnet_mod.ResNetConfig()
    device = resolve_device(device)
    model = _vision_model(resnet_mod.ResNet(config, device=device),
                          resnet_mod.init_params, seed, device, params)
    mesh = mesh if mesh is not None and mesh.world > 1 else None
    model.set_sync_group(None if mesh is None else mesh.groups["data"])
    optimizer = torch.optim.SGD(model.parameters(), lr=learning_rate,
                                momentum=0.9, nesterov=True)

    def loss_fn(harness, batch):
        logits = harness.model(batch["images"], train=True)
        return resnet_mod.cross_entropy_loss(logits, batch["labels"],
                                             harness.batch_size)
    return VisionHarness(model.train(), optimizer, loss_fn, batch_size,
                         sharding.SGD_STATE_KINDS, mesh)


def build_vit_train(config=None, batch_size: int = 256,
                    learning_rate: float = 1e-3, seed: int = 0,
                    device=None, params: Optional[Mapping] = None,
                    mesh: Optional[mesh_mod.RankMesh] = None
                    ) -> VisionHarness:
    """ViT image-classification training, data parallel:
    ``optax.adamw(1e-3, weight_decay=0.05)`` on every parameter, fp32
    parameters, bf16 compute. Batch as build_resnet_train's."""
    from batch_shipyard_tpu_torch.models import vit as vit_mod
    config = config or vit_mod.ViTConfig()
    device = resolve_device(device)
    model = _vision_model(vit_mod.ViT(config, device=device),
                          vit_mod.init_params, seed, device, params)
    optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.05)

    def loss_fn(harness, batch):
        return vit_mod.cross_entropy_loss(harness.model(batch["images"]),
                                          batch["labels"],
                                          harness.batch_size)
    return VisionHarness(model.train(), optimizer, loss_fn, batch_size,
                         sharding.STATE_KINDS, mesh)


def diffusion_step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s timesteps and noise: seeded from
    ``seed + 1`` and the step counter (the reference folds its counter
    into PRNGKey(seed + 1))."""
    generator = torch.Generator(device=device)
    generator.manual_seed(((seed + 1) << 32) + step)
    return generator


def build_diffusion_train(config=None, batch_size: int = 256,
                          learning_rate: float = 1e-4, seed: int = 0,
                          device=None, params: Optional[Mapping] = None,
                          mesh: Optional[mesh_mod.RankMesh] = None
                          ) -> VisionHarness:
    """DiT denoising-diffusion training, data parallel:
    ``optax.adamw(1e-4, weight_decay=0.0)``. Each step draws the global
    batch's timesteps and noise from diffusion_step_generator(seed,
    counter) and trains this rank's rows of them; the counter starts at
    0 in each process, as the reference's does (a resumed run draws its
    first step's noise anew). Batch: {"images": [B, H, W, C] in [-1, 1],
    optional "labels": [B]} of this rank's rows."""
    from batch_shipyard_tpu_torch.models import diffusion as dif_mod
    config = config or dif_mod.DiTConfig()
    device = resolve_device(device)
    model = _vision_model(dif_mod.DiT(config, device=device),
                          dif_mod.init_params, seed, device, params)
    optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.0)
    counter = {"step": 0}

    def loss_fn(harness, batch):
        images = batch["images"]
        generator = diffusion_step_generator(seed, counter["step"], device)
        counter["step"] += 1
        t, noise = dif_mod.draw_loss_noise(
            config, (harness.batch_size, *images.shape[1:]), generator)
        return dif_mod.diffusion_loss(
            harness.model, images, labels=batch.get("labels"),
            t=local_rows(harness, t), noise=local_rows(harness, noise),
            denominator=harness.batch_size)
    return VisionHarness(model.train(), optimizer, loss_fn, batch_size,
                         sharding.STATE_KINDS, mesh)
