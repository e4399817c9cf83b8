"""Transformer training: model + AdamW -> a train step, on one card or
over a mesh of ranks.

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
sum over the data ranks (every rank with this rank's tp index) is the
global mean, which every rank reports. The reference leaves the sums to
XLA; the port's step, after the backward:

0. with fused_norm under tp, sums the norm scales' gradients over the tp
   ring (one ring_all_reduce of them all concatenated): K9's backward
   computes dscale = sum(xhat * dn) with dn = g w_r^T over this rank's
   columns only, so each rank holds a partial sum;
1. builds one flat fp32 gradient bucket of fsdp rows, each a 1/fsdp
   chunk of the parameters followed by a loss slot that holds this
   rank's loss share (every row: the loss needs a place on every fsdp
   rank);
2. reduce-scatters it over the fsdp ring (K14), leaving this rank its
   row summed over fsdp (nothing with fsdp = 1);
3. all-reduces that row over the data ring, the dp x sp ranks with
   this rank's fsdp and tp indices (ring_all_reduce: K14 then K13;
   nothing when the ring has one rank);
4. runs AdamW on its chunk: this rank holds the AdamW state of its
   1/fsdp of the parameters only, and its fp32 parameters are a chunk
   of one flat buffer whose views are the model's parameters;
5. all-gathers the updated chunks over the fsdp ring (K13) into that
   flat buffer (nothing with fsdp = 1).

State export and import (workloads/checkpoint.py): ``state_pieces``
gives this rank's share of the global state as parallel/sharding.py
``Piece``s keyed by the state-dict names: its tp shard of every fp32
parameter whole, and of AdamW's ``exp_avg`` and ``exp_avg_sq`` the
per-tensor flat ranges of its fsdp chunk (views of the optimizer state
of the chunk; one device: of each parameter's state), with AdamW's step
count. ``load_state_pieces`` copies such pieces back into the existing
tensors, so the parameters stay views of the flat buffer, and creates
AdamW's per-tensor state when no step has run yet (torch creates it
lazily). Every ``step`` beats the task's progress file
(agent/progress.py), as the reference's step wrappers do.

Apart from step 0, gradients are never summed over tp: a tp shard's
gradient is whole on its rank (the embedding's rows too: the
vocab-parallel lookup and loss give each rank its own rows' gradient),
and a replicated parameter's is the same on every tp rank (f's backward
sums the activation gradient before it reaches them).
Every rank holds the whole (tp-sharded) parameters during the step;
gathering them layer by layer is not ported yet (ROADMAP). Weights are
drawn once at full shape from the seed (models/convert.init_params) and
then sharded, so every mesh starts from the same model.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional

import torch

from batch_shipyard_tpu_torch.agent import progress
from batch_shipyard_tpu_torch.device import resolve_device
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.ops import ring_attention as ring
from batch_shipyard_tpu_torch.ops import ring_collectives
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import sharding


def bucket_layout(n_params: int, fsdp: int = 1, data: int = 1
                  ) -> tuple[int, int]:
    """(chunk, row): each of the fsdp rows of the gradient bucket holds
    ``chunk`` parameters (1/fsdp of them, in 16-byte lanes) and the loss
    slot, padded to ``row``, a multiple of 4 * data fp32 elements (K14's
    lanes over the data ring, so its all-reduce needs no padding)."""
    chunk = sharding.fsdp_chunk(n_params, fsdp)
    return chunk, -(-(chunk + 1) // (4 * data)) * (4 * data)


class TrainHarness:
    """A model and its AdamW state on one device, or this rank's share
    of them over a ``mesh``. ``step(batch)`` runs one forward, backward
    and optimizer update on the global batch and returns ``{"loss": 0-d
    tensor}`` (the global mean loss) without waiting for the device
    (``float`` of the loss syncs). A ring timeout raises at the next ring
    launch, or at ``mesh.check()`` after a synchronise."""

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
        self.params = list(model.parameters())
        # Step 0 of the module doc: the fused norm scales under tp.
        self.tp_partial = [p for name, p in model.named_parameters()
                           if name.endswith("norm_scale")] \
            if model.config.tp > 1 else []
        if self.mesh is None:
            trained = self.params
        else:
            sizes = self.mesh.sizes
            if seq_len % sizes["sp"]:
                raise ValueError(f"seq_len {seq_len} is not divisible by "
                                 f"sp={sizes['sp']}")
            if batch_size % self.mesh.data_size:
                raise ValueError(
                    f"batch {batch_size} is not divisible by dp * fsdp = "
                    f"{self.mesh.data_size}")
            trained = [self._flatten()]
        self.optimizer = torch.optim.AdamW(
            trained, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=0.01)

    def _flatten(self) -> torch.Tensor:
        """Move every parameter into one flat fp32 buffer of fsdp chunks
        (the parameters become views of it); returns this rank's chunk,
        the tensor AdamW updates."""
        dtypes = {p.dtype for p in self.params}
        if dtypes != {torch.float32}:
            raise ValueError(f"the mesh step keeps fp32 parameters, got "
                             f"{dtypes}")
        fsdp = self.mesh.sizes["fsdp"]
        data = self.mesh.groups["data"]
        self.n_params = sum(p.numel() for p in self.params)
        self.chunk, self.row = bucket_layout(
            self.n_params, fsdp, 1 if data is None else data.size)
        self.flat = torch.zeros(fsdp * self.chunk, device=self.device)
        offset = 0
        for p in self.params:
            view = self.flat[offset:offset + p.numel()].view_as(p)
            view.copy_(p.detach())
            p.data = view
            offset += p.numel()
        start = self.mesh.coords["fsdp"] * self.chunk
        return self.flat[start:start + self.chunk]

    def loss_fn(self, tokens, targets, positions=None):
        hidden = self.model(tokens, positions=positions, return_hidden=True)
        return tfm.lm_loss_chunked(hidden, self.model.embed.embedding,
                                   targets, impl=self.loss_impl,
                                   tp_group=self.model.config.tp_group)

    def sum_tp_partial_grads(self) -> None:
        """Step 0 of the module doc: the fused norm scales' gradients
        summed over the tp ring, in place (nothing without fused_norm or
        tp)."""
        grads = [p.grad for p in self.tp_partial]
        if not grads:
            return
        summed = ring_collectives.ring_all_reduce(
            torch.cat([g.reshape(-1) for g in grads]),
            self.model.config.tp_group)
        for g, part in zip(grads, summed.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

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

    def _bucket(self, loss) -> torch.Tensor:
        """The flat gradient bucket (step 1 of the module doc): fsdp rows
        of ``chunk`` gradients, each followed by this rank's ``loss`` and
        zeros to ``row``, in one copy. Drops the parameters' .grad."""
        fsdp = self.mesh.sizes["fsdp"]
        tail = torch.cat([loss.detach().reshape(1).float(),
                          loss.new_zeros(self.row - self.chunk - 1,
                                         dtype=torch.float32)])
        pieces, end, offset = [], self.chunk, 0
        for p in self.params:
            g = (p.grad if p.grad is not None else
                 torch.zeros_like(p)).reshape(-1)
            start = 0
            while start < g.numel():
                take = min(g.numel() - start, end - offset)
                pieces.append(g[start:start + take])
                start += take
                offset += take
                if offset == end:
                    pieces.append(tail)
                    end += self.chunk
        if offset < fsdp * self.chunk:
            pieces += [tail.new_zeros(fsdp * self.chunk - offset), tail]
        bucket = torch.cat(pieces)
        for p in self.params:
            p.grad = None
        return bucket

    def sum_grads(self, loss) -> tuple[torch.Tensor, torch.Tensor]:
        """Steps 0-3 of the module doc: this rank's chunk of the gradients
        and the loss, each summed over the data ranks (the loss a copy: a
        view would keep the whole row alive as long as the caller keeps
        the loss)."""
        groups = self.mesh.groups
        self.sum_tp_partial_grads()
        row = self._bucket(loss)
        if groups["fsdp"] is not None:
            row = ring_collectives.ring_reduce_scatter(row, groups["fsdp"])
        row = ring_collectives.ring_all_reduce(row, groups["data"])
        return row[:self.chunk], row[self.chunk].clone()

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
        tokens, targets, positions, share = self.shard(tokens, targets)
        loss = self.loss_fn(tokens, targets, positions) * share
        loss.backward()
        owned, = self.optimizer.param_groups[0]["params"]
        owned.grad, loss = self.sum_grads(loss)
        self.optimizer.step()
        fsdp = self.mesh.groups["fsdp"]
        if fsdp is not None:
            ring_collectives.ring_all_gather(owned, fsdp, out=self.flat)
        progress.beat()
        return {"loss": loss}

    # ---------------------------- checkpoints ----------------------------

    @property
    def layout(self) -> tuple[dict, dict]:
        """(sizes, coords) of this rank's place on the mesh; one device
        is the mesh of one rank."""
        if self.mesh is None:
            sizes = mesh_mod.auto_axis_sizes(1)
            return sizes, mesh_mod.RankMesh(sizes, 0).coords
        return self.mesh.sizes, self.mesh.coords

    def state_tensors(self) -> dict[str, tuple[tuple, torch.dtype]]:
        """Every parameter's global shape and dtype, in parameter order
        (the flat bucket's)."""
        tp = self.layout[0]["tp"]
        return {name: (sharding.global_shape(name, p.shape, tp), p.dtype)
                for name, p in self.model.named_parameters()}

    @property
    def optimizer_step(self) -> int:
        """AdamW's step count (0 before the first update)."""
        for state in self.optimizer.state.values():
            return int(state["step"])
        return 0

    def _piece_view(self, piece) -> torch.Tensor:
        """The live tensor elements a held piece names (a view)."""
        param = self._named[piece.key]
        if piece.kind == "param":
            return param.detach().view(-1)[piece.lo:piece.hi]
        if self.mesh is None:
            state = self.optimizer.state[param]
            return state[piece.kind].view(-1)[piece.lo:piece.hi]
        owned, = self.optimizer.param_groups[0]["params"]
        at = self._offsets[piece.key] - self.mesh.coords["fsdp"] * self.chunk
        return self.optimizer.state[owned][piece.kind][
            at + piece.lo:at + piece.hi]

    @functools.cached_property
    def _named(self) -> dict:
        return dict(self.model.named_parameters())

    @functools.cached_property
    def _offsets(self) -> dict:
        offsets, at = {}, 0
        for name, p in self._named.items():
            offsets[name] = at
            at += p.numel()
        return offsets

    def held_pieces(self) -> list:
        """The parallel/sharding.py pieces of the global state this rank
        holds."""
        sizes, coords = self.layout
        shapes = {name: shape
                  for name, (shape, _) in self.state_tensors().items()}
        return sharding.held_pieces(shapes, sizes, coords)

    def state_pieces(self) -> dict:
        """{"step": AdamW's step count, "pieces": {Piece: a view of the
        live tensor}} for every piece this rank holds; the moments are
        zeros before the first update."""
        self._ensure_state()
        return {"step": self.optimizer_step,
                "pieces": {piece: self._piece_view(piece)
                           for piece in self.held_pieces()}}

    def _ensure_state(self) -> None:
        """AdamW's state as torch creates it at the first update: zero
        moments and a 0-d step count on the host."""
        group = self.optimizer.param_groups[0]
        for p in group["params"]:
            state = self.optimizer.state[p]
            if not state:
                state["step"] = torch.tensor(0.0)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def load_state_pieces(self, pieces: Mapping, step: int) -> None:
        """Copy every held piece (``pieces``: Piece -> tensor, anywhere)
        into the live parameters and AdamW state, and set AdamW's step
        count. Raises unless ``pieces`` holds exactly this rank's
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
            state["step"].fill_(float(step))


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
    ring. ``overrides`` (``fused_norm`` and ``quantize_matmuls`` among
    them) pass through."""
    attention_fn = overrides.pop("attention_fn", None)
    if mesh is not None:
        sp = mesh.sizes["sp"]
        group = group or mesh.groups["sp"]
        overrides.setdefault("tp_group", mesh.groups["tp"])
    if sp > 1:
        if group is None or group.size != sp:
            raise ValueError(f"sp={sp} needs a RingGroup of {sp} ranks "
                             f"(sequence_parallel_group)")
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
        if mesh.groups["tp"] is not config.tp_group:
            raise ValueError("the config's tp_group is not the mesh's tp "
                             "ring (make_transformer_config(mesh=...))")
        params = sharding.shard_state_dict(params, mesh)
    model = tfm.TransformerLM(config, device="meta")
    model.load_state_dict({name: t.to(device, copy=True)
                           for name, t in params.items()}, assign=True)
    return TrainHarness(model.train(), batch_size, seq_len, learning_rate,
                        loss_impl, mesh)

