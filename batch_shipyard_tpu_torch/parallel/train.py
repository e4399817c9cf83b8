"""Transformer training: model + AdamW -> a train step, on one card or
over a sequence-parallel ring of ranks.

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

Sequence parallelism (``sp > 1``, the reference's batch sharding
``P(("dp", "fsdp"), "sp")`` with dp = fsdp = 1): every rank holds the
whole model and draws the same global batch; rank r trains on sequence
shard r with its global RoPE positions, through ring attention over a
``parallel.mesh.RingGroup``. Each rank's loss is its shard's loss sum
over the global count of targets, so the ranks' losses and gradients sum
to the global mean's. The reference leaves that sum to XLA; the port
sums the gradients (and the loss) in one flat fp32 bucket with its own
ring all-reduce, reduce-scatter K14 then all-gather K13, before AdamW,
so every rank takes the same step. dp > 1, tp, fsdp, MoE and AOT
precompilation are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from batch_shipyard_tpu_torch.device import resolve_device
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.ops import ring_attention as ring
from batch_shipyard_tpu_torch.ops import ring_collectives
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod


class TrainHarness:
    """A model and its AdamW state on one device. ``step(batch)`` runs
    one forward, backward and optimizer update on the global batch and
    returns ``{"loss": 0-d tensor}`` (the global mean loss) without
    waiting for the device (``float`` of the loss syncs). With a ring
    ``group`` of sp ranks, the step trains this rank's sequence shard and
    all-reduces the gradients over the ring; a ring timeout raises at the
    next ring launch, or at ``group.check()`` after a synchronise."""

    def __init__(self, model: tfm.TransformerLM,
                 optimizer: torch.optim.Optimizer, batch_size: int,
                 seq_len: int, loss_impl: str = "auto",
                 group: Optional[mesh_mod.RingGroup] = None) -> None:
        self.model = model
        self.optimizer = optimizer
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.loss_impl = loss_impl
        self.device = model.embed.embedding.device
        self.group = group
        self.params = list(model.parameters())
        if group is not None and seq_len % group.size:
            raise ValueError(f"seq_len {seq_len} is not divisible by the "
                             f"sp ring of {group.size}")

    def loss_fn(self, tokens, targets, positions=None):
        hidden = self.model(tokens, positions=positions, return_hidden=True)
        return tfm.lm_loss_chunked(hidden, self.model.embed.embedding,
                                   targets, impl=self.loss_impl)

    def shard(self, tokens, targets):
        """This rank's sequence shard of the global batch: (tokens,
        targets, positions, its share of the loss), the share being the
        shard's target count over the global one."""
        sp, rank = self.group.size, self.group.rank
        width = self.seq_len // sp
        cols = slice(rank * width, (rank + 1) * width)
        positions = torch.arange(rank * width, (rank + 1) * width,
                                 dtype=torch.int32, device=self.device)
        local = targets[:, cols]
        share = ((local != -1).sum().clamp(min=1).float() /
                 (targets != -1).sum().clamp(min=1).float())
        return tokens[:, cols], local, positions, share

    def all_reduce_grads(self, loss) -> torch.Tensor:
        """Sum every parameter's gradient and ``loss`` over the ring in one
        fp32 bucket: reduce-scatter (K14) then all-gather (K13). The
        gradients become views of the summed bucket; returns the summed
        loss."""
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p))
                 .reshape(-1).float() for p in self.params]
        n = sum(g.numel() for g in grads)
        pad = bucket_size(n, self.group.size) - n - 1
        bucket = torch.cat(grads + [loss.detach().reshape(1).float(),
                                    loss.new_zeros(pad, dtype=torch.float32)])
        del grads
        summed = ring_collectives.ring_all_gather(
            ring_collectives.ring_reduce_scatter(bucket, self.group),
            self.group)
        offset = 0
        for p in self.params:
            p.grad = summed[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return summed[n]

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
        if self.group is None:
            loss = self.loss_fn(tokens, targets)
            loss.backward()
        else:
            tokens, targets, positions, share = self.shard(tokens, targets)
            loss = self.loss_fn(tokens, targets, positions) * share
            loss.backward()
            loss = self.all_reduce_grads(loss)
        self.optimizer.step()
        return {"loss": loss.detach()}


def bucket_size(n_params: int, ring: int) -> int:
    """Elements of the sp gradient all-reduce bucket: every parameter and
    the loss, padded to a multiple of 4 * ring (K14's chunk in 16-byte
    lanes)."""
    return -(-(n_params + 1) // (4 * ring)) * (4 * ring)


def sequence_parallel_group(sp: int, device, world: Optional[int] = None
                            ) -> Optional[mesh_mod.RingGroup]:
    """The ring of ``sp`` ranks over the default process group, or None
    for sp == 1. ``world`` (default: the process group's size) must equal
    sp: dp = world / sp > 1 is not ported yet."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    dp = mesh_mod.auto_axis_sizes(world, sp=sp)["dp"]
    if dp > 1:
        raise NotImplementedError(
            f"{world} ranks at sp={sp} leave dp={dp}: data parallelism "
            f"across sequence-parallel rings is not ported yet (ROADMAP "
            f"queue 1: the rest of the training mesh)")
    return mesh_mod.RingGroup(device=device) if sp > 1 else None


def make_transformer_config(sp: int = 1,
                            group: Optional[mesh_mod.RingGroup] = None,
                            **overrides) -> tfm.TransformerConfig:
    """A TransformerConfig whose attention matches the sp ring: with
    ``sp > 1``, ring attention (ops/ring_attention, its ``auto`` tier)
    over ``group``, a RingGroup of sp ranks; ``overrides``
    (``fused_norm`` and ``quantize_matmuls`` among them) pass through."""
    attention_fn = overrides.pop("attention_fn", None)
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
                            group: Optional[mesh_mod.RingGroup] = None
                            ) -> TrainHarness:
    """The model on ``device`` (cuda unless "cpu" is named) with
    ``params`` (a state dict, e.g. models.convert.params_from_flax) or
    weights drawn from ``seed`` (convert.init_params; the same on every
    rank), and AdamW. ``loss_impl``: lm_loss_chunked's impl ('auto',
    'kernel' or 'plain'). ``group``: the sp ring the config's attention
    runs over (make_transformer_config), None on one device."""
    if config.decode:
        raise ValueError("training needs decode=False")
    device = resolve_device(device)
    if params is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        params = convert.init_params(config, generator)
    model = tfm.TransformerLM(config, device="meta")
    model.load_state_dict({name: t.to(device, copy=True)
                           for name, t in params.items()}, assign=True)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=0.01)
    return TrainHarness(model.train(), optimizer, batch_size, seq_len,
                        loss_impl, group)
