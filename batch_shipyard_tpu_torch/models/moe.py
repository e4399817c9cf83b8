"""Mixture of experts (PyTorch): routing, routed SwiGLU experts, and the
layer on the mesh.

Counterpart of batch_shipyard_tpu/models/moe.py's ``MoEConfig``,
``top1_routing``, ``topk_routing``, ``expert_choice_routing`` and
``MoEMLP``, with the reference's numbers: the router is an fp32 Dense
over the fp32 tokens and the softmax runs in fp32; the capacity is
``max(1, int(capacity_factor * G / E))`` over the G tokens of the global
batch; top-1's aux loss is ``sum(density * proxy) * E**2 / E`` with the
density of the kept tokens; top-k's uses the first choices' density
before the capacity cut, first choices take buffer priority and later
ones fill what they left, the gates renormalised over the k choices;
expert choice is ``top_k`` of ``probs.T`` over the tokens, without an aux
loss. The experts are SwiGLU over ``w_gate``/``w_up [E, D, F]`` and
``w_down [E, F, D]`` (the reference's layout and names), and the tokens
and the combine weights are cast to ``dtype`` before the products.

No one-hot [G, E, C] tensors. The reference contracts dense dispatch and
combine tensors in einsums; at G 32768, E 8, C 5120 each is 5.4 GB in
fp32 a layer. Routing here returns, per token and choice, the expert,
the slot in its buffer (-1: dropped) and the gate (``Routing``). Dispatch
gathers the tokens into the ``[E, C, D]`` buffers and combine gathers the
outputs back, weighted by the gates. A slot holds at most one token, so
each gather selects the value the reference's einsum sums, and the
backward of each gather is a gather too (``gather_rows``): no atomic
scatter-add, so the step is deterministic. The capacity is static from
the shapes and nothing in the step reads the device from the host.
``dense_dispatch_combine`` rebuilds the reference's tensors from the
indices, for the tests.

One routing over the global batch (``TokenRanks``). The reference runs
the layer under GSPMD, where the program means what it means unsharded:
positions are a cumsum over the global token order (b, t), expert
choice's top-C runs over every token, and the aux loss takes global
means. Over a mesh each rank holds a block of rows and an sp slice of
columns; it gathers the detached fp32 probabilities [G, E] with K13 over
the mesh's "tokens" ring (dp x fsdp x sp ranks of one ep and tp index;
1 MB at G 32768, E 8), routes that global table with the one-device
code, and keeps its own tokens' rows, so positions, drops and the later
choices' ``used`` counts are the single cumsum's. Each rank's aux is its
tokens' share, the global density times its own tokens' probability sums
over the global G: the shares add up to the reference's aux, and so do
their gradients, which the data ring's sum of gradients adds (nothing
counts the aux once per rank). A slot belongs to exactly one token, so no
token activation crosses data ranks: each rank runs its experts on the
slots its own tokens fill.

Expert parallelism (``ep_group``) is Megatron's pair over the ep ring:
rank r holds experts [r E/ep, (r + 1) E/ep); the tokens and the gates
enter the expert region through ``tp_region_input`` (identity forward,
the ring's sum backward) and the region's [G, D] output leaves through
``tp_region_output`` (the sum of every rank's experts' share forward).
The router and the aux loss stay outside the pair, replicated, so the
aux gradient is counted once on every ep rank. Under tp (``tp_group``)
each rank holds F/tp of every expert's ff units, as the dense MLP does
(``P("ep", "fsdp", "tp")``), inside the same pair over the tp ring.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from batch_shipyard_tpu_torch.ops.ring_collectives import (ring_all_gather,
                                                           tp_region_input,
                                                           tp_region_output)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's MoEConfig fields; ``router_generator`` draws the
    router noise (required when ``router_noise`` > 0)."""
    num_experts: int = 8
    d_model: int = 512
    d_ff: int = 1408
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    router_noise: float = 0.0
    num_selected: int = 1    # 1 = Switch-style top-1, k > 1 = top-k
    # "tokens": tokens pick experts; "expert_choice": experts pick their
    # top-C tokens (no aux loss).
    routing: str = "tokens"
    router_generator: Optional[torch.Generator] = None


@dataclasses.dataclass(frozen=True)
class TokenRanks:
    """The ranks that hold distinct tokens of the global batch: the mesh's
    "tokens" RingGroup (dp x fsdp x sp ranks of one ep and tp index,
    members in (data block, sp slice) order) and the sp size."""
    group: object
    sp: int

    @property
    def blocks(self) -> int:
        """Data blocks of rows (dp * fsdp)."""
        return self.group.size // self.sp

    @property
    def place(self) -> tuple[int, int]:
        """This rank's (data block, sp slice)."""
        return divmod(self.group.rank, self.sp)


@dataclasses.dataclass
class Routing:
    """Per token (this rank's, in (row, column) order) and choice: the
    expert, the slot in its buffer (-1 where dropped) and the gate (0
    where dropped); ``aux``, this rank's share of the aux loss."""
    expert: torch.Tensor      # [G, K] int64
    position: torch.Tensor    # [G, K] int64
    gate: torch.Tensor        # [G, K] fp32
    aux: torch.Tensor         # 0-d fp32

    def detach(self) -> "Routing":
        return Routing(self.expert, self.position, self.gate.detach(),
                       self.aux.detach())


def capacity_for(capacity_factor: float, groups: int, num_experts: int
                 ) -> int:
    """The reference's buffer size per expert for ``groups`` tokens."""
    return max(1, int(capacity_factor * groups / num_experts))


def _global_probs(probs: torch.Tensor, tokens: Optional[TokenRanks]
                  ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """probs [R, W, E] of this rank's rows and columns -> (the detached
    probabilities of every token of the global batch in (b, t) order
    [G, E], the rows of this rank's tokens in it; None: these rows are
    the whole batch). Over a mesh they are gathered over the tokens ring
    (K13): the same bits arrive on every rank."""
    rows, width, num_experts = probs.shape
    local = probs.detach().reshape(rows * width, num_experts)
    if tokens is None:
        return local, None
    blocks, sp = tokens.blocks, tokens.sp
    gathered = ring_all_gather(local.contiguous(), tokens.group)
    # [block, slice, row, column] -> [block, row, slice, column].
    table = gathered.view(blocks, sp, rows, width, num_experts).transpose(
        1, 2).reshape(-1, num_experts)
    block, piece = tokens.place
    row = block * rows + torch.arange(rows, device=probs.device)
    mine = ((row[:, None] * sp + piece) * width + torch.arange(
        width, device=probs.device)).reshape(-1)
    return table, mine


def _token_choice(table: torch.Tensor, capacity: int, choices: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every token of ``table`` [G, E] picks its top ``choices`` experts
    (choice order = buffer priority) -> (expert [G, K], slot [G, K] (-1:
    dropped), the aux's density [E])."""
    groups, num_experts = table.shape
    if choices > 1:
        _, expert = torch.topk(table, choices, dim=-1)
    else:
        expert = table.argmax(-1, keepdim=True)
    # With num_classes given, F.one_hot reads nothing back from a CUDA
    # tensor.
    hot = F.one_hot(expert, num_experts).float()          # [G, K, E]
    total = hot.sum(0)                                    # [K, E]
    # The tokens of each (choice, expert) before each token, scanned
    # along the last dim (where CUDA's scan is parallel); counts are
    # integers, exact in fp32.
    flat = hot.view(groups, -1).t().contiguous()
    before = (torch.cumsum(flat, -1) - flat).t().view(hot.shape)
    positions, used = [], torch.zeros_like(total[0])
    for k in range(choices):
        positions.append((before[:, k] + used).gather(
            -1, expert[:, k:k + 1])[:, 0])
        # The reference's used += kept: slots used..used+total-1.
        used = used + (capacity - used).clamp(min=0).minimum(total[k])
    position = torch.stack(positions, -1)
    # Top-1's density counts the kept tokens, top-k's every first choice.
    density = (total[0].clamp(max=capacity) if choices == 1 else
               total[0]) / groups
    return expert, torch.where(position < capacity, position.long(),
                               -1), density


def _expert_choice(table: torch.Tensor, capacity: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each expert takes its top-C tokens of ``table`` [G, E] -> (expert
    [G, E]: every expert, slot [G, E] (-1: not taken))."""
    groups, num_experts = table.shape
    _, token_idx = torch.topk(table.t(), capacity, dim=-1)       # [E, C]
    slots = torch.full(table.shape, -1, dtype=torch.long,
                       device=table.device)
    slots.scatter_(0, token_idx.t(), torch.arange(
        capacity, device=table.device)[:, None].expand(
            capacity, num_experts).contiguous())
    expert = torch.arange(num_experts, device=table.device).expand(
        groups, num_experts)
    return expert, slots


def route(logits: torch.Tensor, capacity: int, cfg: MoEConfig,
          tokens: Optional[TokenRanks] = None) -> Routing:
    """logits [R, W, E] (fp32) of this rank's rows and columns -> Routing
    over the global batch (``tokens``: the token ranks; None: these rows
    are the whole batch). Every rank routes the global table with the
    one-device code and keeps its own tokens' rows; the gates and the aux
    share come from its own probabilities, which keep their gradient."""
    probs = torch.softmax(logits.float(), dim=-1)
    num_experts = probs.shape[-1]
    local = probs.reshape(-1, num_experts)
    with torch.no_grad():
        table, mine = _global_probs(probs, tokens)
        groups = table.shape[0]
        if cfg.routing == "expert_choice":
            expert, position = _expert_choice(table, capacity)
        else:
            expert, position, density = _token_choice(
                table, capacity, cfg.num_selected)
        if mine is not None:
            expert, position = expert[mine], position[mine]
    gate = local.gather(-1, expert)
    if cfg.routing == "expert_choice":
        return Routing(expert, position, gate * (position >= 0),
                       torch.zeros((), device=probs.device))
    if cfg.num_selected > 1:
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    dot = torch.sum(density * (local.sum(0) / groups))
    aux = (dot * num_experts ** 2 / num_experts if cfg.num_selected == 1
           else dot * num_experts)
    return Routing(expert, position, gate * (position >= 0), aux)


def top1_routing(logits: torch.Tensor, capacity: int) -> Routing:
    """The reference's top1_routing on one device: logits [G, E]."""
    return route(logits[None], capacity, MoEConfig(
        num_experts=logits.shape[-1]))


def topk_routing(logits: torch.Tensor, capacity: int,
                 num_selected: int = 2) -> Routing:
    """The reference's topk_routing on one device: logits [G, E]."""
    return route(logits[None], capacity, MoEConfig(
        num_experts=logits.shape[-1], num_selected=num_selected))


def expert_choice_routing(logits: torch.Tensor, capacity: int) -> Routing:
    """The reference's expert_choice_routing on one device."""
    return route(logits[None], capacity, MoEConfig(
        num_experts=logits.shape[-1], routing="expert_choice"))


def dense_dispatch_combine(routing: Routing, num_experts: int,
                           capacity: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's dense dispatch and combine [G, E, C] (fp32), rebuilt
    from a Routing's indices (for the tests; the step never builds
    them)."""
    groups, choices = routing.expert.shape
    dispatch = torch.zeros(groups, num_experts, capacity)
    combine = torch.zeros(groups, num_experts, capacity)
    kept = routing.position >= 0
    g = torch.arange(groups)[:, None].expand(groups, choices)[kept]
    e, c = routing.expert[kept], routing.position[kept]
    dispatch[g, e, c] = 1.0
    combine[g, e, c] = routing.gate.detach().float()[kept]
    return dispatch, combine


class _GatherRows(torch.autograd.Function):
    """out[i] = src[index[i]] (index == len(src): a zero row). The
    backward gathers as well: grad_src[j] = the sum over k of
    grad_out[inverse[j, k]] (inverse == len(out): nothing), added in fp32
    and rounded once, so no scatter-add and no order left to chance."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return torch.cat([src, src.new_zeros(1, *src.shape[1:])]
                         ).index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        inverse, = ctx.saved_tensors
        picked = torch.cat([grad, grad.new_zeros(1, *grad.shape[1:])]
                           ).index_select(0, inverse.reshape(-1)).view(
                               *inverse.shape, *grad.shape[1:])
        summed = (picked[:, 0] if inverse.shape[1] == 1 else
                  picked.float().sum(1).to(grad.dtype))
        return summed, None, None


def gather_rows(src: torch.Tensor, index: torch.Tensor,
                inverse: torch.Tensor) -> torch.Tensor:
    """src [N, ...] rows at ``index`` [M] (N: a zero row), differentiable;
    ``inverse`` [N, K] lists, for each row of src, the rows of the output
    that took it (M where fewer than K did)."""
    return _GatherRows.apply(src, index, inverse)


def _region_input(x, rings):
    """Megatron's f over each ring (ep, then tp)."""
    for group in rings:
        x = tp_region_input(x, group)
    return x


def _region_output(x, rings):
    """Megatron's g over each ring (tp, then ep)."""
    for group in reversed(rings):
        x = tp_region_output(x, group)
    return x


def _local(count: int, group, what: str) -> int:
    size = 1 if group is None else group.size
    if count % size:
        raise ValueError(f"{what}={count} is not divisible by the ring of "
                         f"{size}")
    return count // size


class MoEMLP(nn.Module):
    """The reference's MoEMLP: ``router.weight [E, D]`` (fp32 Dense),
    ``w_gate``/``w_up [E/ep, D, F/tp]`` and ``w_down [E/ep, F/tp, D]`` of
    this rank's experts and ff units. forward(x [B, T, D]) -> ([B, T, D]
    in ``dtype``, this rank's aux share). ``last_routing`` keeps the last
    forward's Routing, detached (the tests and the smoke run read it)."""

    def __init__(self, cfg: MoEConfig, ep_group=None, tp_group=None,
                 tokens: Optional[TokenRanks] = None, device=None) -> None:
        super().__init__()
        if cfg.routing not in ("tokens", "expert_choice"):
            raise ValueError(f"unknown MoE routing {cfg.routing!r} "
                             f"(expected 'tokens' or 'expert_choice')")
        if cfg.router_noise > 0 and cfg.router_generator is None:
            raise ValueError("router_noise needs a router_generator")
        self.config = cfg
        self.ep_group = ep_group if ep_group is not None and \
            ep_group.size > 1 else None
        self.tp_group = tp_group if tp_group is not None and \
            tp_group.size > 1 else None
        self.tokens = tokens
        experts = _local(cfg.num_experts, self.ep_group, "num_experts")
        d_ff = _local(cfg.d_ff, self.tp_group, "d_ff")
        self.router = nn.Linear(cfg.d_model, cfg.num_experts, bias=False,
                                dtype=cfg.param_dtype, device=device)

        def weight(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=cfg.param_dtype,
                                            device=device))
        self.w_gate = weight(experts, cfg.d_model, d_ff)
        self.w_up = weight(experts, cfg.d_model, d_ff)
        self.w_down = weight(experts, d_ff, cfg.d_model)
        self.last_routing: Optional[Routing] = None

    @property
    def first_expert(self) -> int:
        """The global index of this rank's first expert."""
        rank = 0 if self.ep_group is None else self.ep_group.rank
        return rank * self.w_gate.shape[0]

    def capacity(self, local_tokens: int) -> int:
        ranks = 1 if self.tokens is None else self.tokens.group.size
        return capacity_for(self.config.capacity_factor,
                            local_tokens * ranks, self.config.num_experts)

    def forward(self, x):
        cfg = self.config
        batch, seq, d_model = x.shape
        flat = x.reshape(batch * seq, d_model)
        capacity = self.capacity(batch * seq)
        logits = F.linear(flat.float(), self.router.weight.float())
        if cfg.router_noise > 0.0:
            noise = torch.empty_like(logits).uniform_(
                1.0 - cfg.router_noise, 1.0 + cfg.router_noise,
                generator=cfg.router_generator)
            logits = logits * noise
        routing = route(logits.view(batch, seq, -1), capacity, cfg,
                        self.tokens)
        self.last_routing = routing.detach()
        out = self._experts(flat, routing, capacity)
        return out.view(batch, seq, d_model), routing.aux

    def _experts(self, flat, routing: Routing, capacity: int):
        """The expert region: this rank's experts on the slots of its
        tokens, combined; its [G, D] output summed over the ep and tp
        rings."""
        cfg = self.config
        groups, choices = routing.expert.shape
        experts = self.w_gate.shape[0]
        slots = experts * capacity
        local = routing.expert - self.first_expert
        mine = (routing.position >= 0) & (local >= 0) & (local < experts)
        # Each (token, choice) -> its slot among this rank's; ``slots``
        # stands for none.
        slot = torch.where(mine, local * capacity + routing.position, slots)
        choice_of_slot = torch.full((slots + 1,), groups * choices,
                                    dtype=torch.long, device=flat.device)
        choice_of_slot.scatter_(0, slot.reshape(-1), torch.arange(
            groups * choices, device=flat.device))
        choice_of_slot = choice_of_slot[:slots]
        token_of_slot = torch.where(choice_of_slot < groups * choices,
                                    choice_of_slot // choices, groups)
        rings = [g for g in (self.ep_group, self.tp_group) if g is not None]
        tokens = _region_input(flat.to(cfg.dtype), rings)
        gate = _region_input(routing.gate, rings).to(cfg.dtype)
        expert_in = gather_rows(tokens, token_of_slot, slot).view(
            experts, capacity, -1)
        hidden = F.silu(torch.bmm(expert_in, self.w_gate.to(cfg.dtype))) * \
            torch.bmm(expert_in, self.w_up.to(cfg.dtype))
        expert_out = torch.bmm(hidden, self.w_down.to(cfg.dtype)).view(
            slots, -1)
        picked = gather_rows(expert_out, slot.reshape(-1),
                             choice_of_slot[:, None]).view(groups, choices, -1)
        out = (picked.float() * gate.float()[..., None]).sum(1).to(cfg.dtype)
        return _region_output(out, rings)
