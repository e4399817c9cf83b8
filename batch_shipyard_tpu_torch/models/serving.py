"""Continuous batching: a slot-based serving engine over the KV-cache
decode path (PyTorch).

Counterpart of batch_shipyard_tpu/models/serving.py
(``ContinuousBatcher``). A fixed pool of decode SLOTS shares one
batched KV cache; requests admit into free slots as they arrive (a
batch-1 prefill scattered into the slot), every engine step decodes ONE
token for all slots in one batched forward, and finished slots free at
once. The host bookkeeping is the reference's, line for line: the page
allocator with its scratch page, reservation or overcommit preemption
with re-prefill, the blake2b-chained prefix cache with refcounts and an
LRU, EDF admission, shedding and drain.

What differs: the reference jits its decode step into one compiled
call; here, on a CUDA device, the engine captures ``_decode_step`` once
into a CUDA graph (after its first eager decode step, which builds and
loads the kernels) and replays it on every later step, so a step costs
one graph launch instead of ~900 kernel launches. The graph reads and
writes the addresses it captured, so every write to engine state
between replays stays in place: the token, position and active
tensors, the KV cache (its per-layer length / index and the shared
block table) are only ever updated with ``copy_``, indexed assignment
or in-place arithmetic, never rebound. On the CPU the step runs
eagerly. The random stream for temperature sampling is a
torch.Generator seeded with ``seed``, registered with the graph so that
every replay draws afresh.

Prompts pad to the reference's power-of-two buckets (``_bucket_length``),
where the reference compiles one program a bucket; here ``warmup()``
drives every bucket and captures each prefill the engine can run there
(the target's, the shared-prefix suffix's, the draft's) as a CUDA graph
of its own, in the decode graph's memory pool. A prefill reads only
views of one static int32 argument buffer (prompt, suffix, true length,
prefix length, slot, page ids), which admission fills with one host
copy, so a replay serves any request of its bucket. A bucket warm-up
skipped (a tight pool) runs the same prefill eagerly; nothing is
captured under traffic.

Speculative decoding (``speculative=SpeculativeConfig(...)``, the
reference's engine-integrated draft/verify loop): each step drafts gamma
tokens a slot with a small dense-cache draft model, verifies every
slot's [y, d_1..d_gamma] block in ONE target forward and commits a
ragged 1..gamma+1 tokens a slot (``_speculative_step``); on a CUDA device
that step is the graph captured and replayed, in place of the decode
step. ``submit(request, resumed=...)`` continues a request another
replica began (the front end's ``resume_tokens``). AOT precompile
(the reference's ``precompile``) is not ported.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
import uuid
from typing import Callable, Optional, Union

import numpy as np
import torch

from batch_shipyard_tpu_torch.device import resolve_device
from batch_shipyard_tpu_torch.goodput import events as goodput_events
from batch_shipyard_tpu_torch.models import inference as inf
from batch_shipyard_tpu_torch.models import transformer as tfm


def _decode_step(model, sampling, cache, tokens, positions, active,
                 generator):
    """One token for every slot in one batched forward, written in
    place: ``tokens`` [B, 1] takes the sampled token and ``positions``
    [B] advances where ``active`` holds (a captured graph replays this
    against the same tensors). Inactive slots DO write garbage into
    their cache rows (dense) or the scratch page (paged): a freed row is
    never read and the next admission's prefill rewrites it. Only the
    token/position bookkeeping is masked. Returns the sampled tokens
    [B]."""
    logits = model(tokens, positions=positions[:, None], cache=cache)
    next_tok = inf._sample(logits[:, 0].float(), generator, sampling)
    next_tok = torch.where(active, next_tok, tokens[:, 0])
    tokens.copy_(next_tok[:, None])
    positions.add_(active.to(positions.dtype))
    return next_tok


def _speculative_step(target, draft, gamma, t_cache, d_cache, tokens,
                      positions, active):
    """One ragged draft/verify round over the full slot batch, written in
    place (a captured graph replays it against the same tensors).
    ``tokens`` [B, 1] is each slot's pending token y (sampled, not yet
    cached) and ``positions`` [B] its absolute position; both caches hold
    every committed token EXCEPT y.

    Draft: gamma+1 single-token steps propose d_1..d_gamma (the extra
    step only inserts d_gamma's K/V, so the draft cache keeps pace on
    full acceptance). Verify: ONE target forward scores [y, d_1..d_gamma]
    through the multi-token insert. Accept: each slot's longest validated
    prefix a_i; the block commits d_1..d_{a_i} plus the target's token at
    a_i (correction or bonus), both caches rewind by gamma - a_i, and y
    and the position move on. Inactive slots rewind the full gamma+1 and
    keep their token and position. Returns [B, gamma+2]: the block
    [B, gamma+1], then a_i."""
    token, drafts = tokens, []
    for step in range(gamma + 1):
        hidden = draft(token, positions=positions[:, None] + step,
                       cache=d_cache, return_hidden=True)
        token = inf._greedy_next(draft, hidden[:, 0])[:, None]
        drafts.append(token)
    d_tok = torch.cat(drafts[:gamma], dim=1)                     # [B, g]
    steps = torch.arange(gamma + 1, dtype=positions.dtype,
                         device=positions.device)
    hidden = target(torch.cat([tokens, d_tok], dim=1),
                    positions=positions[:, None] + steps, cache=t_cache,
                    return_hidden=True)
    t_tok = inf._greedy_next(target, hidden)                     # [B, g+1]
    match = (d_tok == t_tok[:, :gamma]).to(torch.int32)
    accepted = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    a_slot = torch.where(active, accepted, 0)
    block = torch.where(steps[None, :] < a_slot[:, None],
                        torch.nn.functional.pad(d_tok, (0, 1)), t_tok)
    rewind = torch.where(active, gamma - a_slot, gamma + 1)
    inf._rewind_cache(t_cache, rewind)
    inf._rewind_cache(d_cache, rewind)
    new_tok = block.gather(1, a_slot[:, None].long())
    tokens.copy_(torch.where(active[:, None], new_tok, tokens))
    positions.add_(torch.where(active, a_slot + 1, 0))
    return torch.cat([block, a_slot[:, None]], dim=1)


def _dense_prefill(model, prefill_chunk, prompt, prompt_len, small,
                   start) -> torch.Tensor:
    """Batch-1 prefill of ``prompt`` [1, L] (bucket-padded) into the
    dense batch-1 cache ``small``, whose write index already stands at
    ``start``: ceil(L/chunk) multi-token inserts with GLOBAL positions
    from ``start``. Rows past the true prompt are garbage,
    masked-on-read and overwritten by decode. ``prompt_len`` and
    ``start`` are int32 [1] tensors on the device (a captured graph
    replays this with other values in them). Returns the fp32 logits
    [vocab] of the token at ``prompt_len - 1``, counted from the cache
    start, so a seeded prefix of ``start`` rows counts."""
    total = prompt.shape[1]
    chunk = min(prefill_chunk or total, total)
    hiddens = []
    for off in range(0, total, chunk):
        seg = prompt[:, off:off + chunk]
        positions = start + torch.arange(off, off + seg.shape[1],
                                         dtype=torch.int32,
                                         device=prompt.device)
        hiddens.append(model(seg, positions=positions, cache=small,
                             return_hidden=True))
    hidden = torch.cat(hiddens, dim=1)
    last = hidden[0].index_select(0, (prompt_len - start - 1).long())
    return inf.last_token_logits(model, last[0])


@dataclasses.dataclass
class Request:
    request_id: str
    prompt: list[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    # Admission priority among QUEUED requests (higher first; ties
    # FIFO, then EDF on the TTFT deadline). Active slots are never
    # preempted for priority.
    priority: int = 0
    # Request-level SLO targets (None = best-effort): EDF ordering,
    # prefill-stall deferral and, with a shed grace, overload shedding.
    ttft_target_ms: Optional[float] = None
    tpot_target_ms: Optional[float] = None
    slo_class: str = "standard"


@dataclasses.dataclass
class SpeculativeConfig:
    """Draft model for ENGINE-INTEGRATED speculative decoding: each
    engine step drafts ``gamma`` tokens a slot with the draft model,
    verifies every slot's [y, d_1..d_gamma] block in one target forward,
    then commits and rewinds per slot. Greedy-exact: the tokens equal the
    non-speculative engine's for any draft (only throughput changes),
    bit for bit in fp32 on the CPU; at reduced precision, or where the
    card picks other GEMM kernels for the verify block than for a single
    step, an argmax near-tie can resolve the other way (the reference's
    caveat, docs/15-serving.md). The draft always uses a dense KV cache
    (O(1) cursor rewind); the target may be dense or paged.
    ``draft_params`` is the draft's state dict (models/convert.py)."""
    draft_config: tfm.TransformerConfig
    draft_params: dict
    gamma: int = 4


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    generated: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _QueueEntry:
    """A queued request, plus the tokens it had already generated if it
    was preempted (overcommit mode): resumption re-prefills
    prompt + resumed in one pass and continues decoding."""
    request: Request
    resumed: list[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0


class ContinuousBatcher:
    """Slot-based continuous batching engine.

    Usage:
        engine = ContinuousBatcher(config, state_dict, num_slots=8,
                                   max_decode_len=512, device="cuda")
        engine.submit(Request("r1", prompt_ids, max_new_tokens=128))
        while engine.pending():
            for request_id, tokens in engine.step():
                ...  # finished request

    ``params`` is the model's state dict (models/convert.py). The
    engine runs on ``device`` (default cuda; it raises when no CUDA
    device exists unless ``device="cpu"`` is passed). One thread must
    own stepping: submit/step/cancel/drain mutate engine state.
    """

    def __init__(self, config: tfm.TransformerConfig, params: dict,
                 num_slots: int, max_decode_len: int,
                 sampling: inf.SamplingConfig = inf.SamplingConfig(),
                 seed: int = 0,
                 kv_page_size: Optional[int] = None,
                 kv_num_pages: Optional[int] = None,
                 overcommit: bool = False,
                 prefill_chunk: Optional[int] = None,
                 on_token: Optional[
                     Callable[[str, int, int], None]] = None,
                 speculative: Optional[SpeculativeConfig] = None,
                 prefix_cache: bool = True,
                 slo_shed_grace_ms: Optional[float] = None,
                 tpot_stall_factor: float = 4.0,
                 device: Optional[Union[str, torch.device]] = None):
        """kv_page_size enables the PAGED KV cache: K/V live in a shared
        kv_num_pages-page pool (default: the no-deadlock capacity
        num_slots * max_decode_len / page) and slots hold block tables
        over their live tokens. Admission with a smaller pool:
        overcommit=False RESERVES each request's worst-case pages up
        front; overcommit=True takes only the prompt's pages (+1) and,
        when decode runs dry, PREEMPTS the slot with the fewest
        generated tokens (re-queued, later re-prefilled with what it
        had generated — the greedy continuation is unchanged).

        prefix_cache (paged only) indexes every full prompt page by a
        chained content hash; a later request sharing those pages pins
        them (refcounted) and prefills only its suffix. Unreferenced
        indexed pages park in an LRU, evicted only when the free list
        runs dry.

        slo_shed_grace_ms arms overload shedding of queued requests
        whose TTFT deadline is blown by more than the grace;
        tpot_stall_factor bounds how long a prefill may stall active
        decodes (a multiple of their tightest TPOT target).

        prefill_chunk caps the prefill insert length (the score tensor
        shrinks to O(chunk * max_decode_len)); use a power of two.

        speculative (a SpeculativeConfig) turns every step into a
        draft/verify round; it needs greedy sampling, gamma >= 1, a
        dense-cache draft and the target's vocabulary."""
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.device = resolve_device(device)
        self.prefill_chunk = prefill_chunk
        self.config = inf.decode_config(config, max_decode_len)
        self.paged = kv_page_size is not None
        self.overcommit = overcommit
        # Observers: on_token(request_id, token, index) the moment a
        # token is generated (index 0 = the prefill-sampled token);
        # on_admit(request_id) as a queued request wins a slot, before
        # its prefill; on_shed(request_id, reason) when shedding drops
        # a queued request. All run on the engine's stepping thread.
        self.on_token = on_token
        self.on_admit: Optional[Callable[[str], None]] = None
        self.on_shed: Optional[Callable[[str, str], None]] = None
        self.preemptions = 0
        self.decode_steps = 0
        self.speculative = speculative
        self.gamma = speculative.gamma if speculative else 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        if speculative is not None:
            if speculative.gamma < 1:
                raise ValueError(
                    f"speculative gamma must be >= 1, got "
                    f"{speculative.gamma}")
            if sampling.temperature > 0:
                raise ValueError(
                    "speculative serving is greedy-exact (draft "
                    "acceptance compares argmax chains); it requires "
                    "temperature == 0 sampling")
            if speculative.draft_config.kv_page_size:
                raise ValueError(
                    "the draft model uses a dense KV cache (O(1) "
                    "index rewind); clear kv_page_size on the draft "
                    "config")
            if speculative.draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    "draft/target vocab_size must match (acceptance "
                    "compares token ids)")
            # The verify block is a multi-token insert of gamma+1 tokens
            # from up to max_decode_len - 2: the target's cache takes its
            # tail writes past max_decode_len (transformer.py
            # spec_window: table entries on the scratch page, or extra
            # dense rows).
            self.config = dataclasses.replace(self.config,
                                              spec_window=self.gamma)
        if overcommit and not self.paged:
            raise ValueError("overcommit requires the paged KV cache "
                             "(kv_page_size)")
        if self.paged:
            if max_decode_len % kv_page_size:
                raise ValueError("max_decode_len must be a multiple "
                                 "of kv_page_size")
            if kv_num_pages is None:
                kv_num_pages = num_slots * (
                    max_decode_len // kv_page_size)
            self.page_size = kv_page_size
            self.max_blocks = -(-(max_decode_len + self.gamma)
                                // kv_page_size)
            self._free_pages = list(range(kv_num_pages))
            # Reservation budget (see _admit): worst-case pages per
            # request, so lazy growth during decode cannot deadlock.
            self._avail_pages = kv_num_pages
            self._total_pages = kv_num_pages
            self._slot_reserved = [0] * num_slots
            # The decode step runs the full slot batch, so INACTIVE
            # slots keep writing through their block tables: one extra
            # SCRATCH page (index kv_num_pages) absorbs those writes,
            # and freed slots' table rows reset to it.
            self._scratch_page = kv_num_pages
            self.config = dataclasses.replace(
                self.config, kv_page_size=kv_page_size,
                kv_num_pages=kv_num_pages + 1)
            self._table = np.full((num_slots, self.max_blocks),
                                  self._scratch_page, np.int32)
            self._slot_pages: list[list[int]] = [
                [] for _ in range(num_slots)]
            # Prefix-cache state. Page lifecycle: FREE -> OWNED (a
            # slot's _slot_pages) -> PINNED (indexed, refcount >= 1,
            # in _slot_shared) -> LRU (indexed, refcount 0) -> FREE.
            # Invariant: _avail_pages = total - pinned -
            # sum(_slot_reserved); LRU pages count as available.
            self._slot_shared: list[list[int]] = [
                [] for _ in range(num_slots)]
            self._prefix_index: dict[bytes, int] = {}
            self._page_key: dict[int, bytes] = {}
            self._page_ref: dict[int, int] = {}
            self._lru: "collections.OrderedDict[int, None]" = \
                collections.OrderedDict()
        self.prefix_cache = bool(prefix_cache) and self.paged
        self.prefix_lookups = 0
        self.prefix_hit_pages = 0
        self.prefix_hit_tokens = 0
        self.prefix_total_tokens = 0
        self.prefix_published = 0
        self.prefix_evictions = 0
        self.slo_shed_grace_ms = slo_shed_grace_ms
        self.tpot_stall_factor = tpot_stall_factor
        self.slo_sheds = 0
        self.sheds_by_class: dict[str, int] = {}
        self.slo_deferrals = 0
        # Drain mode: _admit refuses new work; active decodes finish.
        self.draining = False
        self._prefill_ms_per_token: Optional[float] = None
        self._step_ms: Optional[float] = None
        self._timed_buckets: set = set()
        self._step_samples = 0
        self.num_slots = num_slots
        self.max_decode_len = max_decode_len
        self.sampling = sampling
        self.model = self._load_model(self.config, params)
        # Prefill runs on a DENSE batch-1 decode model sharing the
        # weights; paged mode then scatters its rows into pages.
        self._dense_model = self._load_model(
            inf.decode_config(config, max_decode_len),
            self.model.state_dict())
        self.cache = inf.init_cache(self.model, num_slots)
        if self.paged:
            # Fresh tables are zeros (a REAL page): point every slot at
            # the scratch page before any step runs.
            self._push_tables()
        self._slots = [_Slot() for _ in range(num_slots)]
        self._queue: list[_QueueEntry] = []
        self._tokens = torch.zeros((num_slots, 1), dtype=torch.int32,
                                   device=self.device)
        self._positions = torch.zeros((num_slots,), dtype=torch.int32,
                                      device=self.device)
        self._active = torch.zeros((num_slots,), dtype=torch.bool,
                                   device=self.device)
        # Host mirror of _positions, so page growth needs no device read.
        self._positions_host = [0] * num_slots
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        # The captured step (CUDA only): the graph and its output, the
        # sampled tokens [B] (decode) or the block and a_i [B, gamma+2]
        # (speculative).
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_tokens: Optional[torch.Tensor] = None
        if speculative is not None:
            # The draft: a dense cache with gamma+1 extra rows, so a draft
            # block starting at max_decode_len - 2 stays inside it. It
            # shares nothing with the target.
            self._draft_model = self._load_model(
                inf.decode_config(speculative.draft_config,
                                  max_decode_len + self.gamma + 1),
                speculative.draft_params)
            self._draft_cache = inf.init_cache(self._draft_model,
                                               num_slots)
        # One memory pool for every graph of the engine (the decode
        # step's and each prefill bucket's): they replay one at a time
        # on the engine's stream.
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self._init_prefill()

    def _load_model(self, config: tfm.TransformerConfig,
                    params: dict) -> tfm.TransformerLM:
        """A decode model on the engine's device holding ``params``.
        Tensors already on the device in the right dtype are shared,
        not copied (load_state_dict with assign)."""
        model = tfm.TransformerLM(config, device="meta")
        state = {name: t.to(self.device) for name, t in params.items()}
        model.load_state_dict(state, assign=True)
        model.cast_dense_weights_()
        return model.requires_grad_(False).eval()

    # ------------------------------ public -----------------------------

    def warmup_buckets(self) -> list[int]:
        """Every prefill bucket this engine can serve, derived from
        ``_bucket_length`` (the one source of the bucket rule): each
        bucket's successor until the cap."""
        buckets = [self._bucket_length(1)]
        while buckets[-1] < self.max_decode_len:
            buckets.append(self._bucket_length(buckets[-1] + 1))
        return buckets

    def warmup(self, prompt_len: Optional[int] = None,
               max_new_tokens: int = 2) -> list[int]:
        """Drive throwaway requests through prefill and decode before
        real traffic, one per prefill bucket (or one of ``prompt_len``
        tokens), drained one after another, recorded as the goodput
        warm-up phase. A tight paged pool skips the buckets whose worst
        case it cannot admit. With the prefix cache, each bucket runs
        against an empty index, then a second pass runs the
        shared-prefix suffix buckets. On a CUDA device the first decode
        step captures the step graph every later step replays, and then
        every prefill of the warmed buckets (``_prefill_keys``) is
        captured as a graph of its own; nothing is captured after
        warm-up. Leaves the prefix index and the prefix and speculative
        counters empty. Returns the buckets warmed."""
        if prompt_len is not None:
            lengths = [prompt_len]
        else:
            lengths = [min(bucket, self.max_decode_len - max_new_tokens)
                       for bucket in self.warmup_buckets()]
            if self.paged:
                lengths = [
                    length for length in lengths
                    if -(-(length + max_new_tokens)
                         // self.page_size) <= self._total_pages]
        warmed: list[int] = []

        def drain(length: int) -> None:
            self.submit(Request(
                request_id=f"__warmup__{uuid.uuid4().hex[:8]}",
                prompt=[(i % 7) + 1 for i in range(length)],
                max_new_tokens=max_new_tokens))
            while self.pending():
                self.step()

        with goodput_events.phase(goodput_events.PROGRAM_WARMUP,
                                  what="serving_engine",
                                  buckets=len(lengths)):
            for length in lengths:
                if self.prefix_cache:
                    # The warm-up prompts share prefixes: against an
                    # empty index every bucket runs its cold prefill.
                    self.prefix_cache_clear()
                drain(length)
                warmed.append(self._bucket_length(length))
            if self.prefix_cache and len(lengths) > 1:
                # Each chained prompt now matches the pages the previous
                # one published, leaving only its suffix to prefill.
                self.prefix_cache_clear()
                for length in lengths:
                    drain(length)
            if self.device.type == "cuda":
                for kind, bucket in self._prefill_keys(warmed):
                    if (kind, bucket) not in self._prefill_graphs:
                        self._capture_prefill(kind, bucket)
        self.spec_rounds = self.spec_proposed = self.spec_accepted = 0
        if self.prefix_cache:
            self.prefix_cache_clear()
            self.prefix_lookups = 0
            self.prefix_hit_pages = 0
            self.prefix_hit_tokens = 0
            self.prefix_total_tokens = 0
            self.prefix_published = 0
            self.prefix_evictions = 0
        return warmed

    def submit(self, request: Request,
               resumed: Optional[list[int]] = None) -> None:
        """Enqueue a request. ``resumed`` carries the tokens a prior
        (killed or drained) replica already emitted: the entry
        re-prefills prompt + resumed in one pass and decoding continues
        from there, so a greedy stream equals an uninterrupted run.
        Refused while draining."""
        if self.draining:
            raise ValueError(
                f"{request.request_id}: engine is draining")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"{request.request_id}: max_new_tokens must be >= 1")
        if not request.prompt:
            raise ValueError(
                f"{request.request_id}: prompt must be non-empty")
        resumed = [int(t) for t in (resumed or [])]
        if len(resumed) >= request.max_new_tokens:
            raise ValueError(
                f"{request.request_id}: resumed tokens "
                f"{len(resumed)} >= max_new_tokens "
                f"{request.max_new_tokens} — nothing left to decode")
        if self.paged:
            worst = -(-(len(request.prompt) + request.max_new_tokens)
                      // self.page_size)
            if worst > self._total_pages:
                raise ValueError(
                    f"{request.request_id}: worst-case page need "
                    f"{worst} exceeds the pool ({self._total_pages} "
                    f"pages) — it could never admit")
        if len(request.prompt) + request.max_new_tokens > \
                self.max_decode_len:
            raise ValueError(
                f"{request.request_id}: prompt+generation "
                f"{len(request.prompt)}+{request.max_new_tokens} "
                f"exceeds max_decode_len {self.max_decode_len}")
        self._enqueue(_QueueEntry(request, resumed=resumed,
                                  submitted_at=time.monotonic()))

    def pending(self) -> int:
        return len(self._queue) + sum(
            1 for s in self._slots if s.request is not None)

    def drain(self) -> list[str]:
        """Enter drain mode: stop seating new work, evict the queue
        (returning its ids so the caller can fail them over) and let
        active decodes finish. Idempotent; stepping thread only."""
        self.draining = True
        evicted = [e.request.request_id for e in self._queue]
        self._queue.clear()
        return evicted

    def active_request_ids(self) -> list[str]:
        return [s.request.request_id for s in self._slots
                if s.request is not None]

    def cancel(self, request_id: str) -> bool:
        """Abort a queued or decoding request; an active slot frees at
        once (its pages return to the pool). Returns False for unknown
        (already finished) ids. Stepping thread only."""
        for k, entry in enumerate(self._queue):
            if entry.request.request_id == request_id:
                del self._queue[k]
                return True
        for i, slot in enumerate(self._slots):
            if slot.request is not None and \
                    slot.request.request_id == request_id:
                self._free_slot(i)
                return True
        return False

    @torch.no_grad()
    def step(self) -> list[tuple[str, list[int]]]:
        """Admit queued requests into free slots, decode for every active
        slot (one token, or with a draft model a gamma-token draft/verify
        block a slot), and emit finished requests."""
        self._admit()
        # Slots whose prefill-sampled token already satisfied the
        # request emit without a decode step.
        emitted: list[tuple[str, list[int]]] = []
        for i, slot in enumerate(self._slots):
            req = slot.request
            if req is None or not slot.generated:
                continue
            last = slot.generated[-1]
            if (len(slot.generated) >= req.max_new_tokens or
                    (req.eos_id is not None and last == req.eos_id)):
                emitted.append((req.request_id, list(slot.generated)))
                self._free_slot(i)
        if not any(s.request is not None for s in self._slots):
            return emitted
        if self.speculative is not None:
            return emitted + self._step_speculative()
        if self.paged:
            self._grow_pages()
        t0 = time.monotonic()
        if self._graph is not None:
            next_tok = self._replay_decode()
        else:
            next_tok = self._eager_decode()
            if self.device.type == "cuda":
                self.capture_decode()
        next_host = next_tok.cpu().tolist()
        self.decode_steps += 1
        self._record_step_time(t0)
        for i, slot in enumerate(self._slots):
            req = slot.request
            if req is None:
                continue
            self._positions_host[i] += 1
            token = next_host[i]
            slot.generated.append(token)
            if self.on_token is not None:
                self.on_token(req.request_id, token,
                              len(slot.generated) - 1)
            if (len(slot.generated) >= req.max_new_tokens or
                    (req.eos_id is not None and token == req.eos_id)):
                emitted.append((req.request_id, list(slot.generated)))
                self._free_slot(i)
        return emitted

    def _step_speculative(self) -> list[tuple[str, list[int]]]:
        """One ragged draft/verify/commit round (``_speculative_step``):
        slots advance by different amounts, so the host bookkeeping is
        variable-stride: each slot appends its own 1..gamma+1 committed
        tokens, with per-token eos/max_new_tokens checks so a slot can
        stop mid-block (the rest of the block is discarded; its cache
        rows recycle with the slot). The host reads the block and a_i
        once, in one copy."""
        if self.paged:
            self._grow_pages(span=self.gamma)
        t0 = time.monotonic()
        if self._graph is not None:
            out = self._replay_decode()
        else:
            out = self._eager_speculative()
            if self.device.type == "cuda":
                self.capture_decode()
        out_host = out.cpu().tolist()
        self.decode_steps += 1
        self._record_step_time(t0)
        emitted: list[tuple[str, list[int]]] = []
        n_active = 0
        for i, slot in enumerate(self._slots):
            req = slot.request
            if req is None:
                continue
            n_active += 1
            accepted = out_host[i][-1]
            self.spec_accepted += accepted
            self._positions_host[i] += accepted + 1
            for token in out_host[i][:accepted + 1]:
                slot.generated.append(token)
                if self.on_token is not None:
                    self.on_token(req.request_id, token,
                                  len(slot.generated) - 1)
                if (len(slot.generated) >= req.max_new_tokens or
                        (req.eos_id is not None and
                         token == req.eos_id)):
                    emitted.append((req.request_id,
                                    list(slot.generated)))
                    self._free_slot(i)
                    break
        self.spec_rounds += 1
        self.spec_proposed += self.gamma * n_active
        return emitted

    def spec_stats(self) -> Optional[dict]:
        """Speculative counters, or None without a draft model.
        acceptance_rate = accepted / proposed; tokens per target forward
        is 1 + acceptance_rate * gamma."""
        if self.speculative is None:
            return None
        return {
            "gamma": self.gamma,
            "rounds": self.spec_rounds,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "acceptance_rate": (
                self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0),
        }

    def capture_decode(self) -> None:
        """Capture one step of the engine (``_decode_step``, or with a
        draft model ``_speculative_step``, over the engine's models,
        caches, token, position and active tensors) into a CUDA graph on
        a side stream; ``step`` replays it from then on. The kernel
        libraries must be loaded first (one eager step does it).
        Capturing records the step without running it, so no state
        moves. The kernel wrappers count their launches here, once: a
        replay relaunches the captured kernels without calling the
        wrappers (``trace/decode_profile.py`` counts a replay's kernels
        from the device trace). Raises on a CPU engine, and where
        capture fails: there is no eager fallback on the card."""
        if self.device.type != "cuda":
            raise RuntimeError(
                "decode-step capture needs a CUDA device; the CPU "
                "engine steps eagerly")
        graph = torch.cuda.CUDAGraph()
        if self.sampling.temperature > 0.0:
            # Each replay advances the generator's offset, as an eager
            # draw does.
            graph.register_generator_state(self._generator)
        with torch.cuda.graph(graph, pool=self._graph_pool,
                              capture_error_mode="thread_local"):
            if self.speculative is not None:
                out = self._eager_speculative()
            else:
                out = _decode_step(
                    self.model, self.sampling, self.cache, self._tokens,
                    self._positions, self._active, self._generator)
        self._graph, self._graph_tokens = graph, out

    def _eager_decode(self) -> torch.Tensor:
        return _decode_step(self.model, self.sampling, self.cache,
                            self._tokens, self._positions, self._active,
                            self._generator)

    def _eager_speculative(self) -> torch.Tensor:
        return _speculative_step(self.model, self._draft_model, self.gamma,
                                 self.cache, self._draft_cache,
                                 self._tokens, self._positions,
                                 self._active)

    def _replay_decode(self) -> torch.Tensor:
        """One step through the captured graph: its output tensor."""
        self._graph.replay()
        return self._graph_tokens

    def prefix_cache_clear(self) -> int:
        """Evict every UNREFERENCED indexed page back to the free list
        (pinned pages stay). Returns the number reclaimed."""
        dropped = []
        while self._lru:
            pid, _ = self._lru.popitem(last=False)
            key = self._page_key.pop(pid)
            if self._prefix_index.get(key) == pid:
                del self._prefix_index[key]
            del self._page_ref[pid]
            dropped.append(pid)
        self._release_pages(pages=dropped)
        return len(dropped)

    def prefix_stats(self) -> Optional[dict]:
        """Prefix-cache counters, or None when disabled; hit_rate is
        cached prompt tokens / prompt tokens seen by paged admission."""
        if not self.prefix_cache:
            return None
        return {
            "lookups": self.prefix_lookups,
            "hit_pages": self.prefix_hit_pages,
            "hit_tokens": self.prefix_hit_tokens,
            "total_prompt_tokens": self.prefix_total_tokens,
            "hit_rate": (
                self.prefix_hit_tokens / self.prefix_total_tokens
                if self.prefix_total_tokens else 0.0),
            "indexed_pages": len(self._page_ref),
            "lru_pages": len(self._lru),
            "published_pages": self.prefix_published,
            "evictions": self.prefix_evictions,
        }

    def slo_stats(self) -> dict:
        return {
            "sheds": self.slo_sheds,
            "sheds_by_class": dict(self.sheds_by_class),
            "deferrals": self.slo_deferrals,
            "prefill_ms_per_token": self._prefill_ms_per_token,
            "step_ms": self._step_ms,
        }

    # --------------------------- page allocator --------------------------

    def _free_slot(self, i: int) -> None:
        self._slots[i] = _Slot()
        self._active[i] = False
        if self.paged:
            self._release_pages(slot=i)
            # The freed slot keeps decoding (masked): its table must
            # stop referencing returned pages BEFORE reallocation.
            self._table[i] = self._scratch_page
            self._push_tables()

    def _alloc_page(self, grow_slot: Optional[int] = None) -> int:
        """THE single page-allocation path: free list, then LRU-evict
        an unreferenced indexed page, then (overcommit, decode growth)
        preempt a victim slot."""
        while True:
            if self._free_pages:
                return self._free_pages.pop()
            if self._lru:
                pid, _ = self._lru.popitem(last=False)
                key = self._page_key.pop(pid)
                if self._prefix_index.get(key) == pid:
                    del self._prefix_index[key]
                del self._page_ref[pid]
                self.prefix_evictions += 1
                return pid
            if not self.overcommit or grow_slot is None:
                raise RuntimeError(
                    "paged KV pool exhausted mid-decode; size "
                    "kv_num_pages >= num_slots * max_decode_len / "
                    "page_size to rule this out, or enable "
                    "overcommit=True for preemption")
            self._preempt(exclude=grow_slot)

    def _release_pages(self, slot: Optional[int] = None,
                       pages: Optional[list] = None) -> None:
        """THE single page-release path. slot=i returns slot i's OWNED
        pages to the free list, drops its SHARED-page references (a
        refcount reaching zero parks the page in the LRU) and releases
        its reservation; pages=[...] frees unindexed pages directly."""
        if pages:
            self._free_pages.extend(pages)
        if slot is None:
            return
        self._free_pages.extend(self._slot_pages[slot])
        self._slot_pages[slot] = []
        for pid in self._slot_shared[slot]:
            self._page_ref[pid] -= 1
            if self._page_ref[pid] == 0:
                self._lru[pid] = None
                self._avail_pages += 1
        self._slot_shared[slot] = []
        self._avail_pages += self._slot_reserved[slot]
        self._slot_reserved[slot] = 0

    def _grow_pages(self, span: int = 0) -> None:
        """Allocate pages so every active slot's table covers its next
        write positions pos..min(pos + span, total - 1): span 0 is the
        one-token decode step, span gamma the speculative verify block,
        which can cross several page boundaries. Capped at the slot's
        worst-case commit range (tail writes past it land on the scratch
        page through the table's default), so it never exceeds the
        admission reservation. Growth appends OWNED pages only. In
        overcommit mode an empty free list preempts a victim instead of
        raising."""
        positions = self._positions_host
        changed = False
        for i in range(self.num_slots):
            req = self._slots[i].request
            if req is None:
                continue
            total = len(req.prompt) + req.max_new_tokens
            needed = min(positions[i] + span,
                         total - 1) // self.page_size + 1
            while (len(self._slot_shared[i]) +
                   len(self._slot_pages[i])) < needed:
                block = (len(self._slot_shared[i]) +
                         len(self._slot_pages[i]))
                pagenum = self._alloc_page(grow_slot=i)
                self._slot_pages[i].append(pagenum)
                self._table[i, block] = pagenum
                changed = True
        if changed:
            self._push_tables()

    def _preempt(self, exclude: int) -> int:
        """Evict the active slot with the fewest generated tokens and
        re-queue it at the head of its priority class with what it had
        generated. Returns the victim index."""
        candidates = [
            j for j in range(self.num_slots)
            if j != exclude and self._slots[j].request is not None]
        if not candidates:
            raise RuntimeError(
                "paged KV pool exhausted with no preemptible slot — "
                "a single request's live context exceeds the pool")
        victim = min(candidates,
                     key=lambda j: len(self._slots[j].generated))
        slot = self._slots[victim]
        entry = _QueueEntry(slot.request, list(slot.generated))
        pos = 0
        while (pos < len(self._queue) and
               self._queue[pos].request.priority >
               slot.request.priority):
            pos += 1
        self._queue.insert(pos, entry)
        self.preemptions += 1
        self._free_slot(victim)
        return victim

    def _push_tables(self) -> None:
        """Write the canonical block table into the cache's (shared)
        table tensor."""
        self.cache[0]["block_table"].copy_(torch.from_numpy(self._table))

    # ----------------------------- internal ----------------------------

    def _bucket_length(self, n: int) -> int:
        """Round a prompt length up to its bucket (next power of two,
        floored at 16, capped at max_decode_len) — the reference's
        compile buckets, kept so prefill shapes match it."""
        bucket = 16
        while bucket < n:
            bucket *= 2
        return min(bucket, self.max_decode_len)

    def _enqueue(self, entry: _QueueEntry) -> None:
        """Keep the queue sorted by descending priority, then earliest
        TTFT deadline (entries without one sort last, FIFO)."""
        priority = entry.request.priority
        deadline = self._ttft_deadline(entry)
        deadline = float("inf") if deadline is None else deadline
        for k in range(len(self._queue) - 1, -1, -1):
            other = self._queue[k]
            other_deadline = self._ttft_deadline(other)
            if other_deadline is None:
                other_deadline = float("inf")
            if (other.request.priority > priority or
                    (other.request.priority == priority and
                     other_deadline <= deadline)):
                self._queue.insert(k + 1, entry)
                return
        self._queue.insert(0, entry)

    def _ttft_deadline(self, entry: _QueueEntry) -> Optional[float]:
        target = entry.request.ttft_target_ms
        if target is None:
            return None
        return entry.submitted_at + target / 1000.0

    def _shed_expired(self, now: float) -> None:
        """Drop every queued entry whose TTFT deadline is blown by more
        than the shed grace, deepest violation first. Preempted entries
        are exempt (their first token already shipped)."""
        if self.slo_shed_grace_ms is None or self.draining:
            return
        while True:
            worst_k, worst_over = None, 0.0
            for k, entry in enumerate(self._queue):
                if entry.resumed:
                    continue
                deadline = self._ttft_deadline(entry)
                if deadline is None:
                    continue
                over = ((now - deadline) * 1000.0 -
                        self.slo_shed_grace_ms)
                if over > worst_over:
                    worst_k, worst_over = k, over
            if worst_k is None:
                return
            entry = self._queue.pop(worst_k)
            self.slo_sheds += 1
            cls = entry.request.slo_class
            self.sheds_by_class[cls] = \
                self.sheds_by_class.get(cls, 0) + 1
            if self.on_shed is not None:
                self.on_shed(entry.request.request_id,
                             "ttft deadline exceeded")

    def _should_defer(self, entry: _QueueEntry, now: float) -> bool:
        """Hold a prefill back when its predicted stall exceeds
        tpot_stall_factor x the tightest active TPOT target — unless
        its own TTFT deadline would blow while waiting."""
        if self._prefill_ms_per_token is None:
            return False
        targets = [
            s.request.tpot_target_ms for s in self._slots
            if s.request is not None and
            s.request.tpot_target_ms is not None]
        if not targets:
            return False
        tokens = len(entry.request.prompt) + len(entry.resumed)
        if self.prefix_cache:
            matched = self._match_prefix(self._page_keys(
                entry.request.prompt + entry.resumed), tokens)
            tokens -= len(matched) * self.page_size
        stall = self._bucket_length(tokens) * \
            self._prefill_ms_per_token
        if stall <= min(targets) * self.tpot_stall_factor:
            return False
        deadline = self._ttft_deadline(entry)
        if deadline is not None and \
                now + stall / 1000.0 >= deadline:
            return False
        return True

    def _page_keys(self, tokens: list[int]) -> list[bytes]:
        """Chained content hash per FULL page: key_b covers tokens
        [0, (b+1)*page) via H(key_{b-1} || tokens of page b)."""
        keys: list[bytes] = []
        prev = b""
        page = self.page_size
        for b in range(len(tokens) // page):
            digest = hashlib.blake2b(
                prev + np.asarray(tokens[b * page:(b + 1) * page],
                                  np.int64).tobytes(),
                digest_size=16).digest()
            keys.append(digest)
            prev = digest
        return keys

    def _match_prefix(self, keys: list[bytes],
                      num_tokens: int) -> list[int]:
        """Longest indexed page chain, leaving at least one suffix
        token (the first sample needs real last-token logits)."""
        limit = (num_tokens - 1) // self.page_size
        matched: list[int] = []
        for b in range(min(len(keys), limit)):
            pid = self._prefix_index.get(keys[b])
            if pid is None:
                break
            matched.append(pid)
        return matched

    def _publish_pages(self, i: int, keys: list[bytes], m: int,
                       row: np.ndarray, num_tokens: int) -> None:
        """Index this admission's fresh FULL pages under their chain
        keys; each moves from the slot's OWNED list to its SHARED set
        with refcount 1. The partial tail page stays owned."""
        full = num_tokens // self.page_size
        for b in range(m, full):
            key = keys[b]
            if key in self._prefix_index:
                continue
            pid = int(row[b])
            self._slot_pages[i].remove(pid)
            self._slot_shared[i].append(pid)
            self._prefix_index[key] = pid
            self._page_key[pid] = key
            self._page_ref[pid] = 1
            if self.overcommit:
                self._avail_pages -= 1
            else:
                self._slot_reserved[i] -= 1
            self.prefix_published += 1

    def _record_prefill_time(self, key, t0: float,
                             n_tokens: int) -> None:
        """EWMA prefill cost per bucket token; the first sample of each
        bucket is discarded (first-use allocation and, on the card, the
        kernel library's load)."""
        dt_ms = (time.monotonic() - t0) * 1000.0
        if key not in self._timed_buckets:
            self._timed_buckets.add(key)
            return
        per_token = dt_ms / max(1, n_tokens)
        if self._prefill_ms_per_token is None:
            self._prefill_ms_per_token = per_token
        else:
            self._prefill_ms_per_token = (
                0.7 * self._prefill_ms_per_token + 0.3 * per_token)

    def _record_step_time(self, t0: float) -> None:
        """EWMA decode-step wall time; the first sample is discarded."""
        dt_ms = (time.monotonic() - t0) * 1000.0
        self._step_samples += 1
        if self._step_samples == 1:
            return
        if self._step_ms is None:
            self._step_ms = dt_ms
        else:
            self._step_ms = 0.7 * self._step_ms + 0.3 * dt_ms

    # ------------------------------ prefill ------------------------------

    def _init_prefill(self) -> None:
        """The prefill's static state: batch-1 caches for the target's
        prefill model and the draft, and ONE int32 argument buffer
        whose views every prefill reads (``_pf_*``), so that a bucket's
        captured graph replays against the same addresses with the next
        request's values. Admission writes the buffer in one host copy
        (``_push_prefill_args``)."""
        length = self.max_decode_len
        sizes = {"tokens": length, "suffix": length, "len": 1,
                 "start": 1, "slot": 1, "zero": 1}
        if self.paged:
            sizes["pages"] = self.max_blocks
            sizes["prefix"] = length // self.page_size
        self._pf_layout: dict[str, slice] = {}
        offset = 0
        for name, size in sizes.items():
            self._pf_layout[name] = slice(offset, offset + size)
            offset += size
        self._pf_host = np.zeros((offset,), np.int32)
        self._pf_args = torch.zeros((offset,), dtype=torch.int32,
                                    device=self.device)
        for name, where in self._pf_layout.items():
            setattr(self, f"_pf_{name}", self._pf_args[where])
        self._pf_small = inf.init_cache(self._dense_model, 1)
        self._pf_draft_small = (
            inf.init_cache(self._draft_model, 1)
            if self.speculative is not None else None)
        # (kind, bucket) -> (CUDA graph, its logits [vocab]); captured
        # by warmup() only.
        self._prefill_graphs: dict[tuple[str, int], tuple] = {}

    def _set_prefill_args(self, **values) -> None:
        """Write named fields of the host copy of the argument buffer
        (a token list fills the field's head)."""
        for name, value in values.items():
            field = self._pf_host[self._pf_layout[name]]
            value = np.atleast_1d(np.asarray(value, np.int32))
            field[:len(value)] = value

    def _push_prefill_args(self) -> None:
        self._pf_args.copy_(torch.from_numpy(self._pf_host))

    def _prefill(self, kind: str, bucket: int) -> torch.Tensor:
        """One prefill of ``kind`` at ``bucket`` from the pushed
        arguments: a replay of its graph where warm-up captured one,
        else the same work eagerly (the CPU; a bucket a tight pool
        kept warm-up from). Returns the last-token logits [vocab]."""
        captured = self._prefill_graphs.get((kind, bucket))
        if captured is None:
            return self._prefill_body(kind, bucket)
        captured[0].replay()
        return captured[1]

    def _prefill_body(self, kind: str, bucket: int) -> torch.Tensor:
        """The prefill itself, reading only the ``_pf_*`` buffers and
        writing only the device (no host read, no host copy: the body a
        graph captures). ``dense``: the batch-1 prefill copied into slot
        ``_pf_slot``'s first rows, its index set to ``_pf_len``.
        ``paged``: the batch-1 prefill scattered page by page into
        ``_pf_pages``. ``shared``: the batch-1 cache seeded with the
        prefix pages ``_pf_prefix`` (``_pf_start`` rows), the suffix
        ``_pf_suffix`` prefilled after them and its rows scattered into
        ``_pf_pages``. ``draft``: the draft's prefill, copied into its
        cache as ``dense`` does. The paged kinds leave the block table
        and length to ``_install_row``."""
        tokens = self._pf_suffix if kind == "shared" else self._pf_tokens
        prompt = tokens[:bucket][None]
        if kind == "draft":
            model, small, big = (self._draft_model, self._pf_draft_small,
                                 self._draft_cache)
        else:
            model, small, big = self._dense_model, self._pf_small, self.cache
        if kind == "shared":
            start = self._pf_start
            for layer, sm in zip(big, small):
                rows = tfm.prefix_rows_from_pages(layer, self._pf_prefix,
                                                  self.page_size)
                nrows = rows["k"].shape[0]
                for key in rows:
                    sm[key][0, :nrows] = rows[key].to(sm[key].dtype)
                sm["index"].copy_(start)
        else:
            # A fresh batch-1 cache each prefill, as init_cache gives.
            start = self._pf_zero
            for sm in small:
                for t in sm.values():
                    t.zero_()
        last = _dense_prefill(model, self.prefill_chunk, prompt,
                              self._pf_len, small, start)
        if kind in ("paged", "shared"):
            self._scatter_pages(small, start, -(-bucket // self.page_size))
        else:
            slot = self._pf_slot.long()
            for layer, sm in zip(big, small):
                for key, value in sm.items():
                    if key == "index":
                        layer["index"].index_copy_(0, slot, self._pf_len)
                    else:
                        layer[key][:, :value.shape[1]].index_copy_(
                            0, slot, value)
        return last

    def _scatter_pages(self, small: list[dict], start: torch.Tensor,
                       n_blocks: int) -> None:
        """Copy ``n_blocks`` page-sized row blocks of the batch-1 dense
        cache, starting at row ``start`` (each block clamped to stay in
        bounds, like the reference's dynamic slices), into the pool
        pages ``_pf_pages[:n_blocks]`` of every layer. Blocks aimed at
        the scratch page carry padding garbage."""
        page = self.page_size
        firsts = (start.long() + page * torch.arange(
            n_blocks, device=self.device)).clamp(
                max=self.max_decode_len - page)
        rows = (firsts[:, None] + torch.arange(
            page, device=self.device)).reshape(-1)
        ids = self._pf_pages[:n_blocks].long()
        pairs = [("k_pages", "k"), ("v_pages", "v")]
        if "k_page_scales" in self.cache[0]:
            pairs += [("k_page_scales", "k_scale"),
                      ("v_page_scales", "v_scale")]
        for layer, sm in zip(self.cache, small):
            for pool_key, row_key in pairs:
                block = sm[row_key][0].index_select(0, rows)
                layer[pool_key].index_copy_(0, ids, block.reshape(
                    n_blocks, page, *block.shape[1:]).to(
                        layer[pool_key].dtype))

    def _prefill_keys(self, buckets: list[int]) -> list[tuple[str, int]]:
        """The prefills admission can run at ``buckets``: the target's
        (dense or paged), with the prefix cache the shared-prefix
        suffix's, with a draft the draft's."""
        keys = []
        for bucket in buckets:
            keys.append(("paged" if self.paged else "dense", bucket))
            if self.prefix_cache:
                keys.append(("shared", bucket))
            if self.speculative is not None:
                keys.append(("draft", bucket))
        return keys

    def _capture_prefill(self, kind: str, bucket: int) -> None:
        """Capture ``_prefill_body(kind, bucket)`` into a CUDA graph in
        the engine's graph pool, after one eager run of it on arguments
        that touch nothing live: slot 0 of an idle engine, the scratch
        page for every page, a one-token prompt (and for ``shared`` a
        one-page prefix). Capturing records without running."""
        page = self.page_size if self.paged else 0
        start = page if kind == "shared" else 0
        self._set_prefill_args(len=start + 1, start=start, slot=0)
        if self.paged:
            self._set_prefill_args(
                pages=[self._scratch_page] * self.max_blocks,
                prefix=[self._scratch_page] *
                (self.max_decode_len // page))
        self._push_prefill_args()
        self._prefill_body(kind, bucket)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool,
                              capture_error_mode="thread_local"):
            out = self._prefill_body(kind, bucket)
        self._prefill_graphs[(kind, bucket)] = (graph, out)

    def _install_row(self, slot: int, row: np.ndarray,
                     prompt_len: int) -> None:
        self._table[slot] = row
        self._push_tables()
        for big in self.cache:
            big["length"][slot] = prompt_len

    def _admit(self) -> None:
        if self.draining:
            return
        now = time.monotonic()
        self._shed_expired(now)
        for i, slot in enumerate(self._slots):
            if slot.request is not None or not self._queue:
                continue
            entry = self._queue[0]
            req = entry.request
            if self._should_defer(entry, now):
                self.slo_deferrals += 1
                break
            # Resumed (preempted or failed-over) requests re-prefill
            # prompt + what they had already generated, in one pass.
            tokens = req.prompt + entry.resumed
            bucket = self._bucket_length(len(tokens))
            self._set_prefill_args(
                tokens=tokens + [0] * (bucket - len(tokens)),
                len=len(tokens), slot=i)
            t0 = time.monotonic()
            timed_key = ("dense", bucket)
            timed_tokens = bucket
            if self.paged:
                blocks_needed = -(-len(tokens) // self.page_size)
                remaining = req.max_new_tokens - len(entry.resumed)
                worst = -(-(len(tokens) + remaining)
                          // self.page_size)
                keys: list[bytes] = []
                matched: list[int] = []
                if self.prefix_cache:
                    keys = self._page_keys(tokens)
                    matched = self._match_prefix(keys, len(tokens))
                m = len(matched)
                lru_m = sum(1 for pid in matched
                            if self._page_ref[pid] == 0)
                if self.overcommit:
                    # Only the prompt's pages (+1 block of headroom);
                    # exhaustion during decode preempts.
                    want = min(blocks_needed - m +
                               (1 if remaining else 0), worst - m)
                    if (len(self._free_pages) + len(self._lru)
                            - lru_m) < want:
                        break
                else:
                    if self._avail_pages < (worst - m) + lru_m:
                        # Wait for frees rather than risk a mid-decode
                        # exhaustion deadlock between half-grown slots.
                        break
                    self._avail_pages -= worst - m
                    self._slot_reserved[i] = worst - m
                self._queue.pop(0)
                if self.on_admit is not None:
                    self.on_admit(req.request_id)
                # Pin the matched chain (immutable while referenced).
                for pid in matched:
                    if self._page_ref[pid] == 0:
                        del self._lru[pid]
                        self._avail_pages -= 1
                    self._page_ref[pid] += 1
                self._slot_shared[i] = list(matched)
                if self.prefix_cache:
                    self.prefix_lookups += 1
                    self.prefix_hit_pages += m
                    self.prefix_hit_tokens += m * self.page_size
                    self.prefix_total_tokens += len(tokens)
                fresh = [self._alloc_page()
                         for _ in range(blocks_needed - m)]
                self._slot_pages[i] = fresh
                row = np.full((self.max_blocks,), self._scratch_page,
                              np.int32)
                row[:m] = matched
                row[m:blocks_needed] = fresh
                if m:
                    prefix_len = m * self.page_size
                    suffix_tokens = tokens[prefix_len:]
                    sbucket = self._bucket_length(len(suffix_tokens))
                    timed_key = ("shared", sbucket)
                    timed_tokens = sbucket
                    prefix_ids = np.full(
                        (self.max_decode_len // self.page_size,),
                        self._scratch_page, np.int32)
                    prefix_ids[:m] = matched
                    suffix_row = np.full((self.max_blocks,),
                                         self._scratch_page, np.int32)
                    suffix_row[:blocks_needed - m] = fresh
                    self._set_prefill_args(
                        suffix=suffix_tokens +
                        [0] * (sbucket - len(suffix_tokens)),
                        start=prefix_len, prefix=prefix_ids,
                        pages=suffix_row)
                    self._push_prefill_args()
                    last_logits = self._prefill("shared", sbucket)
                else:
                    timed_key = ("paged", bucket)
                    self._set_prefill_args(pages=row)
                    self._push_prefill_args()
                    last_logits = self._prefill("paged", bucket)
                self._install_row(i, row, len(tokens))
                if self.prefix_cache:
                    self._publish_pages(i, keys, m, row, len(tokens))
            else:
                self._queue.pop(0)
                if self.on_admit is not None:
                    self.on_admit(req.request_id)
                self._push_prefill_args()
                last_logits = self._prefill("dense", bucket)
            if self.speculative is not None:
                # The draft cache must hold the same committed prefix (the
                # speculative step's invariant); its logits are unused:
                # the first token comes from the TARGET's prefill.
                self._prefill("draft", bucket)
            first = int(inf._sample(last_logits[None], self._generator,
                                    self.sampling)[0])
            # The prefill-sampled token IS the next generated token.
            self._slots[i] = _Slot(request=req,
                                   generated=entry.resumed + [first])
            if self.on_token is not None:
                self.on_token(req.request_id, first, len(entry.resumed))
            self._tokens[i, 0] = first
            self._positions[i] = len(tokens)
            self._positions_host[i] = len(tokens)
            self._active[i] = True
            # int(...) above waited for the prefill, so t0..now is a
            # faithful admission-stall sample.
            self._record_prefill_time(timed_key, t0, timed_tokens)
