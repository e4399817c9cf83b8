#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (batch_shipyard_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the kernels from ops/csrc with nvcc (sm_90a), one nvcc per
     source, all started together, through the compile cache
     (compilecache/manager.py) into a fresh cache dir: every library a
     new entry, each one's cold nvcc seconds printed (the libraries are
     then copied into build/torch_kernels/, where the ranks and workloads
     the script starts load them); and print each kernel's registers a
     thread, static shared memory and spills (the -Xptxas -v report)
     and K1/K2's dynamic shared memory a block (K6-K8's cluster kernels:
     their plans' dynamic shared memory, cluster size and stages);
  2. hold each kernel against its plain PyTorch version on the card.
     Decode attention (K6-K8): ragged lengths (DECODE_LENGTHS: at the
     cluster kernel's 4 splits some slots keep every split busy, some
     leave splits empty, one is 0), random block tables and a
     NaN-poisoned dead table tail or cache tail, fp32 / bf16 / int8
     pages and the dense int8 cache at D 64 and 128, and at D 16 (the
     speculative draft's depth, its dense cache of 517 rows); each
     planted fault of DECODE_FAULTS (paged and dense alike: one split
     drops a page or a tile, the merge drops a split's denominator, int8
     applies the K scale to V), built alone, must fail it at every
     depth. Flash
     attention (K1 forward, K2 backward): out,
     lse, dq, dk and dv against an fp32 oracle (mha_reference's
     arithmetic with the lse exposed, differentiated by autograd), bf16
     and fp32, causal and full, D 64 and 128, T 128 / 2048 / a ragged
     1000, and the vision models' full-mode bf16 D 64 at T 64, 196 and
     256, with and without an lse cotangent, on strided q/k/v views.
     The flash check reads each output tile by tile, and at the training
     shape it must fail on a copy of the source with faults planted in
     single tiles (FLASH_FAULTS), built beside the kernels. The fused
     cross-entropy (K3 forward, K4 grad_hidden, K5 grad_embedding, alone
     and as the joint backward the training step calls) against its
     plain versions at the training shape (N 32768, D 1024, V 32000,
     bf16 h, fp32 E, 5% of targets ignored), at ragged shapes (N 1000,
     V 700, D 128 and 256, fp32 and bf16; D 1024 fp32) and with every
     target ignored; the fused RMSNorm+matmul (K9) at both training
     shapes and a ragged M 1000 K 128 N 384 in bf16 and fp32. Both are read row by row (lse,
     gold) or tile by tile, and each must fail on its planted faults
     (LOSS_FAULTS, NORM_FAULTS) at the training shape. The int8 quantize
     (K10) and int8 matmul (K11) against their plain versions on the same
     bits, bit for bit (0 differing int8 values, scales or outputs), at
     every training shape (x [32768, 1024] and [32768, 2816] bf16, the
     [1024, 1024], [2816, 1024] and [1024, 2816] weights) and at ragged
     ones (M 300, K 128 and 2816, N 48 and 384, fp32 and bf16, a zero
     row; N 50, where the output is stored from registers); each
     planted fault (QUANT_FAULTS) must fail at every training
     shape. K10's two halves for rows split over tp (bs_row_absmax,
     bs_quantize_scaled) the same way at ragged shapes and at one rank's
     row-parallel operands of the tp mesh runs (x [16384, 512] and
     [16384, 1408], w [1024, 512] and [1024, 1408]), together equal to
     K10 over the same rows bit for bit, each failing on its planted
     fault there. The fused cross-entropy also at one tp rank's
     vocab-parallel shard of the recipe (N 16384, V 16000). The one-device ring schedules (K15 all-gather, K16
     reduce-scatter) bit for bit against their plain versions and against
     the definition (the concatenation; the sum over members within the
     reference test's 1e-4 / 1e-6 relative): rings 2, 4 and 8, chunks 16
     and a ragged 13, 128 features and 3 (K15 in narrower units than 16
     bytes), fp32 and bf16, random and identity-valued shards (member i
     filled with i + 1), K15 in both its designs where its unit is 16
     bytes; then each on large shapes (several tiles a block, the last
     one ragged; K16 also in units narrower than 16 bytes and on a
     misaligned view); their planted faults (RING_FAULTS; K16's two
     each in a build of its own) must fail at ring 4;
  3. time every kernel, its plain version and a library yardstick
     (scaled_dot_product_attention; for K3-K5 and K9 the same products
     alone through torch.matmul at the kernel's precision) at the main
     path's shapes: decode at 8 slots x 16 heads x 64 dims over 512 keys
     (K8 also at the draft's 16 dims over 517 rows),
     flash at the training shape B16 T2048 H16 D64, causal, bf16 (with
     TFLOP/s, and K2 run twice must give the same bits), the
     loss at N 32768 D 1024 V 32000 (the joint backward with its passes
     and its scratch, and again with chunks twice as wide), K9 at M
     32768 K 1024 N 3072 and 5632, K10 and K11 at one layer's seven
     projections (K11's yardstick: torch._int_mm and the two scale
     multiplies; torch._int_mm alone beside it), K10's halves at one
     layer's row-parallel operands beside K10's one pass over the same
     rows (bs_row_absmax's yardstick: the inf-norm); K6-K8 also at the
     serve load's ragged lengths; K1 and K2 also in full mode at the
     vision shapes (B128 H12 T196 and B64 H8 T64, D 64), each beside its
     plain version, SDPA and flash_bound(causal=False);
  4. train the repo's training benchmark model (bench.py
     bench_transformer: vocab 32000, d_model 1024, 12 layers, 16 heads,
     d_ff 2816, bf16 over fp32 parameters, no remat, batch 16 x 2048,
     random weights from seed 0) through TrainHarness for 2 warm-up and
     5 timed steps on one repeated batch. The loss must be finite and
     fall, every step must launch K1 and K2 once per layer and no plain
     attention, and one step's loss and gradients must sit as close to
     an fp32 model as the plain bf16 model does (at batch 2). No
     validation marker is read here, so the loss is the plain slab path
     and K3-K5 and K9 must not launch. Then the same model with
     bench_transformer(fused_norm=True)'s configuration and a marker
     (written to a temp dir after the K3-K5 check passed) that selects
     the fused loss: every step must launch K9 twice per layer, K1 and
     K2 once per layer, K3, K4 and K5 once, and no plain version. Then,
     under the same marker, bench_transformer(quantize=True): every step
     must launch K10 14 times per layer (168), K11 7 times (84), K1 and
     K2 once per layer, K3-K5 once, no K9 and no plain version, and draw
     random bits once per K10 call; its numerics check runs the plain and
     fp32 models on the plain quantize and int8 matmul. All three
     training phases run at full depth;
  4b. (n) the node side (``node_side``): (w), the warm start as bench.py
     bench_compile_warm measures it, run as tasks of the port's own pool.
     A localhost pool (each node a ``python -m
     batch_shipyard_tpu_torch.agent`` process, node prep on) of
     a3-highgpu-1g nodes over a localfs store, in a temp dir. (n1) pool
     add of one node: its node-prep events must be start, ``gpus:<n>``
     with n this host's /dev/nvidia<N>, ``torch_cuda_ready:True``, end.
     (n2) job 1, (w)'s run 1: train_transformer at that bench's child
     widths (WARM_ARGS: vocab 512, d 128, 2 layers, d_ff 256, B2 x T128,
     no remat; 2 heads of 64, where the bench has 4 of 32: K1/K2 take
     depths 64 and 128), the fused loss under the marker, cold into the
     node's cache ($SHIPYARD_COMPILE_CACHE_DIR), building the libraries
     its step needs; the agent's export must then publish
     compilecache/<pool>/latest.json. (n3) pool del, pool add of the same
     pool with two nodes on a new work root; job 2, (w)'s run 2, adds
     --aot-precompile and runs with no nvcc it could reach (its command
     sets PATH without the toolkit's bin and $CUDA_HOME an empty dir): the
     node that claims it must seed from the store first, build nothing
     (0 new entries, its warm-up a cache hit) and give job 1's losses bit
     for bit. (n4) job 3, a gang of 2 instances (jax_distributed on a free
     coordinator port, so the launcher's torch.distributed env), one a
     node, train_transformer at WARM_ARGS over dp 2 on phase 1's
     libraries: both ranks in a group of 2, exactly K1 and K2 once a
     layer, K3-K5 once and the data all-reduce (K14, K13) once a step and
     no plain version, equal parameters, losses within MESH_LOSS_RTOL of
     job 1's. (n5) the CLI leg (``cli_leg``): a configdir in the same
     temp dir (the localfs store, credentials.gcp, a cloud pool --
     ``substrate: tpu_vm``, the A3 VM substrate -- of one node, job 4 =
     job 2's command) and, each a process of its own with a stand-in
     gcloud first on PATH (``write_gcloud_standin``: test scaffolding of
     this script; its ``instances create`` decodes the boot template of
     the VM's startup script and starts the port's agent from it on this
     host, as the VM's boot would), ``python -m
     batch_shipyard_tpu_torch.cli.main --configdir D`` --raw account
     quota, pool add, --raw pool list, jobs add --tail stdout.txt, jobs
     wait --goodput-report, --raw jobs tasks list, --raw pool cache stats,
     --raw goodput job, --raw diag perf and pool del --yes: every command
     exits 0, account quota prints the stand-in's canned GPU types and
     limits, the create argv names a3-highgpu-1g,
     --maintenance-policy=TERMINATE and a startup script, the node row
     carries the stand-in's IP, the VM's node prep reports the card, the
     agent rides on the store-outage wrapper and exits with a journal
     backlog of 0, job 4 completes with its JSON line in the tail, seeds
     from the store and builds nothing, gives job 1's losses bit for bit
     and launches K1/K2 once a layer and K3-K5 once a step with no plain
     version, its goodput report's productive plus badput seconds equal
     its wall within 1%, diag perf holds the pool's create.end, and the
     fresh process's pool del deletes the VM and leaves no agent running.
     (n6) a store outage (``outage_leg``): the port's agent built in this
     process as its process builds it (the ride-through on) over the
     localfs store behind a switch runs job 2's command as a task;
     OUTAGE_AFTER_S into the task every store op fails for OUTAGE_S: the
     task must complete once, unretried, with job 1's losses bit for bit,
     one store_outage goodput row must cover the window and the journal
     must be replayed with backlog 0. Printed: (w)'s lines (each run's
     time to the first step and the speedup, its first step against its
     steady step, the entries each added and each library's cold nvcc
     seconds), each node's node-prep seconds, each job's submit -> task
     start and submit -> complete seconds and the gang's ms a step;
     (n5)'s wall seconds by command (--version: the CLI's start-up,
     which loads no torch), pool add -> task complete, the goodput
     waterfall, the gcloud calls and the leg's seconds; (n6)'s outage
     seconds switched and priced, submit -> complete and the leg's
     seconds;
  5. four sequence-parallel ranks on this one card (``sp_collectives``:
     SP local processes, gloo, the ring kernels' buffers mapped by CUDA
     IPC): K12 (+1 and -1 shifts and its backward through autograd), K13
     and K14 against their definitions on seeded inputs every rank can
     draw, at the sp path's shapes (the (K, V) pair B8 x 2048 x 16 x 64
     bf16; the 187 M-element fp32 gradient bucket), a ragged shape and
     identity-valued shards, K14 bit for bit against the ring order of
     adds; a build with planted copy faults (RING_FAULTS) must fail K12,
     K13 and K14; each rank times K12-K14 (CUDA events, the ranks
     time-sliced on the card), their plain versions over gloo and K12's
     copy_ yardstick from the peer's mapped slot; one step's loss and
     gradients of the sp = 4 kernel path at batch 2 x 2048 must sit as
     close to a single-process fp32 model as train_numerics requires;
     and when rank 3 skips one K12 call of a step shaped like a train
     step's ring calls (four K12, then K14, then K13) every rank must
     raise within SKIP_RAISE_LIMIT_S. Then (at the start of 5b, side by
     side with its (a)) ``--seq-len 8192 --sp 4``
     training at bench_transformer's widths and SP_LAYERS (4) of its 12
     layers (batch 8, remat, the fused loss under the marker) through
     ``python -m torch.distributed.run`` and the workload's entry point,
     1 + 3 steps and one profiled: the
     loss must be finite and fall, and each rank must launch exactly
     sp_launches_per_step(rank) a step and no plain version;
  5b. the training mesh (``train_mesh``), ranks on this card through
     the workload under ``torch.distributed.run``: on eight ranks (a) the
     reference recipe ``--seq-len 8192 --sp 4 --tp 2`` at full width and
     SP_LAYERS (4) layers (batch 8, remat, the fused loss, vocab-parallel over the tp
     ring), (b) ``--sp 2 --fsdp 2`` (dp 2) at 2 layers, (c) ``--sp 2 --tp
     2 --fused-norm`` and (d) ``--sp 2 --tp 2 --int8`` (dp 2) at 2
     layers; on two ranks (e) the MultiSlice-DCN recipe ``--batch 16
     --seq-len 4096 --fsdp 2`` at full width and depth (remat, the fused
     loss), each 1 + 3 steps and one profiled; (a) runs beside the sp
     training above, then (b)-(e), their comparisons and the ring checks
     below run side by side in MESH_ROUNDS (all these times are those of
     shared ranks). Each
     must give finite falling losses, every rank exactly
     mesh_launches_per_step(rank) a step by kernel and by ring axis (K12 on sp rings; K14 + K13 as tp
     all-reduces, the data all-reduce and the fsdp loss all-reduce; K13
     gathers of each fsdp unit, forward and in remat's recompute, and
     K14 scatters of its gradient; K13 gathers of the loss's (lse, gold)
     and of (d)'s absmax; K9 in (c); K10, K11 and K10's halves in (d))
     and no plain version, and one digest of the replicated parameters
     (gathered over fsdp) on every rank and of each tp shard on the
     ranks of its tp index; (a)'s loss at every step within
     MESH_LOSS_RTOL of the sp phase's on the same weights and batch,
     (c)'s and (d)'s within it of the same flags at ``--sp 2`` alone on
     four ranks (dp 2), (e)'s within it of ``--batch 16 --seq-len 4096``
     on two ranks (dp 2), whose parameters' digest it must match, with
     a peak at least FSDP_PEAK_SAVING_GB lower on every rank and at most
     half its resident parameter bytes (plus a lane a unit). Before them
     every ring call of the paths at their shapes, each fsdp unit's
     gather and gradient reduce-scatter included, and (d)'s row-parallel
     int8 operands against K10 over the whole rows, bit for bit on every
     rank (mesh_collectives). In the last round a rank of a small
     recipe-shaped mesh kills itself mid-step and every other rank must
     raise within KILL_RAISE_LIMIT_S;
  5c. checkpoints (``checkpoint``; workloads/checkpoint.py, the loop's
     pool hooks), all dirs in a temp dir the phase removes. (a) One card,
     bench_transformer's fused configuration under the marker through the
     workload's entry point (``--fused-norm --no-remat``, batch 16 x
     2048, ``--warmup 0``): U, 6 uninterrupted steps; P, ``--checkpoint-
     every 2 --keep-last 1`` with a preempt request written first, which
     must exit 75 after step 1 with step 1 committed by a blocking save;
     R, ``--steps 5 --async-checkpoint`` on the same dir, which must
     resume at 1, save 2, 4 and 6 (the final save deduplicated) and
     leave only step 6. R's losses must equal U's steps 2-6 bit for bit,
     every run must launch exactly the fused train phase's kernels a step
     and no plain version, step 6's parameters read back through
     restore_params must have U's final digest, and serve.py
     ``--checkpoint-dir`` must serve them at bench_serving (paged, page
     64, K6, 8 requests) to the last request. It prints the checkpoint's
     bytes, the blocking save's ms, the async snapshot's blocking and
     persist ms, the restore ms and each one's GB/s beside its bound (the
     host link's and the disk's rates, measured here). (b) Four ranks on
     the card through torch.distributed.run, ``--sp 2 --fsdp 2`` at
     --seq-len 8192, batch 8 and 2 layers: 4 uninterrupted steps; 2
     steps and a save (every fsdp rank writes its chunks of the
     parameters and moments); a resume of 2 steps on the same mesh,
     whose losses must be the uninterrupted ones bit for bit and whose
     ranks must read half the parameters and moments each; a resume of
     the same step on ``--sp 2 --tp 2`` (the parameters re-cut), within
     MESH_LOSS_RTOL of them; the first two side by side, then the two
     resumes. It prints each rank's read fraction and restore ms;
  5d. mixture of experts (``moe_phase``, under the marker): (m1)
     bench_transformer's model and batch with ``--moe-experts 8
     --moe-every 2`` (top-1 routing, capacity factor 1.25: 6 MoE layers
     of 8 SwiGLU experts, C 5120), no remat, the fused loss, 2 + 3 steps
     and one profiled: a finite falling loss, exactly K1 and K2 once a
     layer and K3-K5 once a step and no plain version, and a MoE layer's
     forward and backward at the step's shape under
     ``torch.cuda.set_sync_debug_mode("error")``; ms/step, tokens/s,
     MFU (the router and all the experts' E x C buffer rows counted,
     the capacity's padding too), peak
     GB, each MoE layer's dropped-token share and the device ms a step
     by op (the expert products are aten::bmm, the gathers
     aten::index_select). Four ranks on the card (``moe_mesh``): (m2) the
     MoE-Distributed recipe ``--moe-experts 8 --ep 4 --batch 8 --seq-len
     4096`` at the workload's defaults (12 layers, remat, dp 1) and one
     profiled step (ring kernels' ms by axis), (m3) ``--ep 2`` (dp 2) at 2
     layers, each 2 + 3 steps: every rank finite falling losses, exactly
     moe_launches_per_step a step, as counted (K13/K14 all-reduces on
     the ep ring; in (m3) the routing's probabilities gathered by K13 on
     the data ring, which is the tokens ring too) and no plain version;
     against one rank of the same flags at ep 1 with the same weights and
     batch, the same 2 + 3 steps (moe_base): every step's loss, and the
     state after the first step and after the last (every MoE layer's
     router, layer 1's expert shard, against one rank's update), within
     MOE_LIMITS, and layer 1's routing (the first MoE layer, after a dense one) equal
     index for index, and equal to models/moe.route of the ranks' own
     router logits gathered in batch order. (m3) runs again with a
     planted fault, every MoE layer's aux gradient doubled
     (MOE_FAULT_RUNS), which those checks must catch on every rank;
  5e. the vision families (``vision``), after the training phases.
     (v1) bench.py bench_resnet's shape through train_resnet: ResNet-50
     at B256, 224x224, bf16, 3 + 10 steps (img/s a card, ms/step, MFU,
     peak GB; a finite, falling loss), then one fp32 step at batch 8 on
     the card, with its CUDA convolutions (RESNET_FP32_RTOL) and with
     cuDNN's (RESNET_CUDNN_RTOL), against the same step on the CPU.
     (v2) train_resnet over dp 2, both ranks on this card, B32 a rank,
     2 + 2 steps, against one rank on the same 64 images: every loss
     within 2^-8, equal parameter and running-statistic digests on the
     ranks, 53 + 53 + 1 data-ring all-reduces a step (the batch norms'
     statistics and gradient sums, the gradients; K13 and K14 107 a
     step). (v3) ViT-B/16 at 224 (T 196) and 256 (T 256), B128, and the
     DiT at its defaults (d 512, 8 layers, 32/4: T 64), B64, each 2 + 5
     steps through its workload, then 4 DDIM samples of 50 steps:
     exactly 12 K1 and 12 K2 launches a ViT step and 8 and 8 a DiT step
     (8 K1 a sampling step); one step's gradients within TRAIN_SLACK of
     the plain bf16 model's distance from fp32 (train_numerics' rule).
     (v1) and (v3) then profile a step (train_profile: device busy ms,
     idle share, flash and library GEMM ms, the top kernels). The
     phase's seconds and the run's total are printed;
  6. the served decode step as a CUDA graph (decode_graph), for each
     bench_serving cache (paged, paged_int8, dense_int8): one request
     schedule (admissions mid-stream, pages growing past the prompts',
     overcommit preemption with re-prefill on paged_int8) through an
     engine replaying its graph and one held eager must stream
     identical greedy tokens (stream_check); then, on the replaying
     engine, 16 decode steps from one state replayed and eager must
     give identical tokens and state, greedy and with temperature
     (replays repeat under one seed and draw afresh without it;
     graph_check);
  7. serve the repo's serving benchmark model (bench.py bench_serving:
     the same widths, 8 slots, max_decode_len 512) three times through
     ServingFrontEnd + run_load: paged page 64 (K6), paged int8 with
     overcommit over 40 pages (K7), dense int8 (K8), every decode step a
     replay of the graph the warm-up captured and every prefill a replay
     of its bucket's graph. Warm-up must warm every bucket (16-512),
     capture every prefill there and run one decode step eagerly and one
     capture, so each kernel wrapper must count one launch a layer twice
     and no more, and traffic must capture nothing and prefill nothing
     eagerly (``warm``). Each run must finish every request, its kernel
     wrappers must have launched its kernel exactly so and no other, the
     trace of its replayed steps (trace/decode_profile.py's reading of
     the same engine: wall and device-busy ms, idle share, the kernel's
     share) must show its kernel, and no other decode-attention kernel,
     launched exactly once per layer a step, and it must agree with
     the plain attention in a teacher-forced decode of the same tokens;
  8. speculative serving (serve_speculative): bench.py
     bench_serving_speculative's engine (the same target, a draft of
     d_model 256, 2 layers, 16 heads of depth 16, d_ff 768, seed 7,
     gamma 4) under its whole load (32 requests at 16 Hz, prompts and
     generations of 64-128 tokens, seed 0), every step a replay of the
     draft/verify graph the warm-up captured: (s1) dense target, (s2)
     paged page 64, (s3) paged int8 with the draft on the dense int8
     cache (K8 at D 16, (gamma + 1) x 2 launches a step), (s4) a noisy
     copy of the target as draft (some proposals accepted, some not).
     Every request must finish; the wrappers (the warm-up's eager round
     and its capture: (gamma + 1) x 2 launches each) and the trace of
     replayed steps must show K8 in (s3) alone and no K6/K7; 16 replayed
     steps
     must equal 16 eager ones; each stream must equal the
     non-speculative engine's on the same prompt up to its first
     near-tie, a token whose top-2 logit margin there is below the
     largest verify-vs-single-step logit difference on teacher-forced
     tokens (printed, with the streams that stopped early). Then (s1) in
     fp32 on 8 of the requests under the same rule;
  9. the serving tier (serving_tier). (p) the prefill graphs: on
     bench_serving's paged page-64 engine and (s3)'s engine, warm-up
     must return every bucket 16-512 and capture the paged, the
     shared-prefix suffix and the draft prefill at each; a third paged
     engine warmed by ``precompile()`` instead (from shapes) must hold
     the same (kind, bucket) graphs and a decode graph, return the
     reference's count, and have burned no request (no decode step,
     page, slot, prefix-index entry, counter or cache length moved);
     on each engine every replay must equal an eager run of the same
     prefill bit for bit, in the logits and the cache rows of the
     prompt; each one's replayed and eager ms (CUDA events) and device
     kernels are printed; traffic after it captures nothing. (f) bench.py bench_serving_fleet as written: 2
     replicas of the bench_serving model (bf16, dense cache) sharing one
     parameter set behind the port's router, 64 requests at 24 Hz of
     64-128 + 64-128 tokens, seed 0: every request must finish, both
     replicas serve, 4 requests rerun offline on one replica must stream
     the same tokens. (r) failover: two fp32 replicas at the same widths
     on paged page-64 caches (K6), each step slowed by 20 ms, 8 streams;
     (r1) a preempt notice drains one replica mid-stream, (r2) kill()
     severs one mid-stream: no stream lost, every token once, every
     stream the undisturbed fp32 engine's up to its first near-tie (the
     re-prefill-vs-decode logit bound). (o) bench.py bench_serving_slo
     as written (fp32, d_model 256, 4 layers, page 16, K6; 24 diurnal
     requests with 96-token shared prefixes, its three classes), prefix
     cache on and off: the same tokens (sha256), each class's
     attainment and each arm's TTFT printed. K6 with fp32 queries is
     checked at both served shapes in phase 2.

All phases run at full depth but the sp run and the mesh's (a)-(d), the
checkpoint phase's (b) and the MoE phase's (m3). The last two stdout lines are the
{"kernels": [...]} summary (K1-K16, and K10's two halves) and
{"ok": true, "device": {...}}; before them, a "chip_smoke at <s> s:
<phase>" line as each phase starts. Exits nonzero, printing no result,
when no CUDA device is present.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import os
import sys

if __name__ == "__main__" and sys.pycache_prefix is None:
    # An interpreter told to write no bytecode (PYTHONDONTWRITEBYTECODE)
    # over an installation that ships none compiles torch's sources anew
    # in every process (~10 s of an 8-core H100 host's CPU each), and the
    # script starts some hundred ranks and launchers. It keeps one
    # bytecode cache in the checkout's build/ for itself and, through the
    # environment, for every process it starts.
    sys.pycache_prefix = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "pycache")
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

import bisect
import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import gc
import hashlib
import io
import itertools
import json
import math
import pathlib
import re
import shlex
import shutil
import signal
import subprocess
import tempfile
import threading
import types
from typing import Optional

import numpy as np
import torch

from batch_shipyard_tpu_torch.compilecache import manager as cc_manager
from batch_shipyard_tpu_torch.models import inference as inf
from batch_shipyard_tpu_torch.models import moe as moe_mod
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.models.loadgen import load_requests, run_load
from batch_shipyard_tpu_torch.models.server import ServingFrontEnd
from batch_shipyard_tpu_torch.models.serving import (ContinuousBatcher,
                                                     Request)
from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops import attention as attn_ops
from batch_shipyard_tpu_torch.ops import chunked_loss as loss_ops
from batch_shipyard_tpu_torch.ops import decode_attention as dense_ops
from batch_shipyard_tpu_torch.ops import fused_norm as norm_ops
from batch_shipyard_tpu_torch.ops import kernel_select
from batch_shipyard_tpu_torch.ops import paged_attention as paged_ops
from batch_shipyard_tpu_torch.ops import quantization as quant_ops
from batch_shipyard_tpu_torch.ops import ring_collectives as rc
from batch_shipyard_tpu_torch.ops.quantization import quantize_int8_rows
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import mfu
from batch_shipyard_tpu_torch.parallel import sharding
from batch_shipyard_tpu_torch.parallel import train as train_mod
from batch_shipyard_tpu_torch.trace import decode_profile, train_profile
from batch_shipyard_tpu_torch.workloads import distributed
from batch_shipyard_tpu_torch.workloads import train_transformer as train_wl
from batch_shipyard_tpu_torch.workloads.serve import (
    BENCH_DRAFT_MODEL, BENCH_SERVING_KV_CACHES,
    BENCH_SERVING_MAX_LEN as MAX_LEN, BENCH_SERVING_MODEL as MODEL,
    BENCH_SERVING_SLOTS as SLOTS, BENCH_SPEC_GAMMA,
    BENCH_SPECULATIVE_CACHES, bench_params, build_bench_engine,
    build_bench_speculative_engine)

PAGE = BENCH_SERVING_KV_CACHES["paged"][1]["kv_page_size"]
# Published H100 SXM peaks (NVIDIA data sheet, dense): memory rate and
# the operation rate for each input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
            torch.int8: 1979e12, "tf32": 494.7e12}
# Kernel vs plain version: fp32 differs only in summation order; bf16
# rounds p (and the output) at other points; int8 with bf16 queries:
# the kernel dequantizes to fp32, the plain version to bf16.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Teacher-forced decode logits, as RMS over the RMS logit. bf16
# activations through 12 layers of random weights move the logits by a
# few percent from an fp32 model with the same weights (BF16_FLOOR_MAX
# bounds that floor, so a broken fp32 reference cannot pass). The
# kernel model may differ from the plain bf16 model, and from the fp32
# model, by at most FP32_SLACK times that floor.
BF16_FLOOR_MAX = 0.1
FP32_SLACK = 1.25

# Flash kernels against the fp32 oracle (and, at the training shape,
# against their plain versions), tile by tile: the largest
# ||got - want|| / ||want|| over blocks of FLASH_TILE consecutive rows
# of one (batch, head) in out, dq, dk and dv (the kernels' row block),
# where a block's norm counts as at least TILE_FLOOR of the RMS block
# norm. A causal tensor's early rows are far larger than its late ones,
# so a reading against the largest element would not see a fault
# confined to late q- or kv-tiles; a per-block one does. Single rows
# are too fine: a dQ row whose terms cancel (row 1 of a causal head)
# carries the bf16 rounding of O through delta at several percent of
# its own size. fp32 inputs differ only in summation order; bf16 inputs
# round p before P.V and dS before dK/dQ, and every output to bf16
# (2^-9 relative), where the oracle stays in fp32. The bf16 limit sits
# between the sound kernels' reading and the planted faults' (below).
# lse is fp32 in both and held absolutely.
FLASH_TILE = 64
TILE_FLOOR = 0.1
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
LSE_TOL = 1e-4
# Faults planted in a copy of flash_attention.cu, each confined to one
# tile, and the outputs each breaks: the check must fail on every one
# at the training shape. (kernel, line as written, line with the fault,
# outputs.) Each changes a tile count that the kernel's TMA producer and
# its consumers share, so the ring stays in step.
FLASH_FAULTS = (
    # K1: the last q tile (128 rows) skips its diagonal kv tile.
    ("flash_fwd_wgmma_kernel",
     "    return kv_tiles(a, q0 + P::kBM, P::kBN);",
     "    return kv_tiles(a, q0 + P::kBM, P::kBN) - "
     "(q0 == (n_tiles - 1) * P::kBM);", ("out",)),
    # K2, dQ kernel: the same (its last 64 keys, the second warpgroup's
    # diagonal).
    ("flash_bwd_dq_wgmma_kernel",
     "    return kv_tiles(a, q0 + Q::kBM, Q::kBN);",
     "    return kv_tiles(a, q0 + Q::kBM, Q::kBN) - "
     "(q0 == (n_tiles - 1) * Q::kBM);", ("dq",)),
    # K2, dK/dV kernel: the middle kv tile never sees the last q tile.
    ("flash_bwd_dkdv_wgmma_kernel",
     "    const int n_q = cdiv(a.seq, P::kBN);",
     "    const int n_q = cdiv(a.seq, P::kBN) - "
     "(k0 == n_tiles / 2 * P::kBM);", ("dk", "dv")),
)
# The training step against an fp32 model with the same weights, as the
# relative L2 distance of the flattened gradients (and the loss's
# relative difference): the plain bf16 model's distance is the floor,
# which must stay below TRAIN_FLOOR_MAX (so a broken fp32 reference
# cannot pass); the kernel model may sit TRAIN_SLACK times the floor
# from the fp32 model and from the plain model. K2 rounds dS to bf16
# before its products where the plain model's autograd keeps it in
# fp32, hence a wider slack than the serving check's. A single loss is
# noise of either sign, so its floor is at least LOSS_FLOOR_MIN of the
# loss.
TRAIN_FLOOR_MAX = 0.25
TRAIN_SLACK = 1.5
LOSS_FLOOR_MIN = 1e-4
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# The flash kernels' shape on the training path: bench_transformer's
# batch, sequence, heads and head depth.
FLASH_TRAIN_SHAPE = dict(batch=train_wl.BENCH_TRANSFORMER_BATCH,
                         seq=train_wl.BENCH_TRANSFORMER_SEQ,
                         heads=train_wl.BENCH_TRANSFORMER_MODEL["n_heads"],
                         depth=train_wl.BENCH_TRANSFORMER_MODEL["d_head"])
FLASH_SOURCE = "batch_shipyard_tpu_torch/ops/csrc/flash_attention.cu"
# The vision models' attention, full mode at head depth 64: the checked
# lengths (DiT 32/4, ViT-B/16 at 224 and at 256), the timed shapes
# (batch, heads, length) of the main path's runs (ViT-B/16 at 224 and at
# 256, B128; the DiT, B64) and, checked only, the DiT's sampling
# forward (B4).
VISION_FLASH_SEQS = (64, 196, 256)
VISION_FLASH_TIMED = {"vit_b128_t196": (128, 12, 196),
                      "vit_b128_t256": (128, 12, 256),
                      "dit_b64_t64": (64, 8, 64)}
VISION_FLASH_CHECKED = {"dit_sample_b4_t64": (4, 8, 64)}

# Fused cross-entropy (K3-K5) against its plain versions (fp32 products).
# The kernels run their products in TF32: E (and dl) round to 10
# mantissa bits, so a logit carries ~3e-4 of noise at unit scale, the
# gold logit (one logit) as much, lse (a softmax-weighted mean over 32000
# logits) far less. fp32 hidden rows round to TF32 too, bf16 rows do not.
# lse and gold are held per row, absolutely; grad_h and grad_E per
# LOSS_TILE rows, with the TILE_FLOOR rule of tile_err. Each limit sits
# between the sound kernels' reading and the planted faults' (below).
LOSS_TILE = 64
LOSS_LSE_TOL = {torch.bfloat16: 2e-4, torch.float32: 1e-3}
GOLD_TOL = 3e-3
LOSS_GRAD_TOL = 5e-3
LOSS_SOURCE = "batch_shipyard_tpu_torch/ops/csrc/chunked_loss.cu"
LOSS_TRAIN_SHAPE = dict(
    rows=train_wl.BENCH_TRANSFORMER_BATCH * train_wl.BENCH_TRANSFORMER_SEQ,
    vocab=train_wl.BENCH_TRANSFORMER_MODEL["vocab_size"],
    depth=train_wl.BENCH_TRANSFORMER_MODEL["d_model"])
# Faults planted in a copy of chunked_loss.cu, each confined to one (row
# tile, vocab tile) pair. At unit-scale logits the softmax is flat, so a
# pair without a target carries ~1e-4 of its row's grad_h (or its vocab
# row's grad_E), under the TF32 noise; the K4 and K5 faults therefore
# drop the pair that holds a target (row 0's, and the last row's, whose
# targets the check keeps live). They sit in the dl pass's two stores:
# dl (vocab contiguous) is K4's operand alone, dl^T (rows contiguous)
# K5's alone, so each breaks its gradient in K4 (or K5) alone and in the
# joint backward, and nothing else. K3's fault leaves 256 of 32000
# logits out of the first 128 rows' lse, ~8e-3. Each keeps the kernel's
# producer and consumers in step (every tile loaded is still read).
LOSS_FAULTS = (
    # K3: row tile 0 folds every vocab tile but the last into its rows.
    ("xent_fwd_wgmma_kernel", "    fold(st, acc, j * kBN, a.v, tgt, t);",
     "    if (blockIdx.x != 0 || j != n_v - 1) "
     "fold(st, acc, j * kBN, a.v, tgt, t);", ("lse",)),
    # K4: row tile 0 stores zeros as the dl of the vocab tile holding
    # row 0's target.
    ("xent_dl_kernel",
     "    if (p.dl != nullptr) store_dl(p.dl, acc, 1.f, rows, c0, p.np, "
     "f.t);",
     "    if (p.dl != nullptr) store_dl(p.dl, acc, blockIdx.y == 0 && "
     "v0 <= p.tgt[0] && p.tgt[0] < v0 + kBN ? 0.f : 1.f, rows, c0, "
     "p.np, f.t);", ("gh", "gh_joint")),
    # K5: the last row tile stores zeros as the dl^T of the vocab tile
    # holding the last row's target.
    ("xent_dl_kernel",
     "    if (p.dlt != nullptr) store_dlt(p.dlt, acc, 1.f, rows, c0, "
     "p.chunk, f.t);",
     "    if (p.dlt != nullptr) store_dlt(p.dlt, acc, blockIdx.y == "
     "gridDim.y - 1 && v0 <= p.tgt[p.n - 1] && p.tgt[p.n - 1] < v0 + kBN "
     "? 0.f : 1.f, rows, c0, p.chunk, f.t);", ("ge", "ge_joint")),
)

# Fused RMSNorm+matmul (K9) against its plain version, per NORM_TILE
# output block (the kernel's 128 columns by 64 rows). bf16: both round
# the normalized rows to bf16 (r may differ in its last bit, rsqrtf
# against torch.rsqrt, flipping a rare rounding) and the output to bf16
# after fp32 sums in other orders; fp32 differs only in summation order.
NORM_TILE = (64, 128)
NORM_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-5}
NORM_SOURCE = "batch_shipyard_tpu_torch/ops/csrc/fused_norm.cu"
_D_MODEL = train_wl.BENCH_TRANSFORMER_MODEL["d_model"]
NORM_TRAIN_SHAPES = {
    "qkv": (LOSS_TRAIN_SHAPE["rows"], _D_MODEL,
            3 * train_wl.BENCH_TRANSFORMER_MODEL["n_heads"] *
            train_wl.BENCH_TRANSFORMER_MODEL["d_head"]),
    "gate_up": (LOSS_TRAIN_SHAPE["rows"], _D_MODEL,
                2 * train_wl.BENCH_TRANSFORMER_MODEL["d_ff"]),
}
# K9 (the bf16 wgmma kernel): output tile 0 drops the product of its
# first k-slice (its second slice overwrites the accumulator instead of
# adding to it), ~25% of the tile's norm at K 1024.
NORM_FAULTS = (
    ("rmsnorm_matmul_wgmma_kernel",
     "      const uint32_t accumulate = kt > 0;",
     "      const uint32_t accumulate = kt > 0 && (kt != 1 || tile != 0);",
     ("out",)),
)

# Int8 quantize (K10) and int8 matmul (K11) against their plain versions,
# bit for bit: each does the plain version's fp32 operations in the same
# order (K10: the reciprocal-multiply scale, an IEEE division, floor(s +
# u); K11: the exact int32 sum, then (acc * x_scale) * w_scale), so one
# differing int8 value, scale or output element fails the check.
QUANT_SOURCE = "batch_shipyard_tpu_torch/ops/csrc/quantization.cu"
_D_FF = train_wl.BENCH_TRANSFORMER_MODEL["d_ff"]
_ROWS = LOSS_TRAIN_SHAPE["rows"]
# One layer's QuantDense projections on the training path: (rows of x, in
# features, out features) and how many of the layer's seven run at it.
QUANT_TRAIN_SHAPES = {
    "qkvo": ((_ROWS, _D_MODEL, _D_MODEL), 4),
    "gate_up": ((_ROWS, _D_MODEL, _D_FF), 2),
    "down": ((_ROWS, _D_FF, _D_MODEL), 1),
}
QUANT_FAULTS = (
    # K10: row 0 rounds to nearest instead of floor(x / scale + u).
    ("quantize_int8_kernel", "const float r = floorf(__fadd_rn(s, u));",
     "const float r = blockIdx.x == 0 ? rintf(s) : floorf(__fadd_rn(s, u));",
     ("values",)),
    # K11: output tile 0 drops the product of its first k-slice (its
    # second slice overwrites the accumulator instead of adding to it).
    ("int8_matmul_wgmma_kernel",
     "      const uint32_t accumulate = kt > 0;",
     "      const uint32_t accumulate = kt > 0 && (kt != 1 || tile != 0);",
     ("out",)),
    # bs_row_absmax: row 0 reports half its largest |x|.
    ("row_absmax_kernel", "    a.absmax[row] = row_max;",
     "    a.absmax[row] = row == 0 ? 0.5f * row_max : row_max;",
     ("absmax",)),
    # bs_quantize_scaled: row 0 rounds against twice its scale.
    ("quantize_scaled_kernel",
     "  const float row_scale = __ldg(a.scales + row);",
     "  const float row_scale = (row == 0 ? 2.f : 1.f) * __ldg(a.scales + "
     "row);", ("values",)),
)
# K10's two halves on the row-parallel path (o and down under tp 2): one
# rank's x [rows, in / tp] and weight [out, in / tp] at the mesh runs'
# rows (batch 8 x 8192 over dp 2 and sp 2), and how many of a layer's
# calls run at each.
MESH_RANK_ROWS = 8 * 8192 // 4
QUANT_SPLIT_SHAPES = {
    "o": ((MESH_RANK_ROWS, _D_MODEL // 2, _D_MODEL), 1),
    "down": ((MESH_RANK_ROWS, _D_FF // 2, _D_MODEL), 1),
}
# Decode attention (K6-K8). The ragged lengths of check_kernels: at the
# paged kernel's 4 splits over pages of 64 (the dense kernel's 2 over
# units of 128), some slots keep every split busy (200, 333, 511, 512 for
# both), some leave splits empty or are rank 0's alone (1, 63, 64, 65,
# 129), and one is empty (0).
DECODE_SOURCE = "batch_shipyard_tpu_torch/ops/csrc/decode_attention.cu"
DECODE_LENGTHS = [1, 63, 64, 65, 129, 200, 333, 511, 512, 0]
# The head depths check_kernels runs: the served model's 64, 128, and
# the speculative draft's 16 (bench.py bench_serving_speculative: d_model
# 256 over the target's 16 heads), whose dense cache holds DRAFT_ROWS
# rows (max_decode_len + gamma + 1).
DRAFT_DEPTH = BENCH_DRAFT_MODEL["d_head"]
DRAFT_ROWS = MAX_LEN + BENCH_SPEC_GAMMA + 1
DECODE_DEPTHS = (DRAFT_DEPTH, 64, 128)
# The fp32 paged engines the serving tier serves on K6 (heads, page,
# max_decode_len, ragged lengths): the failover phase's bench_serving
# widths on pages of 64, and bench_serving_slo's 4 heads on pages of 16.
SERVED_FP32_PAGED = (
    (16, 64, 512, DECODE_LENGTHS),
    (4, 16, 128, [1, 15, 16, 17, 33, 100, 127, 128, 0]),
)
# Faults planted in copies of decode_attention.cu, one build each, each
# confined to one split of the cluster (decode_cluster, the body both
# cluster kernels run; the dense ones to dense_decode_cluster_kernel):
# check_kernels must fail on every one in the cases it names. (function,
# line as written, line with the fault, cases.)
DECODE_FAULTS = (
    # A rank other than 0 drops its last page.
    ("decode_cluster", "const int p1 = min(np, p0 + per);",
     "const int p1 = max(p0, min(np, p0 + per) - (rank == 1 ? 1 : 0));",
     ("paged", "paged_int8")),
    # The merge drops one rank's denominator.
    ("decode_cluster", "den += w * ml[1];",
     "den += j == 1 ? 0.f : w * ml[1];", ("paged", "paged_int8")),
    # The int8 path applies the K scale to V on one rank.
    ("decode_cluster", "s_p[r] = p * s_vs[r];",
     "s_p[r] = p * (rank == 1 ? s_ks : s_vs)[r];", ("paged_int8",)),
    # Dense: rank 1 drops its last tile.
    ("decode_cluster",
     "const int rows = max(0, min(len, p1 * page) - p0 * page);",
     "const int rows = max(0, min(len, p1 * page) - p0 * page - "
     "(kDense && rank == 1 ? page : 0));", ("dense_int8",)),
    # Dense: the merge drops rank 1's denominator (its numerator stays).
    ("decode_cluster", "const float* ml = s_all[j] + D;",
     "const float ml_[2] = {s_all[j][D], kDense && j == 1 ? 0.f : "
     "s_all[j][D + 1]}; const float* ml = ml_;", ("dense_int8",)),
    # Dense: rank 1 loads the K scales as its V scales.
    ("decode_cluster", "s_vs[r] = a.v_scale[at];",
     "s_vs[r] = (kDense && rank == 1 ? a.k_scale : a.v_scale)[at];",
     ("dense_int8",)),
)
FAULTS = {"flash_attention": FLASH_FAULTS, "chunked_loss": LOSS_FAULTS,
          "fused_norm": NORM_FAULTS, "quantization": QUANT_FAULTS,
          "decode_attention": DECODE_FAULTS}
# Faults built one library each, by source: their indices in FAULTS
# (check_kernels reads each decode fault alone, check_virtual each of
# K16's). Every source also gets one build with all its faults planted,
# unless all of them are built alone.
FAULTS_ONE_BY_ONE = {"decode_attention": tuple(range(len(DECODE_FAULTS)))}

KERNELS = {
    "flash_fwd": dict(
        label="K1", route="cuda", source=FLASH_SOURCE,
        replaces="batch_shipyard_tpu/ops/attention.py:165"),
    "flash_bwd": dict(
        label="K2", route="cuda", source=FLASH_SOURCE,
        replaces="batch_shipyard_tpu/ops/attention.py:277"),
    "xent_fwd": dict(
        label="K3", route="cuda", source=LOSS_SOURCE,
        replaces="batch_shipyard_tpu/ops/chunked_loss.py:57"),
    "xent_bwd_h": dict(
        label="K4", route="cuda", source=LOSS_SOURCE,
        replaces="batch_shipyard_tpu/ops/chunked_loss.py:108"),
    "xent_bwd_e": dict(
        label="K5", route="cuda", source=LOSS_SOURCE,
        replaces="batch_shipyard_tpu/ops/chunked_loss.py:128"),
    "paged_decode": dict(
        label="K6", route="cuda", source=DECODE_SOURCE,
        replaces="batch_shipyard_tpu/ops/paged_attention.py:78"),
    "paged_decode_int8": dict(
        label="K7", route="cuda", source=DECODE_SOURCE,
        replaces="batch_shipyard_tpu/ops/paged_attention.py:104"),
    "dense_decode_int8": dict(
        label="K8", route="cuda", source=DECODE_SOURCE,
        replaces="batch_shipyard_tpu/ops/decode_attention.py:46"),
    "rmsnorm_matmul": dict(
        label="K9", route="cuda", source=NORM_SOURCE,
        replaces="batch_shipyard_tpu/ops/fused_norm.py:48"),
    "quantize_int8": dict(
        label="K10", route="cuda", source=QUANT_SOURCE,
        replaces="batch_shipyard_tpu/ops/quantization.py:41"),
    "int8_matmul": dict(
        label="K11", route="cuda", source=QUANT_SOURCE,
        replaces="batch_shipyard_tpu/ops/quantization.py:105"),
    # K10's halves for rows split over tp: the absmax of this rank's part
    # of each row, and K10's rounding against the scales of the whole
    # rows (the reference's K10 sees the global rows under GSPMD).
    "row_absmax": dict(
        label="K10", route="cuda", source=QUANT_SOURCE,
        replaces="batch_shipyard_tpu/ops/quantization.py:41"),
    "quantize_scaled": dict(
        label="K10", route="cuda", source=QUANT_SOURCE,
        replaces="batch_shipyard_tpu/ops/quantization.py:41"),
}
LOSS_KERNELS = ("xent_fwd", "xent_bwd_h", "xent_bwd_e")
# The kernels that only the tp mesh paths launch.
TP_ONLY_KEYS = ("row_absmax", "quantize_scaled")


class SmokeFailure(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def launch_counts() -> dict:
    """The training path's launch counts and the serving kernels'."""
    return {**train_wl.launch_counts(), **paged_ops.launches,
            **dense_ops.launches}


plain_counts = train_wl.plain_counts


def reset_launch_counts() -> None:
    for counts in (attn_ops.launches, attn_ops.plain_calls,
                   paged_ops.launches, dense_ops.launches,
                   loss_ops.launches, loss_ops.plain_calls,
                   norm_ops.launches, norm_ops.plain_calls,
                   quant_ops.launches, quant_ops.plain_calls,
                   quant_ops.bit_draws, rc.launches, rc.plain_calls,
                   rc.axis_launches):
        for key in counts:
            counts[key] = 0


# ------------------------------ inputs -------------------------------


def paged_case(rng, lengths, heads, depth, page, max_blocks, q_dtype,
               int8, device):
    """Random pool with every slot's live pages drawn without
    replacement. Returns ((q, k_pages, v_pages), lengths, scale kwargs,
    clean table, poisoned table): the clean table's dead tail points at
    a finite stale page, the poisoned one's at a page of NaNs the
    kernel must never read."""
    batch = len(lengths)
    num_pages = batch * max_blocks + 2
    stale, nan_page = num_pages - 2, num_pages - 1
    shape = (num_pages, page, heads, depth)
    k = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    k[nan_page] = float("nan")
    v[nan_page] = float("nan")
    q = torch.from_numpy(rng.standard_normal((batch, 1, heads, depth),
                                             dtype=np.float32))
    table = np.full((batch, max_blocks), stale, np.int32)
    poisoned = np.full((batch, max_blocks), nan_page, np.int32)
    order = rng.permutation(batch * max_blocks)
    for b, n in enumerate(lengths):
        live = -(-n // page)
        table[b, :live] = poisoned[b, :live] = order[
            b * max_blocks:b * max_blocks + live]
    kwargs = {}
    if int8:
        k, ks = quantize_int8_rows(k)
        v, vs = quantize_int8_rows(v)
        kwargs = dict(k_scales=ks.to(device), v_scales=vs.to(device))
    else:
        k, v = k.to(q_dtype), v.to(q_dtype)
    args = (q.to(q_dtype).to(device), k.to(device), v.to(device))
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return (args, lens, kwargs, torch.from_numpy(table).to(device),
            torch.from_numpy(poisoned).to(device))


def dense_case(rng, lengths, heads, depth, rows, q_dtype, device):
    """Random int8 dense cache. Returns (q, k, v, clean scales,
    poisoned scales, lengths): the poisoned scales are NaN on every row
    at or past each slot's length."""
    batch = len(lengths)
    shape = (batch, rows, heads, depth)
    k, ks = quantize_int8_rows(torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)))
    v, vs = quantize_int8_rows(torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)))
    q = torch.from_numpy(rng.standard_normal((batch, 1, heads, depth),
                                             dtype=np.float32))
    ks_p, vs_p = ks.clone(), vs.clone()
    for b, n in enumerate(lengths):
        ks_p[b, n:] = float("nan")
        vs_p[b, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    to = [t.to(device) for t in (k, v, ks, vs, ks_p, vs_p)]
    return (q.to(q_dtype).to(device), *to, lens)


# ------------------------------ checks -------------------------------


def check_result(name, got, want, poisoned, lengths, tol) -> float:
    torch.cuda.synchronize()
    require(torch.equal(got, poisoned),
            f"{name}: output changed when the dead tail held NaNs")
    live = lengths > 0
    require(bool(torch.isfinite(got[live]).all()),
            f"{name}: non-finite output")
    require(not bool(got[~live].any()),
            f"{name}: a length-0 slot did not return zeros")
    err = float((got.float() - want.float()).abs().max())
    require(err <= tol, f"{name}: max |kernel - plain| {err:.3g} > {tol}")
    return err


def fault_err(got, want, lengths) -> float:
    """max |got - want| over the live slots; inf where got is not
    finite there."""
    live = lengths > 0
    got, want = got[live].float(), want[live].float()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - want).abs().max())


def check_kernels(device, fault_libs=()) -> dict:
    """Phase 2a: every kernel against its plain version on ragged cases
    (DECODE_LENGTHS), at D=64 (the served model), D=128 and D=16 (the
    speculative draft's depth; its dense int8 cache has DRAFT_ROWS rows,
    whose last unit is ragged, and one slot fills them). Each build of
    ``fault_libs`` (DECODE_FAULTS, one fault each, in order) runs the
    cases its fault names and must miss the tolerance on at least one at
    every depth. Returns each fault's worst error over tolerance, over
    all depths and at each."""
    rng = np.random.default_rng(0)
    max_blocks = MAX_LEN // PAGE
    worst = [0.0] * len(fault_libs)
    by_depth = {depth: [0.0] * len(fault_libs) for depth in DECODE_DEPTHS}

    def faults_of(case: str):
        return [(i, lib) for i, lib in enumerate(fault_libs)
                if case in DECODE_FAULTS[i][3]]

    def fault_seen(i, depth, ratio):
        worst[i] = max(worst[i], ratio)
        by_depth[depth][i] = max(by_depth[depth][i], ratio)
    for depth in DECODE_DEPTHS:
        lengths = DECODE_LENGTHS
        for q_dtype in (torch.float32, torch.bfloat16):
            for int8 in (False, True):
                name = (f"paged{'_int8' if int8 else ''} D={depth} "
                        f"q={str(q_dtype)[6:]}")
                args, lens, kw, table, poisoned = paged_case(
                    rng, lengths, 4, depth, PAGE, max_blocks, q_dtype,
                    int8, device)
                got = paged_ops.paged_decode_attention_kernel(
                    *args, table, lens, **kw)
                bad = paged_ops.paged_decode_attention_kernel(
                    *args, poisoned, lens, **kw)
                want = paged_ops.paged_decode_attention_reference(
                    *args, table, lens, **kw)
                err = check_result(name, got, want, bad, lens,
                                   TOL[q_dtype])
                print(f"check {name}: max_abs_err {err:.3g} "
                      f"(tol {TOL[q_dtype]})")
                for i, lib in faults_of("paged_int8" if int8 else "paged"):
                    faulty = paged_ops.paged_decode_attention_kernel(
                        *args, table, lens, library=lib, **kw)
                    torch.cuda.synchronize()
                    fault_seen(i, depth, fault_err(faulty, want, lens)
                               / TOL[q_dtype])
            rows = DRAFT_ROWS if depth == DRAFT_DEPTH else MAX_LEN
            name = f"dense_int8 D={depth} L={rows} q={str(q_dtype)[6:]}"
            q, k, v, ks, vs, ks_p, vs_p, lens = dense_case(
                rng, lengths + ([rows] if rows != MAX_LEN else []), 4,
                depth, rows, q_dtype, device)
            got = dense_ops.dense_decode_attention_kernel(
                q, k, v, ks, vs, lens)
            bad = dense_ops.dense_decode_attention_kernel(
                q, k, v, ks_p, vs_p, lens)
            want = dense_ops.dense_decode_attention_reference(
                q, k, v, ks, vs, lens)
            err = check_result(name, got, want, bad, lens, TOL[q_dtype])
            print(f"check {name}: max_abs_err {err:.3g} "
                  f"(tol {TOL[q_dtype]})")
            for i, lib in faults_of("dense_int8"):
                faulty = dense_ops.dense_decode_attention_kernel(
                    q, k, v, ks, vs, lens, library=lib)
                torch.cuda.synchronize()
                fault_seen(i, depth, fault_err(faulty, want, lens)
                           / TOL[q_dtype])
    # K6 with fp32 queries at the served fp32 engines' shapes.
    for heads, page, rows, lengths in SERVED_FP32_PAGED:
        name = f"paged D=64 q=float32 H={heads} page={page} L={rows}"
        args, lens, kw, table, poisoned = paged_case(
            rng, lengths, heads, 64, page, rows // page, torch.float32,
            False, device)
        got = paged_ops.paged_decode_attention_kernel(*args, table, lens)
        bad = paged_ops.paged_decode_attention_kernel(*args, poisoned,
                                                      lens)
        want = paged_ops.paged_decode_attention_reference(*args, table,
                                                          lens)
        err = check_result(name, got, want, bad, lens, TOL[torch.float32])
        print(f"check {name}: max_abs_err {err:.3g} "
              f"(tol {TOL[torch.float32]})")
    for i, (kernel, line, _, _) in enumerate(DECODE_FAULTS):
        ratios = {depth: by_depth[depth][i] for depth in DECODE_DEPTHS}
        print(f"check planted decode fault ({line!r}): worst error "
              f"{worst[i]:.3g} x the tolerance; by depth {ratios}",
              flush=True)
        require(min(ratios.values()) > 1.0,
                f"decode fault {line!r} passed the check at a depth: "
                f"{ratios}")
    return {"fault_err_over_tol": worst,
            "fault_err_over_tol_by_depth": by_depth}


# ------------------------------ timing -------------------------------


def device_ms(fn, sets, iters: int) -> float:
    """Device time per call of fn(*sets[i % len(sets)]), from CUDA
    events around ``iters`` calls queued behind a spin kernel, so the
    host's enqueue cost stays off the clock. Fails if the host had not
    finished queueing before the timed region began."""
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 3e9 cycles a second of host time: at least 1.5 s of spin per
    # second of queueing at the H100's clocks. A host that queues slower
    # than it did untimed (the machine's other load) gets a spin four
    # times as long, twice, before the reading is refused.
    for attempt in range(3):
        torch.cuda._sleep(int(3e9 * host_s * 4 ** attempt) + 1_000_000)
        start.record()
        for i in range(iters):
            fn(*sets[i % len(sets)])
        end.record()
        behind = start.query()
        end.synchronize()
        if not behind:
            return start.elapsed_time(end) / iters
    raise SmokeFailure("timing: the host fell behind the card")


def roofline(nbytes: int, ops: int, peak) -> dict:
    """The least time for ``nbytes`` moved at the HBM rate and ``ops``
    done at PEAK_OPS[peak]: the larger of the two, and which it is."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[peak] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms}


def bound(lengths, heads, depth, kv_dtype, q_dtype, page=None) -> dict:
    """Least time for the work these inputs need: each live K/V row (and
    int8 scale) read once, q read and the output written once, the live
    block-table entries and lengths read once; 4*D operations per live
    (slot, head, key). The larger of bytes / HBM rate and operations /
    the peak rate of the cache's type."""
    kv_elt = torch.empty((), dtype=kv_dtype).element_size()
    q_elt = torch.empty((), dtype=q_dtype).element_size()
    keys = sum(lengths)
    nbytes = keys * heads * depth * 2 * kv_elt
    if kv_dtype == torch.int8:
        nbytes += keys * heads * 2 * 4
    nbytes += 2 * len(lengths) * heads * depth * q_elt + len(lengths) * 4
    if page:
        nbytes += sum(-(-n // page) for n in lengths) * 4
    ops = keys * heads * depth * 4
    return roofline(nbytes, ops, kv_dtype)


def sdpa_view(rows, scales=None):
    """[B, L, H, D] rows (int8 with [B, L, H] scales, or bf16) -> the
    bf16 [B, H, L, D] layout scaled_dot_product_attention takes."""
    if scales is not None:
        rows = rows.float() * scales[..., None]
    return rows.to(torch.bfloat16).transpose(1, 2).contiguous()


def measure(kernel, plain, sets, lib_sets, **bound_kwargs) -> dict:
    """Check kernel against plain on the first set, then time kernel,
    plain (on 4 sets, still past L2) and the SDPA yardstick."""
    got, want = kernel(*sets[0]), plain(*sets[0])
    err = float((got.float() - want.float()).abs().max())
    require(err <= TOL[torch.bfloat16],
            f"{kernel.__name__}: max |kernel - plain| {err}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return dict(max_abs_err=err, ms=device_ms(kernel, sets, 96),
                plain_ms=device_ms(plain, sets[:4], 16),
                library_ms=device_ms(sdpa, lib_sets, 96),
                **bound(**bound_kwargs))


# The serve load's ragged lengths (prompts of 64-128 tokens, 64-128 new
# ones): 8 slots spread evenly over 64-256 keys, every layer alike.
SERVED_LENGTHS = np.linspace(64, 256, SLOTS).round().astype(int).tolist()


def time_paged(rng, lengths, int8, device) -> dict:
    """measure() for the paged kernel at these lengths over n_layers
    input sets; SDPA reads the gathered rows up to the longest slot,
    masked past each slot's length where they differ."""
    batch, heads, depth = SLOTS, MODEL["n_heads"], MODEL["d_head"]
    keys = max(lengths)
    mask = None
    if min(lengths) < keys:
        mask = (torch.arange(keys, device=device)[None, :] <
                torch.tensor(lengths, device=device)[:, None])[:, None, None]
    sets, lib_sets = [], []
    for _ in range(MODEL["n_layers"]):
        (q, kp, vp), lens, kw, table, _ = paged_case(
            rng, lengths, heads, depth, PAGE, MAX_LEN // PAGE,
            torch.bfloat16, int8, device)
        ks, vs = kw.get("k_scales"), kw.get("v_scales")
        sets.append((q, kp, vp, table, lens, ks, vs))
        flat = table.long()

        def gathered(pages, scales):
            rows = pages[flat].reshape(batch, MAX_LEN, heads, depth)[:, :keys]
            if scales is not None:
                scales = scales[flat].reshape(batch, MAX_LEN, heads)[:, :keys]
            return sdpa_view(rows, scales)
        lib_sets.append((sdpa_view(q), gathered(kp, ks), gathered(vp, vs),
                         mask))
    return measure(
        paged_ops.paged_decode_attention_kernel,
        paged_ops.paged_decode_attention_reference, sets, lib_sets,
        lengths=lengths, heads=heads, depth=depth, q_dtype=torch.bfloat16,
        kv_dtype=torch.int8 if int8 else torch.bfloat16, page=PAGE)


def time_dense(rng, lengths, device, depth=MODEL["d_head"],
               rows=MAX_LEN, layers=MODEL["n_layers"]) -> dict:
    """measure() for the dense kernel at these lengths over ``layers``
    input sets of a [SLOTS, rows, 16, depth] cache; SDPA reads the cache
    up to the longest slot, masked past each slot's length where they
    differ."""
    heads = MODEL["n_heads"]
    keys = max(lengths)
    mask = None
    if min(lengths) < keys:
        mask = (torch.arange(keys, device=device)[None, :] <
                torch.tensor(lengths, device=device)[:, None])[:, None, None]
    sets, lib_sets = [], []
    for _ in range(layers):
        q, k, v, ks, vs, _, _, lens = dense_case(
            rng, lengths, heads, depth, rows, torch.bfloat16, device)
        sets.append((q, k, v, ks, vs, lens))
        lib_sets.append((sdpa_view(q), sdpa_view(k[:, :keys], ks[:, :keys]),
                         sdpa_view(v[:, :keys], vs[:, :keys]), mask))
    return measure(
        dense_ops.dense_decode_attention_kernel,
        dense_ops.dense_decode_attention_reference, sets, lib_sets,
        lengths=lengths, heads=heads, depth=depth, q_dtype=torch.bfloat16,
        kv_dtype=torch.int8)


def time_kernels(device) -> dict:
    """Phase 2b: kernel, plain version and the SDPA yardstick at the
    serving shape, all slots full (512 keys), and again at the serve
    load's ragged lengths (SERVED_LENGTHS). Inputs cycle through
    n_layers distinct sets, as a decode step does, so the 50 MB L2
    cannot hold them across calls."""
    lengths = [MAX_LEN] * SLOTS
    rng = np.random.default_rng(1)
    timers = {"paged_decode": functools.partial(time_paged, int8=False),
              "paged_decode_int8": functools.partial(time_paged, int8=True),
              "dense_decode_int8": time_dense}
    out = {}
    for key, timer in timers.items():
        out[key] = timer(rng, lengths, device=device)
        served = timer(rng, SERVED_LENGTHS, device=device)
        out[key]["served_lengths"] = {
            "lengths": SERVED_LENGTHS,
            **{k: served[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "library_ms", "bound_ms",
                                      "bound_by")}}
    # K8 at the speculative draft's shape: D 16 over DRAFT_ROWS rows, the
    # draft's two layers' caches (each read (gamma + 1) times a step).
    draft = {}
    for label, lengths in (("full", [DRAFT_ROWS] * SLOTS),
                           ("served_lengths", SERVED_LENGTHS)):
        reading = time_dense(rng, lengths, device, depth=DRAFT_DEPTH,
                             rows=DRAFT_ROWS, layers=2)
        draft[label] = {"lengths": lengths, **{
            k: reading[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by",
                                    "bytes")}}
        print(f"time K8 dense_decode_int8 at D {DRAFT_DEPTH}, "
              f"{DRAFT_ROWS} rows, {label}: kernel "
              f"{reading['ms'] * 1e3:.2f} us, plain "
              f"{reading['plain_ms'] * 1e3:.2f} us, sdpa "
              f"{reading['library_ms'] * 1e3:.2f} us, bound "
              f"{reading['bound_ms'] * 1e3:.2f} us ({reading['bound_by']}, "
              f"{reading['bytes']} B)", flush=True)
    out["dense_decode_int8"]["draft_d16"] = draft
    for key, row in out.items():
        print(f"time {KERNELS[key]['label']} {key}: kernel "
              f"{row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f}"
              f" us, sdpa {row['library_ms'] * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
              f"{row['bytes']} B)")
        served = row.get("served_lengths")
        if served:
            print(f"time {KERNELS[key]['label']} {key} at the served "
                  f"lengths {served['lengths']}: kernel "
                  f"{served['ms'] * 1e3:.2f} us, plain "
                  f"{served['plain_ms'] * 1e3:.2f} us, sdpa (masked) "
                  f"{served['library_ms'] * 1e3:.2f} us, bound "
                  f"{served['bound_ms'] * 1e3:.2f} us")
    return out


# --------------------------- flash attention --------------------------


def flash_oracle(q, k, v, g, g_lse, causal):
    """fp32 (out [B, T, H, D], lse [B*H, T, 1], (dq, dk, dv)) of
    mha_reference's arithmetic on q, k, v upcast to fp32, with the lse
    exposed, differentiated by autograd against cotangents g, g_lse."""
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / math.sqrt(
        q.shape[-1])
    if causal:
        seq = q.shape[1]
        allowed = torch.ones(seq, seq, dtype=torch.bool,
                             device=q.device).tril()
        scores = scores.masked_fill(~allowed, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)                 # [B, H, T]
    out = torch.einsum("bhqk,bkhd->bqhd",
                       torch.exp(scores - lse[..., None]), vf)
    lse = lse.reshape(-1, q.shape[1], 1)
    grads = torch.autograd.grad(
        (out * g.float()).sum() + (lse * g_lse).sum(), (qf, kf, vf))
    with torch.no_grad():
        ref = attn_ops.mha_reference(qf, kf, vf, causal)
    require(float((ref - out.detach()).abs().max()) <= 1e-5,
            "flash oracle disagrees with mha_reference")
    return out.detach(), lse.detach(), grads


def tile_err(got, want) -> float:
    """max over blocks of FLASH_TILE rows (of one batch and head) of
    ||got - want|| / ||want||, with ||want|| taken as at least
    TILE_FLOOR of the RMS block norm. got, want: [B, T, H, D]."""
    got, want = got.detach().float(), want.detach().float()
    batch, seq, heads, depth = want.shape
    pad = -seq % FLASH_TILE
    shape = (batch, (seq + pad) // FLASH_TILE, FLASH_TILE, heads, depth)

    def block_norms(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(shape).square().sum(dim=(2, 4)).sqrt()
    norms = block_norms(want)
    floor = TILE_FLOOR * float(norms.square().mean().sqrt())
    return float((block_norms(got - want) / norms.clamp_min(floor)).max())


def check_flash(device) -> None:
    """Phase 2b: K1 and K2 through flash_attention(_with_lse) against
    the fp32 oracle. q, k, v are strided views of one fused [B, T, 3, H,
    D] tensor, as a fused projection would give them. Every case is
    read and printed before the first failure is raised."""
    rng = np.random.default_rng(3)
    batch, heads = 2, 2
    failed = []
    cases = [(dtype, depth, seq, causal)
             for dtype in (torch.bfloat16, torch.float32)
             for depth in (64, 128) for seq in (128, 2048, 1000)
             for causal in (True, False)]
    # The vision models' full-mode shapes (D 64; ragged kv tiles at 196
    # and 64 keys).
    cases += [(torch.bfloat16, 64, seq, False) for seq in VISION_FLASH_SEQS]
    for dtype, depth, seq, causal in cases:
        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(device)
        fused = randn(batch, seq, 3, heads, depth).to(dtype)
        q, k, v = (fused[:, :, i].detach().requires_grad_()
                   for i in range(3))
        g = randn(batch, seq, heads, depth).to(dtype)
        g_lse = randn(batch * heads, seq, 1)
        worst, worst_lse = 0.0, 0.0
        for with_lse in (True, False):
            cot = g_lse if with_lse else torch.zeros_like(g_lse)
            want_out, want_lse, want_grads = flash_oracle(
                q, k, v, g, cot, causal)
            if with_lse:
                out, lse = attn_ops.flash_attention_with_lse(q, k, v, causal)
                grads = torch.autograd.grad((out, lse), (q, k, v),
                                            (g, g_lse))
                require(lse.dtype == torch.float32, "flash: lse dtype")
                worst_lse = float((lse.detach() - want_lse).abs().max())
            else:
                out = attn_ops.flash_attention(q, k, v, causal)
                grads = torch.autograd.grad(out, (q, k, v), g)
            torch.cuda.synchronize()
            require(all(t.dtype == dtype for t in (out, *grads)),
                    "flash: output dtype")
            for got, want in [(out, want_out), *zip(grads, want_grads)]:
                require(bool(torch.isfinite(got).all()),
                        "flash: non-finite output")
                worst = max(worst, tile_err(got, want))
        name = (f"flash {str(dtype)[6:]} D={depth} T={seq} "
                f"{'causal' if causal else 'full'}")
        print(f"check {name}: max tile err (out, dq, dk, dv; with and "
              f"without g_lse) {worst:.3g} (tol {FLASH_TOL[dtype]}), lse "
              f"max abs err {worst_lse:.3g} (tol {LSE_TOL})", flush=True)
        if worst > FLASH_TOL[dtype] or worst_lse > LSE_TOL:
            failed.append(name)
    require(not failed, f"flash: outside tolerance: {failed}")


def kernel_body(text: str, kernel: str) -> tuple[int, int]:
    """[start, end) of the body of ``__global__ ... kernel(...) {...}`` (or
    of a ``__device__`` function a kernel runs) in a CUDA source: braces
    matched, string literals and comments skipped."""
    found = re.search(r"__(?:global|device)__[^;{]*?\b" + re.escape(kernel) +
                      r"\(", text)
    if found is None:
        raise SmokeFailure(f"no __global__ or __device__ {kernel} in the "
                           f"source")
    start = text.index("{", found.end())
    depth, i = 0, start
    while i < len(text):
        if text.startswith("//", i):
            i = text.index("\n", i)
        elif text[i] == '"':
            i = text.index('"', i + 1)
            while text[i - 1] == "\\":
                i = text.index('"', i + 1)
        elif text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return start, i + 1
        i += 1
    raise SmokeFailure(f"unbalanced braces in {kernel}")


def plant_faults(name: str, only: Optional[int] = None) -> str:
    """csrc/<name>.cu with FAULTS[name] planted (or only its entry
    ``only``). Raises unless each anchor occurs exactly once in the
    source, inside the body of its named kernel, and its fault changes
    it."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    faults = FAULTS[name] if only is None else (FAULTS[name][only],)
    for kernel, line, fault, _ in faults:
        start, end = kernel_body(text, kernel)
        require(text.count(line) == 1 and start <= text.find(line) and
                text.find(line) + len(line) <= end and fault != line,
                f"{name}: the fault anchor for {kernel} is not once in its "
                f"body: {line!r}")
        at = text.index(line)
        text = text[:at] + fault + text[at + len(line):]
    return text


def build_fault_library(workdir: pathlib.Path,
                        name: str = "flash_attention",
                        only: Optional[int] = None):
    """csrc/<name>.cu with FAULTS[name] (or its entry ``only``) planted
    (plant_faults), built in workdir. Returns (library path, seconds)."""
    text = plant_faults(name, only)
    tag = "" if only is None else str(only)
    source = workdir / f"{name}_faults{tag}.cu"
    source.write_text(text)
    target = workdir / f"lib{name}_faults{tag}.so"
    return target, _build.compile_source(source, target)


def flash_bound(batch, seq, heads, depth, causal, backward) -> dict:
    """Least time for the function at bf16: each input read once, each
    output written once; 2 FLOPs per multiply-add over the (query, key)
    pairs the mask keeps, two products in the forward (QK^T, PV), five
    in the backward (QK^T, dO V^T, P^T dO, dS^T Q, dS K)."""
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    ops = 2 * (5 if backward else 2) * batch * heads * pairs * depth
    tensor = batch * seq * heads * depth * 2
    vector = batch * heads * seq * 4
    nbytes = 7 * tensor + 2 * vector if backward else 4 * tensor + vector
    return roofline(nbytes, ops, torch.bfloat16)


def ptxas_report(log: str, namer=None) -> dict:
    """Each entry function of a build's ``-Xptxas -v`` report: registers a
    thread, static shared memory and spill bytes, by short name
    (``namer``; by default kernel_short_name, as in
    ``flash_fwd_wgmma_kernel<64>``)."""
    namer = namer or kernel_short_name
    report, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = namer(found.group(1))
            report.setdefault(name, {})
            continue
        if name is None:
            continue
        used = re.search(r"Used (\d+) registers", line)
        if used:
            report[name]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[name]["smem"] = int(smem.group(1)) if smem else 0
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            report[name]["spill_stores"] = int(spill.group(1))
            report[name]["spill_loads"] = int(spill.group(2))
    return report


def kernel_short_name(mangled: str) -> str:
    """``_ZN...22flash_fwd_wgmma_kernelILi64EEEv...`` ->
    ``flash_fwd_wgmma_kernel<64>``: the first length-prefixed name in the
    mangled one that ends in ``kernel``, with its integer template
    argument (the mangled name where there is none)."""
    for run in re.finditer(r"\d+", mangled):
        digits = run.group()
        for i in range(len(digits)):  # the length is a suffix of the run
            size = int(digits[i:])
            name = mangled[run.end():run.end() + size]
            if size > 6 and name.endswith("kernel") and \
                    re.fullmatch(r"[A-Za-z_]\w*", name):
                arg = re.match(r"ILi(\d+)E", mangled[run.end() + size:])
                return name + (f"<{arg.group(1)}>" if arg else "")
    return mangled


# Template arguments of the cluster kernels as mangled: float,
# __nv_bfloat16 (its later uses a substitution, S<n>_) and int8_t.
_MANGLED_TYPES = {"f": "fp32", "13__nv_bfloat16": "bf16", "a": "int8"}


def paged_kernel_name(mangled: str) -> str:
    """``...paged_decode_cluster_kernelI13__nv_bfloat16aLi64EE...`` ->
    ``paged_decode_cluster_kernel<bf16, int8, 64>`` (the page type that
    repeats the query's is a substitution) and
    ``...dense_decode_cluster_kernelI13__nv_bfloat16Li64EE...`` ->
    ``dense_decode_cluster_kernel<bf16, 64>``; other kernels as
    kernel_short_name names them."""
    found = re.search(r"paged_decode_cluster_kernelI(f|13__nv_bfloat16)"
                      r"(f|a|S\d*_)Li(\d+)E", mangled)
    if found is not None:
        q = _MANGLED_TYPES[found.group(1)]
        kv = _MANGLED_TYPES.get(found.group(2), q)
        return f"paged_decode_cluster_kernel<{q}, {kv}, {found.group(3)}>"
    found = re.search(r"dense_decode_cluster_kernelI(f|13__nv_bfloat16)"
                      r"Li(\d+)E", mangled)
    if found is not None:
        return (f"dense_decode_cluster_kernel<"
                f"{_MANGLED_TYPES[found.group(1)]}, {found.group(2)}>")
    return kernel_short_name(mangled)


def decode_resources(log: str) -> dict:
    """K6's, K7's and K8's cluster kernels at the served shape (bf16
    queries, bf16 or int8 pages or the dense int8 cache, D 64, 512 keys
    in pages or units of 64): registers a thread and spills (ptxas),
    static and dynamic shared memory a block, threads, cluster size and
    ring stages (the library's plan), keyed as the kernels line is."""
    report = ptxas_report(log, paged_kernel_name)
    depth = MODEL["d_head"]
    plans = {
        "paged_decode": (
            f"paged_decode_cluster_kernel<bf16, bf16, {depth}>",
            paged_ops.paged_decode_plan(depth, PAGE, MAX_LEN // PAGE,
                                        torch.bfloat16)),
        "paged_decode_int8": (
            f"paged_decode_cluster_kernel<bf16, int8, {depth}>",
            paged_ops.paged_decode_plan(depth, PAGE, MAX_LEN // PAGE,
                                        torch.int8)),
        "dense_decode_int8": (
            f"dense_decode_cluster_kernel<bf16, {depth}>",
            dense_ops.dense_decode_plan(depth, MAX_LEN)),
    }
    out = {}
    for key, (name, plan) in plans.items():
        usage = report.get(name, {})
        row = {"kernel": name, "registers": usage.get("registers"),
               "spill_bytes": usage.get("spill_stores", 0) +
               usage.get("spill_loads", 0),
               "static_smem_bytes": usage.get("smem"),
               "threads": 128, "cluster_size": plan["splits"],
               "blocks": SLOTS * MODEL["n_heads"] * plan["splits"],
               **{k: plan[k] for k in ("dynamic_smem_bytes", "stages",
                                       "stage_bytes", "tile_rows")}}
        out[key] = row
        print(f"resources {name}: {row['registers']} registers a thread, "
              f"{row['spill_bytes']} bytes spilled, "
              f"{row['static_smem_bytes']} + {row['dynamic_smem_bytes']} "
              f"bytes of static + dynamic shared memory a block, "
              f"{row['threads']} threads, clusters of "
              f"{row['cluster_size']} ({row['blocks']} blocks), "
              f"{row['stages']} stages of {row['stage_bytes']} bytes",
              flush=True)
    return out


def quant_resources(report: dict) -> dict:
    """K11's kernel: registers a thread, static shared memory and spills
    (ptxas; its ring and staging, mm::kSmem, are dynamic)."""
    name = "int8_matmul_wgmma_kernel"
    usage = report.get(name, {})
    row = {"kernel": name, "registers": usage.get("registers"),
           "spill_bytes": usage.get("spill_stores", 0) +
           usage.get("spill_loads", 0),
           "static_smem_bytes": usage.get("smem"), "threads": 384}
    print(f"resources {name}: {row['registers']} registers a thread, "
          f"{row['spill_bytes']} bytes spilled, {row['static_smem_bytes']} "
          f"bytes of static shared memory, {row['threads']} threads",
          flush=True)
    return row


def flash_resources(report: dict) -> dict:
    """K1's and K2's bf16 kernels at D 64 and 128: registers a thread and
    spills (ptxas) and dynamic shared memory a block (the library's own
    sizes), keyed as the kernels line is."""
    lib = _build.library("flash_attention")
    out = {"flash_fwd": {}, "flash_bwd": {}}
    for depth in attn_ops.SUPPORTED_DEPTHS:
        smem = (ctypes.c_longlong * 3)()
        _build.check(lib.bs_flash_attention_smem(depth, smem),
                     "flash shared memory sizes", lib)
        for i, kernel in enumerate(("flash_fwd_wgmma_kernel",
                                    "flash_bwd_dkdv_wgmma_kernel",
                                    "flash_bwd_dq_wgmma_kernel")):
            name = f"{kernel}<{depth}>"
            usage = report.get(name, {})
            row = {"registers": usage.get("registers"),
                   "spill_bytes": usage.get("spill_stores", 0) +
                   usage.get("spill_loads", 0),
                   "dynamic_smem_bytes": smem[i]}
            out["flash_fwd" if i == 0 else "flash_bwd"][name] = row
            print(f"resources {name}: {row['registers']} registers a "
                  f"thread, {row['spill_bytes']} bytes spilled, "
                  f"{row['dynamic_smem_bytes']} bytes of shared memory a "
                  f"block", flush=True)
    return out


def check_flash_faults(sound, faulty, want) -> dict:
    """Each output of the sound kernels, and of the planted-fault build,
    against the plain versions: the sound ones must sit within
    FLASH_TOL, each output a fault breaks must fall outside it. Prints
    the per-tile reading and, beside it, max |error| / max |plain|."""
    tol = FLASH_TOL[torch.bfloat16]
    broken = {name for *_, outs in FLASH_FAULTS for name in outs}
    readings, failed = {}, []
    for name in ("out", "dq", "dk", "dv"):
        row = {"sound": tile_err(sound[name], want[name]),
               "fault": tile_err(faulty[name], want[name]),
               "fault_max_over_max": _rel(faulty[name].float(),
                                          want[name].float(), torch.amax)}
        readings[name] = row
        print(f"check training-shape {name}: max tile err "
              f"{row['sound']:.3g}"
              f" sound, {row['fault']:.3g} with the planted fault (tol "
              f"{tol}); the fault's max|err|/max|plain| "
              f"{row['fault_max_over_max']:.3g}", flush=True)
        if row["sound"] > tol:
            failed.append(f"{name} sound")
        if name in broken and row["fault"] <= tol:
            failed.append(f"{name} planted fault passed")
    require(not failed, f"flash at the training shape: {failed}")
    return readings


def time_flash(device, fault_lib) -> dict:
    """Phase 3b: K1 and K2 at the training shape against their plain
    versions (and the planted-fault build against the same) and the
    SDPA yardstick (forward; backward alone, from a retained graph; and
    forward plus backward)."""
    batch, seq, heads, depth = (FLASH_TRAIN_SHAPE[k] for k in
                                ("batch", "seq", "heads", "depth"))
    gen = torch.Generator(device=device).manual_seed(4)

    def randn():
        return torch.randn(batch, seq, heads, depth, generator=gen,
                           device=device, dtype=torch.bfloat16)
    q, k, v, dout = randn(), randn(), randn(), randn()
    out, lse = attn_ops.flash_forward_kernel(q, k, v, True)
    want_out, want_lse = attn_ops.flash_forward_reference(q, k, v, True)
    lse_err = float((lse - want_lse).abs().max())
    require(lse_err <= LSE_TOL,
            f"K1 lse at the training shape: max abs err {lse_err}")
    delta = attn_ops.flash_delta(out, dout)
    bwd_args = (q, k, v, lse, dout, delta, True)
    got = attn_ops.flash_backward_kernel(*bwd_args)
    # The split backward owns every output and sums in one order: a
    # second run on the same inputs gives the same bits.
    again = attn_ops.flash_backward_kernel(*bwd_args)
    require(all(torch.equal(x, y) for x, y in zip(got, again)),
            "K2: two runs on the same inputs differ")
    print("check K2 determinism: dq, dk, dv bit-identical over two runs",
          flush=True)
    del again
    want = attn_ops.flash_backward_reference(*bwd_args)
    # The fault build's K2 gets the sound lse and delta, so each
    # kernel's fault shows in its own outputs only.
    faulty = dict(zip(("dq", "dk", "dv"), attn_ops.flash_backward_kernel(
        *bwd_args, library=fault_lib)))
    faulty["out"] = attn_ops.flash_forward_kernel(q, k, v, True,
                                                  library=fault_lib)[0]
    names = ("dq", "dk", "dv")
    fault_check = check_flash_faults(
        {"out": out, **dict(zip(names, got))}, faulty,
        {"out": want_out, **dict(zip(names, want))})
    fwd_err = float((out.float() - want_out.float()).abs().max())
    bwd_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
    tile_errs = {"flash_fwd": fault_check["out"]["sound"],
                "flash_bwd": max(fault_check[n]["sound"] for n in names)}
    del want_out, want_lse, got, want, faulty
    torch.cuda.empty_cache()
    rows = {
        "flash_fwd": dict(
            max_abs_err=fwd_err, max_tile_err=tile_errs["flash_fwd"],
            ms=device_ms(attn_ops.flash_forward_kernel, [(q, k, v, True)],
                         48),
            plain_ms=device_ms(attn_ops.flash_forward_reference,
                               [(q, k, v, True)], 4),
            **flash_bound(batch, seq, heads, depth, True, False)),
        "flash_bwd": dict(
            max_abs_err=bwd_err, max_tile_err=tile_errs["flash_bwd"],
            ms=device_ms(attn_ops.flash_backward_kernel, [bwd_args], 24),
            plain_ms=device_ms(attn_ops.flash_backward_reference,
                               [bwd_args], 4),
            **flash_bound(batch, seq, heads, depth, True, True)),
    }
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs, gs = (x.transpose(1, 2).contiguous()
                      for x in (q, k, v, dout))
    lib_fwd = device_ms(functools.partial(sdpa, is_causal=True),
                        [(qs, ks, vs)], 48)
    leaves = [x.requires_grad_() for x in (qs, ks, vs)]
    graph_out = sdpa(*leaves, is_causal=True)
    lib_bwd = device_ms(
        lambda: torch.autograd.grad(graph_out, leaves, gs,
                                    retain_graph=True), [()], 24)
    lib_both = device_ms(
        lambda: torch.autograd.grad(sdpa(*leaves, is_causal=True), leaves,
                                    gs), [()], 24)
    rows["flash_fwd"]["library_ms"] = lib_fwd
    rows["flash_bwd"]["library_ms"] = lib_bwd
    both = rows["flash_fwd"]["ms"] + rows["flash_bwd"]["ms"]
    for row in rows.values():
        row["library_fwd_bwd_ms"] = lib_both
        row["fwd_bwd_ms"] = both
        # Achieved rate on the function's operations (flash_bound's count).
        row["tflops"] = row["ops"] / (row["ms"] * 1e-3) / 1e12
    # K2 runs seven products where the function needs five (the split).
    rows["flash_bwd"]["ceiling_ms"] = rows["flash_bwd"]["ops_ms"] * 7 / 5
    for key, row in rows.items():
        print(f"time {KERNELS[key]['label']} {key}: kernel "
              f"{row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s), plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; ops "
              f"{row['ops_ms']:.4f} ms, bytes {row['bytes_ms']:.4f} ms"
              + (f"; the split's seven products {row['ceiling_ms']:.4f} ms"
                 if "ceiling_ms" in row else "") +
              f"); K1+K2 {both:.4f} ms, sdpa forward+backward "
              f"{lib_both:.4f} ms")
    del graph_out, leaves
    torch.cuda.empty_cache()
    return rows


def time_flash_vision(device) -> dict:
    """Phase 3b': K1 and K2 in full mode at the vision models' shapes,
    each held against its plain version (out, lse, dq, dk, dv) at
    VISION_FLASH_TIMED's and VISION_FLASH_CHECKED's; at the timed ones
    also both timed beside the SDPA yardstick (forward; backward alone
    from a retained graph) and flash_bound(causal=False). Returns {shape:
    {"flash_fwd": row, "flash_bwd": row}} of the timed shapes."""
    gen = torch.Generator(device=device).manual_seed(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out_rows = {}
    for name, (batch, heads, seq) in {**VISION_FLASH_TIMED,
                                      **VISION_FLASH_CHECKED}.items():
        depth = 64

        def randn():
            return torch.randn(batch, seq, heads, depth, generator=gen,
                               device=device, dtype=torch.bfloat16)
        q, k, v, dout = randn(), randn(), randn(), randn()
        out, lse = attn_ops.flash_forward_kernel(q, k, v, False)
        want_out, want_lse = attn_ops.flash_forward_reference(q, k, v,
                                                              False)
        delta = attn_ops.flash_delta(out, dout)
        bwd_args = (q, k, v, lse, dout, delta, False)
        got = attn_ops.flash_backward_kernel(*bwd_args)
        want = attn_ops.flash_backward_reference(*bwd_args)
        fwd_err = float((out.float() - want_out.float()).abs().max())
        bwd_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
        tile = {"flash_fwd": tile_err(out, want_out),
                "flash_bwd": max(tile_err(a, b) for a, b in zip(got, want))}
        lse_err = float((lse - want_lse).abs().max())
        require(lse_err <= LSE_TOL and tile["flash_fwd"] <= FLASH_TOL[
            torch.bfloat16] and tile["flash_bwd"] <= FLASH_TOL[
            torch.bfloat16], f"K1/K2 at {name}: tile errs {tile}, lse "
            f"{lse_err}")
        del want_out, want_lse, got, want
        if name not in VISION_FLASH_TIMED:
            print(f"check K1/K2 flash {name}: max tile err fwd "
                  f"{tile['flash_fwd']:.3g}, bwd {tile['flash_bwd']:.3g}, "
                  f"lse {lse_err:.3g}", flush=True)
            continue
        qs, ks, vs, gs = (x.transpose(1, 2).contiguous()
                          for x in (q, k, v, dout))
        leaves = [x.requires_grad_() for x in (qs, ks, vs)]
        graph_out = sdpa(*leaves)
        rows = {
            "flash_fwd": dict(
                max_abs_err=fwd_err, max_tile_err=tile["flash_fwd"],
                ms=device_ms(attn_ops.flash_forward_kernel,
                             [(q, k, v, False)], 48),
                plain_ms=device_ms(attn_ops.flash_forward_reference,
                                   [(q, k, v, False)], 4),
                library_ms=device_ms(sdpa, [tuple(x.detach() for x in
                                                  leaves)], 48),
                **flash_bound(batch, seq, heads, depth, False, False)),
            "flash_bwd": dict(
                max_abs_err=bwd_err, max_tile_err=tile["flash_bwd"],
                ms=device_ms(attn_ops.flash_backward_kernel, [bwd_args], 24),
                plain_ms=device_ms(attn_ops.flash_backward_reference,
                                   [bwd_args], 4),
                library_ms=device_ms(
                    lambda: torch.autograd.grad(graph_out, leaves, gs,
                                                retain_graph=True), [()], 24),
                **flash_bound(batch, seq, heads, depth, False, True)),
        }
        for key, row in rows.items():
            row["shape"] = dict(batch=batch, heads=heads, seq=seq,
                                depth=depth, causal=False)
            print(f"time {KERNELS[key]['label']} {key} {name}: kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"sdpa {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}), max tile "
                  f"err {row['max_tile_err']:.3g}", flush=True)
        out_rows[name] = rows
        del graph_out, leaves
        torch.cuda.empty_cache()
    return out_rows


# ------------------- fused cross-entropy (K3-K5) ---------------------


def block_err(got, want, rows: int, cols: int) -> float:
    """max over blocks of rows x cols of a 2-D tensor of ||got - want|| /
    ||want||, with ||want|| taken as at least TILE_FLOOR of the RMS
    block norm (the rule of tile_err)."""
    got, want = got.detach().float(), want.detach().float()
    pad_r, pad_c = -want.shape[0] % rows, -want.shape[1] % cols
    shape = ((want.shape[0] + pad_r) // rows, rows,
             (want.shape[1] + pad_c) // cols, cols)

    def block_norms(x):
        x = torch.nn.functional.pad(x, (0, pad_c, 0, pad_r))
        return x.reshape(shape).square().sum(dim=(1, 3)).sqrt()
    norms = block_norms(want)
    floor = TILE_FLOOR * float(norms.square().mean().sqrt())
    return float((block_norms(got - want) / norms.clamp_min(floor)).max())


def loss_case(gen, rows, vocab, depth, dtype, ignore_frac, device):
    """Unit-scale hidden rows (as RMSNorm leaves them), an embedding at
    bench_transformer's init scale (std 1/sqrt(D)), targets with
    ``ignore_frac`` ignored (-1) but the first and last kept live (the K4
    and K5 faults sit on their targets), and ds = mask / count.
    Returns (h, e, tgt, ds)."""
    h = torch.randn(rows, depth, generator=gen, device=device).to(dtype)
    e = torch.randn(vocab, depth, generator=gen, device=device) / math.sqrt(
        depth)
    tgt = torch.randint(0, vocab, (rows,), generator=gen, device=device,
                        dtype=torch.int32)
    ignored = torch.rand(rows, generator=gen, device=device) < ignore_frac
    if ignore_frac < 1.0:
        ignored[0] = ignored[-1] = False
    tgt[ignored] = -1
    mask = (tgt != -1).float()
    return h, e, tgt, mask / mask.sum().clamp_min(1.0)


def loss_outputs(h, e, tgt, ds, library=None, plain=False) -> dict:
    """lse and gold (K3), gh (K4 alone), ge (K5 alone), gh_joint and
    ge_joint (the joint backward) from the kernels, or their plain
    versions."""
    if plain:
        lse, gold = loss_ops.xent_forward_reference(h, e, tgt)
        args = (h, e, tgt, lse, ds)
        joint = loss_ops.xent_backward_reference(*args)
        return {"lse": lse, "gold": gold,
                "gh": loss_ops.xent_backward_h_reference(*args),
                "ge": loss_ops.xent_backward_e_reference(*args),
                "gh_joint": joint[0], "ge_joint": joint[1]}
    lse, gold = loss_ops.xent_forward_kernel(h, e, tgt, library=library)
    args = (h, e, tgt, lse, ds)
    joint = loss_ops.xent_backward_kernel(*args, library=library)
    return {"lse": lse, "gold": gold,
            "gh": loss_ops.xent_backward_h_kernel(*args, library=library),
            "ge": loss_ops.xent_backward_e_kernel(*args, library=library),
            "gh_joint": joint[0], "ge_joint": joint[1]}


LOSS_GRADS = ("gh", "ge", "gh_joint", "ge_joint")


def loss_errors(got, want) -> dict:
    torch.cuda.synchronize()
    for name, t in got.items():
        require(t.dtype == torch.float32 and bool(torch.isfinite(t).all()),
                f"loss kernels: {name} not finite fp32")
    err = {"lse": float((got["lse"] - want["lse"]).abs().max()),
           "gold": float((got["gold"] - want["gold"]).abs().max())}
    for name in LOSS_GRADS:
        err[name] = block_err(got[name], want[name], LOSS_TILE,
                              want[name].shape[1])
    return err


def loss_failures(err: dict, dtype) -> list:
    limits = {"lse": LOSS_LSE_TOL[dtype], "gold": GOLD_TOL,
              **dict.fromkeys(LOSS_GRADS, LOSS_GRAD_TOL)}
    return [name for name, limit in limits.items() if err[name] > limit]


def _fmt(err: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in err.items())


def check_loss(device, fault_lib) -> dict:
    """Phase 2c: K3, K4 and K5 (alone and as the joint backward) against
    their plain versions: ragged shapes (fp32 h up to D 1024), every
    target ignored, then the training shape, where the
    planted-fault build must fail. Every case is read and printed before
    the first failure is raised. Returns the training-shape readings."""
    gen = torch.Generator(device=device).manual_seed(6)
    failed = []
    ragged = [(depth, dtype) for depth in (128, 256)
              for dtype in (torch.float32, torch.bfloat16)]
    for depth, dtype in ragged + [(1024, torch.float32)]:
        case = loss_case(gen, 1000, 700, depth, dtype, 0.05, device)
        err = loss_errors(loss_outputs(*case),
                          loss_outputs(*case, plain=True))
        name = f"loss N=1000 V=700 D={depth} h={str(dtype)[6:]}"
        print(f"check {name}: {_fmt(err)} (lse tol {LOSS_LSE_TOL[dtype]}, "
              f"gold tol {GOLD_TOL}, tile tol {LOSS_GRAD_TOL})",
              flush=True)
        failed += [f"{name} {k}" for k in loss_failures(err, dtype)]
    h, e, tgt, ds = loss_case(gen, 1000, 700, 128, torch.bfloat16, 1.0,
                              device)
    got = loss_outputs(h, e, tgt, ds)
    want = loss_outputs(h, e, tgt, ds, plain=True)
    torch.cuda.synchronize()
    lse_err = float((got["lse"] - want["lse"]).abs().max())
    print(f"check loss every target ignored: lse {lse_err:.3g}; gold and "
          f"every gradient must be exactly zero", flush=True)
    if lse_err > LOSS_LSE_TOL[torch.bfloat16] or any(
            bool(got[k].any()) for k in ("gold",) + LOSS_GRADS):
        failed.append("every target ignored")

    # One tp rank's vocab-parallel loss at the recipe: an sp rank's rows
    # against half the vocabulary (16000 rows of E: a ragged last tile).
    shard = dict(rows=MESH_RANK_ROWS, vocab=LOSS_TRAIN_SHAPE["vocab"] // 2,
                 depth=LOSS_TRAIN_SHAPE["depth"])
    case = loss_case(gen, shard["rows"], shard["vocab"], shard["depth"],
                     torch.bfloat16, 0.05, device)
    err = loss_errors(loss_outputs(*case), loss_outputs(*case, plain=True))
    del case
    name = "loss vocab shard N={rows} V={vocab} D={depth} h=bf16".format(
        **shard)
    print(f"check {name}: {_fmt(err)}", flush=True)
    failed += [f"{name} {k}" for k in loss_failures(err, torch.bfloat16)]

    shape = LOSS_TRAIN_SHAPE
    case = loss_case(gen, shape["rows"], shape["vocab"], shape["depth"],
                     torch.bfloat16, 0.05, device)
    want = loss_outputs(*case, plain=True)
    sound = loss_errors(loss_outputs(*case), want)
    fault = loss_errors(loss_outputs(*case, library=fault_lib), want)
    del want
    torch.cuda.empty_cache()
    print(f"check loss training shape: sound {_fmt(sound)}; planted faults "
          f"{_fmt(fault)}", flush=True)
    failed += [f"training shape {k}"
               for k in loss_failures(sound, torch.bfloat16)]
    caught = set(loss_failures(fault, torch.bfloat16))
    failed += [f"planted fault in {name} passed"
               for *_, outs in LOSS_FAULTS for name in outs
               if name not in caught]
    require(not failed, f"loss kernels: {failed}")
    return {"sound": sound, "fault": fault}


def loss_bound(rows, vocab, depth, h_dtype, products, out_rows) -> dict:
    """Least time at the kernels' TF32 rate: ``products`` products of
    2*N*V*D operations; each input read once (h, E, targets, and for the
    backward lse and ds), each output written once (lse and gold, or the
    fp32 [out_rows, D] gradient)."""
    ops = products * 2 * rows * vocab * depth
    h_bytes = rows * depth * torch.empty((), dtype=h_dtype).element_size()
    nbytes = h_bytes + vocab * depth * 4 + 3 * rows * 4
    if out_rows is not None:
        nbytes += out_rows * depth * 4
    return roofline(nbytes, ops, "tf32")


# The joint backward's passes, by the kernel names torch.profiler reports.
LOSS_PASSES = {"pre_pass": train_profile.XENT_BWD_PREPASS,
               "dl_pass": train_profile.XENT_DL_PASS,
               "grad_h": train_profile.XENT_BWD_H,
               "grad_e": train_profile.XENT_BWD_E}


def loss_pass_ms(args, calls: int = 3) -> dict:
    """Device ms of each pass of one joint backward call, summed over its
    launches from torch.profiler's kernel records of ``calls`` calls."""
    loss_ops.xent_backward_kernel(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            loss_ops.xent_backward_kernel(*args)
        torch.cuda.synchronize()
    us = dict.fromkeys(LOSS_PASSES, 0.0)
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for key, symbol in LOSS_PASSES.items():
            if symbol in event.name:
                us[key] += event.time_range.end - event.time_range.start
    require(all(us.values()), f"loss passes: a pass left no record {us}")
    return {key: t / 1e3 / calls for key, t in us.items()}


def time_loss(device, readings: dict) -> dict:
    """Phase 3c: K3, K4 and K5 (alone, and the joint backward with its
    pass breakdown) at the training shape against their plain versions
    and the library yardstick: the same products alone through
    torch.matmul with TF32 allowed (K3: h E^T; K4: (h E^T) E; K5:
    (h E^T)^T h; joint: l = h E^T, then l E and l^T h), on h already in
    fp32."""
    shape = LOSS_TRAIN_SHAPE
    rows, vocab, depth = shape["rows"], shape["vocab"], shape["depth"]
    gen = torch.Generator(device=device).manual_seed(7)
    h, e, tgt, ds = loss_case(gen, rows, vocab, depth, torch.bfloat16, 0.05,
                              device)
    lse, _ = loss_ops.xent_forward_kernel(h, e, tgt)
    fwd, bwd = [(h, e, tgt)], [(h, e, tgt, lse, ds)]
    sound = readings["sound"]
    shapes, _ = loss_ops.backward_scratch(rows, vocab, depth)
    joint = dict(
        max_tile_err=max(sound["gh_joint"], sound["ge_joint"]),
        ms=device_ms(loss_ops.xent_backward_kernel, bwd, 3),
        plain_ms=device_ms(loss_ops.xent_backward_reference, bwd, 2),
        passes_ms=loss_pass_ms(bwd[0]),
        dl_scratch_bytes=4 * sum(math.prod(shapes[k]) for k in ("dl", "dlt")),
        scratch_bytes=4 * sum(math.prod(t) for t in shapes.values()),
        **loss_bound(rows, vocab, depth, h.dtype, 3, rows + vocab))
    out = {
        "xent_fwd": dict(
            max_abs_err=max(sound["lse"], sound["gold"]),
            ms=device_ms(loss_ops.xent_forward_kernel, fwd, 5),
            plain_ms=device_ms(loss_ops.xent_forward_reference, fwd, 2),
            **loss_bound(rows, vocab, depth, h.dtype, 1, None)),
        "xent_bwd_h": dict(
            max_tile_err=sound["gh"],
            ms=device_ms(loss_ops.xent_backward_h_kernel, bwd, 3),
            plain_ms=device_ms(loss_ops.xent_backward_h_reference, bwd, 2),
            **loss_bound(rows, vocab, depth, h.dtype, 2, rows)),
        "xent_bwd_e": dict(
            max_tile_err=sound["ge"],
            ms=device_ms(loss_ops.xent_backward_e_kernel, bwd, 3),
            plain_ms=device_ms(loss_ops.xent_backward_e_reference, bwd, 2),
            **loss_bound(rows, vocab, depth, h.dtype, 2, vocab)),
    }
    # max |kernel - plain| of the gradients at the training shape.
    for key, kernel, plain in (
            ("xent_bwd_h", loss_ops.xent_backward_h_kernel,
             loss_ops.xent_backward_h_reference),
            ("xent_bwd_e", loss_ops.xent_backward_e_kernel,
             loss_ops.xent_backward_e_reference)):
        out[key]["max_abs_err"] = float(
            (kernel(*bwd[0]) - plain(*bwd[0])).abs().max())
        torch.cuda.empty_cache()
    joint["max_abs_err"] = max(
        float((got - want).abs().max()) for got, want in zip(
            loss_ops.xent_backward_kernel(*bwd[0]),
            loss_ops.xent_backward_reference(*bwd[0])))
    torch.cuda.empty_cache()
    # The scratch trade-off: the joint backward with chunks twice as wide.
    chunk = loss_ops.BWD_CHUNK
    loss_ops.BWD_CHUNK = 2 * chunk
    try:
        wide, _ = loss_ops.backward_scratch(rows, vocab, depth)
        joint["wide_chunk"] = dict(
            chunk=loss_ops.BWD_CHUNK,
            ms=device_ms(loss_ops.xent_backward_kernel, bwd, 3),
            dl_scratch_bytes=4 * sum(math.prod(wide[k])
                                     for k in ("dl", "dlt")))
    finally:
        loss_ops.BWD_CHUNK = chunk
    torch.cuda.empty_cache()
    hf = h.float()

    def three_matmuls():
        logits = hf @ e.t()
        return logits @ e, logits.t() @ hf
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out["xent_fwd"]["library_ms"] = device_ms(
            lambda: hf @ e.t(), [()], 5)
        out["xent_bwd_h"]["library_ms"] = device_ms(
            lambda: (hf @ e.t()) @ e, [()], 3)
        out["xent_bwd_e"]["library_ms"] = device_ms(
            lambda: (hf @ e.t()).t() @ hf, [()], 3)
        joint["library_ms"] = device_ms(three_matmuls, [()], 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del hf, h, e, lse
    torch.cuda.empty_cache()
    for key, row in out.items():
        print(f"time {KERNELS[key]['label']} {key}: kernel {row['ms']:.4f} "
              f"ms, plain {row['plain_ms']:.4f} ms, torch.matmul tf32 "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; ops {row['ops_ms']:.4f} ms, bytes "
              f"{row['bytes_ms']:.4f} ms)", flush=True)
    print(f"time K4+K5 joint backward: kernel {joint['ms']:.4f} ms (passes "
          f"{_fmt(joint['passes_ms'])} ms), plain {joint['plain_ms']:.4f} "
          f"ms, three torch.matmul tf32 {joint['library_ms']:.4f} ms, bound "
          f"{joint['bound_ms']:.4f} ms ({joint['bound_by']}); dl scratch "
          f"{joint['dl_scratch_bytes']} bytes of {joint['scratch_bytes']}; "
          f"at chunk {joint['wide_chunk']['chunk']} "
          f"{joint['wide_chunk']['ms']:.4f} ms with "
          f"{joint['wide_chunk']['dl_scratch_bytes']} bytes of dl scratch",
          flush=True)
    out["xent_bwd_h"]["joint"] = out["xent_bwd_e"]["joint"] = joint
    return out


# -------------------- fused RMSNorm+matmul (K9) -----------------------


def norm_case(gen, m, k, n, dtype, device):
    """x at unit scale, a scale near one, w at lecun scale, in dtype."""
    x = torch.randn(m, k, generator=gen, device=device).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(k, generator=gen, device=device)
    w = (torch.randn(k, n, generator=gen, device=device) /
         math.sqrt(k)).to(dtype)
    return x, scale, w


def check_norm(device, fault_lib) -> dict:
    """Phase 2d: K9 against its plain version at the ragged shape (bf16
    and fp32) and both training shapes (bf16), per NORM_TILE block; at
    the training shapes the planted-fault build must fail. Returns the
    training-shape readings."""
    gen = torch.Generator(device=device).manual_seed(8)
    failed, readings = [], {}
    cases = [("ragged", (1000, 128, 384), torch.float32),
             ("ragged", (1000, 128, 384), torch.bfloat16)]
    cases += [(name, dims, torch.bfloat16)
              for name, dims in NORM_TRAIN_SHAPES.items()]
    for name, (m, k, n), dtype in cases:
        args = norm_case(gen, m, k, n, dtype, device)
        got = norm_ops.rmsnorm_matmul_kernel(*args)
        want = norm_ops.rmsnorm_matmul_reference(*args)
        torch.cuda.synchronize()
        require(got.dtype == dtype and bool(torch.isfinite(got).all()),
                f"K9 {name}: output dtype or non-finite")
        err = block_err(got, want, *NORM_TILE)
        row = {"tile_err": err,
               "max_abs_err": float((got.float() - want.float()).abs().max())}
        line = (f"check K9 {name} M={m} K={k} N={n} {str(dtype)[6:]}: max "
                f"tile err {err:.3g} (tol {NORM_TOL[dtype]})")
        if err > NORM_TOL[dtype]:
            failed.append(f"{name} {dtype}")
        if name in NORM_TRAIN_SHAPES:
            bad = norm_ops.rmsnorm_matmul_kernel(*args, library=fault_lib)
            row["fault_tile_err"] = block_err(bad, want, *NORM_TILE)
            line += f"; planted fault {row['fault_tile_err']:.3g}"
            if row["fault_tile_err"] <= NORM_TOL[dtype]:
                failed.append(f"{name} planted fault passed")
            readings[name] = row
        print(line, flush=True)
    require(not failed, f"K9: {failed}")
    return readings


def norm_bound(m, k, n) -> dict:
    """Least time in bf16: 2*M*K*N operations; x, scale and w read once,
    the output written once."""
    ops = 2 * m * k * n
    nbytes = m * k * 2 + k * 4 + k * n * 2 + m * n * 2
    return roofline(nbytes, ops, torch.bfloat16)


def time_norm(device, readings: dict) -> dict:
    """Phase 3d: K9 at both training shapes against its plain version and
    the library yardstick (the pre-normalized x @ w in bf16). The row's
    times are one qkv call plus one gate/up call (one layer's pair);
    ``shapes`` keeps each."""
    gen = torch.Generator(device=device).manual_seed(9)
    shapes = {}
    for name, (m, k, n) in NORM_TRAIN_SHAPES.items():
        args = norm_case(gen, m, k, n, torch.bfloat16, device)
        shapes[name] = dict(
            ms=device_ms(norm_ops.rmsnorm_matmul_kernel, [args], 20),
            plain_ms=device_ms(norm_ops.rmsnorm_matmul_reference, [args], 3),
            library_ms=device_ms(torch.matmul, [(args[0], args[2])], 20),
            max_abs_err=readings[name]["max_abs_err"],
            max_tile_err=readings[name]["tile_err"], **norm_bound(m, k, n))
        del args
        torch.cuda.empty_cache()
        row = shapes[name]
        print(f"time K9 rmsnorm_matmul {name} M={m} K={k} N={n}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"torch.matmul bf16 {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    row = {key: sum(s[key] for s in shapes.values())
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "ops",
                       "bytes")}
    row["bound_by"] = ("operations" if all(s["bound_by"] == "operations"
                                           for s in shapes.values())
                       else "bytes")
    row["max_abs_err"] = max(s["max_abs_err"] for s in shapes.values())
    row["max_tile_err"] = max(s["max_tile_err"] for s in shapes.values())
    row["per"] = "one qkv call plus one gate/up call"
    row["shapes"] = shapes
    return {"rmsnorm_matmul": row}


# ---------------- int8 quantize (K10) and matmul (K11) ----------------


def quant_case(gen, rows, cols, dtype, device, weight=False,
               zero_row=False):
    """x with a spread of row scales (or a weight at lecun scale) in
    dtype, and its rounding bits."""
    if weight:
        x = torch.randn(rows, cols, generator=gen, device=device) / \
            math.sqrt(cols)
    else:
        x = torch.randn(rows, cols, generator=gen, device=device) * (
            0.25 + 4 * torch.rand(rows, 1, generator=gen, device=device))
    if zero_row:
        x[rows // 2] = 0.0
    bits = torch.randint(-2 ** 31, 2 ** 31, (rows, cols), generator=gen,
                         device=device, dtype=torch.int32)
    return x.to(dtype), bits


def quant_diff(got, want) -> dict:
    """Differing int8 values and scales (bitwise), and the largest
    difference of either."""
    torch.cuda.synchronize()
    (gv, gs), (wv, ws) = got, want
    require(gv.dtype == torch.int8 and gs.dtype == torch.float32,
            "K10: output dtypes")
    return {"values": int((gv != wv).sum()),
            "scales": int((gs.view(torch.int32) != ws.view(torch.int32))
                          .sum()),
            "max_abs_err": max(float((gv.int() - wv.int()).abs().max()),
                               float((gs - ws).abs().max()))}


def matmul_diff(got, want) -> dict:
    """Output elements that differ bitwise, and the largest difference."""
    torch.cuda.synchronize()
    require(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
            "K11: output dtype or non-finite")
    return {"out": int((got.view(torch.int32) != want.view(torch.int32))
                       .sum()),
            "max_abs_err": float((got - want).abs().max())}


def check_quant(device, fault_lib) -> dict:
    """Phase 2e: K10 and K11 against their plain versions on the same
    bits, bit for bit: ragged shapes (M 300, K 128 and 2816, N 48 and 384,
    and N 50, whose rows TMA cannot store, fp32 and bf16, a zero row),
    then every training shape, where each
    planted fault must fail. Every case is read and printed before the
    first failure is raised. Returns the training-shape readings."""
    gen = torch.Generator(device=device).manual_seed(10)
    failed, readings = [], {}
    kernel_q, plain_q = (quant_ops.quantize_int8_kernel,
                         quant_ops.quantize_int8_reference)
    for k in (128, 2816):
        for dtype in (torch.float32, torch.bfloat16):
            x = quant_case(gen, 300, k, dtype, device, zero_row=True)
            xq = kernel_q(*x)
            q_err = quant_diff(xq, plain_q(*x))
            require(not bool(xq[0][150].any()), "K10: a zero row")
            line = (f"check K10 M=300 K={k} {str(dtype)[6:]} (a zero row): "
                    f"{q_err['values']} values, {q_err['scales']} scales "
                    f"differ")
            if q_err["values"] or q_err["scales"]:
                failed.append(f"K10 ragged K={k} {dtype}")
            for n in (48, 50, 384):
                w = kernel_q(*quant_case(gen, n, k, dtype, device,
                                         weight=True))
                mm = matmul_diff(quant_ops.int8_matmul_kernel(*xq, *w),
                                 quant_ops.int8_matmul_reference(*xq, *w))
                line += f"; K11 N={n}: {mm['out']} outputs differ"
                if mm["out"]:
                    failed.append(f"K11 ragged K={k} N={n} {dtype}")
            print(line, flush=True)

    for name, (shape, _) in QUANT_TRAIN_SHAPES.items():
        rows, k, n = shape
        # One projection's bf16 x [rows, in] and weight [out, in].
        sides = (quant_case(gen, rows, k, torch.bfloat16, device),
                 quant_case(gen, n, k, torch.bfloat16, device, weight=True))
        quantized, row = [], {}
        for side, (x, bits) in zip(("x", "w"), sides):
            want = plain_q(x, bits)
            row[f"K10 {side}"] = quant_diff(kernel_q(x, bits), want)
            fault = quant_diff(kernel_q(x, bits, library=fault_lib), want)
            row[f"K10 {side} fault"] = fault
            if row[f"K10 {side}"]["values"] or row[f"K10 {side}"]["scales"]:
                failed.append(f"K10 {name} {side}")
            if not fault["values"]:
                failed.append(f"K10 {name} {side}: planted fault passed")
            quantized.append(want)
            del x, bits
        want = quant_ops.int8_matmul_reference(*quantized[0], *quantized[1])
        row["K11"] = matmul_diff(
            quant_ops.int8_matmul_kernel(*quantized[0], *quantized[1]), want)
        row["K11 fault"] = matmul_diff(quant_ops.int8_matmul_kernel(
            *quantized[0], *quantized[1], library=fault_lib), want)
        if row["K11"]["out"]:
            failed.append(f"K11 {name}")
        if not row["K11 fault"]["out"]:
            failed.append(f"K11 {name}: planted fault passed")
        del want, quantized, sides
        torch.cuda.empty_cache()
        readings[name] = row
        print(f"check K10/K11 {name} M={rows} K={k} N={n} bf16: " +
              "; ".join(f"{key} {json.dumps(v)}" for key, v in row.items()),
              flush=True)
    require(not failed, f"K10/K11: {failed}")
    return readings


def quantize_bound(rows, cols, dtype) -> dict:
    """K10's least time: x and the int32 bits read once, the int8 values
    and fp32 scales written once; ~5 fp32 operations an element (absmax,
    divide, add, floor, clip) at the fp32 rate."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = rows * cols * (elt + 4 + 1) + rows * 4
    return roofline(nbytes, 5 * rows * cols, torch.float32)


def int8_matmul_bound(rows, k, n) -> dict:
    """K11's least time: 2*M*K*N int8 operations; x_q, w_q and the
    scales read once, the fp32 output written once."""
    nbytes = rows * k + n * k + 4 * rows + 4 * n + 4 * rows * n
    return roofline(nbytes, 2 * rows * k * n, torch.int8)


def _int_mm_yardstick(x_q, x_s, w_q, w_s):
    """One PyTorch call for K11's product: torch._int_mm (cuBLASLt int8
    GEMM with int32 output), then the two scale multiplies."""
    return torch._int_mm(x_q, w_q.t()).float() * x_s * w_s.t()


def _int_mm_alone(x_q, x_s, w_q, w_s):
    """torch._int_mm alone: the int32 product without K11's epilogue."""
    return torch._int_mm(x_q, w_q.t())


def _layer_row(shapes: dict, per: str) -> dict:
    """Sum one layer's calls (each shape times its count) into a row."""
    row = {key: sum(s["count"] * s[key] for s in shapes.values())
           for key in ("ms", "plain_ms", "bound_ms", "ops", "bytes")}
    for key in ("library_ms", "int_mm_ms"):
        libs = [s.get(key) for s in shapes.values()]
        if key in next(iter(shapes.values())):
            row[key] = (None if None in libs else
                        sum(s["count"] * s[key] for s in shapes.values()))
    row["bound_by"] = ("operations" if all(s["bound_by"] == "operations"
                                           for s in shapes.values())
                       else "bytes")
    row["max_abs_err"] = max(s["max_abs_err"] for s in shapes.values())
    row["per"] = per
    row["shapes"] = shapes
    return row


def time_quant(device, readings: dict) -> dict:
    """Phase 3e: K10 and K11 at one layer's training shapes against their
    plain versions, and K11 against the torch._int_mm yardstick (with
    the two scale passes; also torch._int_mm alone; K10 has no single
    PyTorch call). Each row sums one layer's calls: K10 its 14
    (x and the weight of seven projections), K11 its 7; ``shapes`` keeps
    each. Weight-sized inputs cycle through n_layers sets, and x-sized
    ones through two, so the 50 MB L2 does not hold them across calls."""
    gen = torch.Generator(device=device).manual_seed(11)
    layers = train_wl.BENCH_TRANSFORMER_MODEL["n_layers"]
    k10, k11 = {}, {}
    for name, (shape, count) in QUANT_TRAIN_SHAPES.items():
        rows, k, n = shape
        x_sets = [quant_case(gen, rows, k, torch.bfloat16, device)
                  for _ in range(2)]
        w_sets = [quant_case(gen, n, k, torch.bfloat16, device, weight=True)
                  for _ in range(layers)]
        for side, sets, dims in (("x", x_sets, (rows, k)),
                                 ("w", w_sets, (n, k))):
            key = f"{side} {dims[0]}x{dims[1]}"
            if key not in k10:
                k10[key] = dict(
                    count=0,
                    ms=device_ms(quant_ops.quantize_int8_kernel, sets, 24),
                    plain_ms=device_ms(quant_ops.quantize_int8_reference,
                                       sets[:2], 4),
                    library_ms=None,
                    max_abs_err=readings[name][f"K10 {side}"]["max_abs_err"],
                    **quantize_bound(*dims, torch.bfloat16))
            k10[key]["count"] += count
        x_q = [quant_ops.quantize_int8_kernel(*s) for s in x_sets]
        w_q = quant_ops.quantize_int8_kernel(*w_sets[0])
        del x_sets, w_sets
        sets = [(*xq, *w_q) for xq in x_q]
        library = {}
        for key, call in (("library_ms", _int_mm_yardstick),
                          ("int_mm_ms", _int_mm_alone)):
            try:
                library[key] = device_ms(call, sets, 24)
            except RuntimeError as err:  # torch._int_mm refuses the shape
                print(f"time K11 {name}: {call.__name__}: {err}")
                library[key] = None
        k11[name] = dict(
            count=count,
            ms=device_ms(quant_ops.int8_matmul_kernel, sets, 24),
            plain_ms=device_ms(quant_ops.int8_matmul_reference, sets, 4),
            **library,
            max_abs_err=readings[name]["K11"]["max_abs_err"],
            **int8_matmul_bound(rows, k, n))
        del sets, x_q, w_q
        torch.cuda.empty_cache()
    def fmt(ms):
        return "—" if ms is None else f"{ms:.4f} ms"
    for label, shapes in (("K10 quantize_int8", k10),
                          ("K11 int8_matmul", k11)):
        for key, s in shapes.items():
            alone = ("" if "int_mm_ms" not in s else
                     f" (torch._int_mm alone {fmt(s['int_mm_ms'])})")
            print(f"time {label} {key} (x{s['count']} a layer): kernel "
                  f"{s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, library "
                  f"{fmt(s['library_ms'])}{alone}, bound "
                  f"{s['bound_ms']:.4f} ms ({s['bound_by']}), kernel / bound "
                  f"{s['ms'] / s['bound_ms']:.2f}", flush=True)
    return {"quantize_int8": _layer_row(k10, "one layer's 14 calls"),
            "int8_matmul": _layer_row(k11, "one layer's 7 calls")}


def absmax_diff(got, want) -> dict:
    """Differing fp32 absmax values (bitwise), and the largest
    difference."""
    torch.cuda.synchronize()
    require(got.dtype == torch.float32, "row absmax: output dtype")
    return {"absmax": int((got.view(torch.int32) != want.view(torch.int32))
                          .sum()),
            "max_abs_err": float((got - want).abs().max())}


def values_diff(got, want) -> dict:
    torch.cuda.synchronize()
    require(got.dtype == torch.int8, "quantize with scales: output dtype")
    return {"values": int((got != want).sum()),
            "max_abs_err": float((got.int() - want.int()).abs().max())}


def _split_scales(absmax):
    """K10's scale from a row's absmax, as quantize_split_rows writes it."""
    return torch.clamp(absmax, min=1e-8) * (1.0 / 127.0)


def check_quant_split(device, fault_lib) -> dict:
    """Phase 2e': bs_row_absmax and bs_quantize_scaled against their plain
    versions on the same inputs and bits, bit for bit: ragged shapes (M
    300, K 128 and 2816, fp32 and bf16, a zero row), then one rank's
    row-parallel operands at the mesh runs' shapes
    (QUANT_SPLIT_SHAPES), where each planted fault must fail; and the
    two halves over a whole row must give K10's values and scales bit for
    bit. Every case is read and printed before the first failure is
    raised. Returns the training-shape readings."""
    gen = torch.Generator(device=device).manual_seed(12)
    failed, readings = [], {}
    cases = [(f"ragged K={k} {str(dtype)[6:]}",
              quant_case(gen, 300, k, dtype, device, zero_row=True))
             for k in (128, 2816) for dtype in (torch.float32, torch.bfloat16)]
    for name, (shape, _) in QUANT_SPLIT_SHAPES.items():
        rows, k, n = shape
        cases += [(f"{name} x {rows}x{k}",
                   quant_case(gen, rows, k, torch.bfloat16, device)),
                  (f"{name} w {n}x{k}",
                   quant_case(gen, n, k, torch.bfloat16, device,
                              weight=True))]
    for label, (x, bits) in cases:
        want_max = quant_ops.row_absmax_reference(x)
        scales = _split_scales(want_max)
        want_q = quant_ops.quantize_scaled_reference(x, bits, scales)
        row = {"absmax": absmax_diff(quant_ops.row_absmax_kernel(x),
                                     want_max),
               "quantize": values_diff(quant_ops.quantize_scaled_kernel(
                   x, bits, scales), want_q)}
        whole = quant_ops.quantize_int8_kernel(x, bits)
        row["as K10"] = quant_diff(
            (quant_ops.quantize_scaled_kernel(
                x, bits, _split_scales(quant_ops.row_absmax_kernel(x))),
             scales[:, None]), whole)
        if row["absmax"]["absmax"] or row["quantize"]["values"] or \
                row["as K10"]["values"] or row["as K10"]["scales"]:
            failed.append(label)
        if not label.startswith("ragged"):
            row["absmax fault"] = absmax_diff(
                quant_ops.row_absmax_kernel(x, library=fault_lib), want_max)
            row["quantize fault"] = values_diff(
                quant_ops.quantize_scaled_kernel(x, bits, scales,
                                                 library=fault_lib), want_q)
            if not row["absmax fault"]["absmax"]:
                failed.append(f"{label}: planted absmax fault passed")
            if not row["quantize fault"]["values"]:
                failed.append(f"{label}: planted quantize fault passed")
            readings[label] = row
        print(f"check K10 halves {label}: " +
              "; ".join(f"{key} {json.dumps(v)}" for key, v in row.items()),
              flush=True)
        del x, bits, want_max, want_q, whole
    torch.cuda.empty_cache()
    require(not failed, f"K10 halves: {failed}")
    return readings


def row_absmax_bound(rows, cols, dtype) -> dict:
    """bs_row_absmax's least time: x read once, fp32 [rows] written once;
    two fp32 operations an element (abs, max)."""
    elt = torch.empty((), dtype=dtype).element_size()
    return roofline(rows * cols * elt + rows * 4, 2 * rows * cols,
                    torch.float32)


def quantize_scaled_bound(rows, cols, dtype) -> dict:
    """bs_quantize_scaled's least time: x, the int32 bits and the fp32
    scales read once, the int8 values written once; ~4 fp32 operations
    an element (divide, add, floor, clip)."""
    elt = torch.empty((), dtype=dtype).element_size()
    return roofline(rows * cols * (elt + 4 + 1) + rows * 4,
                    4 * rows * cols, torch.float32)


def _library_absmax(x):
    """One PyTorch call for each row's largest |x|: the inf-norm."""
    return torch.linalg.vector_norm(x, ord=float("inf"), dim=-1,
                                    dtype=torch.float32)


def time_quant_split(device, readings: dict) -> dict:
    """Phase 3e': bs_row_absmax and bs_quantize_scaled at one layer's
    row-parallel operands on one rank (QUANT_SPLIT_SHAPES: x and the
    weight of o and down), beside their plain versions, the inf-norm
    (bs_row_absmax's one PyTorch call; the scaled quantize has none) and
    K10's one pass over the same rows. Each row sums one layer's 4 calls
    of each; ``shapes`` keeps each, with K10's time there."""
    gen = torch.Generator(device=device).manual_seed(13)
    layers = train_wl.BENCH_TRANSFORMER_MODEL["n_layers"]
    absmax, scaled = {}, {}
    for name, (shape, count) in QUANT_SPLIT_SHAPES.items():
        rows, k, n = shape
        for side, dims, copies in (("x", (rows, k), 2), ("w", (n, k), layers)):
            sets = [quant_case(gen, *dims, torch.bfloat16, device,
                               weight=side == "w") for _ in range(copies)]
            label = f"{name} x {rows}x{k}" if side == "x" else \
                f"{name} w {n}x{k}"
            err = readings[label]
            x_sets = [(x,) for x, _ in sets]
            k10_ms = device_ms(quant_ops.quantize_int8_kernel, sets, 24)
            absmax[f"{side} {dims[0]}x{dims[1]}"] = dict(
                count=count,
                ms=device_ms(quant_ops.row_absmax_kernel, x_sets, 24),
                plain_ms=device_ms(quant_ops.row_absmax_reference,
                                   x_sets[:2], 4),
                library_ms=device_ms(_library_absmax, x_sets, 24),
                k10_ms=k10_ms, max_abs_err=err["absmax"]["max_abs_err"],
                **row_absmax_bound(*dims, torch.bfloat16))
            q_sets = [(x, bits, _split_scales(
                quant_ops.row_absmax_reference(x))) for x, bits in sets]
            scaled[f"{side} {dims[0]}x{dims[1]}"] = dict(
                count=count,
                ms=device_ms(quant_ops.quantize_scaled_kernel, q_sets, 24),
                plain_ms=device_ms(quant_ops.quantize_scaled_reference,
                                   q_sets[:2], 4),
                library_ms=None, k10_ms=k10_ms,
                max_abs_err=err["quantize"]["max_abs_err"],
                **quantize_scaled_bound(*dims, torch.bfloat16))
            del sets, x_sets, q_sets
            torch.cuda.empty_cache()
    for key in absmax:
        a, q = absmax[key], scaled[key]
        print(f"time K10 halves {key}: row_absmax {a['ms']:.4f} ms (bound "
              f"{a['bound_ms']:.4f}, plain {a['plain_ms']:.4f}, inf-norm "
              f"{a['library_ms']:.4f}); quantize_scaled {q['ms']:.4f} ms "
              f"(bound {q['bound_ms']:.4f}, plain {q['plain_ms']:.4f}); "
              f"together {a['ms'] + q['ms']:.4f} ms against K10's one pass "
              f"{a['k10_ms']:.4f} ms ({(a['ms'] + q['ms']) / a['k10_ms']:.2f}"
              f"x)", flush=True)
    per = "one layer's 4 calls on a rank (x and w of o and down, tp 2)"
    rows = {"row_absmax": _layer_row(absmax, per),
            "quantize_scaled": _layer_row(scaled, per)}
    k10 = sum(s["count"] * s["k10_ms"] for s in absmax.values())
    for row in rows.values():
        row["k10_same_rows_ms"] = k10
    return rows


# ------------- ring collectives (K12-K14) and their schedules (K15, K16) -------------


RING_SOURCE = "batch_shipyard_tpu_torch/ops/csrc/ring_collectives.cu"
# Faults planted in a copy of ring_collectives.cu, each wrong bytes in one
# kind of copy or a wrong slot in one step of one kernel; the check must
# fail on each at ring 4.
RING_FAULTS = (
    # K12: the copy out of the source rank's slot moves K and not V.
    ("ring_permute_kernel",
     "for (int i = 0; i < c.segments; ++i)",
     "for (int i = 0; i < c.segments - (c.filled != nullptr); ++i)",
     ("permute",)),
    # K13: every copy that also fills the own slot (the own chunk, and each
    # forward) drops its last unit, in the output row and in the slot.
    ("ring_all_gather_kernel",
     "copy_lanes<U>(c.dst[0], c.dst2[0], c.src[0], c.nbytes);",
     "copy_lanes<U>(c.dst[0], c.dst2[0], c.src[0], "
     "c.nbytes - (c.dst2[0] != nullptr ? U : 0));",
     ("all_gather",)),
    # K14: each add drops this rank's part of its last lane.
    ("ring_reduce_scatter_kernel",
     "const long long added = c.local != nullptr ? lanes : 0;",
     "const long long added = c.local != nullptr ? lanes - 1 : 0;",
     ("reduce_scatter",)),
    # K15, both designs: output row 0 files shard 1 under shard 2's
    # columns (the bulk design: a tile that starts in shard 1).
    ("virtual_all_gather_bulk_kernel",
     "bulk_store(out + r * total + start, stage + s * kStageBytes, bytes);",
     "bulk_store(out + r * total + start + (r == 0 && start / nbytes == 1 "
     "? nbytes : 0), stage + s * kStageBytes, bytes);",
     ("virtual_all_gather",)),
    ("virtual_all_gather_kernel",
     "const long long at = r * total + u;",
     "const long long at = r * total + u + (r == 0 && u / n == 1 ? n : 0);",
     ("virtual_all_gather",)),
    # K16, both designs (the helpers each kernel's addresses and chain run
    # through): (a) output row 0 reads member 2's term from chunk 1;
    ("part_at",
     "return (static_cast<long long>(m) * ring + j) * n;",
     "return (static_cast<long long>(m) * ring + j + (j == 0 && m == 2)) * "
     "n;",
     ("virtual_reduce_scatter",)),
    # (b) output row 0 adds its second and third terms the other way
    # round, (x1 + x3) + x2 at ring 4: the same terms, not the ring order.
    ("chain_member",
     "return (j + 1 + k) % ring;",
     "return (j + 1 + (j == 0 && (k == 1 || k == 2) ? 3 - k : k)) % ring;",
     ("virtual_reduce_scatter",)),
)
FAULTS["ring_collectives"] = RING_FAULTS
# K16's faults are read each from a build of its own, so that one cannot
# hide the other.
VREDUCE_FAULTS = (len(RING_FAULTS) - 2, len(RING_FAULTS) - 1)
FAULTS_ONE_BY_ONE["ring_collectives"] = VREDUCE_FAULTS
NVLINK_BYTES_PER_S = 450e9  # one direction of one H100's NVLink
SP = 4
# The ring kernels' wait bound in the four-rank checks, and the shorter
# one of the missing-rank check: each rank must raise within
# SKIP_RAISE_LIMIT_S of the skipped call.
RING_TIMEOUT_S = 60.0
SKIP_TIMEOUT_S = 3.0
SKIP_RAISE_LIMIT_S = 4 * SKIP_TIMEOUT_S + 6.0
SP_RANKS_TIMEOUT_S = 300.0
# K16 against a plain sum over members (another order of fp32 adds): the
# reference test's limits (tests/test_ring_collectives.py:86-90).
RS_ATOL, RS_REL = 1e-4, 1e-6
_MODEL = train_wl.BENCH_TRANSFORMER_MODEL
# K12's shape on the sp path: one rank's K (and V) shard of
# bench_transformer's widths at --seq-len 8192 --sp 4, batch 8.
SP_BATCH, SP_SEQ = 8, 8192
PERMUTE_SHAPE = (SP_BATCH, SP_SEQ // SP, _MODEL["n_heads"], _MODEL["d_head"])


def model_units(fsdp: int, **overrides) -> list:
    """The fsdp units (parallel/sharding.fsdp_units) of bench_transformer's
    model (``overrides``: its config's, e.g. a mesh's tp_group) at
    ``fsdp``."""
    model = tfm.TransformerLM(tfm.TransformerConfig(**dict(_MODEL,
                                                          **overrides)),
                              device="meta")
    return sharding.fsdp_units(
        {name: p.shape for name, p in model.named_parameters()}, fsdp)


def bucket_elems(ring: int = SP) -> int:
    """The gradient row of bench_transformer's model on the sp path (fsdp
    1): every unit whole and the loss slot, padded as parallel/train pads
    it for a data ring of ``ring``."""
    return train_mod.row_length(sum(u.chunk for u in model_units(1)), ring)


RING_KEYS = ("ring_permute", "ring_all_gather", "ring_reduce_scatter")
KERNELS.update({
    "ring_permute": dict(
        label="K12", route="cuda", source=RING_SOURCE,
        replaces="batch_shipyard_tpu/ops/ring_collectives.py:105"),
    "ring_all_gather": dict(
        label="K13", route="cuda", source=RING_SOURCE,
        replaces="batch_shipyard_tpu/ops/ring_collectives.py:185"),
    "ring_reduce_scatter": dict(
        label="K14", route="cuda", source=RING_SOURCE,
        replaces="batch_shipyard_tpu/ops/ring_collectives.py:285"),
    "virtual_all_gather": dict(
        label="K15", route="cuda", source=RING_SOURCE,
        replaces="batch_shipyard_tpu/ops/ring_collectives.py:399"),
    "virtual_reduce_scatter": dict(
        label="K16", route="cuda", source=RING_SOURCE,
        replaces="batch_shipyard_tpu/ops/ring_collectives.py:450"),
})


def ring_bound(read: int, written: int, sent) -> dict:
    """Least time for a ring call: ``read`` bytes read and ``written``
    written once at the HBM rate (one card), and, across cards, ``sent``
    bytes over one direction of NVLink (None: a one-device schedule)."""
    row = roofline(read + written, 0, torch.float32)
    row["bound_nvlink_ms"] = (None if sent is None
                              else sent / NVLINK_BYTES_PER_S * 1e3)
    return row


def identity_shards(ring, rows, feat, dtype, device):
    """[ring, rows, feat]: member i's shard filled with i + 1."""
    return (torch.arange(1, ring + 1, device=device, dtype=torch.float32)
            .reshape(ring, 1, 1).expand(ring, rows, feat).to(dtype)
            .contiguous())


def check_virtual(device, fault_lib, vreduce_fault_libs) -> dict:
    """Phase 2f: K15 and K16 against their plain versions, bit for bit,
    and against the definition (every row of K15 the concatenation of the
    shards; K16 the sum over members, within RS_ATOL / RS_REL for fp32):
    ring 2, 4 and 8, chunk 16 and a ragged 13, 128 features and 3 (K15's
    narrower units), fp32 and bf16, random and identity-valued shards.
    Then K15 on shards of several MB, where each block moves several
    tiles and the last one is ragged: the bulk design (16-byte units)
    refills its stages and flips their mbarrier parity, the register
    design (2-byte units) strides its grid. Then K16 on rows of 16-256
    MB in every unit of each dtype: several tiles a block with the last
    tile of a row ragged (the bulk design at rings 3, 4 and 8), chunks
    whose bytes are not a multiple of 16, and views that start 1, 2 or 4
    elements into their storage (the register design). The library's
    tiles must be rc.VIRTUAL_TILE_UNITS and K16's
    rc.virtual_reduce_tile_units. At ring 4 each planted fault must
    fail, on one tile a block and on the large shards, in each design:
    fault_lib holds K15's, vreduce_fault_libs one build each of K16's
    (VREDUCE_FAULTS)."""
    gen = torch.Generator(device=device).manual_seed(12)
    failed, worst_rel = [], 0.0
    worst = {"virtual_all_gather": 0.0, "virtual_reduce_scatter": 0.0}

    def err(got, want):
        return float((got.float() - want.float()).abs().max())

    def gather(x, name):
        got = rc.ring_all_gather_virtual_kernel(x)
        want = rc.ring_all_gather_virtual_reference(x)
        worst["virtual_all_gather"] = max(worst["virtual_all_gather"],
                                          err(got, want))
        full = x.reshape((1, -1) + x.shape[2:])
        if not (torch.equal(got, want) and torch.equal(
                got, full.expand_as(got))):
            failed.append(f"K15 {name}")
    lib = _build.library("ring_collectives")
    tile_units = lib.bs_virtual_gather_tile_units()
    if tile_units != rc.VIRTUAL_TILE_UNITS:
        failed.append(f"K15's tile is {tile_units} units, "
                      f"VIRTUAL_TILE_UNITS {rc.VIRTUAL_TILE_UNITS}")
    reduce_units = {(ring, unit): lib.bs_virtual_reduce_tile_units(ring,
                                                                   unit)
                    for ring in (2, 3, 4, 8, 4096, 4097)
                    for unit in (16, 8, 4, 2)}
    wrong = {key: got for key, got in reduce_units.items()
             if got != rc.virtual_reduce_tile_units(*key)}
    if wrong:
        failed.append(f"K16's tiles (ring, unit): {wrong} differ from "
                      f"virtual_reduce_tile_units")
    cases = itertools.product((2, 4, 8), (16, 13), (128, 3),
                              (torch.float32, torch.bfloat16), (False, True))
    for ring, chunk, feat, dtype, identity in cases:
        name = (f"ring {ring} chunk {chunk} x {feat} {str(dtype)[6:]}"
                f"{' identity' if identity else ''}")
        x = (identity_shards(ring, chunk, feat, dtype, device) if identity
             else torch.randn(ring, chunk, feat, generator=gen,
                              device=device).to(dtype))
        gather(x, name)
        rows = (identity_shards(ring, ring * chunk, feat, dtype, device)
                if identity else torch.randn(ring, ring * chunk, feat,
                                             generator=gen,
                                             device=device).to(dtype))
        got = rc.ring_reduce_scatter_virtual_kernel(rows)
        want = rc.ring_reduce_scatter_virtual_reference(rows)
        worst["virtual_reduce_scatter"] = max(
            worst["virtual_reduce_scatter"], err(got, want))
        total = rows.float().sum(dim=0).reshape(ring, chunk, feat)
        if not torch.equal(got, want):
            failed.append(f"K16 {name} vs plain")
        if dtype == torch.float32:
            rel = float(torch.linalg.vector_norm(got - total) /
                        torch.linalg.vector_norm(total))
            worst_rel = max(worst_rel, rel)
            if err(got, total) > RS_ATOL or rel > RS_REL:
                failed.append(f"K16 {name} vs sum")
        elif identity and not torch.equal(got.float(), total):
            failed.append(f"K16 {name} vs sum")
    # Large shards (MB): 977 and 1465 32 KB tiles in 16-byte units, 7.4
    # and 11.1 a block of 132, the last one ragged; 5860 4 KB tiles in
    # 2-byte units, 22.2 a block of 264.
    large = (torch.randn(4, 2_000_004, 1, generator=gen, device=device),
             torch.randn(8, 1_000_008, 3, generator=gen,
                         device=device).to(torch.bfloat16),
             torch.randn(4, 1_000_001, 3, generator=gen,
                         device=device).to(torch.bfloat16))
    for x in large:
        unit = rc.copy_unit(x[0].numel() * x.element_size())
        gather(x, f"ring {x.shape[0]} chunk {x.shape[1]} x {x.shape[2]} "
                  f"{str(x.dtype)[6:]} in {unit}-byte units")
    # K16's large rows (ring, chunk, feat, dtype, elements the view starts
    # into its storage): in 16-byte units (the bulk design) 489, 489 and
    # 513 tiles a row at rings 4, 8 and 3 (14.8, 29.6 and 11.7 a block of
    # 132, the last one of each row ragged); chunks of 999,999 fp32 and
    # 300,003 bf16 (the register design in 4- and 2-byte units, 977 and
    # 293 tiles a row); views 2, 1, 4, 2 and 1 elements in (8-, 4-, 8-,
    # 4- and 2-byte units).
    units, large_rows = set(), {}
    for ring, chunk, feat, dtype, shift in (
            (4, 1_000_004, 2, torch.float32, 0),
            (8, 250_001, 8, torch.bfloat16, 0),
            (3, 700_001, 4, torch.float32, 0),
            (4, 333_333, 3, torch.float32, 0),
            (8, 100_001, 3, torch.bfloat16, 0),
            (4, 250_000, 2, torch.float32, 2),
            (8, 125_000, 2, torch.float32, 1),
            (4, 250_000, 4, torch.bfloat16, 4),
            (8, 125_000, 4, torch.bfloat16, 2),
            (4, 250_000, 4, torch.bfloat16, 1)):
        shape = (ring, ring * chunk, feat)
        storage = torch.randn(shift + math.prod(shape), generator=gen,
                              device=device).to(dtype)
        rows = storage[shift:].view(shape)
        unit = rc.copy_unit(chunk * feat * rows.element_size(),
                            rows.data_ptr())
        units.add((str(dtype)[6:], unit))
        got = rc.ring_reduce_scatter_virtual_kernel(rows)
        want = rc.ring_reduce_scatter_virtual_reference(rows)
        worst["virtual_reduce_scatter"] = max(
            worst["virtual_reduce_scatter"], err(got, want))
        if not torch.equal(got, want):
            failed.append(f"K16 ring {ring} chunk {chunk} x {feat} "
                          f"{str(dtype)[6:]} {shift} elements in, "
                          f"{unit}-byte units, vs plain")
        if (ring, dtype) == (4, torch.float32) and unit in (16, 4):
            large_rows[unit] = rows
        del storage, rows, got, want
    if len(units) != 7:
        failed.append(f"K16's large cases took units {sorted(units)}")
    # K15's faults: the bulk design on 32 KB shards (one tile a block) and
    # on the large fp32 shards, the register design in 2-byte units. K16's
    # (a wrong chunk read; two adds swapped), each in both designs: fp32
    # rows of one tile a row and the large ones, in 16- and 4-byte units.
    xs = (torch.randn(4, 64, 128, generator=gen, device=device), large[0],
          torch.randn(4, 13, 3, generator=gen,
                      device=device).to(torch.bfloat16))
    fault_ag = all(not torch.equal(
        rc.ring_all_gather_virtual_kernel(x, library=fault_lib),
        rc.ring_all_gather_virtual_reference(x)) for x in xs)
    rows = (torch.randn(4, 64, 128, generator=gen, device=device),
            torch.randn(4, 52, 3, generator=gen, device=device),
            large_rows[16], large_rows[4])
    fault_rs = [all(not torch.equal(
        rc.ring_reduce_scatter_virtual_kernel(r, library=bad),
        rc.ring_reduce_scatter_virtual_reference(r)) for r in rows)
        for bad in vreduce_fault_libs]
    torch.cuda.synchronize()
    del large, xs, rows, large_rows
    torch.cuda.empty_cache()
    print(f"check K15/K16 (rings 2, 4, 8; chunks 16, 13 x 128, 3; fp32, "
          f"bf16; random and identity shards; K15 also on three large "
          f"shard sets, tile {tile_units} units; K16 on ten large row "
          f"sets in units {sorted(units)}, tiles at rings 2, 3, 4, 8 in "
          f"16-byte units {[reduce_units[r, 16] for r in (2, 3, 4, 8)]}): "
          f"{len(failed)} cases failed; max "
          f"|kernel - plain| K15 {worst['virtual_all_gather']:.3g}, K16 "
          f"{worst['virtual_reduce_scatter']:.3g}; K16 vs the plain sum: "
          f"worst relative L2 {worst_rel:.3g} (tol {RS_REL}); planted "
          f"faults caught: K15 {fault_ag}, K16 wrong chunk "
          f"{fault_rs[0]}, K16 swapped adds {fault_rs[1]}", flush=True)
    failed += [f"planted fault {k} passed" for k, caught in
               (("in K15", fault_ag), ("K16 wrong chunk", fault_rs[0]),
                ("K16 swapped adds", fault_rs[1])) if not caught]
    require(not failed, f"K15/K16: {failed}")
    return {"virtual_all_gather": {
                "max_abs_err": worst["virtual_all_gather"]},
            "virtual_reduce_scatter": {
                "max_abs_err": worst["virtual_reduce_scatter"],
                "rel_l2_vs_sum": worst_rel}}


def device_kernels_per_call(fn, *args) -> int:
    """The device kernels one call of fn(*args) launches (torch.profiler),
    after a warm-up call."""
    fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def time_virtual(device, readings: dict) -> dict:
    """Phase 3f: K15 and K16 at ring 4 at the sp path's all-reduce bytes
    (each member's chunk is K13's per-rank chunk of the gradient bucket),
    against their plain versions and one PyTorch call each that computes
    the same function: ``repeat`` of the concatenated shards for K15, a
    ``sum`` over members for K16 (another order of fp32 adds). Each
    kernel's device kernels a call are counted (each is one launch, no
    scratch), and its output at this shape must equal its plain version's
    bit for bit (K15's also the ``repeat``)."""
    chunk = bucket_elems() // SP
    gen = torch.Generator(device=device).manual_seed(13)
    out = {}
    failed = []

    def same(key, kernel, plain, library, x):
        got = kernel(x)
        equal = torch.equal(got, plain(x)) and (
            library is None or torch.equal(got, library(x)))
        if not equal:
            failed.append(f"{key} differs from its plain version")
        return {"timing_shape_equal": equal}
    x = torch.randn(SP, chunk, 1, generator=gen, device=device)

    def repeat(t):
        return t.reshape(1, -1, t.shape[2]).repeat(SP, 1, 1)
    out["virtual_all_gather"] = dict(
        ms=device_ms(rc.ring_all_gather_virtual_kernel, [(x,)], 8),
        device_kernels_per_call=device_kernels_per_call(
            rc.ring_all_gather_virtual_kernel, x),
        plain_ms=device_ms(rc.ring_all_gather_virtual_reference, [(x,)], 2),
        library_ms=device_ms(repeat, [(x,)], 8),
        **ring_bound(x.numel() * 4, SP * x.numel() * 4, None),
        **readings["virtual_all_gather"],
        **same("K15", rc.ring_all_gather_virtual_kernel,
               rc.ring_all_gather_virtual_reference, repeat, x))
    del x
    torch.cuda.empty_cache()
    rows = torch.randn(SP, SP * chunk, 1, generator=gen, device=device)
    out["virtual_reduce_scatter"] = dict(
        ms=device_ms(rc.ring_reduce_scatter_virtual_kernel, [(rows,)], 8),
        device_kernels_per_call=device_kernels_per_call(
            rc.ring_reduce_scatter_virtual_kernel, rows),
        plain_ms=device_ms(rc.ring_reduce_scatter_virtual_reference,
                           [(rows,)], 2),
        library_ms=device_ms(
            lambda t: t.view(SP, SP, chunk, t.shape[2]).sum(dim=0),
            [(rows,)], 8),
        **ring_bound(rows.numel() * 4, rows.numel() // SP * 4, None),
        **readings["virtual_reduce_scatter"],
        **same("K16", rc.ring_reduce_scatter_virtual_kernel,
               rc.ring_reduce_scatter_virtual_reference, None, rows))
    del rows
    torch.cuda.empty_cache()
    failed += [f"{KERNELS[key]['label']} launched "
               f"{row['device_kernels_per_call']} device kernels a call"
               for key, row in out.items()
               if row["device_kernels_per_call"] != 1]
    for key, row in out.items():
        print(f"time {KERNELS[key]['label']} {key} (ring 4, {chunk} fp32 a "
              f"member): kernel {row['ms']:.4f} ms, "
              f"{row['device_kernels_per_call']} device kernels a call, "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"(bytes); equal to the plain version at this shape: "
              f"{row['timing_shape_equal']}", flush=True)
    require(not failed, f"at the timing shape: {failed}")
    return out


class _PeerBytes:
    """A device address as a uint8 tensor (``__cuda_array_interface__``):
    the peer's mapped slot, for K12's copy_ yardstick."""

    def __init__(self, ptr: int, nbytes: int) -> None:
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


def _draw(device, seed: int, rank: int, shape, dtype):
    """Inputs every rank can draw for every other: seeded by (seed, rank)."""
    gen = torch.Generator(device=device).manual_seed(seed * 1009 + rank)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _rs_in_ring_order(parts):
    """Chunk c's sum as K14 forms it: the partial starts at rank c + 1 and
    every later rank adds its part (parts: rank c+1's first)."""
    acc = parts[0]
    for part in parts[1:]:
        acc = (acc.float() + part.float()).to(acc.dtype)
    return acc


def rank_check_collectives(group, fault_group, device) -> dict:
    """On every rank: K12 (+1 and -1 shifts, and its backward through
    autograd), K13 and K14 against their definitions, at the sp path's
    shapes, a ragged shape and identity-valued shards; the planted-fault
    build must fail K12, K13 and K14. Returns this rank's findings."""
    me, ring = group.rank, group.size
    failed = []
    worst = dict.fromkeys(RING_KEYS, 0.0)

    def note(key, got, want):
        worst[key] = max(worst[key],
                         float((got.float() - want.float()).abs().max()))
        return torch.equal(got, want)
    permute_cases = [("path", PERMUTE_SHAPE, torch.bfloat16, False),
                     ("ragged", (3, 77, 5, 64), torch.float32, False),
                     ("identity", (2, 64, 4, 64), torch.bfloat16, True)]
    for seed, (name, shape, dtype, identity) in enumerate(permute_cases):
        def kv(rank):
            if identity:
                value = torch.full(shape, float(rank + 1), device=device)
                return value.to(dtype), (-value).to(dtype)
            return (_draw(device, 2 * seed, rank, shape, dtype),
                    _draw(device, 2 * seed + 1, rank, shape, dtype))
        k, v = kv(me)
        for shift in (1, -1):
            got = rc.ring_permute_kernel(k, v, group, shift)
            want = kv((me - shift) % ring)
            if not all([note("ring_permute", a, b)
                        for a, b in zip(got, want)]):
                failed.append(f"K12 {name} shift {shift}")
        del got, want
    # The backward: the transpose of the +1 rotation is the -1 rotation.
    shape = (2, 128, 4, 64)
    k = _draw(device, 10, me, shape, torch.float32).requires_grad_()
    v = _draw(device, 11, me, shape, torch.float32).requires_grad_()
    k_out, v_out = rc.ring_permute_pair(k, v, group)
    g_k, g_v = (_draw(device, s, me, shape, torch.float32) for s in (12, 13))
    torch.autograd.backward((k_out, v_out), (g_k, g_v))
    right = (me + 1) % ring
    if not all([note("ring_permute", grad,
                     _draw(device, seed, right, shape, torch.float32))
                for grad, seed in ((k.grad, 12), (v.grad, 13))]):
        failed.append("K12 backward")
    bucket = bucket_elems()
    gather_cases = [("path", (bucket // ring,), torch.float32, False),
                    ("ragged", (37, 3), torch.bfloat16, False),
                    ("identity", (64, 128), torch.float32, True)]
    for seed, (name, shape, dtype, identity) in enumerate(gather_cases):
        def chunk_of(rank):
            if identity:
                return torch.full(shape, float(rank + 1), device=device,
                                  dtype=dtype)
            return _draw(device, 20 + seed, rank, shape, dtype)
        got = rc.ring_all_gather_kernel(chunk_of(me), group)
        for rank in range(ring):
            rows = slice(rank * shape[0], (rank + 1) * shape[0])
            if not note("ring_all_gather", got[rows], chunk_of(rank)):
                failed.append(f"K13 {name} rank {rank}'s chunk")
        del got
    scatter_cases = [("path", (bucket,), torch.float32, False),
                     ("ragged", (ring * 37, 3), torch.bfloat16, False),
                     ("identity", (ring * 64, 128), torch.float32, True)]
    worst_rel = 0.0
    for seed, (name, shape, dtype, identity) in enumerate(scatter_cases):
        rows = shape[0] // ring

        def part_of(rank):
            if identity:
                return torch.full((rows,) + shape[1:], float(rank + 1),
                                  device=device, dtype=dtype)
            x = _draw(device, 30 + seed, rank, shape, dtype)
            return x[me * rows:(me + 1) * rows].clone()
        if identity:
            x = torch.cat([torch.full((rows,) + shape[1:], float(me + 1),
                                      device=device, dtype=dtype)] * ring)
        else:
            x = _draw(device, 30 + seed, me, shape, dtype)
        got = rc.ring_reduce_scatter_kernel(x, group)
        del x
        parts = [part_of(rank) for rank in range(ring)]
        if not note("ring_reduce_scatter", got, _rs_in_ring_order(
                [parts[(me + 1 + j) % ring] for j in range(ring)])):
            failed.append(f"K14 {name} vs ring order")
        # The plain sum in rank order: another order of fp32 adds.
        total = torch.stack([p.float() for p in parts]).sum(dim=0)
        rel = float(torch.linalg.vector_norm(got.float() - total) /
                    torch.linalg.vector_norm(total))
        if dtype == torch.float32:
            worst_rel = max(worst_rel, rel)
            if float((got - total).abs().max()) > RS_ATOL or rel > RS_REL:
                failed.append(f"K14 {name} vs sum")
        del got, parts, total
    torch.cuda.empty_cache()
    # The planted faults: fresh random inputs, so a stale output row
    # cannot pass for the right one.
    shape = (2, 64, 4, 64)
    got = rc.ring_permute_kernel(
        _draw(device, 42, me, shape, torch.bfloat16),
        _draw(device, 43, me, shape, torch.bfloat16), fault_group)
    src = (me - 1) % ring
    fault_permute = not all(
        torch.equal(g, _draw(device, seed, src, shape, torch.bfloat16))
        for g, seed in zip(got, (42, 43)))
    x = _draw(device, 40, me, (64, 128), torch.float32)
    got = rc.ring_all_gather_kernel(x, fault_group)
    want = torch.cat([_draw(device, 40, r, (64, 128), torch.float32)
                      for r in range(ring)])
    fault_ag = not torch.equal(got, want)
    x = _draw(device, 41, me, (ring * 64, 128), torch.float32)
    got = rc.ring_reduce_scatter_kernel(x, fault_group)
    parts = [_draw(device, 41, (me + 1 + j) % ring, (ring * 64, 128),
                   torch.float32)[me * 64:(me + 1) * 64] for j in range(ring)]
    fault_rs = not torch.equal(got, _rs_in_ring_order(parts))
    torch.cuda.synchronize()
    group.check()
    fault_group.check()
    return {"failed": failed, "max_abs_err": worst,
            "k14_rel_l2_vs_sum": worst_rel,
            "fault_caught": {"permute": fault_permute,
                             "all_gather": fault_ag,
                             "reduce_scatter": fault_rs}}


def rank_missing_peer(device) -> dict:
    """Steps shaped like a train step's ring calls (four K12 rotations,
    then a K14 and a K13) on a group with a SKIP_TIMEOUT_S bound; rank
    SP - 1 skips the second K12 call of the first step. The epochs pair
    each rank's i-th call of a buffer, so the skip is silent until the
    calls part: rank 0's last K12 of the step waits for a call rank SP - 1
    makes only next step, while the others wait in K14 for rank 0. Every
    rank calls on until its group raises. Returns the seconds from the
    skipped call to this rank's error."""
    group = mesh_mod.RingGroup(device=device, timeout_s=SKIP_TIMEOUT_S)
    k = torch.zeros(2, 64, 4, 64, device=device, dtype=torch.bfloat16)
    bucket = torch.zeros(SP * 64, 128, device=device)
    torch.distributed.barrier()
    started, error = time.perf_counter(), None
    try:
        for step in range(4):
            for call in range(4):
                if (step, call, group.rank) == (0, 1, group.size - 1):
                    continue
                rc.ring_permute_kernel(k, k, group)
            rc.ring_all_gather_kernel(
                rc.ring_reduce_scatter_kernel(bucket, group), group)
            torch.cuda.synchronize()
            group.check()
    except RuntimeError as err:
        error = str(err)
    return {"raised": error is not None, "error": error,
            "seconds": time.perf_counter() - started}


def rank_time_collectives(group, device) -> dict:
    """K12 on the (K, V) pair at the sp path's shape, K13 and K14 on the
    gradient bucket: CUDA events around ``n`` calls after a barrier (the
    four ranks share one card, so each rank's time holds the others'
    time slices), the plain versions over gloo on host copies (host
    clock), and K12's yardstick: one copy_ of the peer's mapped slot."""
    me, ring = group.rank, group.size
    out = {}

    def events(fn, n):
        fn()
        torch.cuda.synchronize()
        torch.distributed.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        group.check()
        return start.elapsed_time(end) / n

    def host(fn):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    k = _draw(device, 50, me, PERMUTE_SHAPE, torch.bfloat16)
    v = _draw(device, 51, me, PERMUTE_SHAPE, torch.bfloat16)
    pair = k.numel() * k.element_size() * 2
    out["ring_permute"] = dict(
        ms=events(lambda: rc.ring_permute_kernel(k, v, group), 20),
        **ring_bound(pair, pair, pair))
    nbytes = k.numel() * k.element_size()
    span = rc.permute_slot_bytes(nbytes)
    permute = group.buffer("permute", span)  # K12's, mapped already
    slot = (permute.peer((me - 1) % ring) + mesh_mod.PAD_BYTES +
            (permute.calls % 2) * permute.slot_stride)
    peer = torch.as_tensor(_PeerBytes(slot, span), device=device)
    local = torch.empty(span, dtype=torch.uint8, device=device)
    out["ring_permute"]["library_ms"] = events(lambda: local.copy_(peer), 20)
    del peer, local
    k_cpu, v_cpu = k.cpu(), v.cpu()
    out["ring_permute"]["plain_ms"] = host(
        lambda: rc.ring_permute_reference(k_cpu, v_cpu, group))
    del k, v, k_cpu, v_cpu
    bucket = bucket_elems()
    x = _draw(device, 52, me, (bucket,), torch.float32)
    out["ring_reduce_scatter"] = dict(
        ms=events(lambda: rc.ring_reduce_scatter_kernel(x, group), 5),
        library_ms=None,
        **ring_bound(bucket * 4, bucket // ring * 4,
                     (ring - 1) * bucket // ring * 4))
    x_cpu = x.cpu()
    out["ring_reduce_scatter"]["plain_ms"] = host(
        lambda: rc.ring_reduce_scatter_reference(x_cpu, group))
    chunk = x[:bucket // ring].clone()
    del x, x_cpu
    out["ring_all_gather"] = dict(
        ms=events(lambda: rc.ring_all_gather_kernel(chunk, group), 5),
        library_ms=None,
        **ring_bound(bucket // ring * 4, bucket * 4,
                     (ring - 1) * bucket // ring * 4))
    chunk_cpu = chunk.cpu()
    out["ring_all_gather"]["plain_ms"] = host(
        lambda: rc.ring_all_gather_reference(chunk_cpu, group))
    del chunk, chunk_cpu
    torch.cuda.empty_cache()
    return out


def sp_rank_main() -> None:
    """One rank of the four-rank ring phase (``sp_collectives`` launches
    SP of them on the one card): the checks, the timing, the missing-rank
    check, then (if asked) one numerics step of the sp training path.
    Prints this rank's findings as one JSON line."""
    spec = json.loads(os.environ["CHIP_SMOKE_SP"])
    ctx = distributed.setup()
    device = ctx["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    group = mesh_mod.RingGroup(device=device, timeout_s=RING_TIMEOUT_S)
    fault_group = mesh_mod.RingGroup(
        device=device, timeout_s=RING_TIMEOUT_S,
        library=_build.load(pathlib.Path(spec["fault_library"]),
                            "ring_collectives"))
    result = {"rank": group.rank}
    result["check"] = rank_check_collectives(group, fault_group, device)
    result["time"] = rank_time_collectives(group, device)
    fault_group.close()
    group.close()
    if spec.get("numerics_dir"):
        result["numerics"] = rank_numerics(device, spec["numerics_dir"])
    result["missing_peer"] = rank_missing_peer(device)
    print("SP_RANK " + json.dumps(result), flush=True)


def sp_collectives(device, fault_path, numerics_dir=None) -> dict:
    """Phases 2g/3g: SP ranks on this one card (``distributed.launch_local``
    of sp_rank_main), each running the checks and timings above. Fails
    unless every rank passed, caught both planted faults and raised within
    SKIP_RAISE_LIMIT_S of a missing peer's skipped call."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    env = dict(os.environ, CHIP_SMOKE_SP=json.dumps({
        "fault_library": str(fault_path),
        "numerics_dir": str(numerics_dir) if numerics_dir else None}))
    started = time.perf_counter()
    runs = distributed.launch_local(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.sp_rank_main()"],
        SP, SP_RANKS_TIMEOUT_S, env=env,
        cwd=pathlib.Path(__file__).resolve().parent)
    results = []
    for run in runs:
        line = next((ln for ln in run["stdout"].splitlines()[::-1]
                     if ln.startswith("SP_RANK ")), None)
        if run["returncode"] != 0 or line is None:
            raise SmokeFailure(
                f"sp rank {run['rank']}: rc {run['returncode']} (timed out: "
                f"{run['timed_out']}): {run['stderr'][-3000:]}")
        results.append(json.loads(line[len("SP_RANK "):]))
    for r in results:
        check, skip = r["check"], r["missing_peer"]
        print(f"check sp rank {r['rank']}: K12-K14 failed cases "
              f"{check['failed']}, K14 vs sum rel L2 "
              f"{check['k14_rel_l2_vs_sum']:.3g}; planted faults caught "
              f"{check['fault_caught']}; missing peer: raised "
              f"{skip['raised']} after {skip['seconds']:.2f} s (limit "
              f"{SKIP_RAISE_LIMIT_S} s)", flush=True)
        require(not check["failed"], f"sp rank {r['rank']}: {check}")
        require(all(check["fault_caught"].values()),
                f"sp rank {r['rank']}: a planted fault passed {check}")
        require(skip["raised"] and skip["seconds"] <= SKIP_RAISE_LIMIT_S,
                f"sp rank {r['rank']}: missing peer {skip}")
    timing = {}
    for key in ("ring_permute", "ring_all_gather", "ring_reduce_scatter"):
        row = dict(results[0]["time"][key])
        row["ms_per_rank"] = [r["time"][key]["ms"] for r in results]
        row["max_abs_err"] = max(r["check"]["max_abs_err"][key]
                                 for r in results)
        row["note"] = (f"{SP} ranks time-sliced on one card (CUDA IPC "
                       f"mappings of one card's memory, not NVLink)")
        timing[key] = row
        lib = ("—" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"time {KERNELS[key]['label']} {key}: kernel {row['ms']:.4f} "
              f"ms (ranks {[round(x, 4) for x in row['ms_per_rank']]}), "
              f"plain {row['plain_ms']:.4f} ms, library {lib}, bound "
              f"{row['bound_ms']:.4f} ms one card, "
              f"{row['bound_nvlink_ms']:.4f} ms NVLink", flush=True)
    return {"timing": timing, "ranks": results,
            "seconds": time.perf_counter() - started}


# ------------------------------ training ------------------------------


def _flat_grads(harness, batch) -> tuple[float, torch.Tensor]:
    """(loss, every parameter's gradient flattened to fp32) of one
    step's forward and backward, leaving the parameters untouched."""
    loss = harness.loss_fn(batch["tokens"], batch["targets"])
    params = list(harness.model.parameters())
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), torch.cat(
        [g.float().reshape(-1) for g in grads])


def train_numerics(harness, batch, kernel=None) -> dict:
    """One step of the kernel model against a plain bf16 model (the
    attention's blockwise plain version, the plain slab loss and, with
    fused_norm, the plain norm-matmul; with quantize_matmuls, the plain
    quantize and int8 matmul on the same bits) and an fp32 plain model,
    all with the harness's current weights, on the first two rows of the
    batch. ``kernel``: the kernel path's (loss, flat gradients) when it
    ran elsewhere (the sp ranks), else the harness's own."""
    small = {name: t[:2] for name, t in batch.items()}
    plain_fn = functools.partial(attn_ops.attention, impl="blockwise")
    cfg = harness.model.config
    params = harness.model.state_dict()
    loss_k, grad_k = kernel or _flat_grads(harness, small)
    results = {}
    for name, dtype in (("plain", cfg.dtype), ("fp32", torch.float32)):
        other = train_mod.build_transformer_train(
            dataclasses.replace(cfg, dtype=dtype, attention_fn=plain_fn,
                                fused_norm_impl="plain",
                                quantize_impl="plain"),
            batch_size=2, seq_len=small["tokens"].shape[1],
            device=harness.device, params=params, loss_impl="plain")
        results[name] = _flat_grads(other, small)
        del other
    torch.cuda.empty_cache()
    (loss_p, grad_p), (loss_f, grad_f) = results["plain"], results["fp32"]

    def rel(a, b):
        return _rel(a, b, torch.linalg.vector_norm)
    floor = rel(grad_p, grad_f)
    loss_floor = max(abs(loss_p - loss_f), LOSS_FLOOR_MIN * abs(loss_f))
    row = {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_fp32": loss_f,
           "grad_kernel_vs_fp32": rel(grad_k, grad_f),
           "grad_kernel_vs_plain": rel(grad_k, grad_p),
           "grad_plain_vs_fp32": floor}
    require(all(math.isfinite(x) for x in row.values()),
            f"train numerics: non-finite {row}")
    require(floor <= TRAIN_FLOOR_MAX,
            f"train numerics: plain bf16 vs fp32 gradients {row}")
    require(row["grad_kernel_vs_fp32"] <= TRAIN_SLACK * floor and
            row["grad_kernel_vs_plain"] <= TRAIN_SLACK * floor,
            f"train numerics: kernel gradients off by more than bf16 "
            f"rounding: {row}")
    require(abs(loss_k - loss_f) <= TRAIN_SLACK * loss_floor,
            f"train numerics: kernel loss off by more than bf16 "
            f"rounding: {row}")
    return row


def train(device, fused: bool = False, quantize: bool = False) -> dict:
    """Phase 4: a training path, end to end: bench_transformer's model
    (``fused``: with fused_norm; ``quantize``: with quantize_matmuls;
    either with the fused loss that the validation marker in force
    selects)."""
    model = train_wl.BENCH_TRANSFORMER_MODEL
    batch_size = train_wl.BENCH_TRANSFORMER_BATCH
    seq = train_wl.BENCH_TRANSFORMER_SEQ
    loss_path = kernel_select.resolve_auto(loss_ops.VALIDATION_NAME, device)
    require(loss_path == ("kernel" if fused or quantize else "plain"),
            f"train: the loss resolves to {loss_path!r}")
    layers = model["n_layers"]
    per_step = {"flash_fwd": layers, "flash_bwd": layers}
    allowed_plain = {"chunked_loss.chunked"}
    if fused or quantize:
        per_step.update({key: 1 for key in LOSS_KERNELS})
        allowed_plain = set()
    if fused:
        per_step["rmsnorm_matmul"] = 2 * layers
    if quantize:
        # Seven QuantDense projections a layer: K10 for x and for the
        # weight, K11 once; each K10 call's bits are one draw.
        per_step["quantize_int8"] = 14 * layers
        per_step["int8_matmul"] = 7 * layers
    started = time.perf_counter()
    harness = train_wl.build_bench_harness(device, seed=0,
                                           batch_size=batch_size,
                                           seq_len=seq, fused_norm=fused,
                                           quantize=quantize)
    batch = train_wl.random_batch(model["vocab_size"], batch_size, seq, 0,
                                  device)
    numerics = train_numerics(harness, batch)
    print("train numerics " + json.dumps(numerics), flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = [harness.step(batch)["loss"] for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [harness.step(batch)["loss"] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launch_counts()
    plain = plain_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    steps = TRAIN_WARMUP + TRAIN_STEPS
    require(all(math.isfinite(x) for x in losses),
            f"train: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"train: loss did not fall {losses}")
    for key, n in per_step.items():
        require(counts[key] == n * steps,
                f"train: {counts[key]} {key} launches in {steps} steps")
    others = {k: n for k, n in counts.items() if k not in per_step and n}
    require(not others, f"train: unexpected launches {others}")
    ran = {k: n for k, n in plain.items() if n and k not in allowed_plain}
    require(not ran, f"train: plain versions ran {ran}")
    draws = quant_ops.bit_draws["random_bits"]
    require(draws == per_step.get("quantize_int8", 0) * steps,
            f"train: {draws} draws of random bits in {steps} steps")
    tokens_per_s = batch_size * seq * TRAIN_STEPS / elapsed
    flops = mfu.transformer_train_flops_per_token(harness.model.config, seq)
    profile = train_profile.profile_steps(harness, batch, 2)
    row = {
        "model": model, "fused_norm": fused, "quantize_matmuls": quantize,
        "loss": loss_path,
        "batch": batch_size, "seq_len": seq,
        "steps": steps, "timed_steps": TRAIN_STEPS,
        "launches": {k: counts[k] for k in per_step},
        "launches_per_step": {k: counts[k] / steps for k in per_step},
        "plain_calls": {k: n for k, n in plain.items() if n},
        "bit_draws_per_step": draws / steps,
        "ms_per_step": elapsed / TRAIN_STEPS * 1e3,
        "tokens_per_s": tokens_per_s,
        "tflop_per_step": flops * batch_size * seq / 1e12,
        "mfu_pct": mfu.mfu_pct(tokens_per_s, flops,
                               mfu.peak_bf16_tflops()),
        "peak_mem_gb": peak_gb, "losses": losses,
        "numerics": numerics, "profile": profile,
        "phase_s": time.perf_counter() - started,
    }
    label = " fused" if fused else " int8" if quantize else ""
    print(f"train{label} " + json.dumps(row), flush=True)
    del harness, batch
    torch.cuda.empty_cache()
    return row


# ----------------- sequence-parallel training (--sp 4) -----------------


# The sp phase: the reference workload's long-context recipe
# (workloads/train_transformer.py:8-10, --seq-len 8192 --sp 4; its --tp 2
# is not ported) at bench_transformer's widths, batch 8, remat on, at
# SP_LAYERS of its 12 layers (the script's time: its per-step work on the
# host's cores and the card sets the first mesh round). Every run of the
# sp and mesh phases takes SP_WARMUP + SP_STEPS steps.
SP_WARMUP, SP_STEPS, SP_PROFILE_STEPS = 1, 3, 1
SP_LAYERS = 4
SP_TRAIN_TIMEOUT_S = 300.0
# One step's numerics at batch 2, T 2048 (where the fp32 plain model
# fits): the sp kernel path against single-process plain models.
SP_NUMERICS_BATCH, SP_NUMERICS_SEQ = 2, 2048


def mesh_launches_per_step(rank: int, sizes: dict,
                           layers: int = _MODEL["n_layers"],
                           flags=()) -> dict:
    """What rank ``rank`` of a mesh of ``sizes`` (auto_axis_sizes)
    launches each step of the workload (causal, remat on, the fused loss,
    ``layers`` layers, the workload ``flags``: ``--fused-norm`` or
    ``--int8``), by kernel and by ring call and axis (the workload's
    ``launches``). Per layer: sp - 1 ring rotations forward, as many
    again in remat's recompute and in the backward (K12); the diagonal
    and sp_index full flash blocks, forward and recompute (K1) and
    backward (K2); with tp, two all-reduces (g) forward, the same two in
    the recompute and two (f) in the backward, each one K14 and one K13.
    With --fused-norm, K9 twice forward and twice in the recompute. With
    --int8, seven projections forward and in the recompute, each K11
    once; a column-parallel one (all seven without tp) K10 for x and the
    weight, a row-parallel one (o and down under tp) bs_row_absmax and
    bs_quantize_scaled for each and one K13 absmax gather over the tp
    ring. Per step: the loss once (K3-K5, on the vocab shard under tp);
    with tp, the embedding's all-reduce (g), the loss's (lse, gold)
    gather and grad_h all-reduce, and with --fused-norm the norm scales'
    gradient all-reduce; with fsdp, over the fsdp ring, each unit's
    gather (K13: ``embed`` once, each layer forward and again in remat's
    recompute) and gradient reduce-scatter (K14: one a unit), and the
    loss share's all-reduce (K14 + K13); with dp x sp > 1, one all-reduce
    (K14 + K13) over the data ring. Each K12-K14 launch counts under its
    ring's label too, and each all-reduce under
    "ring_all_reduce.<label>"; with dp = 1 the sp ring is the data ring,
    labelled "sp+data"."""
    fused, int8 = "--fused-norm" in flags, "--int8" in flags
    coords = mesh_mod.RankMesh(sizes, rank).coords
    blocks = 1 + coords["sp"]
    rotations = 3 * (sizes["sp"] - 1) * layers
    split = sizes["tp"] > 1
    tp = 6 * layers + 2 + int(fused) if split else 0
    tp_gathers = 1 + (4 * layers if int8 else 0) if split else 0
    row = 2 if split else 0  # row-parallel products a layer
    data = int(sizes["dp"] * sizes["sp"] > 1)
    fsdp = int(sizes["fsdp"] > 1)
    unit_gathers = fsdp * (1 + 2 * layers)
    unit_scatters = fsdp * (1 + layers)
    shared = "sp+data" if sizes["dp"] == 1 else None
    want = collections.Counter({
        "ring_permute": rotations, f"ring_permute.{shared or 'sp'}":
        rotations, "flash_fwd": 2 * blocks * layers,
        "flash_bwd": blocks * layers, "xent_fwd": 1, "xent_bwd_h": 1,
        "xent_bwd_e": 1,
        "ring_reduce_scatter": tp + data + fsdp + unit_scatters,
        "ring_all_gather": tp + tp_gathers + data + fsdp + unit_gathers,
        "ring_all_gather.tp": tp_gathers,
        "ring_all_gather.fsdp": unit_gathers,
        "ring_reduce_scatter.fsdp": unit_scatters})
    for label, n in (("tp", tp), (shared or "data", data), ("fsdp", fsdp)):
        for call in ("ring_reduce_scatter", "ring_all_gather",
                     "ring_all_reduce"):
            want[f"{call}.{label}"] += n
    if fused:
        want["rmsnorm_matmul"] = 4 * layers
    if int8:
        want["int8_matmul"] = 14 * layers
        want["quantize_int8"] = 4 * (7 - row) * layers
        want["row_absmax"] = want["quantize_scaled"] = 4 * row * layers
    return {key: n for key, n in want.items() if n}


def sp_launches_per_step(rank: int) -> dict:
    """What rank ``rank`` of the sp path (--sp 4 on four ranks) launches
    each step: mesh_launches_per_step of the sp-only mesh, whose data
    ring is the sp ring (one all-reduce, K14 + K13)."""
    return mesh_launches_per_step(rank, mesh_mod.auto_axis_sizes(SP, sp=SP),
                                  SP_LAYERS)


def rank_numerics(device, out_dir) -> dict:
    """One step's loss and gradients (no update) of the sp kernel path at
    SP_NUMERICS_BATCH x SP_NUMERICS_SEQ, weights and batch from seed 0;
    rank 0 saves them for sp_numerics."""
    group = mesh_mod.RingGroup(device=device, timeout_s=RING_TIMEOUT_S)
    harness = train_wl.build_bench_harness(
        device, seed=0, batch_size=SP_NUMERICS_BATCH,
        seq_len=SP_NUMERICS_SEQ, group=group, remat=True)
    batch = train_wl.random_batch(_MODEL["vocab_size"], SP_NUMERICS_BATCH,
                                  SP_NUMERICS_SEQ, 0, device)
    tokens, targets, positions, share = harness.shard(batch["tokens"],
                                                      batch["targets"])
    loss = harness.loss_fn(tokens, targets, positions) * share
    loss.backward()
    grads, loss = harness.sum_grads(loss)
    # The parameters' order (the single-process models' flat gradients).
    by_name = sharding.join_owned(harness.units, [grads])
    grads = torch.cat([by_name[name].reshape(-1)
                       for name in harness.state_tensors()])
    torch.cuda.synchronize()
    group.check()
    if group.rank == 0:
        torch.save({"loss": float(loss), "grads": grads.cpu()},
                   pathlib.Path(out_dir) / "sp_numerics.pt")
    del harness, grads
    group.close()
    torch.cuda.empty_cache()
    return {"loss": float(loss)}


def sp_numerics(device, out_dir) -> dict:
    """The sp kernel path's loss and gradients (rank 0's, summed over the
    ring) against single-process plain bf16 and fp32 models with the same
    weights and batch: train_numerics' criterion."""
    saved = torch.load(pathlib.Path(out_dir) / "sp_numerics.pt")
    harness = train_wl.build_bench_harness(
        device, seed=0, batch_size=SP_NUMERICS_BATCH,
        seq_len=SP_NUMERICS_SEQ)
    batch = train_wl.random_batch(_MODEL["vocab_size"], SP_NUMERICS_BATCH,
                                  SP_NUMERICS_SEQ, 0, device)
    row = train_numerics(harness, batch,
                         kernel=(saved["loss"], saved["grads"].to(device)))
    del harness, saved
    torch.cuda.empty_cache()
    print("sp numerics " + json.dumps(row), flush=True)
    return row


def train_sp(device, marker_env: dict, port: Optional[int] = None) -> dict:
    """Phase 5: ``--sp 4`` training at full width through the workload's
    entry point under ``python -m torch.distributed.run``, four ranks on
    this one card (rendezvous on ``port``, a free one by default). The
    loss must be finite and fall; every rank must launch exactly
    sp_launches_per_step(rank) a step and no plain version."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", str(SP), "--master-port",
           str(port or distributed.free_port()), "-m",
           "batch_shipyard_tpu_torch.workloads.train_transformer",
           "--sp", str(SP), "--n-layers", str(SP_LAYERS), "--seq-len",
           str(SP_SEQ), "--batch", str(SP_BATCH), "--warmup",
           str(SP_WARMUP), "--steps",
           str(SP_STEPS), "--profile-steps", str(SP_PROFILE_STEPS)]
    started = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=SP_TRAIN_TIMEOUT_S,
                          env=dict(os.environ, **marker_env),
                          cwd=pathlib.Path(__file__).resolve().parent)
    seconds = time.perf_counter() - started
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and len(lines) >= 2,
            f"train --sp {SP}: rc {proc.returncode}: "
            f"{proc.stderr[-4000:]}")
    print(lines[-2], flush=True)
    report = json.loads(lines[-1])
    losses = report["losses"]
    require(all(math.isfinite(x) for x in losses),
            f"train --sp: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"train --sp: loss did not fall {losses}")
    steps = SP_WARMUP + SP_STEPS
    for r in report["per_rank"]:
        want = sp_launches_per_step(r["rank"])
        require(r["launches"] == {k: n * steps for k, n in want.items()},
                f"train --sp rank {r['rank']}: launches {r['launches']} in "
                f"{steps} steps, want {want} a step")
        require(not r["plain_calls"],
                f"train --sp rank {r['rank']}: plain versions ran "
                f"{r['plain_calls']}")
    profile = [r["profile"] for r in report["per_rank"]]
    row = {
        "config": f"bench_transformer widths, {SP_LAYERS} layers, "
                  f"--seq-len {SP_SEQ} --sp {SP}, batch {SP_BATCH}, remat, "
                  f"fused loss",
        "ranks": f"{SP} ranks time-sliced on one card",
        "steps": steps, "timed_steps": SP_STEPS,
        "tokens_per_s": report["tokens_per_sec"],
        "ms_per_step": report["ms_per_step"], "losses": losses,
        "mfu_pct_of_one_card": report["mfu_pct"],
        "launches_rank0": report["per_rank"][0]["launches"],
        "launches_per_step": {r["rank"]: r["launches_per_step"]
                              for r in report["per_rank"]},
        "peak_mem_gb": [r["peak_mem_gb"] for r in report["per_rank"]],
        "ring_wait_ms_per_step": [p["ring_wait_ms_per_step"]
                                  for p in profile],
        "ring_share_of_device": [p["ring_share_of_device"] for p in profile],
        "ring_ms_per_step": [p["ring_ms_per_step"] for p in profile],
        "k12_ms_per_step": [p["kernel_ms_per_step"]["ring_permute"]
                            for p in profile],
        "k13_k14_ms_per_step": [p["ring_all_reduce_ms_per_step"]
                                for p in profile],
        "profile": profile, "phase_s": seconds,
    }
    print(f"train --sp {SP} ({row['ranks']}): {row['tokens_per_s']:.0f} "
          f"tokens/s of the global batch, {row['ms_per_step']:.1f} ms/step, "
          f"peak GB per rank {row['peak_mem_gb']}, ring share of device "
          f"time per rank {row['ring_share_of_device']}", flush=True)
    print("train sp " + json.dumps(row), flush=True)
    return row


# --------------------- the training mesh (8 ranks) ---------------------


# The mesh phase: ranks on this one card through the workload under
# torch.distributed.run. (a) the reference workload's recipe,
# --seq-len 8192 --sp 4 --tp 2 (workloads/train_transformer.py:8-10), at
# bench_transformer's widths and SP_LAYERS layers (the --sp 4 run it is
# held against has them), batch 8, remat, the fused loss (vocab-parallel
# over the tp ring); (b) dp and fsdp across sp rings,
# --sp 2 --fsdp 2 (dp 2), the same widths and batch, depth cut to 2
# layers; (c) and (d) the tp axis with the fused norms and with int8,
# --sp 2 --tp 2 (dp 2) --fused-norm or --int8 at 2 layers, each against
# the same flags at --sp 2 alone on ``base`` ranks (dp 2 again, so each
# rank holds the same rows and, with --int8, draws the same bits), all
# on eight ranks; (e) the MultiSlice-DCN recipe (recipes/MultiSlice-DCN/
# config/jobs.yaml: --batch 16 --seq-len 4096 --fsdp 2) at the workload's
# default widths and depth, remat, the fused loss, on two ranks (dp 1),
# against --batch 16 --seq-len 4096 on two ranks (dp 2, fsdp 1: the same
# 8 x 4096 rows a rank). ``base``: the comparison's overrides of the
# run's ranks and axes.
MESH_RANKS = 8
MESH_RUNS = {
    "recipe": dict(tp=2, sp=4, fsdp=1, n_layers=SP_LAYERS),
    "dp_fsdp": dict(tp=1, sp=2, fsdp=2, n_layers=2),
    "fused_tp": dict(tp=2, sp=2, fsdp=1, n_layers=2,
                     flags=["--fused-norm"], base=dict(ranks=4, tp=1)),
    "int8_tp": dict(tp=2, sp=2, fsdp=1, n_layers=2, flags=["--int8"],
                    base=dict(ranks=4, tp=1)),
    "fsdp_recipe": dict(tp=1, sp=1, fsdp=2, n_layers=_MODEL["n_layers"],
                        ranks=2, batch=16, seq=4096,
                        base=dict(ranks=2, fsdp=1)),
}
# (e) against its comparison: a rank's peak memory at least this much
# lower (PERF.md's reckoning: 1.1-1.9 GB), set before the first run.
FSDP_PEAK_SAVING_GB = 0.9
# The meshes whose ring calls mesh_collectives holds against their plain
# versions ((c) has (d)'s axes).
MESH_CHECKED = ("recipe", "dp_fsdp", "int8_tp")
MESH_TRAIN_TIMEOUT_S = 300.0
# (a)'s loss at every step against train_sp's on the same weights and
# batch: the two differ only in the order of bf16 sums (tp splits the
# o/down products and adds the halves in bf16, K14's ring order), so each
# loss must sit within one bf16 unit roundoff (2^-8) of train_sp's,
# relative. Set before the first run; not tuned after.
MESH_LOSS_RTOL = 2.0 ** -8
# The killed-rank check: a small mesh of the recipe's axes (2 layers,
# batch 2 x 2048) whose groups wait KILL_TIMEOUT_S; rank KILLED_RANK
# kills itself in the second step's forward, and every other rank must
# raise within twice the timeout.
KILL_TIMEOUT_S = 5.0
KILL_RAISE_LIMIT_S = 2 * KILL_TIMEOUT_S
KILLED_RANK = 5
KILL_RANKS_TIMEOUT_S = 150.0


def mesh_kill_main() -> None:
    """One rank of the killed-rank check (``mesh_kill`` launches
    MESH_RANKS of them): steps of a small recipe-shaped mesh, each ending
    in a synchronise and a check; rank KILLED_RANK writes the time and
    SIGKILLs itself as layer 1's forward starts in step 1. Prints when
    this rank raised, as one JSON line, and exits at once (a peer's
    mapped buffers may be gone)."""
    import faulthandler
    import signal
    # A rank that hangs prints every thread's stack before it is killed.
    faulthandler.dump_traceback_later(KILL_RANKS_TIMEOUT_S - 60, exit=True)
    spec = json.loads(os.environ["CHIP_SMOKE_KILL"])
    ctx = distributed.setup()
    device, me = ctx["device"], ctx["process_index"]
    mesh = mesh_mod.RankMesh.build(device, tp=2, sp=4,
                                   timeout_s=KILL_TIMEOUT_S)
    harness = train_wl.build_bench_harness(
        device, seed=0, batch_size=2, seq_len=2048, mesh=mesh, remat=True,
        n_layers=2)
    batch = train_wl.random_batch(_MODEL["vocab_size"], 2, 2048, 0, device)
    step = [0]

    def die(*_):
        if step[0] == 1 and me == KILLED_RANK:
            with open(spec["killed_file"], "w") as f:
                f.write(json.dumps({"killed_at": time.time()}))
                f.flush()
                os.fsync(f.fileno())
            os.kill(os.getpid(), signal.SIGKILL)
    harness.model.layer_1.register_forward_pre_hook(die)
    torch.distributed.barrier()
    error = None
    try:
        for step[0] in range(8):
            harness.step(batch)
            torch.cuda.synchronize()
            mesh.check()
    except RuntimeError as err:
        error = str(err)
    print("KILL_RANK " + json.dumps({"rank": me, "raised": error is not None,
                                     "error": error,
                                     "raised_at": time.time()}), flush=True)
    os._exit(0)


def mesh_kill(device) -> dict:
    """The killed-rank check: every rank but KILLED_RANK must raise within
    KILL_RAISE_LIMIT_S of the kill."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    workdir = tempfile.TemporaryDirectory()
    killed_file = pathlib.Path(workdir.name) / "killed.json"
    env = dict(os.environ, CHIP_SMOKE_KILL=json.dumps({
        "killed_file": str(killed_file)}))
    started = time.perf_counter()
    try:
        runs = distributed.launch_local(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.mesh_kill_main()"],
            MESH_RANKS, KILL_RANKS_TIMEOUT_S, env=env,
            cwd=pathlib.Path(__file__).resolve().parent)
        require(killed_file.exists(),
                f"mesh kill: rank {KILLED_RANK} never reached its kill: "
                f"{runs[KILLED_RANK]['stderr'][-3000:]}")
        killed_at = json.loads(killed_file.read_text())["killed_at"]
    finally:
        workdir.cleanup()
    seconds, failed = {}, []
    for run in runs:
        if run["rank"] == KILLED_RANK:
            continue
        line = next((ln for ln in run["stdout"].splitlines()[::-1]
                     if ln.startswith("KILL_RANK ")), None)
        result = json.loads(line[len("KILL_RANK "):]) if line else {}
        if not result.get("raised") or run["timed_out"]:
            failed.append(f"rank {run['rank']}: rc {run['returncode']} "
                          f"(timed out: {run['timed_out']}) {result}: "
                          f"{run['stderr'][-6000:]}")
        else:
            seconds[run["rank"]] = result["raised_at"] - killed_at
    require(not failed, "mesh kill: " + "\n".join(failed))
    print(f"check mesh kill: rank {KILLED_RANK} killed mid-step; the other "
          f"ranks raised after {[round(x, 2) for x in seconds.values()]} s "
          f"(limit {KILL_RAISE_LIMIT_S} s, ring timeout {KILL_TIMEOUT_S} s)",
          flush=True)
    require(all(x <= KILL_RAISE_LIMIT_S for x in seconds.values()),
            f"mesh kill: a rank raised too late {seconds}")
    return {"raise_s": seconds, "limit_s": KILL_RAISE_LIMIT_S,
            "phase_s": time.perf_counter() - started}


MESH_CHECK_RANKS_TIMEOUT_S = 300.0
# Ring calls of the mesh paths' own kind at a ragged size (the
# all-reduce's pad and unpad; 37 x 3 bf16 is 111 elements).
MESH_RAGGED = {"tp": ((37, 3), torch.bfloat16),
               "data": ((37,), torch.float32)}


def _against_plain(note, key, got, plain) -> bool:
    """The card's result against its plain version's (a CPU tensor): bit
    for bit, the largest difference noted under ``key``."""
    got = got.cpu()
    note[key] = max(note.get(key, 0.0),
                    float((got.float() - plain.float()).abs().max()))
    return got.dtype == plain.dtype and torch.equal(got, plain)


# Units of the fsdp checks besides the model's own: a ragged one (37
# elements: the last lane of a chunk padded) and one smaller than a lane
# a rank (5 elements: the final norm's case at a wide ring).
FSDP_RAGGED_UNITS = (37, 5)


def rank_check_fsdp_unit(group, unit, draw, note) -> bool:
    """One fsdp unit's gather (forward: K13 of this rank's chunk into the
    unit's flat) and gradient reduce-scatter (backward: K14 into the
    sink) through ring_collectives.fsdp_gather on the card, against the
    plain all-gather and reduce-scatter on CPU copies, bit for bit. The
    unit's values are drawn alike on every rank, its gaps zero, as the
    harness lays it out; the gradient differs a rank."""
    full = unit.flatten({name: draw(shape, 0) for name, shape, _ in
                         unit.params})
    lo, hi = unit.span(group.rank)
    chunk = full[lo:hi].clone()
    sink = torch.full_like(chunk, float("nan"))
    grad = draw((unit.length,), group.rank + 1)
    flat = rc.fsdp_gather(chunk.requires_grad_(), group, sink)
    flat.backward(grad)
    want_flat = rc.ring_all_gather(chunk.detach().cpu(), group)
    want_sink = rc.ring_reduce_scatter(grad.cpu(), group)
    return all([_against_plain(note, "ring_all_gather", flat.detach(),
                               want_flat),
                _against_plain(note, "ring_reduce_scatter", sink,
                               want_sink),
                torch.equal(want_flat, full.cpu()), chunk.grad is None])


def rank_check_mesh(name: str, mesh, device) -> dict:
    """On every rank of a MESH_RUNS mesh: each ring call of its path on
    card tensors at the shapes the path gives it, against the plain
    version on CPU copies of the same inputs over the same group's gloo
    subgroup, bit for bit. The tp all-reduce of an activation [batch /
    (dp fsdp), seq / sp, d_model] bf16, the vocab-parallel loss's gather
    of (lse, gold) [2, rows] and all-reduce of grad_h [rows, d_model]
    fp32; over the fsdp ring, each unit's gather and gradient
    reduce-scatter (rank_check_fsdp_unit: ``embed`` and a layer, whose
    sizes (b) and (e) share, then FSDP_RAGGED_UNITS) and the loss
    share's all-reduce; the data ring's all-reduce of the gradient row;
    K12's rotations of the (K, V) shard over the sp ring; and the
    all-reduce at a ragged size (MESH_RAGGED) over the tp and data rings.
    With --int8, one layer's row-parallel operands (down: x [rows, d_ff /
    tp], w [d_model, d_ff / tp]) through quantize_split_rows on the card
    (bs_row_absmax, the K13 absmax gather, bs_quantize_scaled), bit for
    bit against K10 on this rank over the whole rows."""
    cfg = MESH_RUNS[name]
    groups, sizes = mesh.groups, mesh.sizes
    units = model_units(sizes["fsdp"], n_layers=cfg["n_layers"],
                        tp_group=groups["tp"])
    owned = sum(unit.chunk for unit in units)
    data = groups["data"]
    row = train_mod.row_length(owned, 1 if data is None else data.size)
    rows = cfg.get("batch", SP_BATCH) // mesh.data_size
    width = cfg.get("seq", SP_SEQ) // sizes["sp"]
    failed, worst, cases = [], {}, []
    seed = itertools.count(100)

    def case(label, ok):
        cases.append(label)
        if not ok:
            failed.append(label)
    if groups["tp"] is not None:
        shape = (rows, width, _MODEL["d_model"])
        x = _draw(device, next(seed), mesh.rank, shape, torch.bfloat16)
        case(f"tp all-reduce {shape} bf16", _against_plain(
            worst, "ring_all_reduce", rc.ring_all_reduce(x, groups["tp"]),
            rc.ring_all_reduce(x.cpu(), groups["tp"])))
        stats = _draw(device, next(seed), mesh.rank, (2, rows * width),
                      torch.float32)
        case(f"tp loss gather (2, {rows * width}) fp32", _against_plain(
            worst, "ring_all_gather", rc.ring_all_gather(stats, groups["tp"]),
            rc.ring_all_gather(stats.cpu(), groups["tp"])))
        x = _draw(device, next(seed), mesh.rank,
                  (rows * width, _MODEL["d_model"]), torch.float32)
        case(f"tp grad_h all-reduce {tuple(x.shape)} fp32", _against_plain(
            worst, "ring_all_reduce", rc.ring_all_reduce(x, groups["tp"]),
            rc.ring_all_reduce(x.cpu(), groups["tp"])))
        del x, stats
        if "--int8" in cfg.get("flags", ()):
            case("int8 row-parallel operands (down) against K10 on the "
                 "whole rows", rank_check_split_rows(
                     groups["tp"], rows * width, device))
    if groups["fsdp"] is not None:
        group = groups["fsdp"]
        ragged = [sharding.fsdp_units({"layer_0.w": (n,)}, group.size)[0]
                  for n in FSDP_RAGGED_UNITS]
        for unit in units[:2] + ragged:
            at = next(seed)
            case(f"fsdp unit {unit.name} of {unit.length} ({unit.chunk} a "
                 f"rank) gather and gradient reduce-scatter",
                 rank_check_fsdp_unit(
                     group, unit, lambda shape, r, at=at: _draw(
                         device, at, r, shape, torch.float32), worst))
        x = _draw(device, next(seed), mesh.rank, (1,), torch.float32)
        case("fsdp loss all-reduce (1,) fp32",
             _against_plain(worst, "ring_all_reduce",
                            rc.ring_all_reduce(x, group),
                            rc.ring_all_reduce(x.cpu(), group)))
    if data is not None:
        x = _draw(device, next(seed), mesh.rank, (row,), torch.float32)
        case(f"data all-reduce ({row},) fp32 over {data.axis}",
             _against_plain(worst, "ring_all_reduce",
                            rc.ring_all_reduce(x, data),
                            rc.ring_all_reduce(x.cpu(), data)))
        del x
    if groups["sp"] is not None:
        shape = (rows, width, _MODEL["n_heads"], _MODEL["d_head"])
        k = _draw(device, next(seed), mesh.rank, shape, torch.bfloat16)
        v = _draw(device, next(seed), mesh.rank, shape, torch.bfloat16)
        for shift in (1, -1):
            got = rc.ring_permute(k, v, groups["sp"], shift)
            want = rc.ring_permute(k.cpu(), v.cpu(), groups["sp"], shift)
            case(f"sp rotation {shift:+d} {shape} bf16", all(
                [_against_plain(worst, "ring_permute", a, b)
                 for a, b in zip(got, want)]))
        del k, v, got, want
    for role, (shape, dtype) in MESH_RAGGED.items():
        if groups[role] is not None:
            x = _draw(device, next(seed), mesh.rank, shape, dtype)
            case(f"{role} all-reduce {shape} {str(dtype)[6:]}",
                 _against_plain(worst, "ring_all_reduce",
                                rc.ring_all_reduce(x, groups[role]),
                                rc.ring_all_reduce(x.cpu(), groups[role])))
    torch.cuda.synchronize()
    mesh.check()
    torch.cuda.empty_cache()
    return {"failed": failed, "cases": cases, "max_abs_err": worst,
            "units": [(u.name, u.length, u.chunk) for u in units],
            "row": row}


def rank_check_split_rows(group, rows: int, device) -> bool:
    """One row-parallel product's int8 operands on this tp rank (the down
    projection: x [rows, d_ff] and w [d_model, d_ff] drawn alike on every
    rank, each rank's d_ff / tp columns) through
    quantize_split_rows on the card, against K10 on this rank over the
    whole rows with the whole bits: x_q, w_q and both scales bit for
    bit."""
    k, n = _MODEL["d_ff"], _MODEL["d_model"]
    x = _draw(device, 70, 0, (rows, k), torch.bfloat16)
    w = _draw(device, 71, 0, (n, k), torch.bfloat16) / math.sqrt(k)
    part = k // group.size
    cols = slice(group.rank * part, (group.rank + 1) * part)
    xr, wr = x[:, cols].contiguous(), w[:, cols].contiguous()
    got = quant_ops.quantize_split_rows(
        xr, quant_ops.shard_bits(0, xr.shape, device, group, 1), wr,
        quant_ops.shard_bits(1, wr.shape, device, group, 1), group)
    want_x = quant_ops.quantize_int8_kernel(
        x, quant_ops.random_bits(0, x.shape, device))
    want_w = quant_ops.quantize_int8_kernel(
        w, quant_ops.random_bits(1, w.shape, device))
    torch.cuda.synchronize()
    return (torch.equal(got[0], want_x[0][:, cols]) and
            torch.equal(got[1], want_x[1]) and
            torch.equal(got[2], want_w[0][:, cols]) and
            torch.equal(got[3], want_w[1]))


def rank_check_mesh_faults(mesh, device) -> dict:
    """The planted-fault build's K12, K13 and K14 on a ring of two (the
    recipe's tp ring, built with that library): each must disagree with
    its plain version."""
    group = mesh.groups["tp"]
    x = _draw(device, 60, mesh.rank, (2 * 64, 128), torch.float32)
    scatter = not torch.equal(rc.ring_reduce_scatter_kernel(x, group).cpu(),
                              rc.ring_reduce_scatter(x.cpu(), group))
    x = x[:64].contiguous()
    gather = not torch.equal(rc.ring_all_gather_kernel(x, group).cpu(),
                             rc.ring_all_gather(x.cpu(), group))
    k = _draw(device, 61, mesh.rank, (2, 64, 4, 64), torch.bfloat16)
    got = rc.ring_permute_kernel(k, k, group)
    want = rc.ring_permute(k.cpu(), k.cpu(), group)
    permute = not all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    mesh.check()
    return {"permute": permute, "all_gather": gather,
            "reduce_scatter": scatter}


def mesh_check_main() -> None:
    """One rank of the mesh collectives check (``mesh_collectives``
    launches MESH_RANKS of them): rank_check_mesh on each MESH_CHECKED
    mesh, then the planted faults on a ring of two. Prints this rank's
    findings as one JSON line."""
    spec = json.loads(os.environ["CHIP_SMOKE_MESH_CHECK"])
    device = distributed.setup()["device"]
    result = {"rank": torch.distributed.get_rank(), "meshes": {}}
    for name in MESH_CHECKED:
        cfg = MESH_RUNS[name]
        mesh = mesh_mod.RankMesh.build(device, tp=cfg["tp"], sp=cfg["sp"],
                                       fsdp=cfg["fsdp"],
                                       timeout_s=RING_TIMEOUT_S)
        try:
            result["meshes"][name] = rank_check_mesh(name, mesh, device)
        finally:
            mesh.close()
    recipe = MESH_RUNS["recipe"]
    mesh = mesh_mod.RankMesh.build(
        device, tp=recipe["tp"], sp=recipe["sp"], fsdp=recipe["fsdp"],
        timeout_s=RING_TIMEOUT_S, roles=("tp",),
        library=_build.load(pathlib.Path(spec["fault_library"]),
                            "ring_collectives"))
    try:
        result["fault_caught"] = rank_check_mesh_faults(mesh, device)
    finally:
        mesh.close()
    print("MESH_CHECK " + json.dumps(result), flush=True)


def mesh_collectives(fault_path) -> dict:
    """The mesh paths' ring calls against their plain versions on every
    one of MESH_RANKS ranks on this card (mesh_check_main). Fails unless
    every case agreed bit for bit and the planted faults were caught."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    env = dict(os.environ, CHIP_SMOKE_MESH_CHECK=json.dumps({
        "fault_library": str(fault_path)}))
    started = time.perf_counter()
    runs = distributed.launch_local(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.mesh_check_main()"],
        MESH_RANKS, MESH_CHECK_RANKS_TIMEOUT_S, env=env,
        cwd=pathlib.Path(__file__).resolve().parent)
    results = []
    for run in runs:
        line = next((ln for ln in run["stdout"].splitlines()[::-1]
                     if ln.startswith("MESH_CHECK ")), None)
        require(run["returncode"] == 0 and line is not None,
                f"mesh check rank {run['rank']}: rc {run['returncode']} "
                f"(timed out: {run['timed_out']}): {run['stderr'][-3000:]}")
        results.append(json.loads(line[len("MESH_CHECK "):]))
    worst = {}
    for r in results:
        for name, check in r["meshes"].items():
            print(f"check mesh {name} rank {r['rank']}: {len(check['cases'])}"
                  f" ring calls against their plain versions "
                  f"{check['cases']}, failed {check['failed']}, max abs err "
                  f"{check['max_abs_err']}", flush=True)
            require(check["cases"] and not check["failed"],
                    f"mesh {name} rank {r['rank']}: {check}")
            for key, err in check["max_abs_err"].items():
                worst[key] = max(worst.get(key, 0.0), err)
        print(f"check mesh planted faults rank {r['rank']} (ring of 2): "
              f"caught {r['fault_caught']}", flush=True)
        require(all(r["fault_caught"].values()),
                f"mesh rank {r['rank']}: a planted fault passed "
                f"{r['fault_caught']}")
    return {"max_abs_err": worst, "ranks": results,
            "seconds": time.perf_counter() - started}


def _loss_ms(profile: dict) -> dict:
    """A rank's loss ms a step from its profile: K3-K5 on its vocabulary
    (the backward's pre-pass and dl pass included), and the ring kernels
    of the vocab-parallel merge (the (lse, gold) gather and the grad_h
    all-reduce, logged as "tp:loss")."""
    kernels = sum(profile["kernel_ms_per_step"][key] for key in (
        "xent_fwd", "xent_bwd_dl", "xent_bwd_h", "xent_bwd_e"))
    merge = profile.get("ring_ms_per_step_by_axis", {}).get("tp:loss", 0.0)
    return {"kernels": kernels, "merge": merge, "total": kernels + merge}


def train_mesh_run(name: str, marker_env: dict, base: bool = False,
                   port: Optional[int] = None) -> dict:
    """One MESH_RUNS configuration through the workload's entry point
    under torch.distributed.run, its ranks (MESH_RANKS unless it says)
    on this card (``base``: its comparison, its ``base`` overrides on the
    same flags, not profiled, its times not read), gated: finite falling
    losses; every rank's launches exactly mesh_launches_per_step a step,
    by kernel and by axis, and no plain version; the replicated
    parameters' digest (gathered over fsdp) equal on every rank and each
    tp shard's on the ranks of its tp index."""
    cfg = dict(MESH_RUNS[name], **(MESH_RUNS[name]["base"] if base else {}))
    flags = cfg.get("flags", [])
    ranks, tp = cfg.get("ranks", MESH_RANKS), cfg["tp"]
    batch, seq = cfg.get("batch", SP_BATCH), cfg.get("seq", SP_SEQ)
    profile_steps = 0 if base else SP_PROFILE_STEPS
    sizes = mesh_mod.auto_axis_sizes(ranks, tp=tp, sp=cfg["sp"],
                                     fsdp=cfg["fsdp"])
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", str(ranks), "--master-port",
           str(port or distributed.free_port()), "-m",
           "batch_shipyard_tpu_torch.workloads.train_transformer",
           "--tp", str(tp), "--sp", str(cfg["sp"]), "--fsdp",
           str(cfg["fsdp"]), "--n-layers", str(cfg["n_layers"]),
           "--seq-len", str(seq), "--batch", str(batch), "--warmup",
           str(SP_WARMUP), "--steps", str(SP_STEPS), "--profile-steps",
           str(profile_steps), *flags]
    label = f"{name}{' base' if base else ''}"
    started = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=MESH_TRAIN_TIMEOUT_S,
                          env=dict(os.environ, **marker_env),
                          cwd=pathlib.Path(__file__).resolve().parent)
    seconds = time.perf_counter() - started
    lines = proc.stdout.strip().splitlines()
    first = proc.stderr.find("Traceback")
    require(proc.returncode == 0 and len(lines) >= 2,
            f"train mesh {label}: rc {proc.returncode}: first error "
            f"{proc.stderr[first:first + 3000] if first >= 0 else ''} ... "
            f"{proc.stderr[-2000:]}")
    print(lines[-2], flush=True)
    report = json.loads(lines[-1])
    require(report["mesh"] == sizes, f"train mesh {label}: {report['mesh']}")
    losses = report["losses"]
    require(all(math.isfinite(x) for x in losses),
            f"train mesh {label}: non-finite loss {losses}")
    require(losses[-1] < losses[0],
            f"train mesh {label}: loss did not fall {losses}")
    steps = SP_WARMUP + SP_STEPS
    for r in report["per_rank"]:
        want = mesh_launches_per_step(r["rank"], sizes, cfg["n_layers"],
                                      flags)
        require(r["launches"] == {k: n * steps for k, n in want.items()},
                f"train mesh {label} rank {r['rank']}: launches "
                f"{r['launches']} in {steps} steps, want {want} a step")
        require(not r["plain_calls"],
                f"train mesh {label} rank {r['rank']}: plain versions ran "
                f"{r['plain_calls']}")
        require(r["coords"] == mesh_mod.RankMesh(sizes, r["rank"]).coords,
                f"train mesh {label} rank {r['rank']}: coords {r['coords']}")
    digests = {(kind, r["coords"]["tp"] if kind == "tp_shard" else 0):
               set() for r in report["per_rank"]
               for kind in r["params_sha256"]}
    for r in report["per_rank"]:
        for kind, digest in r["params_sha256"].items():
            digests[kind, r["coords"]["tp"] if kind == "tp_shard" else 0
                    ].add(digest)
    require(all(len(d) == 1 for d in digests.values()),
            f"train mesh {label}: parameters that must match differ "
            f"{digests}")
    row = {
        "config": (f"bench_transformer widths, {cfg['n_layers']} layers, "
                   f"--seq-len {seq} --tp {tp} --sp {cfg['sp']} "
                   f"--fsdp {cfg['fsdp']} {' '.join(flags)} (mesh {sizes}), "
                   f"batch {batch}, remat, fused loss"),
        "ranks": f"{ranks} ranks time-sliced on one card",
        "steps": steps, "timed_steps": SP_STEPS,
        "tokens_per_s": report["tokens_per_sec"],
        "ms_per_step": report["ms_per_step"], "losses": losses,
        "mfu_pct_of_one_card": report["mfu_pct"],
        "launches_rank0": report["per_rank"][0]["launches"],
        "launches_per_step": {r["rank"]: r["launches_per_step"]
                              for r in report["per_rank"]},
        "peak_mem_gb": [r["peak_mem_gb"] for r in report["per_rank"]],
        "resident_param_bytes": [r["resident_param_bytes"]
                                 for r in report["per_rank"]],
        "params_sha256": report["per_rank"][0]["params_sha256"],
        "phase_s": seconds,
    }
    if not base:
        profile = [r["profile"] for r in report["per_rank"]]
        row.update({
            "ring_ms_per_step_by_axis": [p["ring_ms_per_step_by_axis"]
                                         for p in profile],
            "ring_wait_ms_per_step_by_group": [
                p["ring_wait_ms_per_step_by_group"] for p in profile],
            "device_idle_share": [p["device_idle_share"] for p in profile],
            "loss_ms_per_step": [_loss_ms(p) for p in profile],
            "profile": profile})
    return row


def side_by_side(jobs: dict) -> dict:
    """Each job (name -> a callable of no arguments) in a thread of its
    own, all started together: their results by name. Jobs whose times
    are read do not go here: the ranks of jobs run side by side share
    the card and the host's cores."""
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        return {name: future.result() for name, future in futures.items()}


def free_ports(n: int) -> list:
    """``n`` distinct free localhost ports."""
    ports = set()
    while len(ports) < n:
        ports.add(distributed.free_port())
    return sorted(ports)


# The mesh phase's rounds after (a), which runs beside train_sp: each
# round's jobs run side by side (side_by_side),
# "<name> base" being a run's comparison and "collectives" the mesh ring
# checks. A launch costs ~30-40 s whatever its ranks (2 ranks of (e) took
# 37.5 s, 8 of (b) 42.3 s), so rounds, not ranks, set the phase's time;
# each round stays under ~20 ranks and ~50 GB of the card's memory (the
# peaks below are torch's; the rings' mapped buffers come on top: (e)'s
# comparison beside the first round ran the card out of memory). "kill"
# is the killed-rank check (a small mesh), in the lightest round: the
# times it reads run from the kill to each rank's raise, against twice
# the ring timeout. Peaks by rank (PR 21's run, GB): (b) 1.66, (c) 1.71,
# (d) 1.86, (e) 4.84, the bases of (c) 2.53, (d) 2.85, (e) 6.15.
MESH_ROUNDS = (("dp_fsdp", "fused_tp", "fsdp_recipe"),
               ("int8_tp", "fused_tp base", "int8_tp base"),
               ("collectives", "fsdp_recipe base", "kill"))


def train_mesh(device, marker_env: dict, sp_losses: list,
               fault_path, recipe: Optional[dict] = None) -> dict:
    """Phase 5b: the MESH_RUNS through the workload, (a) (``recipe``: its
    row where the caller ran it, else run here alone) and the rest in
    MESH_ROUNDS with the mesh paths' ring calls against their plain
    versions (mesh_collectives), (a)'s losses within MESH_LOSS_RTOL of
    train_sp's step by step, (c)'s, (d)'s and (e)'s within it of their
    comparisons' (fsdp_saving: (e)'s memory and parameters against its
    comparison's), and the killed-rank check (in the last round)."""
    started = time.perf_counter()
    rows = {"recipe": recipe or train_mesh_run("recipe", marker_env)}
    bases = {}
    for round_ in MESH_ROUNDS:
        ports = iter(free_ports(len(round_)))
        jobs = {}
        for job in round_:
            name, _, base = job.partition(" ")
            if name == "collectives":
                jobs[job] = functools.partial(mesh_collectives, fault_path)
            elif name == "kill":
                jobs[job] = functools.partial(mesh_kill, device)
            else:
                jobs[job] = functools.partial(
                    train_mesh_run, name, marker_env, base=bool(base),
                    port=next(ports))
        t0 = time.perf_counter()
        for job, row in side_by_side(jobs).items():
            name, _, base = job.partition(" ")
            (bases if base else rows)[name] = row
        print(f"train mesh round {list(round_)}: "
              f"{time.perf_counter() - t0:.1f} s side by side", flush=True)
    for name in MESH_RUNS:
        row = rows[name]
        print(f"train mesh {name} ({row['config']}; {row['ranks']}"
              f"{'' if name == 'recipe' else ', side by side'}): "
              f"{row['tokens_per_s']:.0f} tokens/s of the global batch, "
              f"{row['ms_per_step']:.1f} ms/step, peak GB per rank "
              f"{row['peak_mem_gb']}, loss ms a step per rank (kernels + "
              f"merge) {row['loss_ms_per_step']}, ring kernels' ms a step "
              f"by axis per rank {row['ring_ms_per_step_by_axis']}, ring "
              f"wait ms a step by group per rank "
              f"{row['ring_wait_ms_per_step_by_group']}, "
              f"{row['phase_s']:.1f} s", flush=True)
        print(f"train mesh {name} " + json.dumps(row), flush=True)
    # Only the comparisons' losses, memory and digests are read, not
    # their times.
    for name, base in bases.items():
        row = rows[name]
        row["base"] = base
        off = [abs(a - b) / abs(b)
               for a, b in zip(row["losses"], base["losses"])]
        row["loss_rel_vs_base"] = off
        print(f"check mesh {name} vs {base['config']}: losses "
              f"{row['losses']} vs {base['losses']}, relative {off} (limit "
              f"{MESH_LOSS_RTOL}); base peak GB per rank "
              f"{base['peak_mem_gb']}, {base['phase_s']:.1f} s side by "
              f"side", flush=True)
        require(len(off) == len(base["losses"]) and
                all(x <= MESH_LOSS_RTOL for x in off),
                f"train mesh {name}: losses {row['losses']} off the "
                f"comparison's {base['losses']} by {off}")
    rows["fsdp_recipe"]["saving"] = fsdp_saving(rows["fsdp_recipe"])
    recipe = rows["recipe"]["losses"]
    off = [abs(a - b) / abs(b) for a, b in zip(recipe, sp_losses)]
    print(f"check mesh recipe vs train sp losses: {recipe} vs {sp_losses}, "
          f"relative {off} (limit {MESH_LOSS_RTOL})", flush=True)
    require(len(recipe) == len(sp_losses) and
            all(x <= MESH_LOSS_RTOL for x in off),
            f"train mesh recipe: losses {recipe} off train_sp's "
            f"{sp_losses} by {off}")
    rows["loss_rel_vs_sp"] = off
    rows["phase_s"] = time.perf_counter() - started
    print(f"train mesh phase: {rows['phase_s']:.1f} s", flush=True)
    return rows


def fsdp_saving(row: dict) -> dict:
    """(e) against its comparison (``row["base"]``, fsdp 1 on the same
    rows): every rank's peak at least FSDP_PEAK_SAVING_GB lower, its
    resident parameter bytes at most half the comparison's plus one lane
    of each unit, and the gathered parameters' digest the comparison's
    (with two ranks each element's gradient is the same one sum of two
    in both runs, so the parameters stay bit-identical)."""
    base = row["base"]
    units = model_units(MESH_RUNS["fsdp_recipe"]["fsdp"])
    padding = 4 * sharding.LANE * len(units)
    saving = [b - a for a, b in zip(row["peak_mem_gb"], base["peak_mem_gb"])]
    reading = {"peak_saving_gb": saving,
               "resident_param_bytes": row["resident_param_bytes"],
               "base_resident_param_bytes": base["resident_param_bytes"],
               "digest_equal": row["params_sha256"] == base["params_sha256"]}
    print(f"check mesh fsdp_recipe memory: peak GB per rank "
          f"{row['peak_mem_gb']} vs {base['peak_mem_gb']} (saving {saving}, "
          f"limit {FSDP_PEAK_SAVING_GB}); resident parameter bytes "
          f"{row['resident_param_bytes']} vs "
          f"{base['resident_param_bytes']}; gathered parameters' digest "
          f"equal: {reading['digest_equal']}", flush=True)
    require(all(x >= FSDP_PEAK_SAVING_GB for x in saving),
            f"train mesh fsdp_recipe: peak saving {saving} GB")
    require(all(a <= b / 2 + padding for a, b in zip(
        row["resident_param_bytes"], base["resident_param_bytes"])),
        f"train mesh fsdp_recipe: resident parameter bytes {reading}")
    require(reading["digest_equal"],
            f"train mesh fsdp_recipe: parameters {row['params_sha256']} "
            f"vs the comparison's {base['params_sha256']}")
    return reading


# ----------------------------- checkpoints -----------------------------


# (a): bench_transformer's fused configuration through the workload (its
# widths are the workload's defaults), as the fused train phase runs it.
CKPT_ARGS = ["--fused-norm", "--no-remat", "--batch",
             str(train_wl.BENCH_TRANSFORMER_BATCH), "--seq-len",
             str(train_wl.BENCH_TRANSFORMER_SEQ), "--warmup", "0"]
CKPT_STEPS = 6
# (b): the mesh phase's (b) on four ranks: --sp 2 --fsdp 2 (dp 1), then
# the resume resized onto --sp 2 --tp 2.
CKPT_MESH = ["--n-layers", "2", "--seq-len", str(SP_SEQ), "--batch",
             str(SP_BATCH), "--warmup", "0"]
CKPT_MESH_RANKS = 4
CKPT_PROBE_BYTES = 1 << 30


def run_workload(argv, env=None, main=None) -> tuple[int, dict, list]:
    """A workload's main (train_transformer's by default) in this process
    (launch counts reset just before): (exit code, its JSON line, its
    stdout lines)."""
    reset_launch_counts()
    out = io.StringIO()
    saved = {key: os.environ.get(key) for key in (env or {})}
    os.environ.update(env or {})
    try:
        with contextlib.redirect_stdout(out):
            rc = (main or train_wl.main)(argv)
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    gc.collect()
    torch.cuda.empty_cache()
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), lines


def io_rates(workdir: pathlib.Path) -> dict:
    """The host link's device->host rate into pinned memory and the disk's
    write rate (fsynced), each the best of three 1 GiB transfers: the
    bounds of a snapshot and of a persist."""
    device_buf = torch.empty(CKPT_PROBE_BYTES, dtype=torch.uint8,
                             device="cuda")
    host = torch.empty(CKPT_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    link = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.copy_(device_buf, non_blocking=True)
        torch.cuda.synchronize()
        link.append(time.perf_counter() - t0)
    disk = []
    path = workdir / "disk_probe.bin"
    for _ in range(3):
        t0 = time.perf_counter()
        with open(path, "wb") as fh:
            fh.write(host.numpy().data)
            fh.flush()
            os.fsync(fh.fileno())
        disk.append(time.perf_counter() - t0)
        path.unlink()
    del device_buf, host
    torch.cuda.empty_cache()
    return {"host_link_gb_s": CKPT_PROBE_BYTES / min(link) / 1e9,
            "disk_write_gb_s": CKPT_PROBE_BYTES / min(disk) / 1e9}


def _fused_per_step() -> dict:
    layers = train_wl.BENCH_TRANSFORMER_MODEL["n_layers"]
    return {"flash_fwd": layers, "flash_bwd": layers, "xent_fwd": 1,
            "xent_bwd_h": 1, "xent_bwd_e": 1, "rmsnorm_matmul": 2 * layers}


def _require_fused_launches(name: str, report: dict, steps: int) -> None:
    rank, = report["per_rank"]
    want = {key: n * steps for key, n in _fused_per_step().items()}
    require(rank["launches"] == want,
            f"checkpoint {name}: launches {rank['launches']} in {steps} "
            f"steps, want {want}")
    require(not rank["plain_calls"],
            f"checkpoint {name}: plain versions ran {rank['plain_calls']}")


def checkpoint_one_card(device, workdir: pathlib.Path) -> dict:
    """(a) of the checkpoint phase (the module doc's 5c)."""
    from batch_shipyard_tpu_torch.agent import preemption
    from batch_shipyard_tpu_torch.workloads import checkpoint as ckpt_mod
    from batch_shipyard_tpu_torch.workloads import serve as serve_wl
    rates = io_rates(workdir)
    ckpt = str(workdir / "one_card")
    flags = ["--checkpoint-dir", ckpt, "--checkpoint-every", "2",
             "--keep-last", "1"]
    rc, whole, _ = run_workload(CKPT_ARGS + ["--steps", str(CKPT_STEPS)])
    require(rc == 0, f"checkpoint U: rc {rc}")
    _require_fused_launches("U", whole, CKPT_STEPS)
    request = workdir / "preempt.json"
    preemption.write_request(str(request), reason="chip smoke")
    rc, cut, _ = run_workload(
        CKPT_ARGS + ["--steps", str(CKPT_STEPS)] + flags,
        env={preemption.PREEMPT_REQUEST_FILE_ENV: str(request)})
    require(rc == preemption.EXIT_PREEMPTED and cut.get("exit") ==
            "preempted" and cut["end_step"] == 1,
            f"checkpoint P: rc {rc}, {cut.get('exit')} at {cut['end_step']}")
    require(ckpt_mod._committed_steps(ckpt) == [1],
            f"checkpoint P: committed {ckpt_mod._committed_steps(ckpt)}")
    _require_fused_launches("P", cut, 1)
    rc, resumed, lines = run_workload(
        CKPT_ARGS + ["--steps", str(CKPT_STEPS - 1), "--async-checkpoint"]
        + flags)
    require(rc == 0 and "[proc 0/1] resumed from step 1" in lines,
            f"checkpoint R: rc {rc}, {lines[:3]}")
    saves = resumed["checkpoint"]["saves"]
    require([s["step"] for s in saves] == [2, 4, 6],
            f"checkpoint R: saves {[s['step'] for s in saves]}")
    require(ckpt_mod._committed_steps(ckpt) == [CKPT_STEPS] and
            sorted(os.listdir(ckpt)) == [
                f"step_{CKPT_STEPS:08d}", f"step_{CKPT_STEPS:08d}.COMMITTED",
                f"step_{CKPT_STEPS:08d}.MESH"],
            f"checkpoint R: left {sorted(os.listdir(ckpt))}")
    _require_fused_launches("R", resumed, CKPT_STEPS - 1)
    print(f"check checkpoint resume: U losses {whole['losses']}, P "
          f"{cut['losses']}, R {resumed['losses']}", flush=True)
    require(cut["losses"] == whole["losses"][:1] and
            resumed["losses"] == whole["losses"][1:],
            "checkpoint: the resumed losses are not U's bit for bit")
    restored = ckpt_mod.restore_params(ckpt)
    require(restored is not None and restored[1] == CKPT_STEPS,
            f"checkpoint: restore_params gave {restored and restored[1]}")
    digest = hashlib.sha256()
    for tensor in restored[0].values():
        digest.update(tensor.numpy().tobytes())
    want = whole["per_rank"][0]["params_sha256"]["replicated"]
    require(digest.hexdigest() == want,
            f"checkpoint: step {CKPT_STEPS}'s digest {digest.hexdigest()} "
            f"is not U's {want}")
    del restored
    reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_wl.main([
            "--d-model", str(MODEL["d_model"]), "--n-layers",
            str(MODEL["n_layers"]), "--n-heads", str(MODEL["n_heads"]),
            "--d-ff", str(MODEL["d_ff"]), "--vocab",
            str(MODEL["vocab_size"]), "--num-slots", str(SLOTS),
            "--max-decode-len", str(MAX_LEN), "--kv-page-size", str(PAGE),
            "--loadgen", "8", "--rate", "16", "--prompt-len", "64", "128",
            "--gen-tokens", "64", "128", "--port", "0", "--report",
            str(workdir / "serve_report.json"), "--checkpoint-dir", ckpt])
    served = out.getvalue().strip().splitlines()
    report = json.loads(served[-1])
    counts = launch_counts()
    require(rc == 0 and report["completed"] == 8 and report["failed"] == 0,
            f"checkpoint serve: rc {rc}, {report.get('errors')}")
    require(f"serving checkpoint step {CKPT_STEPS} from {ckpt}" in served,
            f"checkpoint serve: {served[:2]}")
    require(counts["paged_decode"] > 0 and not {
        k: n for k, n in counts.items() if n and k != "paged_decode"},
        f"checkpoint serve: launches {counts}")
    torch.cuda.empty_cache()
    sync = cut["checkpoint"]["saves"][0]
    nbytes = sync["bytes"]

    def gb_s(ms):
        return nbytes / (ms / 1e3) / 1e9

    row = {
        "config": "bench_transformer(fused_norm=True), fused loss, batch 16 "
                  "x 2048, no remat, through the workload",
        "checkpoint_bytes": nbytes, "rates": rates,
        "snapshot_bound_ms": nbytes / (rates["host_link_gb_s"] * 1e9) * 1e3,
        "persist_bound_ms": nbytes / (rates["disk_write_gb_s"] * 1e9) * 1e3,
        "sync_save": dict(sync, gb_s=gb_s(sync["blocking_ms"])),
        "async_saves": [dict(s, snapshot_gb_s=gb_s(s["snapshot_ms"]),
                             persist_gb_s=gb_s(s["persist_ms"]))
                        for s in saves],
        "restore_ms": resumed["checkpoint"]["restore_ms"],
        "restore_gb_s": gb_s(resumed["checkpoint"]["restore_ms"]),
        "losses": whole["losses"], "ms_per_step": {
            "U": whole["ms_per_step"], "R": resumed["ms_per_step"]},
        "serve": {k: report[k] for k in ("completed", "failed",
                                         "tokens_per_second")},
        "paged_decode_launches": counts["paged_decode"],
    }
    print(f"checkpoint (a): {nbytes} bytes; blocking save "
          f"{sync['blocking_ms']:.1f} ms ({row['sync_save']['gb_s']:.2f} "
          f"GB/s; its copy {sync['snapshot_ms']:.1f} ms); async saves "
          f"blocked {[round(s['blocking_ms'], 1) for s in saves]} ms: "
          f"drains {[round(s['drain_ms'], 1) for s in saves]} ms, copies "
          f"{[round(s['snapshot_ms'], 1) for s in saves]} ms (bound "
          f"{row['snapshot_bound_ms']:.1f}), persists "
          f"{[round(s['persist_ms'], 1) for s in saves]} ms (bound "
          f"{row['persist_bound_ms']:.1f}); restore "
          f"{row['restore_ms']:.1f} ms ({row['restore_gb_s']:.2f} GB/s); "
          f"host link {rates['host_link_gb_s']:.2f} GB/s, disk "
          f"{rates['disk_write_gb_s']:.2f} GB/s", flush=True)
    return row


def _mesh_workload(axes: list, steps: int, flags=(), marker_env=None,
                   port: Optional[int] = None) -> dict:
    """The workload under torch.distributed.run, CKPT_MESH_RANKS ranks on
    this card: its JSON line."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(CKPT_MESH_RANKS), "--master-port",
           str(port or distributed.free_port()), "-m",
           "batch_shipyard_tpu_torch.workloads.train_transformer", *axes,
           *CKPT_MESH, "--steps", str(steps), *flags]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=MESH_TRAIN_TIMEOUT_S,
                          env=dict(os.environ, **(marker_env or {})),
                          cwd=pathlib.Path(__file__).resolve().parent)
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and lines,
            f"checkpoint mesh {axes} {list(flags)}: rc {proc.returncode}: "
            f"{proc.stderr[-4000:]}")
    report = json.loads(lines[-1])
    for r in report["per_rank"]:
        want = mesh_launches_per_step(r["rank"], report["mesh"], 2)
        require(r["launches"] == {k: n * steps for k, n in want.items()},
                f"checkpoint mesh {axes}: rank {r['rank']} launched "
                f"{r['launches']} in {steps} steps, want {want} a step")
        require(not r["plain_calls"],
                f"checkpoint mesh {axes}: rank {r['rank']} ran plain "
                f"versions {r['plain_calls']}")
    return report


def checkpoint_mesh(workdir: pathlib.Path, marker_env: dict) -> dict:
    """(b) of the checkpoint phase (the module doc's 5c): the
    uninterrupted run beside the saving one, then the two resumes side
    by side (their times are not read)."""
    import shutil
    a, b = ["--sp", "2", "--fsdp", "2"], ["--sp", "2", "--tp", "2"]
    same, resized = str(workdir / "mesh"), str(workdir / "mesh_resized")
    ports = free_ports(2)
    whole = side_by_side({
        "whole": functools.partial(_mesh_workload, a, 4,
                                   marker_env=marker_env, port=ports[0]),
        "save": functools.partial(
            _mesh_workload, a, 2, ["--checkpoint-dir", same,
                                   "--checkpoint-every", "2"], marker_env,
            port=ports[1])})["whole"]
    shutil.copytree(same, resized)
    ports = free_ports(2)
    resumed = side_by_side({
        "back": functools.partial(_mesh_workload, a, 2,
                                  ["--checkpoint-dir", same], marker_env,
                                  port=ports[0]),
        "moved": functools.partial(_mesh_workload, b, 2,
                                   ["--checkpoint-dir", resized],
                                   marker_env, port=ports[1])})
    back, moved = resumed["back"], resumed["moved"]
    want = whole["losses"][2:]
    off = [abs(x - y) / abs(y) for x, y in zip(moved["losses"], want)]
    print(f"check checkpoint mesh: uninterrupted {whole['losses']}, same "
          f"mesh resumed {back['losses']}, --sp 2 --tp 2 resumed "
          f"{moved['losses']} (relative {off}, limit {MESH_LOSS_RTOL})",
          flush=True)
    require(back["losses"] == want,
            "checkpoint mesh: the same-mesh resume is not bit for bit")
    require(len(off) == 2 and all(x <= MESH_LOSS_RTOL for x in off),
            f"checkpoint mesh: the resized resume is off by {off}")
    readings = {}
    for name, report in (("same", back), ("resized", moved)):
        readings[name] = [{
            "rank": r["rank"], "coords": r["coords"],
            "read_fraction": r["checkpoint"]["restored"]["read_fraction"],
            "read_fraction_by_kind":
                r["checkpoint"]["restored"]["read_fraction_by_kind"],
            "restore_ms": r["checkpoint"]["restored"]["restore_ms"]}
            for r in report["per_rank"]]
        require(all(r["checkpoint"]["restored"]["step"] == 2
                    for r in report["per_rank"]),
                f"checkpoint mesh {name}: not restored at step 2")
    # The same mesh reads its fsdp chunks: half the params and moments.
    for r in readings["same"]:
        fractions = r["read_fraction_by_kind"]
        require(all(abs(x - 0.5) < 1e-3 for x in fractions.values()),
                f"checkpoint mesh same: rank {r['rank']} read {fractions}")
    print("checkpoint (b) restores " + json.dumps(readings), flush=True)
    return {"config": f"bench_transformer widths, 2 layers, {CKPT_MESH}, "
                      f"{CKPT_MESH_RANKS} ranks on one card",
            "losses": {"whole": whole["losses"], "same": back["losses"],
                       "resized": moved["losses"]},
            "loss_rel_resized": off, "restores": readings,
            "ms_per_step": {"whole": whole["ms_per_step"],
                            "same": back["ms_per_step"],
                            "resized": moved["ms_per_step"]}}


def checkpoint_phase(device, marker_env: dict) -> dict:
    """Phase 5c: (a) and (b), in a temp dir removed after."""
    started = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        workdir = pathlib.Path(tmp)
        row = {"one_card": checkpoint_one_card(device, workdir),
               "mesh": checkpoint_mesh(workdir, marker_env)}
    row["phase_s"] = time.perf_counter() - started
    print(f"checkpoint phase: {row['phase_s']:.1f} s", flush=True)
    print("checkpoint " + json.dumps(row), flush=True)
    return row


# ------------------------- mixture of experts -------------------------


# Phase 5d: (m1) bench_transformer's model with --moe-experts 8
# --moe-every 2 on this card (no remat, the fused loss under the marker);
# (m2) the MoE-Distributed recipe (recipes/MoE-Distributed-TPU/config/
# jobs.yaml: --moe-experts 8 --ep 4 --batch 8 --seq-len 4096, at the
# workload's defaults: bench_transformer's widths, 12 layers, remat) on
# four ranks of this card (dp 1); (m3) --ep 2 on four ranks (dp 2) at 2
# layers, batch 8 x 4096. (m2) and (m3) are held against one rank with
# the same weights and batch (``moe_base``).
MOE_EXPERTS, MOE_EVERY = 8, 2
MOE_WARMUP, MOE_STEPS, MOE_PROFILE_STEPS = 2, 3, 1
MOE_RANKS = 4
MOE_RUNS = {
    "m2": dict(ep=4, n_layers=_MODEL["n_layers"], batch=8, seq=4096,
               profile=True),
    "m3": dict(ep=2, n_layers=2, batch=8, seq=4096, profile=False),
}
# (m3) again with a planted fault: every MoE layer's aux gradient doubled,
# its value unchanged, as an aux counted once per ep rank or once per data
# rank would be (both rings have two ranks in m3). The checks against one
# rank must catch it on every rank.
MOE_FAULT_RUNS = {"m3_aux_x2": "m3"}
MOE_RANKS_TIMEOUT_S = 300.0
# The first MoE layer (moe_every 2), after a dense layer ep does not
# touch: its routing must equal one rank's index for index.
MOE_LAYER = 1
# Every rank against one rank on the same weights and batch
# (_moe_readings): every step's loss, relative, and each tensor of its
# state (every MoE layer's router, layer MOE_LAYER's expert shard) after
# the first step and after the last, as ||rank's - one rank's|| / ||one
# rank's update||. With dp 1 (m2) they are equal bit for bit. With dp 2
# (m3) the data ring adds two fp32 halves of each gradient where one rank
# adds the whole batch, and AdamW's first, sign-like updates carry that
# rounding on: 1.22e-5 in the losses, 7.8e-6 in the router after the
# first step, 0.0087 in the experts, 0.052 after the last step. The
# planted fault (MOE_FAULT_RUNS) moves the router after the first step by
# 0.478, the losses by 7.3e-5, the state after the last step by 0.222.
# The limits were set between the two from those readings (NVIDIA H100
# 80GB HBM3, 700 W; the readings repeat bit for bit from run to run).
MOE_LOSS_RTOL = 4e-5
MOE_ROUTER_RTOL = 1e-3
MOE_STATE_RTOL = 0.15
MOE_LIMITS = {"loss": MOE_LOSS_RTOL,
              "routers after the first step": MOE_ROUTER_RTOL,
              "other state": MOE_STATE_RTOL}


def moe_launches_per_step(sizes: dict, layers: int, remat: bool) -> dict:
    """A MoE training rank's wrapper launches a step (moe_every 2, the
    fused loss, tp, sp and fsdp 1): K1 once a layer (twice with remat's
    recompute), K2 once, K3-K5 once; over the ep ring, per MoE layer,
    Megatron's g forward (again in the recompute) and f backward on the
    tokens and on the gates, each an all-reduce (K14 then K13); with dp >
    1, the routing's probabilities gathered over the tokens ring (K13,
    forward and recompute) and the gradient all-reduce over the data
    ring, one ring of the same ranks labelled "data+tokens"."""
    passes = 2 if remat else 1
    moe_layers = layers // MOE_EVERY
    want = collections.Counter({"flash_fwd": passes * layers,
                                "flash_bwd": layers,
                                **{key: 1 for key in LOSS_KERNELS}})
    ep = (passes + 2) * moe_layers if sizes["ep"] > 1 else 0
    data = int(sizes["dp"] > 1)
    tokens = passes * moe_layers if sizes["dp"] > 1 else 0
    for label, n in (("ep", ep), ("data+tokens", data)):
        for call in ("ring_reduce_scatter", "ring_all_gather",
                     "ring_all_reduce"):
            want[f"{call}.{label}"] += n
        want["ring_reduce_scatter"] += n
        want["ring_all_gather"] += n
    want["ring_all_gather"] += tokens
    want["ring_all_gather.data+tokens"] += tokens
    return {key: n for key, n in want.items() if n}


def _capture_logits(model) -> tuple[dict, object]:
    """Layer MOE_LAYER's router logits of the next forward, computed as
    MoEMLP.forward computes them (a pre-hook; remove the handle)."""
    stash = {}

    def hook(module, args):
        x = args[0]
        stash["logits"] = torch.nn.functional.linear(
            x.reshape(-1, x.shape[-1]).float(),
            module.router.weight.float()).detach().cpu()
    moe = getattr(model, f"layer_{MOE_LAYER}").moe
    return stash, moe.register_forward_pre_hook(hook)


def _routing(model) -> dict:
    """Layer MOE_LAYER's last routing (experts and slots) on the host."""
    routing = getattr(model, f"layer_{MOE_LAYER}").moe.last_routing
    return {"expert": routing.expert.cpu(), "position": routing.position.cpu()}


def _moe_state(harness) -> dict:
    """Every MoE layer's router and layer MOE_LAYER's experts (this rank's
    shard) from the harness's state_dict, on the host."""
    experts = f"layer_{MOE_LAYER}.moe.w_"
    return {key: t.to("cpu", copy=True)
            for key, t in harness.state_dict().items()
            if key.endswith(".moe.router.weight") or key.startswith(experts)}


def _state_rel(got: dict, base: dict, first: int, after: str) -> dict:
    """Each of got's tensors' ||got - one rank's|| / ||one rank's
    update|| (``base``: moe_base's, its state ``after`` the first step or
    the last; an expert tensor at the rank's experts [first, first + its
    count))."""
    rel = {}
    for key, value in got.items():
        rows = (slice(first, first + value.shape[0]) if ".w_" in key else
                slice(None))
        want = base[after][key][rows]
        update = (want - base["init"][key][rows]).norm()
        rel[key] = float((value - want).norm() / update)
    return rel


def _plant_aux_x2(model) -> None:
    """MOE_FAULT_RUNS' fault: every MoE layer's aux gradient doubled, its
    value unchanged."""
    for block in model.blocks():
        if getattr(block, "moe", None) is not None:
            block.moe.register_forward_hook(
                lambda module, args, out: (out[0],
                                           2 * out[1] - out[1].detach()))


def moe_layer_syncs_nothing(harness, batch_size: int, seq: int) -> None:
    """One forward and backward of layer MOE_LAYER's MoE layer at the
    step's shape under torch.cuda.set_sync_debug_mode("error"): any op
    that reads the device from the host raises (the routing, dispatch and
    combine must not)."""
    moe = getattr(harness.model, f"layer_{MOE_LAYER}").moe
    gen = torch.Generator(device=harness.device).manual_seed(0)
    x = torch.randn(batch_size, seq, moe.config.d_model, generator=gen,
                    device=harness.device, dtype=moe.config.dtype,
                    requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe(x)
        (out.float().sum() + aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    harness.optimizer.zero_grad(set_to_none=True)


def train_moe(device) -> dict:
    """(m1): bench_transformer's model and batch with --moe-experts 8
    --moe-every 2, 2 + 3 steps and one profiled. The loss must be finite
    and fall; every step must launch K1 and K2 once a layer and K3-K5
    once, no other wrapper and no plain version; a MoE layer's forward and
    backward must not read the device from the host
    (moe_layer_syncs_nothing)."""
    model = train_wl.BENCH_TRANSFORMER_MODEL
    batch_size = train_wl.BENCH_TRANSFORMER_BATCH
    seq = train_wl.BENCH_TRANSFORMER_SEQ
    per_step = moe_launches_per_step({"ep": 1, "dp": 1}, model["n_layers"],
                                     remat=False)
    started = time.perf_counter()
    harness = train_wl.build_bench_harness(
        device, seed=0, batch_size=batch_size, seq_len=seq,
        moe_experts=MOE_EXPERTS, moe_every=MOE_EVERY)
    batch = train_wl.random_batch(model["vocab_size"], batch_size, seq, 0,
                                  device)
    moe_layer_syncs_nothing(harness, batch_size, seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = [harness.step(batch)["loss"] for _ in range(MOE_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [harness.step(batch)["loss"] for _ in range(MOE_STEPS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    steps = MOE_WARMUP + MOE_STEPS
    counts = {k: n for k, n in launch_counts().items() if n}
    plain = {k: n for k, n in plain_counts().items() if n}
    losses = [float(x) for x in losses]
    require(all(math.isfinite(x) for x in losses),
            f"train moe (m1): non-finite loss {losses}")
    require(losses[-1] < losses[0],
            f"train moe (m1): loss did not fall {losses}")
    require(counts == {k: n * steps for k, n in per_step.items()},
            f"train moe (m1): launches {counts} in {steps} steps, want "
            f"{per_step} a step")
    require(not plain, f"train moe (m1): plain versions ran {plain}")
    tokens_per_s = batch_size * seq * MOE_STEPS / elapsed
    flops = mfu.transformer_train_flops_per_token(
        harness.model.config, seq, batch_size=batch_size)
    measured = {k: n / steps for k, n in counts.items()}
    row = {
        "config": "bench_transformer --moe-experts 8 --moe-every 2, batch "
                  "16 x 2048, no remat, fused loss",
        "steps": steps, "timed_steps": MOE_STEPS,
        "launches": counts, "launches_per_step": measured,
        "ms_per_step": elapsed / MOE_STEPS * 1e3,
        "tokens_per_s": tokens_per_s,
        "tflop_per_step": flops * batch_size * seq / 1e12,
        "mfu_pct": mfu.mfu_pct(tokens_per_s, flops, mfu.peak_bf16_tflops()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses,
        "dropped_share": train_wl.dropped_shares(harness.model),
        "profile": train_profile.profile_steps(harness, batch,
                                               MOE_PROFILE_STEPS),
        "phase_s": time.perf_counter() - started,
    }
    print(f"train moe (m1) ({row['config']}): {row['ms_per_step']:.1f} "
          f"ms/step, {tokens_per_s:.0f} tokens/s, MFU {row['mfu_pct']} "
          f"(every expert buffer row counted, the capacity's padding too), "
          f"peak {row['peak_mem_gb']:.2f} GB, launches a step {measured}, "
          f"dropped share by layer {row['dropped_share']}, device ms a step "
          f"by op {row['profile']['op_ms_per_step']}", flush=True)
    print("train moe m1 " + json.dumps(row), flush=True)
    del harness, batch
    torch.cuda.empty_cache()
    return row


def _moe_harness(device, cfg: dict, mesh=None):
    return train_wl.build_bench_harness(
        device, seed=0, batch_size=cfg["batch"], seq_len=cfg["seq"],
        mesh=mesh, remat=True, n_layers=cfg["n_layers"],
        moe_experts=MOE_EXPERTS, moe_every=MOE_EVERY)


def moe_rank_run(name: str, device, out_dir: pathlib.Path) -> dict:
    """One MOE_RUNS or MOE_FAULT_RUNS configuration on this rank:
    MOE_WARMUP + MOE_STEPS steps (and a profiled one where it says); the
    first step's layer MOE_LAYER routing and router logits and the state
    after the steps (_moe_state) saved for the parent."""
    cfg = MOE_RUNS[MOE_FAULT_RUNS.get(name, name)]
    mesh = mesh_mod.RankMesh.build(device, ep=cfg["ep"],
                                   timeout_s=RING_TIMEOUT_S,
                                   roles=mesh_mod.MOE_ROLES)
    harness = _moe_harness(device, cfg, mesh)
    if name in MOE_FAULT_RUNS:
        _plant_aux_x2(harness.model)
    batch = train_wl.random_batch(_MODEL["vocab_size"], cfg["batch"],
                                  cfg["seq"], 0, device)
    stash, handle = _capture_logits(harness.model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = [harness.step(batch)["loss"]]
    handle.remove()
    routing = _routing(harness.model)
    first_state = _moe_state(harness)
    losses += [harness.step(batch)["loss"] for _ in range(MOE_WARMUP - 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [harness.step(batch)["loss"] for _ in range(MOE_STEPS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    mesh.check()
    counts = {k: n for k, n in launch_counts().items() if n}
    plain = {k: n for k, n in plain_counts().items() if n}
    peak = torch.cuda.max_memory_allocated() / 1e9
    moe = getattr(harness.model, f"layer_{MOE_LAYER}").moe
    torch.save({"routing": routing, "logits": stash["logits"],
                "first": first_state, "last": _moe_state(harness),
                "first_expert": moe.first_expert},
               out_dir / f"{name}_rank{mesh.rank}.pt")
    profile = (train_profile.profile_steps(harness, batch, MOE_PROFILE_STEPS)
               if cfg["profile"] else None)
    row = {"rank": mesh.rank, "coords": mesh.coords,
           "losses": [float(x) for x in losses],
           "ms_per_step": elapsed / MOE_STEPS * 1e3, "peak_mem_gb": peak,
           "launches": counts, "plain_calls": plain,
           "dropped_share": train_wl.dropped_shares(harness.model),
           "profile": profile}
    del harness, batch
    mesh.close()
    torch.cuda.empty_cache()
    return row


def moe_rank_main() -> None:
    """One of the MOE_RANKS ranks (``moe_mesh`` launches them on the one
    card): every MOE_RUNS and MOE_FAULT_RUNS configuration in turn.
    Prints its findings as one JSON line."""
    spec = json.loads(os.environ["CHIP_SMOKE_MOE"])
    ctx = distributed.setup()
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {name: moe_rank_run(name, ctx["device"],
                                 pathlib.Path(spec["dir"]))
              for name in (*MOE_RUNS, *MOE_FAULT_RUNS)}
    print("MOE_RANK " + json.dumps(result), flush=True)


def moe_base(device, name: str) -> dict:
    """One rank's MOE_WARMUP + MOE_STEPS steps of a MOE_RUNS configuration
    (ep 1): its losses, layer MOE_LAYER's first routing, and its state
    (_moe_state) before and after the steps."""
    cfg = MOE_RUNS[name]
    harness = _moe_harness(device, cfg)
    batch = train_wl.random_batch(_MODEL["vocab_size"], cfg["batch"],
                                  cfg["seq"], 0, device)
    init = _moe_state(harness)
    losses = [float(harness.step(batch)["loss"])]
    routing = _routing(harness.model)
    first = _moe_state(harness)
    losses += [float(harness.step(batch)["loss"])
               for _ in range(MOE_WARMUP + MOE_STEPS - 1)]
    last = _moe_state(harness)
    del harness, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "routing": routing, "init": init,
            "first": first, "last": last}


def _routing_diff(got: dict, want: dict) -> int:
    """Entries of two routings (experts, slots) that differ."""
    return int(sum((got[k] != want[k]).sum() for k in ("expert",
                                                        "position")))


def _moe_readings(res: dict, saved: dict, base: dict) -> dict:
    """A rank's run against one rank's (moe_base): the worst relative
    loss over the steps, the first step's, and the worst _state_rel after
    the first step and after the last (each tensor's too)."""
    rel = [abs(got - want) / abs(want)
           for got, want in zip(res["losses"], base["losses"])]
    out = {"loss_rel": max(rel), "first_loss_rel": rel[0]}
    for after in ("first", "last"):
        by_tensor = _state_rel(saved[after], base, saved["first_expert"],
                               after)
        out[f"{after}_state_rel"] = max(by_tensor.values())
        out[f"{after}_state_rel_by_tensor"] = by_tensor
    return out


def _moe_over(readings: dict) -> list:
    """The _moe_readings over their MOE_LIMITS."""
    over = ["loss"] if readings["loss_rel"] > MOE_LOSS_RTOL else []
    for after in ("first", "last"):
        for key, rel in readings[f"{after}_state_rel_by_tensor"].items():
            router = after == "first" and key.endswith(".router.weight")
            if rel > (MOE_ROUTER_RTOL if router else MOE_STATE_RTOL):
                over.append(f"{key} after the {after} step")
    return over


def moe_mesh(device, out_dir: pathlib.Path) -> dict:
    """(m2) and (m3): MOE_RANKS ranks on this card (launch_local of
    moe_rank_main), then one rank of each configuration. Every rank must
    give finite falling losses, exactly moe_launches_per_step a step and
    no plain version; its losses and state within MOE_LIMITS of one
    rank's (_moe_readings, _moe_over); layer
    MOE_LAYER's routing equal to one rank's at its rows, index for index,
    and to the global routing (models/moe.route) of the ranks' own router
    logits gathered in batch order. Every rank of a MOE_FAULT_RUNS run
    must exceed a limit. The readings print before any check fails."""
    env = dict(os.environ, CHIP_SMOKE_MOE=json.dumps({"dir": str(out_dir)}))
    started = time.perf_counter()
    runs = distributed.launch_local(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.moe_rank_main()"],
        MOE_RANKS, MOE_RANKS_TIMEOUT_S, env=env,
        cwd=pathlib.Path(__file__).resolve().parent)
    ranks = []
    for run in runs:
        line = next((ln for ln in run["stdout"].splitlines()[::-1]
                     if ln.startswith("MOE_RANK ")), None)
        first = run["stderr"].find("Traceback")
        require(run["returncode"] == 0 and line is not None,
                f"moe rank {run['rank']}: rc {run['returncode']} (timed "
                f"out: {run['timed_out']}): first error "
                f"{run['stderr'][first:first + 3000] if first >= 0 else ''}"
                f" ... {run['stderr'][-2000:]}")
        ranks.append(json.loads(line[len("MOE_RANK "):]))
    rows = {"ranks_s": time.perf_counter() - started}
    steps = MOE_WARMUP + MOE_STEPS
    failures, bases = [], {}
    for name, cfg in MOE_RUNS.items():
        sizes = mesh_mod.auto_axis_sizes(MOE_RANKS, ep=cfg["ep"])
        base = bases[name] = moe_base(device, name)
        want = moe_launches_per_step(sizes, cfg["n_layers"], remat=True)
        rows_per_rank = cfg["batch"] // sizes["dp"]
        saved = [torch.load(out_dir / f"{name}_rank{r}.pt")
                 for r in range(MOE_RANKS)]
        # The global routing of the ranks' own logits: one rank of each
        # data block (ep index 0), in batch order.
        logits = torch.cat([saved[r]["logits"] for r in range(MOE_RANKS)
                            if ranks[r][name]["coords"]["ep"] == 0]).view(
            cfg["batch"], cfg["seq"], MOE_EXPERTS)
        moe_cfg = train_wl.moe_config(MOE_EXPERTS, _MODEL["d_model"],
                                      _MODEL["d_ff"])
        glob = moe_mod.route(logits.to(device), moe_mod.capacity_for(
            moe_cfg.capacity_factor, cfg["batch"] * cfg["seq"], MOE_EXPERTS),
            moe_cfg)
        glob = {"expert": glob.expert.cpu(), "position": glob.position.cpu()}
        checked = []
        for r, res in enumerate(rank[name] for rank in ranks):
            losses = res["losses"]
            if not (all(math.isfinite(x) for x in losses) and
                    losses[-1] < losses[0]):
                failures.append(f"moe {name} rank {r}: losses {losses}")
            if res["launches"] != {k: n * steps for k, n in want.items()}:
                failures.append(f"moe {name} rank {r}: launches "
                                f"{res['launches']} in {steps} steps, want "
                                f"{want} a step")
            if res["plain_calls"]:
                failures.append(f"moe {name} rank {r}: plain versions ran "
                                f"{res['plain_calls']}")
            lo = res["coords"]["dp"] * rows_per_rank * cfg["seq"]
            hi = lo + rows_per_rank * cfg["seq"]
            mine = {k: v[lo:hi] for k, v in base["routing"].items()}
            off_base = _routing_diff(saved[r]["routing"], mine)
            off_global = _routing_diff(saved[r]["routing"], {
                k: v[lo:hi] for k, v in glob.items()})
            readings = _moe_readings(res, saved[r], base)
            checked.append({"rank": r, "routing_entries_off_one_rank":
                            off_base, "routing_entries_off_global":
                            off_global, **readings})
            if off_base or off_global:
                failures.append(
                    f"moe {name} rank {r}: layer {MOE_LAYER}'s routing "
                    f"differs from one rank's in {off_base} entries and "
                    f"from the global routing of the ranks' logits in "
                    f"{off_global}")
            if _moe_over(readings):
                failures.append(
                    f"moe {name} rank {r}: {_moe_over(readings)} over "
                    f"{MOE_LIMITS}: losses {losses} vs one rank's "
                    f"{base['losses']}, {readings}")
        del saved
        dropped = float((base["routing"]["position"] < 0).float().mean())
        # Rank 0's launches a step, as counted (every rank's are checked
        # against moe_launches_per_step above).
        measured = {k: n / steps
                    for k, n in ranks[0][name]["launches"].items()}
        rows[name] = row = {
            "config": (f"--moe-experts {MOE_EXPERTS} --ep {cfg['ep']} "
                       f"--batch {cfg['batch']} --seq-len {cfg['seq']}, "
                       f"bench_transformer widths, {cfg['n_layers']} "
                       f"layers, remat, fused loss (mesh {sizes})"),
            "ranks": f"{MOE_RANKS} ranks time-sliced on one card",
            "one_rank_losses": base["losses"],
            "layer1_dropped_share": dropped, "checked": checked,
            "launches_per_step_rank0": measured,
            "launches_rank0": ranks[0][name]["launches"],
            "losses_rank0": ranks[0][name]["losses"],
            "ms_per_step": [r[name]["ms_per_step"] for r in ranks],
            "peak_mem_gb": [r[name]["peak_mem_gb"] for r in ranks],
            "dropped_share_rank0": ranks[0][name]["dropped_share"]}
        if cfg["profile"]:
            profile = [r[name]["profile"] for r in ranks]
            row.update({
                "ring_ms_per_step_by_axis": [
                    p["ring_ms_per_step_by_axis"] for p in profile],
                "device_idle_share": [p["device_idle_share"]
                                      for p in profile],
                "op_ms_per_step_rank0": profile[0]["op_ms_per_step"],
                "profile": profile})
        worst = {key: max(c[key] for c in checked)
                 for key in ("loss_rel", "first_loss_rel", "first_state_rel",
                             "last_state_rel")}
        print(f"train moe ({name}) ({row['config']}; {row['ranks']}): "
              f"losses (rank 0) {row['losses_rank0']} vs one rank's "
              f"{base['losses']}, worst over the ranks {worst} (limits "
              f"{MOE_LIMITS}), by tensor (rank 0) after the first step "
              f"{checked[0]['first_state_rel_by_tensor']} and the last "
              f"{checked[0]['last_state_rel_by_tensor']}, layer {MOE_LAYER} "
              f"routing entries off one rank's "
              f"{[c['routing_entries_off_one_rank'] for c in checked]}, "
              f"dropped share {dropped:.4f}, launches a step as counted "
              f"(rank 0; K13/K14 on the ep ring: "
              f"{measured.get('ring_all_reduce.ep', 0)} all-reduces) "
              f"{measured}, ms/step per rank {row['ms_per_step']}, peak GB "
              f"per rank {row['peak_mem_gb']}" +
              (f", ring kernels' ms a step by axis (rank 0) "
               f"{row['ring_ms_per_step_by_axis'][0]}, device ms a step "
               f"by op (rank 0) {row['op_ms_per_step_rank0']}"
               if cfg["profile"] else ""), flush=True)
        print(f"train moe {name} " + json.dumps(row), flush=True)
    for name, of in MOE_FAULT_RUNS.items():
        readings = []
        for r, rank in enumerate(ranks):
            saved = torch.load(out_dir / f"{name}_rank{r}.pt")
            readings.append(_moe_readings(rank[name], saved, bases[of]))
            if not _moe_over(readings[-1]):
                failures.append(f"moe planted fault {name} rank {r}: not "
                                f"caught, {readings[-1]}")
        rows[name] = {"of": of, "readings": readings}
        print(f"train moe planted fault {name} (every MoE layer's aux "
              f"gradient doubled, in {of}): readings per rank {readings} "
              f"(limits {MOE_LIMITS})", flush=True)
    require(not failures, "; ".join(failures))
    return rows


def moe_phase(device) -> dict:
    """Phase 5d: (m1), then (m2) and (m3), under the loss marker."""
    started = time.perf_counter()
    rows = {"m1": train_moe(device)}
    with tempfile.TemporaryDirectory() as tmp:
        rows.update(moe_mesh(device, pathlib.Path(tmp)))
    rows["phase_s"] = time.perf_counter() - started
    print(f"moe phase: {rows['phase_s']:.1f} s", flush=True)
    return rows


# ------------------------------ serving ------------------------------


# BENCH_SERVING_KV_CACHES entry -> the kernel it must launch.
SERVED = (("paged", "paged_decode"), ("paged_int8", "paged_decode_int8"),
          ("dense_int8", "dense_decode_int8"))


def _copy_model(engine, **overrides) -> tfm.TransformerLM:
    cfg = dataclasses.replace(engine.config, **overrides)
    model = tfm.TransformerLM(cfg, device="meta")
    model.load_state_dict({k: t.to(cfg.dtype if t.dtype == torch.bfloat16
                                   else t.dtype)
                           for k, t in engine.model.state_dict().items()},
                          assign=True)
    return model.eval()


def _rel(got, want, reduce) -> float:
    return float(reduce((got - want).abs()) / reduce(want.abs()))


def teacher_forced(engine: ContinuousBatcher, steps: int = 96) -> dict:
    """Feed the same random tokens, every slot at its own depth (slot b
    starts at 9*b, so pages and lengths are ragged), through three
    models with the engine's weights: the engine's own (kernels), a
    copy on the plain attention, and an fp32 copy on the plain
    attention. Returns the kernel-vs-plain logit difference and each
    bf16 model's distance from the fp32 one, as RMS and max over all
    steps relative to the RMS and max of the reference logits."""
    plain_impl = dict(paged_attention_impl="reference",
                      decode_attention_impl="reference")
    cfg = engine.config
    models = (engine.model, _copy_model(engine, **plain_impl),
              _copy_model(engine, dtype=torch.float32, **plain_impl))
    batch = engine.num_slots
    rng = np.random.default_rng(2)
    starts = np.arange(batch, dtype=np.int32) * 9
    caches = [inf.init_cache(m, batch) for m in models]
    dev = engine.device
    start_t = torch.from_numpy(starts).to(dev)
    for cache in caches:
        for layer in cache:
            layer["length" if cfg.kv_page_size else "index"].copy_(start_t)
    if cfg.kv_page_size:
        scratch = cfg.kv_num_pages - 1
        live = -(-(int(starts.max()) + steps) // PAGE)
        order = rng.permutation(scratch)[:batch * live]
        table = np.full((batch, MAX_LEN // PAGE), scratch, np.int32)
        table[:, :live] = order.reshape(batch, live)
        for cache in caches:
            cache[0]["block_table"].copy_(torch.from_numpy(table))
    tokens = rng.integers(0, cfg.vocab_size, (steps, batch))
    logits = [[], [], []]
    with torch.no_grad():
        for t in range(steps):
            tok = torch.from_numpy(tokens[t, :, None]).to(dev)
            pos = (start_t + t)[:, None]
            for out, m, c in zip(logits, models, caches):
                out.append(m(tok, positions=pos, cache=c)[:, 0].float())
    kernel, plain, exact = (torch.cat(out) for out in logits)
    require(bool(torch.isfinite(kernel).all()),
            "teacher-forced: non-finite logits")

    def rms(x):
        return x.square().mean().sqrt()
    return {
        "kernel_vs_plain_rms": _rel(kernel, plain, rms),
        "kernel_vs_plain_max": _rel(kernel, plain, torch.amax),
        "kernel_vs_fp32_rms": _rel(kernel, exact, rms),
        "plain_vs_fp32_rms": _rel(plain, exact, rms),
    }


# The graph check: decode steps from one state, replayed and eager.
GRAPH_STEPS, GRAPH_PROMPT, GRAPH_SEED = 16, 96, 5
# The stream check: STREAM_REQUESTS greedy requests, the first
# STREAM_FIRST at once and one more every STREAM_GAP steps, prompts and
# new tokens drawn from STREAM_PROMPT and STREAM_NEW (up to 8 pages a
# slot, so the 40-page paged_int8 cache must preempt).
STREAM_REQUESTS, STREAM_FIRST, STREAM_GAP = 12, 4, 12
STREAM_PROMPT, STREAM_NEW = (100, 300), (100, 200)


def _decode_state(engine: ContinuousBatcher) -> list:
    """The tensors a decode step writes: tokens, positions and every
    cache tensor (the block table too, which it only reads)."""
    tensors = [engine._tokens, engine._positions]
    for layer in engine.cache:
        tensors += [layer[key] for key in sorted(layer)]
    return tensors


def _stream(engine: ContinuousBatcher, schedule) -> dict:
    """Drive ``schedule`` ([(step, request)]) through engine.step();
    returns each request's streamed tokens."""
    out, pending = {}, list(schedule)
    for step in range(16 * MAX_LEN):
        while pending and pending[0][0] <= step:
            engine.submit(pending.pop(0)[1])
        for rid, tokens in engine.step():
            out[rid] = tokens
        if not pending and not engine.pending():
            return out
    raise SmokeFailure("stream check: the engine did not drain")


def _stream_schedule() -> list:
    """[(step, request)]: STREAM_FIRST requests at step 0, then one
    every STREAM_GAP steps, drawn from one seed."""
    rng = np.random.default_rng(4)
    plan = []
    for i in range(STREAM_REQUESTS):
        prompt = rng.integers(0, MODEL["vocab_size"],
                              int(rng.integers(*STREAM_PROMPT)))
        plan.append((max(0, i - STREAM_FIRST + 1) * STREAM_GAP,
                     Request(f"stream-{i}", prompt.tolist(),
                             max_new_tokens=int(rng.integers(*STREAM_NEW)))))
    return plan


def stream_check(name, device) -> tuple[dict, ContinuousBatcher]:
    """One request schedule (admissions mid-stream, pages growing past
    the prompts', and for paged_int8 overcommit preemption with
    re-prefill) through an engine that replays its decode graph and its
    prefill graphs and through one held eager (its captures skipped):
    every request must
    stream identical greedy tokens, with as many decode steps and
    preemptions. Returns the row and the replaying engine, drained."""
    runs = {}
    for mode in ("replayed", "eager"):
        engine = build_bench_engine(name, device)
        if mode == "eager":
            # Hold this one eager: no decode graph, no prefill graph.
            engine.capture_decode = lambda: None
            engine._capture_prefill = lambda kind, bucket: None
        engine.warmup()
        require((engine._graph is not None) == (mode == "replayed") and
                bool(engine._prefill_graphs) == (mode == "replayed"),
                f"{name} stream check: the {mode} engine's graphs")
        runs[mode] = (_stream(engine, _stream_schedule()), engine)
    (got, replayed), (want, eager) = runs["replayed"], runs["eager"]
    row = {"requests": len(want), "decode_steps": replayed.decode_steps,
           "preemptions": replayed.preemptions,
           "tokens": sum(len(t) for t in want.values()),
           "identical": got == want,
           "same_steps": replayed.decode_steps == eager.decode_steps,
           "same_preemptions": replayed.preemptions == eager.preemptions}
    require(len(want) == STREAM_REQUESTS and row["identical"] and
            row["same_steps"] and row["same_preemptions"],
            f"{name} stream check, replayed vs eager: {row}")
    require(name != "paged_int8" or row["preemptions"] > 0,
            f"{name} stream check: no preemption fired: {row}")
    del eager, runs
    return row, replayed


def graph_check(name, engine: ContinuousBatcher,
                steps: int = GRAPH_STEPS) -> dict:
    """A replaying engine's captured decode step against the eager one,
    from one state (8 live slots after 96-token prompts). Greedy:
    ``steps`` steps replayed and ``steps`` eager must give identical
    tokens and leave identical state (every tensor the step writes).
    Temperature 0.8 / top-k 50 (recaptured): two replayed runs from the
    same state and seed must agree, with each other and with an eager
    run from that seed, and a third without reseeding must draw other
    tokens (each replay draws afresh). The steps stay inside the slots'
    allocated pages (positions 97-112 of 128), as step() would keep
    them by growing pages first."""
    require(engine._graph is not None, f"{name}: warmup captured no graph")
    rng = np.random.default_rng(3)
    for i in range(engine.num_slots):
        engine.submit(Request(
            f"graph-{i}", rng.integers(0, MODEL["vocab_size"],
                                       GRAPH_PROMPT).tolist(),
            max_new_tokens=MAX_LEN - GRAPH_PROMPT))
    engine.step()
    require(len(engine.active_request_ids()) == engine.num_slots,
            f"{name} graph check: not every slot admitted")
    start = [t.clone() for t in _decode_state(engine)]

    def run(fn, reseed=True):
        for t, t0 in zip(_decode_state(engine), start):
            t.copy_(t0)
        if reseed:
            engine._generator.manual_seed(GRAPH_SEED)
        tokens = torch.stack([fn().clone() for _ in range(steps)])
        return tokens, [t.clone() for t in _decode_state(engine)]

    def same_state(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    replay, eager = run(engine._replay_decode), run(engine._eager_decode)
    rows = {"greedy": {
        "steps": steps, "tokens_identical": torch.equal(replay[0], eager[0]),
        "state_identical": same_state(replay[1], eager[1])}}
    require(rows["greedy"]["tokens_identical"] and
            rows["greedy"]["state_identical"],
            f"{name} graph vs eager, greedy: {rows['greedy']}")
    engine.sampling = inf.SamplingConfig(temperature=0.8, top_k=50)
    engine.capture_decode()
    first, again = run(engine._replay_decode), run(engine._replay_decode)
    fresh = run(engine._replay_decode, reseed=False)
    eager = run(engine._eager_decode)
    rows["temperature"] = {
        "steps": steps,
        "replays_repeat_with_seed": torch.equal(first[0], again[0]) and
        same_state(first[1], again[1]),
        "fresh_draws_differ_share": float(
            (fresh[0] != first[0]).float().mean()),
        "eager_same_token_share": float(
            (eager[0] == first[0]).float().mean())}
    require(rows["temperature"]["replays_repeat_with_seed"] and
            rows["temperature"]["fresh_draws_differ_share"] > 0.5 and
            rows["temperature"]["eager_same_token_share"] == 1.0,
            f"{name} graph, temperature: {rows['temperature']}")
    return rows


def decode_graph(name, device) -> dict:
    """Phase 6 for one cache: stream_check, then graph_check on the
    drained replaying engine."""
    stream, engine = stream_check(name, device)
    rows = {"stream": stream, **graph_check(name, engine)}
    print(f"graph {name} " + json.dumps(rows), flush=True)
    del engine
    torch.cuda.empty_cache()
    return rows


# The decode-attention kernels' names as the profiler reports them.
DECODE_KERNEL_NAMES = tuple(sorted(set(
    decode_profile.ATTENTION_KERNEL.values())))


def replayed_step_launches(name, reading: dict) -> dict:
    """The decode-attention kernels the traced replays launched a step,
    by kernel name: there must be exactly one, the cache's own, at one
    launch a layer (a layer on any other path would leave it short)."""
    found = {kernel: n for kernel, n in
             reading["launches_per_step_by_kernel"].items()
             if any(k in kernel for k in DECODE_KERNEL_NAMES)}
    own = decode_profile.ATTENTION_KERNEL[name]
    require(len(found) == 1 and own in next(iter(found)) and
            next(iter(found.values())) == MODEL["n_layers"],
            f"{name}: decode-attention launches a replayed step {found}")
    return found


@contextlib.contextmanager
def counted_decode(engine: ContinuousBatcher):
    """Counts, inside the block, the engine's eager decode (or
    speculative) steps and its decode captures; the step a capture
    records is not counted."""
    eager_name = ("_eager_speculative" if engine.speculative is not None
                  else "_eager_decode")
    eager, capture = getattr(engine, eager_name), engine.capture_decode
    calls = {"eager": 0, "captures": 0}

    def counted_eager():
        calls["eager"] += 1
        return eager()

    def counted_capture():
        calls["captures"] += 1
        setattr(engine, eager_name, eager)  # the capture records the step
        try:
            return capture()
        finally:
            setattr(engine, eager_name, counted_eager)
    setattr(engine, eager_name, counted_eager)
    engine.capture_decode = counted_capture
    try:
        yield calls
    finally:
        setattr(engine, eager_name, eager)
        engine.capture_decode = capture


def warm(name, engine: ContinuousBatcher) -> tuple[dict, dict]:
    """``engine.warmup()`` with its decode steps counted, then the engine
    watched from the outside. Warm-up must warm every bucket
    (``warmup_buckets``), capture a prefill graph for every prefill it
    can run there (``_prefill_keys``) and run exactly one decode step
    eagerly (its first) and one capture: every later step replays. So a
    decode kernel's wrapper counts its per-step launches twice in the
    warm-up and never again. Returns the warm-up's row and a dict that
    counts, from then on, captures (decode or prefill), eager decode
    steps and eager prefills (a prefill with no graph): all must stay 0
    under traffic."""
    started = time.perf_counter()
    with counted_decode(engine) as calls:
        buckets = engine.warmup()
    keys = engine._prefill_keys(buckets)
    row = {"buckets": buckets, "eager_decode_steps": calls["eager"],
           "decode_captures": calls["captures"],
           "prefill_graphs": len(engine._prefill_graphs),
           "seconds": time.perf_counter() - started}
    require(buckets == engine.warmup_buckets() and
            sorted(engine._prefill_graphs) == sorted(keys) and
            engine._graph is not None and calls["eager"] == 1 and
            calls["captures"] == 1,
            f"{name} warm-up: {row}, prefill graphs "
            f"{sorted(engine._prefill_graphs)}")
    return row, watch(engine)


def watch(engine: ContinuousBatcher) -> dict:
    """A dict that counts, from now on, the engine's captures (decode or
    prefill), eager decode steps and eager prefills (a prefill with no
    graph)."""
    eager_name = ("_eager_speculative" if engine.speculative is not None
                  else "_eager_decode")
    live = {"captures": 0, "eager_decode_steps": 0, "eager_prefills": 0}

    def counting(attr, key):
        fn = getattr(engine, attr)

        def counted(*args, **kwargs):
            live[key] += 1
            return fn(*args, **kwargs)
        setattr(engine, attr, counted)
    counting("capture_decode", "captures")
    counting("_capture_prefill", "captures")
    counting(eager_name, "eager_decode_steps")
    counting("_prefill_body", "eager_prefills")
    return live


def _idle_state(engine: ContinuousBatcher) -> dict:
    """What a burned request or a polluted engine would move: the decode
    steps, the slots, the queue, the page lists and reservations, the
    prefix index and counters, the timing samples, the block table and
    every cache length, the token, position and active tensors."""
    torch.cuda.synchronize()
    return {
        "decode_steps": engine.decode_steps,
        "slots": [s.request for s in engine._slots],
        "queue": len(engine._queue),
        "free_pages": sorted(engine._free_pages),
        "avail_pages": engine._avail_pages,
        "reserved": list(engine._slot_reserved),
        "prefix_index": len(engine._prefix_index), "lru": len(engine._lru),
        "prefix": engine.prefix_stats(), "slo": engine.slo_stats(),
        "timed_buckets": sorted(engine._timed_buckets),
        "table": engine._table.tolist(),
        "lengths": [layer["length"].tolist() for layer in engine.cache],
        "device_table": engine.cache[0]["block_table"].tolist(),
        "tokens": engine._tokens.tolist(),
        "positions": engine._positions.tolist(),
        "active": engine._active.tolist()}


def warm_from_shapes(name, engine: ContinuousBatcher,
                     want_keys: list) -> tuple[dict, dict]:
    """``engine.precompile()`` on an idle engine: it must capture the
    decode graph and exactly the (kind, bucket) prefill graphs
    ``want_keys`` (a warmup()-warmed engine's), return the reference's
    count, run one decode step eagerly (every slot inactive) and one
    capture, and leave _idle_state as it was. Returns its row and the
    engine watched from then on (watch)."""
    started = time.perf_counter()
    before = _idle_state(engine)
    with counted_decode(engine) as calls:
        count = engine.precompile()
    after = _idle_state(engine)
    moved = {key: (before[key], after[key]) for key in before
             if before[key] != after[key]}
    row = {"count": count, "eager_decode_steps": calls["eager"],
           "decode_captures": calls["captures"],
           "prefill_graphs": len(engine._prefill_graphs),
           "burned": sorted(moved),
           "seconds": time.perf_counter() - started}
    require(sorted(engine._prefill_graphs) == want_keys and
            engine._graph is not None and
            count == 1 + len(engine.warmup_buckets()) and
            calls["eager"] == 1 and calls["captures"] == 1,
            f"{name} precompile: {row}, prefill graphs "
            f"{sorted(engine._prefill_graphs)} vs warmup()'s {want_keys}")
    require(not moved, f"{name} precompile moved {moved}")
    return row, watch(engine)


def require_replayed(name, live: dict) -> None:
    require(not any(live.values()),
            f"{name}: after warm-up, traffic captured or ran eagerly: {live}")


def serve(name, kernel, device) -> dict:
    """Phase 7: one served configuration, end to end, its decode steps
    replayed from the graph the warm-up captured; then
    trace/decode_profile.py's reading of the same engine's replayed
    step."""
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    engine = build_bench_engine(name, device)
    warmed, live = warm(name, engine)
    front = ServingFrontEnd(engine, port=0).start()
    try:
        front.generate({"prompt": [1, 2, 3], "max_new_tokens": 2})
        # bench_serving's profile for max_decode_len 512.
        report = run_load(front.url, 8, rate_hz=16.0,
                          prompt_len=(64, 128), max_new_tokens=(64, 128),
                          vocab_size=MODEL["vocab_size"], seed=0)
    finally:
        front.shutdown()
    torch.cuda.synchronize()
    require_replayed(name, live)
    # The wrappers count where they launch: one launch a layer in the
    # warm-up's one eager decode step and one in its capture (prefill
    # runs no decode kernel). Replays relaunch the captured kernels
    # without the wrappers; the trace below counts those.
    counts = launch_counts()
    expected = MODEL["n_layers"] * (warmed["eager_decode_steps"] +
                                    warmed["decode_captures"])
    require(report["completed"] == 8 and report["failed"] == 0,
            f"{name}: {report['failed']} failed: {report.get('errors')}")
    require(counts[kernel] == expected,
            f"{name}: {kernel} launched {counts[kernel]} times through "
            f"its wrapper, not {expected}")
    others = {k: n for k, n in counts.items() if k != kernel and n}
    require(not others, f"{name}: unexpected launches {others}")
    steps = engine.decode_steps
    slo = engine.slo_stats()
    preemptions = engine.preemptions
    reading = decode_profile.profile_engine(engine, name, GRAPH_STEPS)
    require(reading["graph"], f"{name} decode profile: not replayed")
    found = replayed_step_launches(name, reading)
    forced = teacher_forced(engine)
    floor = forced["plain_vs_fp32_rms"]
    require(floor <= BF16_FLOOR_MAX,
            f"{name}: plain bf16 vs fp32 logits {forced}")
    require(forced["kernel_vs_fp32_rms"] <= FP32_SLACK * floor and
            forced["kernel_vs_plain_rms"] <= FP32_SLACK * floor,
            f"{name}: the kernel path is off by more than bf16 "
            f"rounding: {forced}")
    row = {
        "config": name, "kernel": kernel, "launches": counts[kernel],
        "launches_counted": "wrapper calls: the eager warm-up step and "
                            "the graph capture",
        "warmup": warmed,
        "decode_steps": steps,
        "launches_per_replayed_step": next(iter(found.values())),
        "replayed_kernel": next(iter(found))[:120],
        "completed": report["completed"], "failed": report["failed"],
        "preemptions": preemptions,
        "ttft_ms": report["ttft_exact_ms"],
        "tpot_ms": report["tpot_exact_ms"],
        "tokens_per_second": report["tokens_per_second"],
        "step_ms": slo["step_ms"],
        "teacher_forced": forced,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "decode_profile": {
            k: reading[k] for k in (
                "steps", "wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share", "device_idle_share_of_wall",
                "kernel_launches_per_step", "attention_launches_per_step",
                "attention_ms_per_step", "attention_share_of_device",
                "top_kernels_ms_per_step")},
    }
    print("serve " + json.dumps(row), flush=True)
    del engine
    torch.cuda.empty_cache()
    return row


# ------------------------- speculative serving --------------------------

# bench.py bench_serving_speculative's load at max_decode_len 512, whole:
# 32 requests at 16 Hz, prompts of 64-128 tokens, 64-128 new ones, seed 0.
SPEC_REQUESTS, SPEC_RATE_HZ = 32, 16.0
SPEC_PROMPT, SPEC_NEW = (MAX_LEN // 8, MAX_LEN // 4), (MAX_LEN // 8,
                                                     MAX_LEN // 4)
# The runs: (name, cache of serve.BENCH_SPECULATIVE_CACHES, draft). "bench"
# is bench.py's random draft (seed 7); "noisy" is the target's own weights
# plus SPEC_NOISE times each tensor's RMS in Gaussian noise (seed 7), a
# draft that validates some proposals and not others.
SPEC_RUNS = (("s1", "dense", "bench"), ("s2", "paged", "bench"),
             ("s3", "paged_int8", "bench"), ("s4", "dense", "noisy"))
SPEC_NOISE = 0.05
# Replayed speculative steps the decode profile reads (each holds 2,000 to
# 6,000 kernels).
SPEC_PROFILE_STEPS = 4
# The fp32 run of (s1): requests of the same load, served offline.
SPEC_FP32_REQUESTS = 8


def spec_payloads(num: int) -> list:
    """The load's requests (loadgen.load_requests, as run_load draws
    them)."""
    return load_requests(num, SPEC_RATE_HZ, SPEC_PROMPT, SPEC_NEW,
                         MODEL["vocab_size"], seed=0)[1]


def noisy_draft(device) -> tuple:
    """(config, state dict) of the (s4) draft: bench_serving's target
    config and seed-0 weights, each tensor plus SPEC_NOISE x its RMS x
    N(0, 1) from a seed-7 generator."""
    config = tfm.TransformerConfig(**MODEL, max_seq_len=MAX_LEN,
                                   dtype=torch.bfloat16)
    params = bench_params(config, device, 0)
    gen = torch.Generator(device=device).manual_seed(7)
    noisy = {}
    for name, t in params.items():
        rms = t.float().square().mean().sqrt()
        noise = torch.randn(t.shape, generator=gen, device=device)
        noisy[name] = (t.float() + SPEC_NOISE * rms * noise).to(t.dtype)
    return config, noisy


def spec_load(engine: ContinuousBatcher) -> tuple[dict, dict]:
    """The load through ServingFrontEnd + run_load; returns the report
    and every load request's streamed tokens (recorded as the engine
    emits them)."""
    front = ServingFrontEnd(engine, port=0).start()
    streams = collections.defaultdict(dict)
    emit = engine.on_token

    def record(request_id, token, index):
        streams[request_id][index] = token
        emit(request_id, token, index)
    engine.on_token = record
    try:
        front.generate({"prompt": [1, 2, 3], "max_new_tokens": 2})
        report = run_load(front.url, SPEC_REQUESTS, rate_hz=SPEC_RATE_HZ,
                          prompt_len=SPEC_PROMPT, max_new_tokens=SPEC_NEW,
                          vocab_size=MODEL["vocab_size"], seed=0)
    finally:
        front.shutdown()
        engine.on_token = emit
    torch.cuda.synchronize()
    return report, {rid: [tokens[i] for i in range(len(tokens))]
                    for rid, tokens in streams.items()}


def nonspec_twin(engine: ContinuousBatcher,
                 kv_cache: str) -> ContinuousBatcher:
    """The non-speculative engine on the speculative engine's target: its
    weights shared, the cache of ``kv_cache``."""
    _, kwargs = BENCH_SPECULATIVE_CACHES[kv_cache]
    config = dataclasses.replace(engine.config, spec_window=0,
                                 kv_page_size=None, kv_num_pages=0)
    return ContinuousBatcher(config, engine.model.state_dict(),
                             num_slots=engine.num_slots,
                             max_decode_len=engine.max_decode_len,
                             device=engine.device, **kwargs)


def nonspec_reference(twin: ContinuousBatcher,
                      payloads: list) -> tuple[dict, dict]:
    """The non-speculative engine ``twin`` (idle) with ``payloads`` all
    submitted at once, its decode steps replayed from the graph its first
    one captures, as served. Returns each request's tokens and, for each
    generated token, the top-2 margin of the logits its decode step
    sampled it from (index 0, sampled from the prefill, gets inf): the
    sampler is wrapped while the step runs and is captured, so every
    replay also writes the margins of its logits."""
    margins = collections.defaultdict(lambda: {0: math.inf})
    sample, gaps = inf._sample, {}

    def hook(logits, generator, sampling):
        if logits.shape[0] == twin.num_slots:
            top = logits.topk(2, dim=-1).values
            gaps["step"] = top[:, 0] - top[:, 1]
        return sample(logits, generator, sampling)

    def noted(step):
        def run():
            out = step()
            gap = gaps["step"].tolist()
            for i, slot in enumerate(twin._slots):
                if slot.request is not None:
                    margins[slot.request.request_id][
                        len(slot.generated)] = gap[i]
            return out
        return run
    twin._replay_decode = noted(twin._replay_decode)
    twin._eager_decode = noted(twin._eager_decode)
    inf._sample = hook
    try:
        for p in payloads:
            twin.submit(Request(p["request_id"], p["prompt"],
                                p["max_new_tokens"]))
        streams = {}
        while twin.pending():
            for rid, tokens in twin.step():
                streams[rid] = tokens
    finally:
        inf._sample = sample
    return streams, dict(margins)


def verify_vs_single(engine: ContinuousBatcher, twin: ContinuousBatcher,
                     payloads: list, streams: dict) -> float:
    """The largest |logit difference| between the speculative engine's
    verify block and the non-speculative ``twin``'s single-step decode,
    teacher-forced on the non-speculative streams (each request's prompt
    and generated tokens, every request a slot of one batch, fresh caches
    of each engine's target): blocks of gamma + 1 tokens from position 0
    against the same tokens one step at a time, read at the positions
    whose logits pick a generated token. Logits as each engine's argmax
    reads them: the verify's fp32 product with the fp32 embedding, the
    decode step's logits in the model's dtype (bf16 logits tie where the
    fp32 ones do not)."""
    span = engine.gamma + 1
    seqs = [p["prompt"] + streams[p["request_id"]] for p in payloads]
    batch = len(seqs)
    steps = -(-max(map(len, seqs)) // span) * span
    dev = engine.device
    padded = np.array([s + [s[-1]] * (steps - len(s)) for s in seqs],
                      np.int32)
    tokens = torch.from_numpy(padded).to(dev)
    # Positions whose logits pick generated tokens 1.. (the decode steps').
    read = torch.zeros((batch, steps), dtype=torch.bool, device=dev)
    for b, p in enumerate(payloads):
        read[b, len(p["prompt"]):len(seqs[b]) - 1] = True
    caches = []
    for eng in (engine, twin):
        cfg = eng.model.config
        if cfg.kv_page_size:
            pages = -(-(steps + engine.gamma) // PAGE)
            cfg = dataclasses.replace(cfg, kv_num_pages=batch * pages + 1)
        # init_cache reads only the config and the embedding's device.
        cache = inf.init_cache(types.SimpleNamespace(
            config=cfg, embed=eng.model.embed), batch)
        if cfg.kv_page_size:
            table = np.full((batch, eng.max_blocks), batch * pages, np.int32)
            table[:, :pages] = np.arange(batch * pages).reshape(batch, pages)
            cache[0]["block_table"].copy_(torch.from_numpy(table))
        caches.append(cache)
    offs = torch.arange(span, dtype=torch.int32, device=dev)
    worst = torch.zeros((), device=dev)
    # The single steps: the first eager, then (on the card) replays of it
    # captured, as the twin's own decode steps are.
    token = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    position = torch.zeros((1,), dtype=torch.int32, device=dev)

    def single():
        return twin.model(token, positions=position,
                          cache=caches[1])[:, 0].float()
    graph = logits = None
    with torch.no_grad():
        for t0 in range(0, steps, span):
            block = inf.last_token_logits(engine.model, engine.model(
                tokens[:, t0:t0 + span], positions=t0 + offs,
                cache=caches[0], return_hidden=True))
            for s in range(span):
                t = t0 + s
                token.copy_(tokens[:, t:t + 1])
                position.fill_(t)
                if graph is None:
                    one = single()
                else:
                    graph.replay()
                    one = logits
                diff = (block[:, s] - one).abs().amax(dim=-1)
                worst = torch.maximum(worst, torch.where(
                    read[:, t], diff, 0.0).amax())
                if graph is None and dev.type == "cuda":
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph,
                                          capture_error_mode="thread_local"):
                        logits = single()
    worst = float(worst)
    require(math.isfinite(worst), "verify vs single step: non-finite")
    return worst


def compare_streams(name, got: dict, want: dict, margins: dict,
                    bound: float) -> dict:
    """Each speculative stream against the non-speculative one on the
    same prompt: identical up to its first near-tie, the first token
    whose non-speculative top-2 margin is below ``bound`` (the largest
    verify-vs-single-step logit difference). Streams that part there
    stopped early."""
    missing = sorted(set(want) - set(got))
    require(not missing, f"{name}: streams {missing} missing")
    identical = stopped = tied = 0
    for rid, ref in want.items():
        ties = [i for i, m in sorted(margins[rid].items()) if m < bound]
        tie = ties[0] if ties else None
        tied += tie is not None
        spec = got[rid]
        diff = next((i for i, (a, b) in enumerate(zip(spec, ref)) if a != b),
                    None if len(spec) == len(ref) else min(len(spec),
                                                           len(ref)))
        if diff is None:
            identical += 1
            continue
        require(tie is not None and diff >= tie,
                f"{name}: {rid} parts from the non-speculative stream at "
                f"token {diff}, before any near-tie (first {tie}, bound "
                f"{bound:.4g}, margin there {margins[rid].get(diff)})")
        stopped += 1
    return {"streams": len(want), "identical": identical,
            "stopped_early": stopped, "with_near_tie": tied,
            "near_tie_bound": bound}


def _spec_state(engine: ContinuousBatcher) -> list:
    """The tensors a speculative step writes: tokens, positions and every
    tensor of both caches (the block table too, which it only reads)."""
    tensors = [engine._tokens, engine._positions, engine._active]
    for cache in (engine.cache, engine._draft_cache):
        for layer in cache:
            tensors += [layer[key] for key in sorted(layer)]
    return tensors


def spec_graph_check(name, engine: ContinuousBatcher,
                     steps: int = GRAPH_STEPS) -> dict:
    """The captured speculative step against the eager one, from one
    state (every slot live: the decode profile's requests): ``steps``
    replays and ``steps`` eager steps must give identical blocks, a_i,
    tokens, positions, cache cursors and cache rows. Pages are grown
    first to cover every position the steps can reach, as step() would."""
    require(engine._graph is not None, f"{name}: warmup captured no graph")
    require(len(engine.active_request_ids()) == engine.num_slots,
            f"{name} speculative graph check: not every slot is live")
    if engine.paged:
        engine._grow_pages(span=steps * (engine.gamma + 1))
    start = [t.clone() for t in _spec_state(engine)]

    def run(fn):
        for t, t0 in zip(_spec_state(engine), start):
            t.copy_(t0)
        out = torch.stack([fn().clone() for _ in range(steps)])
        return out, [t.clone() for t in _spec_state(engine)]
    replay, eager = run(engine._replay_decode), run(engine._eager_speculative)
    row = {"steps": steps,
           "blocks_identical": torch.equal(replay[0], eager[0]),
           "state_identical": all(torch.equal(a, b) for a, b in
                                  zip(replay[1], eager[1])),
           "accepted_in_window": int(replay[0][..., -1].sum())}
    require(row["blocks_identical"] and row["state_identical"],
            f"{name} speculative graph vs eager: {row}")
    return row


def _spec_row(report: dict, engine: ContinuousBatcher) -> dict:
    stats = engine.spec_stats()
    rate = stats["acceptance_rate"]
    return {"completed": report["completed"], "failed": report["failed"],
            "ttft_ms": report["ttft_exact_ms"],
            "tpot_ms": report["tpot_exact_ms"],
            "tokens_per_second": report["tokens_per_second"],
            "spec_step_ms": engine.slo_stats()["step_ms"],
            "speculative": stats,
            "tokens_per_target_forward": 1 + rate * engine.gamma}


def serve_speculative(device) -> dict:
    """Phase 8: bench_serving_speculative's engine (the bench_serving
    target, the 256-wide 2-layer draft at depth 16, gamma 4) under its
    whole load through ServingFrontEnd + run_load, every step a replay
    of the draft/verify graph the warm-up captured: (s1) dense target,
    (s2) paged page 64, (s3) paged int8 with the draft on the dense int8
    cache (K8 at D 16), (s4) a noisy copy of the target as draft. Each
    run must finish every request; the wrappers must show K8 launched in
    (s3) alone and no K6/K7; the trace of replayed steps must show K8
    exactly (gamma + 1) x 2 times a step in (s3) and no decode-attention
    kernel elsewhere; 16 replayed steps must equal 16 eager ones; every
    stream must equal the non-speculative engine's on the same prompt up
    to its first near-tie (compare_streams). (s4) must accept some
    proposals and reject others. Then (s1) in fp32 on SPEC_FP32_REQUESTS
    of the load, offline, under the same stream rule."""
    gamma = BENCH_SPEC_GAMMA
    payloads = spec_payloads(SPEC_REQUESTS)
    rows, refs = {}, {}
    for name, kv_cache, draft in SPEC_RUNS:
        started = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        engine = build_bench_speculative_engine(
            kv_cache, device,
            draft=noisy_draft(device) if draft == "noisy" else None)
        warmed, live = warm(name, engine)
        seconds = {"build_and_warmup": time.perf_counter() - started}
        mark = time.perf_counter()

        def lap(what):
            nonlocal mark
            now = time.perf_counter()
            seconds[what] = now - mark
            mark = now
        report, streams = spec_load(engine)
        lap("load")
        require_replayed(name, live)
        counts = {k: n for k, n in launch_counts().items() if n}
        require(report["completed"] == SPEC_REQUESTS and
                report["failed"] == 0,
                f"{name}: {report['failed']} failed: {report.get('errors')}")
        want_k8 = kv_cache == "paged_int8"
        # (s3): the int8 draft's K8, one launch a layer in each of a
        # round's gamma + 1 draft steps, in the eager warm-up round and
        # its capture; the verify and the prefills run no decode kernel.
        expected = ({"dense_decode_int8": (gamma + 1) *
                     BENCH_DRAFT_MODEL["n_layers"] *
                     (warmed["eager_decode_steps"] +
                      warmed["decode_captures"])} if want_k8 else {})
        require(counts == expected,
                f"{name}: kernel launches {counts}, not {expected}")
        row = {"config": kv_cache, "draft": draft, **_spec_row(report, engine),
               "warmup": warmed, "launches": counts,
               "launches_counted": "wrapper calls: the eager warm-up step "
                                   "and the graph capture"}
        reading = decode_profile.profile_engine(
            engine, kv_cache, SPEC_PROFILE_STEPS,
            decode_profile.DECODE_ATTENTION_KERNELS)
        require(reading["graph"], f"{name}: the profiled steps not replayed")
        found = {kernel: n for kernel, n in
                 reading["launches_per_step_by_kernel"].items()
                 if any(k in kernel for k in DECODE_KERNEL_NAMES)}
        per_step = (gamma + 1) * BENCH_DRAFT_MODEL["n_layers"] * want_k8
        require(reading["attention_launches_per_step"] == per_step and
                all("dense_decode_cluster_kernel" in k for k in found),
                f"{name}: decode-attention launches a replayed step {found}")
        row["decode_profile"] = {k: reading[k] for k in (
            "steps", "wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share", "device_idle_share_of_wall",
            "kernel_launches_per_step", "attention_launches_per_step",
            "attention_ms_per_step", "top_kernels_ms_per_step")}
        row["decode_profile"]["decode_attention_by_kernel"] = {
            k[:120]: n for k, n in found.items()}
        lap("profile")
        row["graph_check"] = spec_graph_check(name, engine)
        lap("graph_check")
        if kv_cache not in refs:
            twin = nonspec_twin(engine, kv_cache)
            ref_streams, margins = nonspec_reference(twin, payloads)
            lap("nonspec_reference")
            refs[kv_cache] = (ref_streams, margins, verify_vs_single(
                engine, twin, payloads, ref_streams))
            lap("near_tie_bound")
            del twin
        want_streams, margins, bound = refs[kv_cache]
        row["streams"] = compare_streams(name, streams, want_streams,
                                         margins, bound)
        stats = row["speculative"]
        if draft == "noisy":
            require(0 < stats["accepted"] < stats["proposed"],
                    f"{name}: no ragged acceptance {stats}")
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        row["phase_seconds"] = time.perf_counter() - started
        row["seconds"] = seconds
        print(f"serve_speculative {name} " + json.dumps(row), flush=True)
        rows[name] = row
        del engine
        torch.cuda.empty_cache()
    # (s1) in fp32, offline: no stream may part before a near-tie.
    started = time.perf_counter()
    engine = build_bench_speculative_engine("dense", device,
                                            dtype=torch.float32)
    engine.warmup()
    require(engine._graph is not None, "s1 fp32: no speculative graph")
    few = spec_payloads(SPEC_REQUESTS)[:SPEC_FP32_REQUESTS]
    for p in few:
        engine.submit(Request(p["request_id"], p["prompt"],
                              p["max_new_tokens"]))
    streams = {}
    while engine.pending():
        for rid, tokens in engine.step():
            streams[rid] = tokens
    twin = nonspec_twin(engine, "dense")
    want_streams, margins = nonspec_reference(twin, few)
    bound = verify_vs_single(engine, twin, few, want_streams)
    del twin
    rows["s1_fp32"] = {
        "config": "dense", "dtype": "float32", "requests": len(few),
        "speculative": engine.spec_stats(),
        "streams": compare_streams("s1 fp32", streams, want_streams,
                                   margins, bound),
        "phase_seconds": time.perf_counter() - started}
    print("serve_speculative s1_fp32 " + json.dumps(rows["s1_fp32"]),
          flush=True)
    del engine
    torch.cuda.empty_cache()
    return rows


# --------------------------- the serving tier ----------------------------

# The prefill buckets of a max_decode_len-512 engine.
ALL_BUCKETS = [16, 32, 64, 128, 256, 512]
PREFILL_TIMED_CALLS = 5


def _profile_windows(calls: list) -> dict:
    """The device kernels each of ``calls`` ([(name, fn)]) launches, from
    one torch.profiler trace: every call runs once untraced-by-count
    first (the profiler can lose the first kernels it sees), then once in
    a window of its own, synchronised, so each kernel belongs to the last
    window that began before it."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _, fn in calls[:1]:
            fn()
        torch.cuda.synchronize()
        for name, fn in calls:
            with torch.profiler.record_function(f"window:{name}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    starts = sorted((e.time_range.start, e.name[len("window:"):])
                    for e in events if e.name.startswith("window:") and
                    e.device_type == torch.autograd.DeviceType.CPU)
    counts = {name: 0 for name, _ in calls}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA or
                e.name.startswith("window:")):
            continue
        k = bisect.bisect_right(starts, (e.time_range.start, "\uffff"))
        if k:
            counts[starts[k - 1][1]] += 1
    return counts


def _events_ms(fn, calls: int = PREFILL_TIMED_CALLS) -> float:
    """ms a call from CUDA events around ``calls`` calls, host enqueue
    included (an eager prefill's launches are host-bound)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _prefill_case(engine: ContinuousBatcher, kind: str, bucket: int,
                  rng) -> tuple:
    """Arguments for one real prefill of ``kind`` at ``bucket`` on an
    idle engine, pushed; returns (state tensors the prefill writes, the
    active part of each as a boolean row mask, or None for the whole
    tensor). paged: a prompt of bucket - 3 tokens into pages 1..;
    shared: page 0 first filled by a paged prefill of 64 tokens, then a
    suffix after that one-page prefix into pages 1..; draft: slot 0 of
    the draft cache."""
    page, length = engine.page_size, engine.max_decode_len
    scratch, vocab = engine._scratch_page, engine.config.vocab_size
    body = type(engine)._prefill_body  # not the counting wrapper
    if kind == "shared":
        engine._set_prefill_args(
            tokens=rng.integers(0, vocab, page).tolist(), len=page,
            pages=[0] + [scratch] * (engine.max_blocks - 1))
        engine._push_prefill_args()
        body(engine, "paged", engine._bucket_length(page))
        n = min(bucket - 3, length - 1 - page)
        engine._set_prefill_args(
            suffix=rng.integers(0, vocab, bucket).tolist(), start=page,
            len=page + n, prefix=[0] + [scratch] * (length // page - 1))
    else:
        n = bucket - 3
        engine._set_prefill_args(
            tokens=rng.integers(0, vocab, bucket).tolist(), len=n, slot=0)
    blocks = -(-n // page)
    engine._set_prefill_args(pages=list(range(1, blocks + 1)) +
                             [scratch] * (engine.max_blocks - blocks))
    engine._push_prefill_args()
    written = []
    if kind == "draft":
        for layer in engine._draft_cache:
            for key, t in layer.items():
                written.append((t[0] if key != "index" else t, n))
        return written
    for layer in engine.cache:
        for key in ("k_pages", "v_pages", "k_page_scales", "v_page_scales"):
            if key in layer:
                rows = layer[key][1:blocks + 1].flatten(0, 1)
                written.append((rows, n))
    return written


def prefill_check(name, engine: ContinuousBatcher,
                  timed: bool = True) -> dict:
    """Phase (p) on one warmed engine: for every captured prefill, a
    replay against an eager run of the same prefill on the same pushed
    arguments, bit for bit in the logits and in the cache rows it writes
    (the live ones: rows of the prompt, not the padding); then, when
    ``timed``, each one's ms a call, replayed and eager (CUDA events),
    and the device kernels each launches (its argument push, one copy,
    included in both)."""
    rng = np.random.default_rng(6)
    rows, calls = {}, []
    for kind, bucket in sorted(engine._prefill_graphs,
                               key=lambda k: (k[1], k[0])):
        graph, out = engine._prefill_graphs[(kind, bucket)]
        written = _prefill_case(engine, kind, bucket, rng)

        def snap():
            return [t[:n].clone() for t, n in written]
        graph.replay()
        replayed, replayed_state = out.clone(), snap()
        eager = type(engine)._prefill_body(engine, kind, bucket).clone()
        eager_state = snap()
        same = (torch.equal(replayed, eager) and
                all(torch.equal(a, b) for a, b in
                    zip(replayed_state, eager_state)))
        require(same and bool(torch.isfinite(eager).all()),
                f"{name} prefill {kind} {bucket}: replay differs from eager")
        key = f"{kind}_{bucket}"
        if not timed:
            rows[key] = {"bit_identical": True}
            continue
        eager_call = functools.partial(type(engine)._prefill_body, engine,
                                       kind, bucket)
        rows[key] = {"replay_ms": _events_ms(graph.replay),
                     "eager_ms": _events_ms(eager_call),
                     "bit_identical": True}
        args = engine._pf_host.copy()

        def with_args(fn, args=args):
            # This case's arguments (the buffer holds the last case's).
            def call():
                engine._pf_host[:] = args
                engine._push_prefill_args()
                fn()
            return call
        calls += [(f"{key}:replay", with_args(graph.replay)),
                  (f"{key}:eager", with_args(eager_call))]
    if not timed:
        return rows
    kernels = _profile_windows(calls)
    for key, row in rows.items():
        row["replay_kernels"] = kernels[f"{key}:replay"]
        row["eager_kernels"] = kernels[f"{key}:eager"]
        require(row["replay_kernels"] > 0,
                f"{name} prefill {key}: the replay launched nothing")
    return rows


def prefill_graphs(device) -> dict:
    """Phase (p): bench_serving's paged page-64 engine and (s3)'s
    speculative engine (paged int8 target, int8 dense draft) must warm
    every bucket from 16 to 512 and hold a captured prefill for each
    (the paged prefill, the shared-prefix suffix prefill, the draft's);
    a second paged engine warmed by precompile() must hold the first
    one's graphs and have burned no request (warm_from_shapes); each
    replay equal to eager bit for bit (prefill_check); then traffic
    through each engine captures nothing and runs no prefill eagerly."""
    out, keys = {}, {}
    for name, build in (
            ("paged", lambda: build_bench_engine("paged", device)),
            ("s3", lambda: build_bench_speculative_engine("paged_int8",
                                                          device)),
            ("paged_aot", lambda: build_bench_engine("paged", device))):
        started = time.perf_counter()
        engine = build()
        if name == "paged_aot":
            warmed, live = warm_from_shapes(f"prefill {name}", engine,
                                            keys["paged"])
            row = {"precompile": warmed}
        else:
            warmed, live = warm(f"prefill {name}", engine)
            require(warmed["buckets"] == ALL_BUCKETS,
                    f"prefill {name}: buckets {warmed['buckets']}")
            row = {"warmup": warmed}
        keys[name] = sorted(engine._prefill_graphs)
        # The precompiled engine's graphs are the paged one's: held bit
        # for bit, not timed again.
        row["graphs"] = prefill_check(f"prefill {name}", engine,
                                      timed=name != "paged_aot")
        live["eager_prefills"] = 0  # the check's eager runs are its own
        # Traffic after the checks: every admission a replay.
        payloads = load_requests(8, 16.0, (16, 300), (4, 8),
                                 MODEL["vocab_size"], seed=5)[1]
        for p in payloads:
            engine.submit(Request(p["request_id"], p["prompt"],
                                  p["max_new_tokens"]))
        done = 0
        while engine.pending():
            done += len(engine.step())
        require(done == len(payloads), f"prefill {name}: {done} finished")
        require_replayed(f"prefill {name}", live)
        row["seconds"] = time.perf_counter() - started
        print(f"prefill_graphs {name} " + json.dumps(row), flush=True)
        out[name] = row
        del engine
        torch.cuda.empty_cache()
    return out


# bench.py bench_serving_fleet, whole: 2 replicas sharing one parameter
# set behind the router, the bench_serving model in bf16 on a dense cache,
# 64 requests at 24 Hz, prompts and generations of 64-128 tokens, seed 0.
FLEET_REPLICAS, FLEET_REQUESTS, FLEET_RATE_HZ = 2, 64, 24.0
FLEET_RECHECKED = 4


def _recorded(engines) -> dict:
    """Every token the engines emit, by request id and index (each
    engine's on_token wrapped; the front end's hook still runs)."""
    streams = collections.defaultdict(dict)
    for engine in engines:
        emit = engine.on_token

        def record(request_id, token, index, emit=emit):
            streams[request_id][index] = token
            emit(request_id, token, index)
        engine.on_token = record
    return streams


def _fleet_up(engines, router_kwargs=None, front_kwargs=None):
    from batch_shipyard_tpu_torch.models.router import ServingRouter
    fronts = [ServingFrontEnd(engine, port=0, **(front_kwargs or {}))
              for engine in engines]
    streams = _recorded(engines)
    for front in fronts:
        front.start()
    router = ServingRouter([f.url for f in fronts],
                           **(router_kwargs or {})).start()
    return fronts, router, streams


def _fleet_down(fronts, router) -> None:
    router.shutdown()
    for front in fronts:
        try:
            front.shutdown()
        except OSError:
            pass


def fleet(device) -> dict:
    """Phase (f): bench_serving_fleet as written through the port's
    router. Every request must finish, both replicas must be dispatched
    to, traffic must capture nothing and prefill nothing eagerly, and
    FLEET_RECHECKED of the requests run again offline on one replica
    must stream the tokens the fleet streamed."""
    started = time.perf_counter()
    config = tfm.TransformerConfig(**MODEL, max_seq_len=MAX_LEN,
                                   dtype=torch.bfloat16)
    params = bench_params(config, device, 0)
    engines, watched = [], []
    for i in range(FLEET_REPLICAS):
        engine = ContinuousBatcher(config, params, num_slots=SLOTS,
                                   max_decode_len=MAX_LEN, device=device)
        warmed, live = warm(f"fleet replica {i}", engine)
        engines.append(engine)
        watched.append(live)
    warm_s = time.perf_counter() - started
    fronts, router, streams = _fleet_up(
        engines, router_kwargs=dict(health_interval=1.0))
    try:
        for front in fronts:
            front.generate({"prompt": [1, 2, 3], "max_new_tokens": 2})
        report = run_load(router.url, FLEET_REQUESTS, rate_hz=FLEET_RATE_HZ,
                          prompt_len=(MAX_LEN // 8, MAX_LEN // 4),
                          max_new_tokens=(MAX_LEN // 8, MAX_LEN // 4),
                          vocab_size=MODEL["vocab_size"], seed=0)
        stats = router.stats()
    finally:
        _fleet_down(fronts, router)
    torch.cuda.synchronize()
    for i, live in enumerate(watched):
        require_replayed(f"fleet replica {i}", live)
    dispatched = [s["dispatched"] for s in stats["per_replica"]]
    require(report["completed"] == FLEET_REQUESTS and report["failed"] == 0,
            f"fleet: {report['failed']} failed: {report.get('errors')}")
    require(all(n > 0 for n in dispatched),
            f"fleet: a replica got no request: {dispatched}")
    payloads = load_requests(FLEET_REQUESTS, FLEET_RATE_HZ,
                             (MAX_LEN // 8, MAX_LEN // 4),
                             (MAX_LEN // 8, MAX_LEN // 4),
                             MODEL["vocab_size"], seed=0)[1]
    again = payloads[:FLEET_RECHECKED]
    for p in again:
        engines[0].submit(Request(p["request_id"], p["prompt"],
                                  p["max_new_tokens"]))
    offline = {}
    while engines[0].pending():
        for rid, tokens in engines[0].step():
            offline[rid] = tokens
    for p in again:
        rid = p["request_id"]
        fleet_tokens = [streams[rid][i] for i in range(len(streams[rid]))]
        require(offline[rid] == fleet_tokens,
                f"fleet: {rid} streamed other tokens offline")
    row = {"replicas": FLEET_REPLICAS, "completed": report["completed"],
           "failed": report["failed"],
           "ttft_ms": report["ttft_exact_ms"],
           "tpot_ms": report["tpot_exact_ms"],
           "tokens_per_second": report["tokens_per_second"],
           "generated_tokens": report["generated_tokens"],
           "elapsed_seconds": report["elapsed_seconds"],
           "rechecked_offline": len(again),
           "router": {k: stats[k] for k in (
               "dispatched", "completed", "failed", "affinity_routed",
               "recoveries", "lost_streams", "ttft_ms", "tpot_ms")},
           "dispatched_by_replica": dispatched,
           "warmup_seconds": warm_s,
           "seconds": time.perf_counter() - started}
    print("fleet " + json.dumps(row), flush=True)
    del engines, fronts, router
    torch.cuda.empty_cache()
    return row


# Phase (r): two fp32 replicas of the bench_serving widths on paged
# page-64 caches (K6) behind the router, each engine step slowed by
# FAILOVER_STEP_DELAY_S (the serving drill's throttle) so that the faults
# land mid-stream; FAILOVER_REQUESTS streams of 64-128 + 64-128 tokens.
FAILOVER_REQUESTS, FAILOVER_STEP_DELAY_S = 8, 0.02
FAILOVER_GRACE_S = 0.3


class _StreamClient(collections.namedtuple("_StreamClient",
                                           "thread tokens indexes final")):
    """One streaming client of the router: token and index lines as they
    arrive, then the final object."""


def _stream_client(url: str, payload: dict) -> _StreamClient:
    import urllib.request
    tokens, indexes, final = [], [], []

    def run():
        req = urllib.request.Request(
            f"{url}/v1/generate",
            data=json.dumps(dict(payload, stream=True)).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            for line in resp:
                event = json.loads(line)
                if "index" in event:
                    tokens.append(event["token"])
                    indexes.append(event["index"])
                else:
                    final.append(event)
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return _StreamClient(thread, tokens, indexes, final)


def _throttle(engine: ContinuousBatcher, delay: float) -> None:
    step = engine.step

    def slow_step():
        time.sleep(delay)
        return step()
    engine.step = slow_step


def reprefill_vs_decode(engine: ContinuousBatcher, payloads: list,
                        streams: dict) -> float:
    """The largest |logit difference| between a token's logits through
    the prefill path (one batch-1 insert of its whole context, as a
    resume re-prefills prompt + emitted tokens) and through decode steps
    (K6 over a paged cache filled one token a step), teacher-forced on
    the undisturbed streams, at the positions whose logits pick a
    generated token: the near-tie bound of a resumed stream."""
    dev = engine.device
    seqs = [p["prompt"] + streams[p["request_id"]] for p in payloads]
    batch, steps = len(seqs), max(map(len, seqs))
    model, dense = engine.model, engine._dense_model
    vocab = engine.config.vocab_size
    prefill = torch.zeros((batch, steps, vocab), device=dev)
    read = torch.zeros((batch, steps), dtype=torch.bool, device=dev)
    with torch.no_grad():
        for b, seq in enumerate(seqs):
            small = inf.init_cache(dense, 1)
            hidden = dense(torch.tensor([seq], dtype=torch.int32,
                                        device=dev),
                           positions=torch.arange(len(seq), device=dev,
                                                  dtype=torch.int32),
                           cache=small, return_hidden=True)
            prefill[b, :len(seq)] = inf.last_token_logits(dense, hidden[0])
            read[b, len(payloads[b]["prompt"]) - 1:len(seq) - 1] = True
        pages = -(-steps // PAGE)
        cfg = dataclasses.replace(model.config,
                                  kv_num_pages=batch * pages + 1)
        cache = inf.init_cache(types.SimpleNamespace(
            config=cfg, embed=model.embed), batch)
        table = np.full((batch, engine.max_blocks), batch * pages, np.int32)
        table[:, :pages] = np.arange(batch * pages).reshape(batch, pages)
        cache[0]["block_table"].copy_(torch.from_numpy(table))
        padded = torch.tensor([s + [s[-1]] * (steps - len(s)) for s in seqs],
                              dtype=torch.int32, device=dev)
        worst = torch.zeros((), device=dev)
        for t in range(steps):
            logits = model(padded[:, t:t + 1], positions=torch.full(
                (batch, 1), t, dtype=torch.int32, device=dev),
                cache=cache)[:, 0].float()
            diff = (logits - prefill[:, t]).abs().amax(dim=-1)
            worst = torch.maximum(worst, torch.where(read[:, t], diff,
                                                     0.0).amax())
    worst = float(worst)
    require(math.isfinite(worst), "re-prefill vs decode: non-finite")
    return worst


def failover(device) -> dict:
    """Phase (r): (r1) a preempt notice to one replica mid-stream (its
    drain abandons the streams at FAILOVER_GRACE_S and the router resumes
    them on the sibling), (r2) kill() of one replica mid-stream. Each
    must lose no stream and deliver every token once, each assembled
    stream must equal the undisturbed fp32 engine's or part from it only
    at a near-tie (compare_streams, with reprefill_vs_decode's bound),
    and K6's wrapper must count the replicas' warm-up launches alone."""
    from batch_shipyard_tpu_torch.agent import preemption
    started = time.perf_counter()
    config = tfm.TransformerConfig(**MODEL, max_seq_len=MAX_LEN,
                                   dtype=torch.float32)
    params = bench_params(config, device, 0)

    def engine():
        return ContinuousBatcher(config, params, num_slots=SLOTS,
                                 max_decode_len=MAX_LEN, device=device,
                                 kv_page_size=PAGE)
    payloads = load_requests(FAILOVER_REQUESTS, 16.0,
                             (MAX_LEN // 8, MAX_LEN // 4),
                             (MAX_LEN // 8, MAX_LEN // 4),
                             MODEL["vocab_size"], seed=2)[1]
    reference = engine()
    want, margins = nonspec_reference(reference, payloads)
    bound = reprefill_vs_decode(reference, payloads, want)
    del reference
    rows = {"near_tie_bound": bound,
            "reference_seconds": time.perf_counter() - started}
    tmp = tempfile.TemporaryDirectory()
    try:
        for fault in ("r1_preempt", "r2_kill"):
            mark = time.perf_counter()
            reset_launch_counts()
            engines, watched = [], []
            for i in range(2):
                e = engine()
                warmed, live = warm(f"{fault} replica {i}", e)
                engines.append(e)
                watched.append(live)
            warm_launches = launch_counts()["paged_decode"]
            for e in engines:
                _throttle(e, FAILOVER_STEP_DELAY_S)
            fronts, router, _ = _fleet_up(
                engines, router_kwargs=dict(health_interval=0.5),
                front_kwargs=dict(drain_grace_s=FAILOVER_GRACE_S))
            notices = [str(pathlib.Path(tmp.name) / f"{fault}-{i}.json")
                       for i in range(2)]
            for front, notice in zip(fronts, notices):
                require(front.arm_preempt_drain(path=notice,
                                                poll_interval=0.05),
                        f"{fault}: preempt drain not armed")
            try:
                clients = {p["request_id"]: _stream_client(router.url, p)
                           for p in payloads}
                victim = fronts[0].url
                deadline = time.monotonic() + 120
                while not any(
                        len(c.tokens) >= 2 and
                        getattr(router._owner.get(rid), "url", None) ==
                        victim for rid, c in clients.items()):
                    require(time.monotonic() < deadline,
                            f"{fault}: no stream live on the victim")
                    time.sleep(0.01)
                live_on_victim = [
                    rid for rid, c in clients.items()
                    if getattr(router._owner.get(rid), "url", None) ==
                    victim and 0 < len(c.tokens) < len(want[rid])]
                if fault == "r1_preempt":
                    preemption.write_request(notices[0],
                                             reason="chip smoke")
                else:
                    fronts[0].kill()
                for c in clients.values():
                    c.thread.join(300)
                stats = router.stats()
            finally:
                _fleet_down(fronts, router)
            torch.cuda.synchronize()
            for i, live in enumerate(watched):
                require_replayed(f"{fault} replica {i}", live)
            got = {}
            for rid, c in clients.items():
                final = c.final[0] if c.final else {}
                require(not c.thread.is_alive() and "tokens" in final and
                        "error" not in final,
                        f"{fault}: {rid} lost: {final}")
                require(c.indexes == list(range(len(c.tokens))) and
                        c.tokens == final["tokens"],
                        f"{fault}: {rid} delivered a token twice or not "
                        f"at all: {c.indexes}")
                got[rid] = c.tokens
            streams = compare_streams(fault, got, want, margins, bound)
            require(stats["lost_streams"] == 0 and stats["recoveries"] >= 1,
                    f"{fault}: router {stats['recoveries']} recoveries, "
                    f"{stats['lost_streams']} lost")
            launches = launch_counts()["paged_decode"]
            expected = 2 * MODEL["n_layers"] * (
                warmed["eager_decode_steps"] + warmed["decode_captures"])
            require(launches == warm_launches == expected,
                    f"{fault}: K6 wrapper launches {launches}, at warm-up "
                    f"{warm_launches}, not {expected}")
            rows[fault] = {
                "streams": streams,
                "streamed_on_victim_at_fault": len(live_on_victim),
                "recoveries": stats["recoveries"],
                "recovered_requests": stats["recovered_requests"],
                "lost_streams": stats["lost_streams"],
                "recovery_seconds": [r["recovery_seconds"]
                                     for r in stats["recovery_log"]],
                "paged_decode_launches": launches,
                "seconds": time.perf_counter() - mark}
            print(f"failover {fault} " + json.dumps(rows[fault]),
                  flush=True)
            del engines, fronts, router
            torch.cuda.empty_cache()
    finally:
        tmp.cleanup()
    rows["seconds"] = time.perf_counter() - started
    return rows


# bench.py bench_serving_slo, whole: fp32, vocab 4096, d_model 256, 4
# layers of 4 heads of 64, d_ff 1024, 4 slots, max_decode_len 128, page 16
# (K6) over 4 x 8 + 2 x 6 + 4 pages; 24 requests at a diurnal 16 Hz peak
# (one virtual day of 20 s) with 2 shared 96-token prefixes, prompts of
# 9-16 tokens after them, 4-12 new; its three classes; both arms.
SLO_MODEL = dict(vocab_size=4096, d_model=256, n_layers=4, n_heads=4,
                 d_head=64, d_ff=1024)
SLO_SLOTS, SLO_MAX_LEN, SLO_PAGE, SLO_PREFIX = 4, 128, 16, 96
SLO_PAGES = SLO_SLOTS * (SLO_MAX_LEN // SLO_PAGE) + \
    2 * (SLO_PREFIX // SLO_PAGE) + 4
SLO_REQUESTS, SLO_RATE_HZ, SLO_DAY_S = 24, 16.0, 20.0
SLO_CLASSES = {"interactive": {"ttft_ms": 5000.0, "tpot_ms": 500.0},
               "standard": {"ttft_ms": 20000.0, "tpot_ms": 2000.0},
               "batch": {"ttft_ms": None, "tpot_ms": None}}


def slo_load(device) -> dict:
    """Phase (o): the same diurnal shared-prefix load through two
    engines that differ only in the prefix cache. Every request must
    finish, both arms must stream the same tokens (the sha256 over every
    request's tokens), the cache arm must hit, traffic must capture
    nothing and prefill nothing eagerly, and K6's wrapper must count the
    warm-up's launches alone."""
    started = time.perf_counter()
    config = tfm.TransformerConfig(**SLO_MODEL, max_seq_len=SLO_MAX_LEN,
                                   dtype=torch.float32)
    params = bench_params(config, device, 0)
    arms = {}
    for arm, prefix_cache in (("prefix_cache_on", True),
                              ("prefix_cache_off", False)):
        reset_launch_counts()
        engine = ContinuousBatcher(config, params, num_slots=SLO_SLOTS,
                                   max_decode_len=SLO_MAX_LEN,
                                   kv_page_size=SLO_PAGE,
                                   kv_num_pages=SLO_PAGES,
                                   prefix_cache=prefix_cache,
                                   device=device)
        warmed, live = warm(f"slo {arm}", engine)
        front = ServingFrontEnd(engine, port=0,
                                slo_classes=SLO_CLASSES).start()
        try:
            front.generate({"prompt": [1, 2, 3], "max_new_tokens": 2})
            report = run_load(
                front.url, SLO_REQUESTS, rate_hz=SLO_RATE_HZ,
                prompt_len=(9, 16), max_new_tokens=(4, 12),
                vocab_size=SLO_MODEL["vocab_size"], seed=0,
                arrival="diurnal", day_seconds=SLO_DAY_S,
                shared_prefix_groups=2, shared_prefix_len=SLO_PREFIX,
                slo_classes=SLO_CLASSES)
        finally:
            front.shutdown()
        torch.cuda.synchronize()
        require_replayed(f"slo {arm}", live)
        launches = launch_counts()["paged_decode"]
        expected = SLO_MODEL["n_layers"] * (warmed["eager_decode_steps"] +
                                            warmed["decode_captures"])
        require(report["completed"] == SLO_REQUESTS and
                report["failed"] == 0,
                f"slo {arm}: {report['failed']} failed: "
                f"{report.get('errors')}")
        require(launches == expected,
                f"slo {arm}: K6 wrapper launches {launches}, not {expected}")
        arms[arm] = {
            "completed": report["completed"], "shed": report["shed"],
            "outputs_sha256": report["outputs_sha256"],
            "ttft_mean_ms": report["ttft_mean_ms"],
            "ttft_exact_ms": report["ttft_exact_ms"],
            "tpot_mean_ms": report["tpot_mean_ms"],
            "attainment": {
                name: {k: c[k] for k in ("requests", "ttft_attainment",
                                         "tpot_attainment")}
                for name, c in report["slo_attainment"].items()},
            "prefix_cache": engine.prefix_stats(),
            "paged_decode_launches": launches,
            "warmup_buckets": warmed["buckets"]}
        del engine
    on, off = arms["prefix_cache_on"], arms["prefix_cache_off"]
    require(on["outputs_sha256"] == off["outputs_sha256"],
            "slo: the prefix-cache arms streamed different tokens")
    require(on["prefix_cache"]["hit_tokens"] > 0,
            f"slo: no prefix hit {on['prefix_cache']}")
    row = {**arms, "outputs_identical": True,
           "ttft_mean_delta_ms": on["ttft_mean_ms"] - off["ttft_mean_ms"],
           "ttft_p99_delta_ms": (on["ttft_exact_ms"]["p99"] -
                                 off["ttft_exact_ms"]["p99"]),
           "seconds": time.perf_counter() - started}
    print("slo_load " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    return row


def serving_tier(device) -> dict:
    """Phases (p), (f), (r) and (o), with their seconds."""
    rows = {}
    for name, phase in (("prefill_graphs", prefill_graphs),
                        ("fleet", fleet), ("failover", failover),
                        ("slo_load", slo_load)):
        started = time.perf_counter()
        rows[name] = phase(device)
        rows[f"{name}_seconds"] = time.perf_counter() - started
    print("serving_tier seconds " + json.dumps(
        {k: v for k, v in rows.items() if k.endswith("_seconds")}),
        flush=True)
    return rows


# ------------------------- vision (v1)-(v3) ---------------------------


# (v1) bench_resnet's shape (bench.py:54-101): ResNet-50 at batch 256,
# 224x224, bf16, through train_resnet; (v2) dp 2 on this card; (v3) ViT-B/16
# at 224 and 256 and the DiT at its defaults.
RESNET_WARMUP, RESNET_STEPS = 3, 10
RESNET_FP32_BATCH = 8
# One fp32 step on the card against the same step on the CPU, from the
# same weights and batch: the loss, the parameters' updates (new - old,
# all tensors as one vector) and the running statistics after the step,
# each relative (L2). With the card's own CUDA convolutions (cuDNN off)
# the step is held to RESNET_FP32_RTOL: the rest is the port's arithmetic,
# fp32 in a different order. cuDNN's fp32 convolutions (the bf16 path's
# library, here in fp32) round the update at about 1e-3 of its norm on
# the H100 with TF32 off (printed beside it): held to RESNET_CUDNN_RTOL.
# A per-element reading is not stable: sum(dy * xhat) of a late bn3's
# scale nearly cancels.
RESNET_FP32_RTOL = 1e-4
RESNET_CUDNN_RTOL = 3e-3
RESNET_DP, RESNET_DP_BATCH, RESNET_DP_WARMUP, RESNET_DP_STEPS = 2, 32, 2, 2
RESNET_DP_TIMEOUT_S = 300.0
# dp 2 against one rank on the same 64 images: every loss within 2^-8
# relative (bf16 rounds each rank's rows and the one rank's alike, but
# the statistics' sums and cuDNN's algorithms differ).
RESNET_DP_LOSS_RTOL = 2.0 ** -8
VIT_RUNS = {"vit224": 224, "vit256": 256}
VIT_BATCH, DIT_BATCH = 128, 64
VISION_WARMUP, VISION_STEPS = 2, 5
DIT_SAMPLES, DIT_SAMPLE_STEPS = 4, 50
VIT_LAYERS, DIT_LAYERS = 12, 8
# One step's gradients of the kernel model against the plain bf16 model
# (blockwise attention in K1/K2's place) and an fp32 plain model with
# the same weights, at batch 2: TRAIN_SLACK times the plain model's
# distance, as train_numerics (TRAIN_FLOOR_MAX bounds that floor).
VISION_NUMERICS_BATCH = 2
# Steps each (v1)/(v3) run profiles after its timed ones (the workloads'
# --profile-steps: train_profile runs them timed, then WARMUP_STEPS and
# them again under the profiler), and the flash launches those add.
VISION_PROFILE_STEPS = 1
VISION_PROFILE_RUNS = 2 * VISION_PROFILE_STEPS + train_profile.WARMUP_STEPS


def _profile_line(name: str, report: dict) -> dict:
    """Print and return the profiled steps' breakdown (rank 0's)."""
    prof = report["per_rank"][0]["profile"]
    row = {k: prof[k] for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                                "device_idle_share",
                                "kernel_launches_per_step",
                                "library_gemm_ms_per_step",
                                "top_kernels_ms_per_step")}
    row["flash_ms_per_step"] = {k: prof["kernel_ms_per_step"][k]
                                for k in ("flash_fwd", "flash_bwd")}
    print(f"vision {name} profile " + json.dumps(row), flush=True)
    return row


def _bench_line(name: str, report: dict, smi: str) -> None:
    mfu_pct = report["mfu_pct"]
    mfu_text = ("none (no FLOPs model)" if mfu_pct is None
                else f"{mfu_pct:.2f} %")
    print(f"vision {name}: {report['images_per_sec_per_card']:.1f} img/s "
          f"a card ({report['images_per_sec']:.1f} total, "
          f"{report['ranks']} rank(s) on {report['cards']} card(s)), "
          f"{report['ms_per_step']:.2f} ms/step, MFU {mfu_text}, peak "
          f"{report['peak_mem_gb']:.2f} GB, on {smi}", flush=True)


def _falling(name: str, losses: list) -> None:
    require(all(math.isfinite(x) for x in losses),
            f"{name}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"{name}: loss did not fall {losses}")


def resnet_bench(smi: str) -> dict:
    """(v1) train_resnet at bench_resnet's shape: img/s a card, ms/step,
    MFU, peak memory; a finite, falling loss."""
    from batch_shipyard_tpu_torch.workloads import train_resnet
    argv = ["--batch-per-device", str(train_resnet.BENCH_RESNET_BATCH),
            "--image-size", str(train_resnet.BENCH_RESNET_IMAGE),
            "--warmup", str(RESNET_WARMUP), "--steps", str(RESNET_STEPS),
            "--profile-steps", str(VISION_PROFILE_STEPS)]
    rc, report, lines = run_workload(argv, main=train_resnet.main)
    require(rc == 0, f"train_resnet: rc {rc}")
    print(lines[-2], flush=True)
    _falling("resnet50", report["losses"])
    require(report["mfu_pct"] is not None, "resnet50: no MFU on the card")
    _bench_line("v1 resnet50 b256", report, smi)
    report["profile"] = _profile_line("v1 resnet50 b256", report)
    return report


def resnet_fp32_check(device) -> dict:
    """(v1') One fp32 step of ResNet-50 at batch 8, 224x224, on the card
    (TF32 off, as main() sets it), with the card's CUDA convolutions and
    with cuDNN's, each against the same step on the CPU."""
    from batch_shipyard_tpu_torch.models import resnet as resnet_mod
    from batch_shipyard_tpu_torch.workloads import train_resnet
    config = resnet_mod.ResNetConfig(dtype=torch.float32)
    require(not torch.backends.cudnn.allow_tf32, "resnet fp32: TF32 on")
    cpu = train_mod.build_resnet_train(config, RESNET_FP32_BATCH,
                                       device="cpu")
    before = cpu.state_dict()
    batch = train_resnet.synthetic_batch(RESNET_FP32_BATCH, 224, 1000, 1)
    batch["images"] = batch["images"].float()
    loss_cpu = float(cpu.step(batch)["loss"])
    want = cpu.state_dict()
    names = [n for n, _ in cpu.model.named_parameters()]
    buffers = [n for n in want if n not in names]

    def flat(state, keys, minus=None):
        return torch.cat([(state[n].cpu() - (0 if minus is None
                                             else minus[n])).reshape(-1)
                          for n in keys])

    def rel(a, b):
        return _rel(a, b, torch.linalg.vector_norm)
    row = {"loss_cpu": loss_cpu,
           "tol": {"cuda": RESNET_FP32_RTOL, "cudnn": RESNET_CUDNN_RTOL}}
    saved = torch.backends.cudnn.enabled
    try:
        for name, cudnn in (("cuda", False), ("cudnn", True)):
            torch.backends.cudnn.enabled = cudnn
            card = train_mod.build_resnet_train(
                config, RESNET_FP32_BATCH, device=device, params=before)
            loss = float(card.step({k: t.to(device) for k, t in
                                    batch.items()})["loss"])
            got = card.state_dict()
            row[name] = {
                "loss_card": loss,
                "loss_rel": abs(loss - loss_cpu) / abs(loss_cpu),
                "update_rel_l2": rel(flat(got, names, before),
                                     flat(want, names, before)),
                "stats_rel_l2": rel(flat(got, buffers),
                                    flat(want, buffers))}
            del card, got
    finally:
        torch.backends.cudnn.enabled = saved
    print("vision v1 resnet50 fp32 card vs cpu " + json.dumps(row),
          flush=True)
    for name in ("cuda", "cudnn"):
        require(max(row[name]["loss_rel"], row[name]["update_rel_l2"],
                    row[name]["stats_rel_l2"]) <= row["tol"][name],
                f"resnet50 fp32 ({name} convolutions): the card's step "
                f"is not the CPU's: {row}")
    torch.cuda.empty_cache()
    return row


def resnet_dp(smi: str) -> dict:
    """(v2) train_resnet over dp 2 (two ranks with torch.distributed.run's
    env, distributed.launch_local), both time-sliced on this card,
    against one rank on the same 64 images:
    losses within 2^-8, the parameters and the running statistics equal
    across the ranks; the ring calls a step by label."""
    from batch_shipyard_tpu_torch.models import resnet as resnet_mod
    from batch_shipyard_tpu_torch.workloads import train_resnet
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flags = ["--warmup", str(RESNET_DP_WARMUP), "--steps",
             str(RESNET_DP_STEPS)]
    runs = distributed.launch_local(
        [sys.executable, "-m",
         "batch_shipyard_tpu_torch.workloads.train_resnet",
         "--batch-per-device", str(RESNET_DP_BATCH), *flags],
        RESNET_DP, RESNET_DP_TIMEOUT_S,
        cwd=pathlib.Path(__file__).resolve().parent)
    for run in runs:
        require(run["returncode"] == 0 and not run["timed_out"],
                f"train_resnet dp {RESNET_DP}: rank {run['rank']} rc "
                f"{run['returncode']}: {run['stderr'][-4000:]}")
    lines = runs[0]["stdout"].strip().splitlines()
    require(len(lines) >= 2, f"train_resnet dp: rank 0 printed {lines}")
    print(lines[-2], flush=True)
    dp = json.loads(lines[-1])
    rc1, one, _ = run_workload(
        ["--batch-per-device", str(RESNET_DP * RESNET_DP_BATCH), *flags],
        main=train_resnet.main)
    require(rc1 == 0, f"train_resnet one rank: rc {rc1}")
    _falling("resnet50 dp", dp["losses"])
    rel = max(abs(a - b) / abs(b) for a, b in zip(dp["losses"],
                                                  one["losses"]))
    n_bn = len(resnet_mod.resnet50().batch_norms())
    per_step = dp["ring_calls_per_step"]
    row = {"losses_dp": dp["losses"], "losses_one_rank": one["losses"],
           "max_loss_rel": rel, "tol": RESNET_DP_LOSS_RTOL,
           "ring_calls_per_step": per_step,
           "launches_per_step_by_rank": [r["launches_per_step"]
                                         for r in dp["per_rank"]],
           "params_sha256": [r["params_sha256"] for r in dp["per_rank"]],
           "buffers_sha256": [r["buffers_sha256"] for r in dp["per_rank"]],
           "images_per_sec_per_card": dp["images_per_sec_per_card"],
           "ms_per_step": dp["ms_per_step"],
           "peak_mem_gb": dp["peak_mem_gb"], "mfu_pct": dp["mfu_pct"]}
    print("vision v2 resnet50 dp2 " + json.dumps(row), flush=True)
    _bench_line("v2 resnet50 dp2 b32x2", dp, smi)
    require(rel <= RESNET_DP_LOSS_RTOL,
            f"resnet dp: losses off the one-rank run's: {row}")
    require(len(set(row["params_sha256"])) == 1 and
            len(set(row["buffers_sha256"])) == 1,
            f"resnet dp: ranks hold different parameters or statistics")
    require(per_step == {"bn_stats": n_bn, "bn_grads": n_bn, "grads": 1},
            f"resnet dp: ring calls a step {per_step}")
    for launches in row["launches_per_step_by_rank"]:
        for key in ("ring_all_gather", "ring_reduce_scatter"):
            require(launches.get(key) == 2 * n_bn + 1,
                    f"resnet dp: {key} launches a step {launches}")
    return row


def _vision_grads(model, loss_fn) -> tuple[float, torch.Tensor]:
    params = list(model.parameters())
    loss = loss_fn(model)
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), torch.cat([g.float().reshape(-1)
                                            for g in grads])


def vision_numerics(kind: str, config, state: dict, inputs: dict,
                    device) -> dict:
    """One step's gradients of the kernel model (K1/K2) against the plain
    bf16 model (blockwise attention in their place) and an fp32 plain
    model, on the same weights and inputs: the rule of train_numerics."""
    from batch_shipyard_tpu_torch.models import diffusion as dif_mod
    from batch_shipyard_tpu_torch.models import vit as vit_mod
    build = vit_mod.ViT if kind == "vit" else dif_mod.DiT

    def loss_fn(model):
        if kind == "vit":
            return vit_mod.cross_entropy_loss(model(inputs["images"]),
                                              inputs["labels"])
        return dif_mod.diffusion_loss(model, inputs["images"],
                                      t=inputs["t"], noise=inputs["noise"])
    results = {}
    kernel_attention = attn_ops.attention
    for name, dtype, impl in (("kernel", torch.bfloat16, None),
                              ("plain", torch.bfloat16, "blockwise"),
                              ("fp32", torch.float32, "blockwise")):
        model = build(dataclasses.replace(config, dtype=dtype),
                      device=device)
        model.load_state_dict(state)
        before = dict(attn_ops.launches)
        # The plain models: the blockwise softmax in the kernels' place.
        attn_ops.attention = (kernel_attention if impl is None else
                              functools.partial(kernel_attention, impl=impl))
        try:
            results[name] = _vision_grads(model, loss_fn)
        finally:
            attn_ops.attention = kernel_attention
        ran = attn_ops.launches["flash_fwd"] - before["flash_fwd"]
        require(ran == (config.n_layers if impl is None else 0),
                f"{kind} numerics: {ran} K1 launches in the {name} model")
        del model
    (loss_k, grad_k), (loss_p, grad_p), (loss_f, grad_f) = (
        results[n] for n in ("kernel", "plain", "fp32"))

    def rel(a, b):
        return _rel(a, b, torch.linalg.vector_norm)
    floor = rel(grad_p, grad_f)
    row = {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_fp32": loss_f,
           "grad_kernel_vs_fp32": rel(grad_k, grad_f),
           "grad_kernel_vs_plain": rel(grad_k, grad_p),
           "grad_plain_vs_fp32": floor}
    require(all(math.isfinite(x) for x in row.values()),
            f"{kind} numerics: non-finite {row}")
    require(floor <= TRAIN_FLOOR_MAX,
            f"{kind} numerics: plain bf16 vs fp32 gradients {row}")
    require(row["grad_kernel_vs_fp32"] <= TRAIN_SLACK * floor,
            f"{kind} numerics: kernel gradients off by more than bf16 "
            f"rounding: {row}")
    torch.cuda.empty_cache()
    return row


def vit_run(name: str, image_size: int, device, smi: str) -> dict:
    """(v3) ViT-B/16 at ``image_size`` through train_vit, B128: exactly
    VIT_LAYERS K1 and K2 launches a step; the numerics rule at batch 2."""
    from batch_shipyard_tpu_torch.models import vit as vit_mod
    from batch_shipyard_tpu_torch.workloads import train_vit
    config = vit_mod.ViTConfig(image_size=image_size)
    steps = VISION_WARMUP + VISION_STEPS + VISION_PROFILE_RUNS
    rc, report, lines = run_workload(
        ["--batch-per-device", str(VIT_BATCH), "--image-size",
         str(image_size), "--warmup", str(VISION_WARMUP), "--steps",
         str(VISION_STEPS), "--seed", "0", "--profile-steps",
         str(VISION_PROFILE_STEPS)], main=train_vit.main)
    require(rc == 0, f"train_vit {name}: rc {rc}")
    print(lines[-2], flush=True)
    launches = dict(attn_ops.launches)
    _falling(name, report["losses"])
    require(launches == {"flash_fwd": VIT_LAYERS * steps,
                         "flash_bwd": VIT_LAYERS * steps},
            f"{name}: {launches} flash launches in {steps} steps")
    report["launches_run"] = launches
    model = vit_mod.ViT(config, device=device)
    vit_mod.init_params(model, torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(5)
    inputs = {"images": torch.randn(VISION_NUMERICS_BATCH, image_size,
                                    image_size, 3, generator=gen,
                                    device=device),
              "labels": torch.randint(0, 1000, (VISION_NUMERICS_BATCH,),
                                      generator=gen, device=device)}
    report["numerics"] = vision_numerics("vit", config, model.state_dict(),
                                         inputs, device)
    print(f"vision v3 {name} numerics " + json.dumps(report["numerics"]),
          flush=True)
    _bench_line(f"v3 {name} b{VIT_BATCH} t{config.num_patches}", report,
                smi)
    report["profile"] = _profile_line(name, report)
    del model
    return report


def dit_run(device, smi: str) -> dict:
    """(v3) the DiT at its defaults through train_diffusion, B64, then
    DDIM sampling: exactly DIT_LAYERS K1 and K2 launches a step (and K1
    DIT_LAYERS times a sampling step); finite samples; the numerics
    rule at batch 2."""
    from batch_shipyard_tpu_torch.models import diffusion as dif_mod
    from batch_shipyard_tpu_torch.workloads import train_diffusion
    config = dif_mod.DiTConfig()
    steps = VISION_WARMUP + VISION_STEPS + VISION_PROFILE_RUNS
    rc, report, lines = run_workload(
        ["--batch-per-device", str(DIT_BATCH), "--warmup",
         str(VISION_WARMUP), "--steps", str(VISION_STEPS), "--sample",
         str(DIT_SAMPLES), "--sample-steps", str(DIT_SAMPLE_STEPS),
         "--profile-steps", str(VISION_PROFILE_STEPS)],
        main=train_diffusion.main)
    require(rc == 0, f"train_diffusion: rc {rc}")
    print("\n".join(lines[-3:-1]), flush=True)
    launches = dict(attn_ops.launches)
    require(all(math.isfinite(x) for x in report["losses"]),
            f"dit: non-finite loss {report['losses']}")
    require(launches == {
        "flash_fwd": DIT_LAYERS * (steps + DIT_SAMPLE_STEPS),
        "flash_bwd": DIT_LAYERS * steps},
        f"dit: {launches} flash launches in {steps} steps and "
        f"{DIT_SAMPLE_STEPS} sampling steps")
    samples = report["samples"]
    require(samples["finite"] and samples["shape"] == [DIT_SAMPLES, 32, 32,
                                                       3],
            f"dit: samples {samples}")
    report["launches_run"] = launches
    model = dif_mod.DiT(config, device=device)
    dif_mod.init_params(model, torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(6)
    with torch.no_grad():  # adaLN-Zero: give the gates and head weight
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device=device))
    shape = (VISION_NUMERICS_BATCH, 32, 32, 3)
    inputs = {"images": torch.tanh(torch.randn(shape, generator=gen,
                                               device=device)),
              "t": torch.randint(0, config.timesteps,
                                 (VISION_NUMERICS_BATCH,), generator=gen,
                                 device=device),
              "noise": torch.randn(shape, generator=gen, device=device)}
    report["numerics"] = vision_numerics("dit", config, model.state_dict(),
                                         inputs, device)
    print("vision v3 dit numerics " + json.dumps(report["numerics"]),
          flush=True)
    _bench_line(f"v3 dit b{DIT_BATCH} t64", report, smi)
    report["profile"] = _profile_line("dit", report)
    del model
    return report


def vision(device, smi: str) -> dict:
    """Phase 6: the vision families, (v1)-(v3), and the phase's time."""
    started = time.perf_counter()
    torch.cuda.empty_cache()
    parts = {"resnet": lambda: resnet_bench(smi),
             "resnet_fp32": lambda: resnet_fp32_check(device),
             "resnet_dp": lambda: resnet_dp(smi),
             **{name: functools.partial(vit_run, name, size, device, smi)
                for name, size in VIT_RUNS.items()},
             "dit": lambda: dit_run(device, smi)}
    out, seconds = {}, {}
    for name, run in parts.items():
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - started
    out["seconds"] = seconds
    print(f"vision phase: {out['phase_s']:.1f} s " + json.dumps(seconds),
          flush=True)
    return out


# Phase 1's compile cache root, made afresh each run (build/ is ignored).
SMOKE_CACHE = _build.REPO_ROOT / "build" / "smoke_cache"


def install_library(path: pathlib.Path) -> None:
    """A library phase 1 built into the compile cache, copied into
    build/torch_kernels/ (atomically), where the ranks and workloads the
    script starts, which enable no cache, look for it under the same
    name; its log beside it."""
    for src, dst in ((path, _build.BUILD_DIR / path.name),
                     (_build.log_path(path),
                      _build.log_path(_build.BUILD_DIR / path.name))):
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_name(f"{dst.name}.{os.getpid()}.tmp")
        shutil.copy2(src, tmp)
        os.replace(tmp, dst)


# (w): bench.py bench_compile_warm's child model (bench.py:520-523: vocab
# 512, d 128, 2 layers, d_ff 256, B2 x T128, no remat) through the port's
# workload, at 2 heads of 64 where the bench has 4 of 32 (K1/K2 take
# depths 64 and 128), with its 5 steady steps after 1 warm-up step.
WARM_ARGS = ["--vocab", "512", "--d-model", "128", "--n-layers", "2",
             "--n-heads", "2", "--d-ff", "256", "--seq-len", "128",
             "--batch", "2", "--warmup", "1", "--steps", "5", "--no-remat"]


def _without_nvcc(env: dict, empty: pathlib.Path) -> dict:
    """``env`` with no nvcc to reach: PATH without any dir holding one,
    $CUDA_HOME an empty dir (ops/_build.nvcc_path looks in both)."""
    path = [d for d in env.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
    env = dict(env, PATH=os.pathsep.join(path), CUDA_HOME=str(empty))
    require(shutil.which("nvcc", path=env["PATH"]) is None and
            not (empty / "bin" / "nvcc").exists(),
            "warm start: nvcc still reachable for run 2")
    return env


# (n): (w)'s two runs, and a gang, as tasks of the port's own pool: a
# localhost pool (each node a ``python -m batch_shipyard_tpu_torch.agent``
# process, node prep on) of NODE_VM_SIZE nodes over a localfs store, all
# in a temp dir. The node agents' caches live in their work dirs
# (<work_dir>/compilecache, exported to tasks as
# $SHIPYARD_COMPILE_CACHE_DIR); the store carries the seed between them.
NODE_POOL_ID = "chipsmoke"
NODE_VM_SIZE = "a3-highgpu-1g"
NODE_TIMEOUT_S = 300.0
NODE_EXPORT_TIMEOUT_S = 60.0
GANG_INSTANCES = 2


def _node_pool(store, creds, work_root: pathlib.Path, nodes: int) -> dict:
    """``pool add`` of NODE_POOL_ID with ``nodes`` nodes on a fresh work
    root; it returns once every node is ready (node prep done). Checks
    each node's node-prep events: start, ``gpus:<n>`` with n this host's
    /dev/nvidia<N> count, ``torch_cuda_ready:True``, end."""
    from batch_shipyard_tpu_torch.agent import nodeprep, perf
    from batch_shipyard_tpu_torch.config import settings as settings_mod
    from batch_shipyard_tpu_torch.pool import manager as pool_mgr
    from batch_shipyard_tpu_torch.substrate.localhost import (
        LocalhostSubstrate)
    conf = {"pool_specification": {
        "id": NODE_POOL_ID, "substrate": "localhost",
        "vm_configuration": {"vm_size": NODE_VM_SIZE,
                             "vm_count": {"dedicated": nodes}},
        "inter_node_communication_enabled": True,
        "max_wait_time_seconds": NODE_TIMEOUT_S}}
    pool = settings_mod.pool_settings(conf)
    substrate = LocalhostSubstrate(store, creds, work_root=str(work_root),
                                   pool_config=conf, run_nodeprep=True)
    since = time.time()
    t0 = time.perf_counter()
    ready = pool_mgr.create_pool(store, substrate, pool,
                                 settings_mod.global_settings({}), conf)
    add_s = time.perf_counter() - t0
    gpus = nodeprep.detect_gpus()
    events = collections.defaultdict(list)
    for row in perf.query(store, NODE_POOL_ID):
        if row["source"] == "nodeprep" and row["timestamp"] >= since:
            events[row["node_id"]].append(row)
    prep = {}
    for node in ready:
        rows = events[node.node_id]
        seq = [row["event"] for row in rows]
        require(len(seq) >= 4 and seq[0] == "start" and seq[-1] == "end"
                and seq[1] == f"gpus:{gpus}" and gpus >= 1 and
                "torch_cuda_ready:True" in seq,
                f"node side: {node.node_id}'s node prep events {seq} "
                f"({[row.get('message') for row in rows]}); this host "
                f"has {gpus} /dev/nvidia<N>")
        prep[node.node_id] = {"events": seq, "seconds":
                              rows[-1]["timestamp"] - rows[0]["timestamp"]}
    require(len(prep) == nodes, f"node side: {len(ready)} nodes ready")
    return {"pool": pool, "substrate": substrate, "conf": conf,
            "work_root": work_root, "add_s": add_s, "node_prep": prep,
            "gpus": gpus}


def _node_job(store, node_pool: dict, job_id: str, command: str,
              env: dict, multi_instance: Optional[dict] = None) -> dict:
    """``jobs add`` of one task running ``command`` with ``env``, waited
    for; it must complete with exit code 0. Its row, the stdout of each
    instance, the seconds from the submit to the task's start and to its
    completion (the task row's clock), and its goodput events."""
    from batch_shipyard_tpu_torch.config import settings as settings_mod
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    task = {"id": "run", "command": command, "environment_variables": env}
    if multi_instance is not None:
        task["multi_instance"] = multi_instance
    jobs = settings_mod.job_settings_list(
        {"job_specifications": [{"id": job_id, "tasks": [task]}]})
    pool_id = node_pool["pool"].id
    jobs_mgr.add_jobs(store, node_pool["pool"], jobs)
    rows = jobs_mgr.wait_for_tasks(store, pool_id, job_id,
                                   timeout=NODE_TIMEOUT_S)
    row = rows[0]
    instances = [None] if multi_instance is None else list(
        range(multi_instance["num_instances"]))

    def output(name, k):
        try:
            return jobs_mgr.get_task_output(store, pool_id, job_id, "run",
                                            name, instance=k).decode()
        except Exception as exc:  # noqa: BLE001 - reported below
            return f"<{name}: {exc}>"

    require(row.get("state") == "completed" and row.get("exit_code") == 0,
            f"node side: job {job_id}: {row.get('state')} exit "
            f"{row.get('exit_code')} {row.get('error', '')}\n" + "\n".join(
                output("stderr.txt", k)[-3000:] for k in instances))
    submitted = gp_events.iso_to_epoch(row["submitted_at"])
    return {"row": row, "stdout": [output("stdout.txt", k)
                                   for k in instances],
            "submit_to_start_s":
                gp_events.iso_to_epoch(row["started_at"]) - submitted,
            "submit_to_complete_s":
                gp_events.iso_to_epoch(row["completed_at"]) - submitted,
            "events": gp_events.query(store, pool_id, job_id=job_id)}


def _node_cache(node_pool: dict, node_id: str) -> dict:
    """A node's cache entries by identity (name -> size)."""
    root = node_pool["work_root"] / NODE_POOL_ID / node_id / "compilecache"
    return {ident: cc_manager.snapshot(d) for ident, d in
            cc_manager.list_identity_dirs(str(root)).items()}


def _node_warm_run(store, node_pool: dict, job_id: str, command: str,
                   env: dict, before: dict) -> dict:
    """One of (w)'s runs as a task: its JSON line, the compile events it
    wrote (ingested by the agent), the cache entries it added on the node
    that ran it over ``before`` (identity -> entries) and its times."""
    job = _node_job(store, node_pool, job_id, command, env)
    node_id = job["row"]["node_id"]
    after = _node_cache(node_pool, node_id)
    added = sorted(entry for i, entries in after.items()
                   for entry in entries if entry not in before.get(i, {}))
    return {"report": json.loads(job["stdout"][0].strip().splitlines()[-1]),
            "added": added, "identities": sorted(after), "entries": after,
            "compile_events": [e.get("attrs", {}) for e in job["events"]
                               if e["kind"] == "compile"],
            "node_id": node_id,
            "submit_to_start_s": job["submit_to_start_s"],
            "submit_to_complete_s": job["submit_to_complete_s"]}


def _gang_launches(layers: int) -> dict:
    """What each rank of a dp-2 gang of train_transformer at WARM_ARGS
    (no remat, the fused loss) launches a step: K1 and K2 once a layer,
    K3-K5 once, and the data all-reduce (K14 then K13, over the data
    ring)."""
    want = {"flash_fwd": layers, "flash_bwd": layers, "xent_fwd": 1,
            "xent_bwd_h": 1, "xent_bwd_e": 1}
    for call in ("ring_reduce_scatter", "ring_all_gather"):
        want[call] = want[f"{call}.data"] = 1
    want["ring_all_reduce.data"] = 1
    return want


# A gang member's command: train_transformer at WARM_ARGS, then one line
# with the process group this instance joined (every rank prints it; rank
# 0's report comes before it). ``--no-compile-cache``: the ranks load
# phase 1's libraries from build/torch_kernels/ (a dp-2 identity would
# otherwise build its libraries on each node).
GANG_COMMAND = (
    "{python} -c 'import json, sys; import torch.distributed as dist; "
    "from batch_shipyard_tpu_torch.workloads import train_transformer; "
    "rc = train_transformer.main(sys.argv[1:]); print(json.dumps("
    "{{\"rank\": dist.get_rank(), \"process_count\": "
    "dist.get_world_size()}}), flush=True); sys.exit(rc)' {args} "
    "--no-compile-cache")


# (n5): the CLI leg. The port's operator entry point, one process per
# command, on a configdir in (n)'s temp dir: a cloud pool (``substrate:
# tpu_vm``) of one NODE_VM_SIZE node, whose gcloud is the stand-in below,
# and job 4, (w)'s warm run with no nvcc reachable.
CLI = [sys.executable, "-m", "batch_shipyard_tpu_torch.cli.main"]
CLI_TIMEOUT_S = 300.0
# How long a pool del from a fresh process is given for the agents the
# pool add process started to exit.
CLI_AGENT_EXIT_S = 5.0
AGENT_STOP_S = 15.0
CLOUD_PROJECT = "chipsmoke-project"
CLOUD_ZONE = "us-central1-a"
# The stand-in's canned answers: Compute Engine's GPU types in the zone
# and the region's quotas, in the shapes gcloud prints them
# (``accelerator-types list --format=json``, ``regions describe
# --format=json``).
CLOUD_ACCELERATOR_TYPES = [
    {"name": "nvidia-h100-80gb", "description": "NVIDIA H100 80GB",
     "maximumCardsPerInstance": 8,
     "zone": f"https://www.googleapis.com/compute/v1/projects/"
             f"{CLOUD_PROJECT}/zones/{CLOUD_ZONE}"},
    {"name": "nvidia-h100-mega-80gb", "description": "NVIDIA H100 Mega 80GB",
     "maximumCardsPerInstance": 8,
     "zone": f"https://www.googleapis.com/compute/v1/projects/"
             f"{CLOUD_PROJECT}/zones/{CLOUD_ZONE}"}]
CLOUD_REGION = {"name": "us-central1", "quotas": [
    {"metric": "CPUS", "limit": 2400.0, "usage": 0.0},
    {"metric": "NVIDIA_H100_GPUS", "limit": 16.0, "usage": 0.0},
    {"metric": "PREEMPTIBLE_NVIDIA_H100_GPUS", "limit": 64.0, "usage": 0.0},
    {"metric": "NVIDIA_H100_MEGA_GPUS", "limit": 8.0, "usage": 0.0}]}

# A stand-in for the gcloud CLI, test scaffolding of this script (no part
# of the package): ``compute instances create`` records its argv, decodes
# the boot template from the startup script, points its work_dir at the
# stand-in's state dir and starts the port's agent from it on this host,
# as the VM's boot would; ``describe`` answers RUNNING at 127.0.0.1;
# ``delete`` stops that agent; ``accelerator-types list`` and ``regions
# describe`` answer the canned JSON. Every call is appended to
# calls.jsonl in the state dir.
GCLOUD_STANDIN = r"""#!{python}
import base64, json, os, re, signal, subprocess, sys, time

STATE = {state!r}
REPO = {repo!r}
RUN_NODEPREP = {run_nodeprep!r}
ACCELERATOR_TYPES = {accelerator_types!r}
REGION = {region!r}


def flag(argv, name):
    for arg in argv:
        if arg.startswith(name + "="):
            return arg.split("=", 1)[1]
    return None


def alive(pid):
    try:
        with open(f"/proc/{{pid}}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def missing(verb, name):
    sys.stderr.write(
        f"ERROR: (gcloud.compute.instances.{{verb}}) Could not fetch "
        f"resource:\n - The resource 'projects/p/zones/z/instances/"
        f"{{name}}' was not found\n")
    return 1


def main(argv):
    with open(os.path.join(STATE, "calls.jsonl"), "a") as fh:
        fh.write(json.dumps(argv) + "\n")
    verb = argv[:3]
    if verb == ["compute", "instances", "create"]:
        name = argv[3]
        script_path = flag(argv, "--metadata-from-file").split("=", 1)[1]
        with open(script_path) as fh:
            script = fh.read()
        with open(os.path.join(STATE, name + ".startup.sh"), "w") as fh:
            fh.write(script)
        b64 = re.search(r"echo (\S+) \| base64 -d", script).group(1)
        boot = json.loads(base64.b64decode(b64))
        work = os.path.join(STATE, name)
        os.makedirs(work, exist_ok=True)
        boot["work_dir"] = work
        boot["identity"].update(hostname=name, internal_ip="127.0.0.1")
        boot["run_nodeprep"] = RUN_NODEPREP
        path = os.path.join(work, "boot.json")
        with open(path, "w") as fh:
            json.dump(boot, fh)
        log = open(os.path.join(work, "agent.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "batch_shipyard_tpu_torch.agent", path],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            stdin=subprocess.DEVNULL, stdout=log, stderr=log,
            start_new_session=True)
        with open(os.path.join(STATE, name + ".pid"), "w") as fh:
            fh.write(str(proc.pid))
        return 0
    if verb in (["compute", "instances", "describe"],
                ["compute", "instances", "delete"]):
        name = argv[3]
        pidfile = os.path.join(STATE, name + ".pid")
        if not os.path.exists(pidfile):
            return missing(verb[2], name)
        if verb[2] == "describe":
            desc = {{"name": name, "status": "RUNNING",
                    "networkInterfaces": [{{
                        "networkIP": "127.0.0.1",
                        "accessConfigs": [{{"natIP": "127.0.0.1"}}]}}]}}
            fmt = flag(argv, "--format")
            print(json.dumps(desc) if fmt == "json" else
                  desc["status"] if fmt == "value(status)" else
                  "127.0.0.1")
            return 0
        with open(pidfile) as fh:
            pid = int(fh.read())
        for signum in (signal.SIGTERM, signal.SIGKILL):
            try:
                os.kill(pid, signum)
            except ProcessLookupError:
                pass
            deadline = time.monotonic() + 15.0
            while alive(pid) and time.monotonic() < deadline:
                time.sleep(0.1)
            if not alive(pid):
                break
        os.remove(pidfile)
        return 0
    if verb == ["compute", "accelerator-types", "list"]:
        print(ACCELERATOR_TYPES)
        return 0
    if verb == ["compute", "regions", "describe"]:
        print(REGION)
        return 0
    sys.stderr.write(f"stand-in gcloud: unsupported {{argv}}\n")
    return 2


sys.exit(main(sys.argv[1:]))
"""


def write_gcloud_standin(bin_dir: pathlib.Path, state: pathlib.Path,
                         run_nodeprep: bool = True) -> pathlib.Path:
    """The stand-in ``gcloud`` in ``bin_dir`` (put it first on PATH),
    keeping its VMs' work dirs, pid files and calls.jsonl in ``state``."""
    bin_dir.mkdir(parents=True, exist_ok=True)
    state.mkdir(parents=True, exist_ok=True)
    path = bin_dir / "gcloud"
    path.write_text(GCLOUD_STANDIN.format(
        python=sys.executable, state=str(state),
        repo=str(_build.REPO_ROOT), run_nodeprep=run_nodeprep,
        accelerator_types=json.dumps(CLOUD_ACCELERATOR_TYPES),
        region=json.dumps(CLOUD_REGION)))
    path.chmod(0o755)
    return path


def gcloud_calls(state: pathlib.Path) -> list:
    path = state / "calls.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()]


def _cli(configdir: pathlib.Path, env: dict, *argv: str) -> tuple:
    """One CLI command in its own process: (wall seconds, stdout); it
    must exit 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(CLI + ["--configdir", str(configdir), *argv],
                          cwd=str(_build.REPO_ROOT), env=env,
                          capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"(n5) {' '.join(argv)}: exit {proc.returncode}\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return seconds, proc.stdout


def _agent_pids(root: pathlib.Path) -> list:
    """Live node agent processes whose bootstrap lies under ``root``
    (zombies left to a parent that does not reap them count as gone)."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as fh:
                argv = fh.read().split(b"\0")
            with open(f"/proc/{entry}/stat", "rb") as fh:
                state = fh.read().rsplit(b")", 1)[1].split()[0]
        except OSError:
            continue
        if (b"batch_shipyard_tpu_torch.agent" in argv and state != b"Z"
                and any(str(root).encode() in arg for arg in argv)):
            pids.append(int(entry))
    return pids


def _await_agents_gone(root: pathlib.Path, seconds: float) -> list:
    deadline = time.monotonic() + seconds
    while (pids := _agent_pids(root)) and time.monotonic() < deadline:
        time.sleep(0.2)
    return pids


def _stop_agents(root: pathlib.Path) -> int:
    """Terminate the agents under ``root`` (SIGKILL after AGENT_STOP_S);
    how many there were."""
    pids = _agent_pids(root)
    for signum in (signal.SIGTERM, signal.SIGKILL):
        for pid in pids:
            try:
                os.kill(pid, signum)
            except ProcessLookupError:
                pass
        if not _await_agents_gone(root, AGENT_STOP_S):
            break
    require(not _agent_pids(root), f"(n5) agents {pids} did not stop")
    return len(pids)


def cli_leg(work: pathlib.Path, env: dict, marker_env: dict, command: str,
            cold: dict) -> dict:
    """(n5): account quota -> pool add -> jobs add --tail -> jobs wait
    --goodput-report -> the reports -> pool del through ``python -m
    batch_shipyard_tpu_torch.cli.main --configdir``, each command a
    process of its own, on a cloud pool (``substrate: tpu_vm``) whose
    gcloud is the stand-in (``write_gcloud_standin``), first on the
    commands' PATH. Job 4 is ``command`` (job 2's: (w)'s warm run,
    --aot-precompile, no nvcc reachable) on a fresh one-node pool of
    NODE_POOL_ID: its node seeds from the store and builds nothing, its
    losses are job 1's (``cold``) bit for bit and its launches job 1's;
    its goodput report sums to its wall within 1%; ``diag perf`` holds
    this pool add's create.end. The VM's create argv names NODE_VM_SIZE,
    ``--maintenance-policy=TERMINATE`` and a startup script; the node's
    row carries the stand-in's IP and its node prep reports the card; its
    agent rides store outages (its log: the wrapper on over
    ``<work_dir>/store_wal.jsonl``, a journal backlog of 0 at its exit);
    ``--raw account quota`` prints the canned limits; and a pool del from
    a fresh process deletes the VM and leaves no agent."""
    import yaml

    from batch_shipyard_tpu_torch.agent import nodeprep, perf
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    from batch_shipyard_tpu_torch.state import names as state_names
    from batch_shipyard_tpu_torch.state.localfs import LocalFSStateStore
    from batch_shipyard_tpu_torch.substrate import gcp_gpu
    from batch_shipyard_tpu_torch.trace import spans as trace_spans
    started = time.perf_counter()
    configdir = work / "configdir"
    tmp = work / "cli_tmp"
    vms = work / "gcloud_vms"
    configdir.mkdir()
    tmp.mkdir()
    write_gcloud_standin(work / "gcloud_bin", vms)
    confs = {
        "credentials": {"credentials": {
            "gcp": {"project": CLOUD_PROJECT, "zone": CLOUD_ZONE},
            "storage": {"backend": "localfs", "root": str(work / "store")}}},
        "config": None,
        "pool": {"pool_specification": {
            "id": NODE_POOL_ID, "substrate": "tpu_vm",
            "vm_configuration": {"vm_size": NODE_VM_SIZE,
                                 "vm_count": {"dedicated": 1}},
            "max_wait_time_seconds": int(NODE_TIMEOUT_S)}},
        "jobs": {"job_specifications": [{"id": "job4", "tasks": [{
            "id": "run", "command": command,
            "environment_variables": marker_env}]}]}}
    for name, data in confs.items():
        (configdir / f"{name}.yaml").write_text(
            "" if data is None else yaml.safe_dump(data))
    env = dict(env, TMPDIR=str(tmp), PATH=os.pathsep.join(
        [str(work / "gcloud_bin"), env.get("PATH", "")]))
    store = LocalFSStateStore(str(work / "store"))
    seconds = {}
    out = {}
    vm = gcp_gpu.vm_name(NODE_POOL_ID, 0)

    def run(name, *argv):
        seconds[name], out[name] = _cli(configdir, env, *argv)
        return out[name]

    try:
        run("--version", "--version")
        quota = json.loads(run("--raw account quota", "--raw", "account",
                               "quota"))
        want_limits = [{"metric": q["metric"], "unit": "GPUs",
                        "region": CLOUD_REGION["name"],
                        "limit": int(q["limit"]), "usage": int(q["usage"])}
                       for q in CLOUD_REGION["quotas"] if "GPU" in q["metric"]]
        require(quota == {"project": CLOUD_PROJECT, "zone": CLOUD_ZONE,
                          "accelerator_types": sorted(
                              t["name"] for t in CLOUD_ACCELERATOR_TYPES),
                          "quota_limits": want_limits},
                f"(n5) --raw account quota: {quota}")
        added_at = time.time()
        run("pool add", "pool", "add")
        pools = json.loads(run("--raw pool list", "--raw", "pool",
                               "list"))["pools"]
        require([p["state"] for p in pools if p["id"] == NODE_POOL_ID]
                == ["ready"], f"(n5) pool list: {pools}")
        tail = run("jobs add --tail", "jobs", "add", "--tail",
                   "stdout.txt")
        report = json.loads(tail.strip().splitlines()[-1])
        waited = run("jobs wait --goodput-report", "jobs", "wait",
                     "--job-id", "job4", "--timeout", str(CLI_TIMEOUT_S),
                     "--goodput-report")
        tasks = json.loads(run("--raw jobs tasks list", "--raw", "jobs",
                               "tasks", "list", "job4"))["tasks"]
        require([(t["state"], t["exit_code"]) for t in tasks] ==
                [("completed", 0)], f"(n5) job 4's tasks: {tasks}")
        cache_stats = json.loads(run("--raw pool cache stats", "--raw",
                                     "pool", "cache", "stats"))
        goodput = json.loads(run("--raw goodput job", "--raw", "goodput",
                                 "job", "job4"))
        perf_events = json.loads(run("--raw diag perf", "--raw", "diag",
                                     "perf"))["events"]
        row, = jobs_mgr.list_tasks(store, NODE_POOL_ID, "job4")
        node_row, = store.query_entities(state_names.TABLE_NODES,
                                         partition_key=NODE_POOL_ID)
        node_dirs = sorted(p.parent for p in vms.glob("*/boot.json"))
        entries = {ident: cc_manager.snapshot(d) for node in node_dirs
                   for ident, d in cc_manager.list_identity_dirs(
                       str(node / "compilecache")).items()}
        running_before_del = _agent_pids(vms)
        run("pool del --yes", "pool", "del", "--yes")
        left = _await_agents_gone(vms, CLI_AGENT_EXIT_S)
    finally:
        stopped = _stop_agents(vms)
    agent_log = (vms / vm / "agent.log").read_text(errors="replace")
    calls = gcloud_calls(vms)
    creates = [c for c in calls if c[:3] == ["compute", "instances",
                                             "create"]]
    deletes = [c for c in calls if c[:3] == ["compute", "instances",
                                             "delete"]]
    require(len(creates) == 1 and creates[0][3] == vm and
            f"--machine-type={NODE_VM_SIZE}" in creates[0] and
            "--maintenance-policy=TERMINATE" in creates[0] and
            any(a.startswith("--metadata-from-file=startup-script=")
                for a in creates[0]) and
            f"--project={CLOUD_PROJECT}" in creates[0] and
            f"--zone={CLOUD_ZONE}" in creates[0],
            f"(n5) gcloud create calls {creates}")
    require([c[3] for c in deletes] == [vm],
            f"(n5) gcloud delete calls {deletes}")
    require(node_row.get("internal_ip") == "127.0.0.1" and
            node_row.get("hostname") == vm,
            f"(n5) the node's row {node_row}")
    require(f"store-outage ride-through on; journal "
            f"{vms / vm / 'store_wal.jsonl'}" in agent_log and
            "journal backlog 0 at exit" in agent_log,
            f"(n5) the agent did not ride on the wrapper or left a "
            f"backlog; its log:\n{agent_log[-3000:]}")
    gpus = nodeprep.detect_gpus()
    prep = [e["event"] for e in perf.query(store, NODE_POOL_ID)
            if e["source"] == "nodeprep" and e["timestamp"] >= added_at]
    require(len(prep) >= 4 and prep[0] == "start" and prep[-1] == "end"
            and f"gpus:{gpus}" in prep and "torch_cuda_ready:True" in prep,
            f"(n5) the VM's node prep events {prep} ({gpus} GPUs here)")
    require(len(running_before_del) == 1 and not left and not stopped,
            f"(n5) agents {running_before_del} before pool del, {left} "
            f"left {CLI_AGENT_EXIT_S:.0f} s after it, {stopped} stopped "
            f"by the script")
    layers = int(WARM_ARGS[WARM_ARGS.index("--n-layers") + 1])
    want = {"flash_fwd": layers, "flash_bwd": layers, "xent_fwd": 1,
            "xent_bwd_h": 1, "xent_bwd_e": 1}
    rank, = report["per_rank"]
    cold_rank, = cold["report"]["per_rank"]
    require(rank["launches_per_step"] == want ==
            cold_rank["launches_per_step"] and not rank["plain_calls"],
            f"(n5) job 4 launched {rank['launches_per_step']} a step, "
            f"plain {rank['plain_calls']}; job 1 "
            f"{cold_rank['launches_per_step']} (want {want})")
    require(report["losses"] == cold["report"]["losses"],
            f"(n5) losses {report['losses']} (job 4) vs "
            f"{cold['report']['losses']} (job 1)")
    compile_events = [e.get("attrs", {}) for e in gp_events.query(
        store, NODE_POOL_ID, job_id="job4") if e["kind"] == "compile"]
    warmup = [e for e in compile_events if e.get("what") == "warmup"]
    seeds = [s for s in trace_spans.query(store, NODE_POOL_ID,
                                          job_id="job4")
             if s["kind"] == trace_spans.SPAN_CACHE_SEED]
    start = report["warm_start"]
    require(len(node_dirs) == 1 and len(seeds) == 1 and
            entries == cold["entries"] and not start["built"] and
            len(warmup) == 1 and warmup[0].get("cache_hit") is True,
            f"(n5) job 4's node {node_dirs} holds {entries} after seed "
            f"spans {seeds}; job 1 left {cold['entries']}; built "
            f"{start['built']}, compile events {compile_events}")
    total = goodput["productive_seconds"] + sum(
        goodput["badput_seconds"].values())
    require(goodput["wall_seconds"] > 0 and
            abs(total - goodput["wall_seconds"]) <=
            0.01 * goodput["wall_seconds"],
            f"(n5) goodput job: productive + badput {total} s, wall "
            f"{goodput['wall_seconds']} s")
    require(any(e["event"] == "create.end" and e["t"] >= added_at
                for e in perf_events),
            f"(n5) diag perf: no create.end since pool add {perf_events}")
    waterfall = {}
    for line in waited.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0] in goodput["badput_seconds"]:
            waterfall[parts[0]] = float(parts[1])
        elif len(parts) == 3 and parts[0] in ("productive", "wall"):
            waterfall[parts[0]] = float(parts[1])
    require(set(goodput["badput_seconds"]) <= set(waterfall),
            f"(n5) jobs wait --goodput-report printed no waterfall:\n"
            f"{waited}")
    leg = {"seconds": seconds,
           "pool_add_to_task_complete_s":
               gp_events.iso_to_epoch(row["completed_at"]) - added_at,
           "waterfall_s": waterfall,
           "goodput_ratio": goodput["goodput_ratio"],
           "cache_stats": cache_stats, "seed_ms":
               (seeds[0]["end"] - seeds[0]["start"]) * 1000,
           "gcloud_calls": [c[:3] for c in calls],
           "agents_left_after_pool_del": len(left),
           "leg_s": time.perf_counter() - started}
    print(f"node side (n5) CLI on the cloud substrate (stand-in gcloud): "
          f"wall seconds by command "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}; "
          f"pool add -> task complete "
          f"{leg['pool_add_to_task_complete_s']:.2f} s; job 4 seeded in "
          f"{leg['seed_ms']:.1f} ms, built nothing, losses equal job 1's "
          f"bit for bit; gcloud calls "
          f"{json.dumps([' '.join(c) for c in leg['gcloud_calls']])}",
          flush=True)
    print(f"node side (n5) goodput waterfall (jobs wait --goodput-report) "
          f"{json.dumps(waterfall)}; goodput_ratio "
          f"{goodput['goodput_ratio']:.4f}", flush=True)
    print(f"node side (n5) pool del from a fresh process deleted {vm}; 0 "
          f"agents running {CLI_AGENT_EXIT_S:.0f} s after it; leg "
          f"{leg['leg_s']:.1f} s", flush=True)
    return leg


# (n6): a store outage on the card. The port's agent, built in this
# process as its process builds it (agent/__main__.build_agent: the
# ride-through on), over the leg's localfs store behind a switch, runs
# job 2's warm command as a task; OUTAGE_AFTER_S into the task every store
# op fails with a transport error for OUTAGE_S.
OUTAGE_AFTER_S = 2.0
OUTAGE_S = 5.0
OUTAGE_NODE = f"{NODE_POOL_ID}-outage-n0"
OUTAGE_HEARTBEAT_S = 0.5


class SwitchedStore:
    """A store behind a switch: while ``off`` every op raises a transport
    error (ConnectionError), as a store a node cannot reach does."""

    def __init__(self, inner):
        self.inner = inner
        self.off = False

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            if self.off:
                raise ConnectionError(f"store switched off ({name})")
            return attr(*args, **kwargs)
        return call


class InProcessNode:
    """A one-node substrate whose agent runs in this process, built by
    ``agent/__main__.build_agent`` from a bootstrap without a resilience
    block, over ``store``."""

    def __init__(self, store, work: pathlib.Path):
        self.store = store
        self.work = work
        self.agent = None

    def allocate_pool(self, pool) -> None:
        from batch_shipyard_tpu_torch.agent import __main__ as agent_main
        from batch_shipyard_tpu_torch.state import names as state_names
        self.store.inner.upsert_entity(
            state_names.TABLE_NODES, pool.id, OUTAGE_NODE, {
                "state": "creating", "hostname": OUTAGE_NODE,
                "internal_ip": "127.0.0.1", "node_index": 0,
                "slice_index": 0, "worker_index": 0,
                "registered_at": time.time()})
        boot = {
            "pool_config": {"pool_specification": {
                "id": pool.id, "substrate": "localhost",
                "vm_configuration": {"vm_size": pool.vm_size,
                                     "vm_count": {"dedicated": 1}}}},
            "identity": {"pool_id": pool.id, "node_id": OUTAGE_NODE,
                         "node_index": 0, "hostname": OUTAGE_NODE,
                         "internal_ip": "127.0.0.1"},
            "work_dir": str(self.work / OUTAGE_NODE),
            "heartbeat_interval": OUTAGE_HEARTBEAT_S,
            "poll_interval": 0.2, "node_stale_seconds": 10.0,
            "run_nodeprep": False}
        self.agent = agent_main.build_agent(boot, store=self.store)
        self.agent.start()

    def deallocate_pool(self, pool_id: str) -> None:
        from batch_shipyard_tpu_torch.state import names as state_names
        if self.agent is not None:
            self.agent.stop()
            self.agent.join(60.0)
        for row in list(self.store.inner.query_entities(
                state_names.TABLE_NODES, partition_key=pool_id)):
            self.store.inner.delete_entity(state_names.TABLE_NODES,
                                           pool_id, row["_rk"])

    def recreate_slice(self, pool, slice_index: int) -> None:
        raise RuntimeError("(n6) the in-process node cannot be recreated")


def outage_leg(work: pathlib.Path, marker_env: dict, command: str,
               cold: dict) -> dict:
    """(n6): the task must complete on the card once, unretried, with job
    1's losses bit for bit; exactly one ``store_outage`` goodput row must
    cover the switched-off window; the journal must have held the
    advisory writes of the window and be replayed (each journaled goodput
    row in the store, the node's heartbeat the newest journaled one or
    later) with backlog 0."""
    from batch_shipyard_tpu_torch.config import settings as settings_mod
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    from batch_shipyard_tpu_torch.pool import manager as pool_mgr
    from batch_shipyard_tpu_torch.state import names as state_names
    from batch_shipyard_tpu_torch.state import resilient
    from batch_shipyard_tpu_torch.state.localfs import LocalFSStateStore
    started = time.perf_counter()
    store = LocalFSStateStore(str(work / "store"))
    switch = SwitchedStore(store)
    node = InProcessNode(switch, work / "outage")
    conf = {"pool_specification": {
        "id": NODE_POOL_ID, "substrate": "localhost",
        "vm_configuration": {"vm_size": NODE_VM_SIZE,
                             "vm_count": {"dedicated": 1}},
        "max_wait_time_seconds": int(NODE_TIMEOUT_S)}}
    pool = settings_mod.pool_settings(conf)
    pool_mgr.create_pool(store, node, pool, settings_mod.global_settings({}),
                         conf)
    try:
        agent = node.agent
        require(isinstance(agent.store, resilient.ResilientStore),
                f"(n6) the agent's store is {type(agent.store).__name__}")
        wal = pathlib.Path(agent.work_dir) / "store_wal.jsonl"
        # The agent runs in this process, so its tasks get this
        # process's environment: the repo on PYTHONPATH as a node's.
        jobs_mgr.add_jobs(store, pool, settings_mod.job_settings_list(
            {"job_specifications": [{"id": "outage", "tasks": [{
                "id": "run", "command": command,
                "environment_variables": dict(
                    marker_env, PYTHONPATH=str(_build.REPO_ROOT))}]}]}))
        deadline = time.monotonic() + NODE_TIMEOUT_S
        while time.monotonic() < deadline and jobs_mgr.list_tasks(
                store, NODE_POOL_ID, "outage")[0].get("state") not in (
                "running", "completed", "failed"):
            time.sleep(0.05)
        state = jobs_mgr.list_tasks(store, NODE_POOL_ID,
                                    "outage")[0].get("state")
        require(state == "running", f"(n6) the task is {state}")
        time.sleep(OUTAGE_AFTER_S)
        off = time.time()
        switch.off = True
        time.sleep(OUTAGE_S)
        journaled = [json.loads(line) for line in wal.read_text().splitlines()
                     if line.strip()] if wal.exists() else []
        on = time.time()
        switch.off = False
        row, = jobs_mgr.wait_for_tasks(store, NODE_POOL_ID, "outage",
                                       timeout=NODE_TIMEOUT_S)
        deadline = time.monotonic() + 60.0

        def outages():
            return [e for e in gp_events.query(store, NODE_POOL_ID)
                    if e["kind"] == gp_events.STORE_OUTAGE]

        while time.monotonic() < deadline and (
                agent.store.journal_backlog() or not outages()):
            time.sleep(0.1)
        stdout = jobs_mgr.get_task_output(store, NODE_POOL_ID, "outage",
                                          "run", "stdout.txt").decode()
        node_row = store.get_entity(state_names.TABLE_NODES, NODE_POOL_ID,
                                    OUTAGE_NODE)
        rows = outages()
        backlog = agent.store.journal_backlog()
        running = [e for e in gp_events.query(store, NODE_POOL_ID,
                                              job_id="outage")
                   if e["kind"] == gp_events.TASK_RUNNING]
    finally:
        switch.off = False
        pool_mgr.delete_pool(store, node, NODE_POOL_ID)
    require(row.get("state") == "completed" and row.get("exit_code") == 0
            and not row.get("retries") and len(running) == 1,
            f"(n6) the task {row.get('state')} exit {row.get('exit_code')} "
            f"retries {row.get('retries')}, {len(running)} running "
            f"interval(s): {row.get('error', '')}")
    report = json.loads(stdout.strip().splitlines()[-1])
    require(report["losses"] == cold["report"]["losses"],
            f"(n6) losses {report['losses']} vs job 1's "
            f"{cold['report']['losses']}")
    require(len(rows) == 1 and off <= rows[0]["start"] <= off + 1.0 and
            rows[0]["end"] >= on and rows[0]["node_id"] == OUTAGE_NODE,
            f"(n6) store_outage rows {rows} for the window [{off}, {on}]")
    inserted = [e for e in journaled if e["op"] == "insert_entity"]
    beats = [e["args"][3]["heartbeat_at"] for e in journaled
             if e["op"] == "merge_entity" and
             e["args"][0] == state_names.TABLE_NODES and
             "heartbeat_at" in e["args"][3]]
    missing = []
    for entry in inserted:
        table, pk, rk = entry["args"][:3]
        try:
            store.get_entity(table, pk, rk)
        except KeyError:
            missing.append((table, rk))
    require(beats and backlog == 0 and not missing and not wal.exists() and
            node_row["heartbeat_at"] >= max(beats),
            f"(n6) journal: {len(journaled)} entries ({len(beats)} beats) "
            f"at the window's end, backlog {backlog} after, rows never "
            f"replayed {missing}, node heartbeat {node_row['heartbeat_at']}")
    submitted = gp_events.iso_to_epoch(row["submitted_at"])
    leg = {"outage_switched_s": on - off,
           "outage_priced_s": rows[0]["end"] - rows[0]["start"],
           "journaled_entries": len(journaled),
           "replayed": rows[0].get("attrs", {}).get("replayed"),
           "submit_to_complete_s":
               gp_events.iso_to_epoch(row["completed_at"]) - submitted,
           "leg_s": time.perf_counter() - started}
    print(f"node side (n6) store outage: switched off {leg['outage_switched_s']:.3f} "
          f"s from {OUTAGE_AFTER_S:.0f} s into the task, priced "
          f"{leg['outage_priced_s']:.3f} s as one store_outage row; "
          f"{leg['journaled_entries']} journal entries at the window's "
          f"end, replayed in order, backlog 0; the task completed once, "
          f"unretried, losses equal job 1's bit for bit; submit -> "
          f"complete {leg['submit_to_complete_s']:.2f} s; leg "
          f"{leg['leg_s']:.1f} s", flush=True)
    return leg


def node_side(marker_env: dict) -> dict:
    """Phase 4b, (n): node prep, (w)'s cold run as job 1, its seeded warm
    run as job 2 on a fresh pool, and a 2-instance gang as job 3 (module
    doc). Returns (w)'s rows and the node side's."""
    from batch_shipyard_tpu_torch.compilecache import seeding
    from batch_shipyard_tpu_torch.config import settings as settings_mod
    from batch_shipyard_tpu_torch.pool import manager as pool_mgr
    from batch_shipyard_tpu_torch.state.localfs import LocalFSStateStore
    from batch_shipyard_tpu_torch.trace import spans as trace_spans
    started = time.perf_counter()
    node = {}
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        empty = work / "no_cuda_home"
        empty.mkdir()
        store = LocalFSStateStore(str(work / "store"))
        creds = settings_mod.credentials_settings({"credentials": {
            "storage": {"backend": "localfs", "root": str(work / "store")}}})
        env = dict(os.environ, **marker_env)
        env.pop(cc_manager.CACHE_DIR_ENV, None)
        bare = _without_nvcc(env, empty)
        python = shlex.quote(sys.executable)
        workload = (f"{python} -m "
                    f"batch_shipyard_tpu_torch.workloads.train_transformer "
                    f"{' '.join(WARM_ARGS)}")
        warm_command = (f"env PATH={shlex.quote(bare['PATH'])} "
                        f"CUDA_HOME={shlex.quote(bare['CUDA_HOME'])} "
                        f"{workload} --aot-precompile")
        pools = []
        try:
            # (n1) node prep, (n2) the cold run on it and the export.
            first = _node_pool(store, creds, work / "nodes1", 1)
            pools.append(first)
            cold = _node_warm_run(store, first, "cold", workload,
                                  marker_env, {})
            deadline = time.monotonic() + NODE_EXPORT_TIMEOUT_S
            latest = None
            while time.monotonic() < deadline:
                latest = seeding.latest_info(store, NODE_POOL_ID)
                if latest and set(cold["identities"]) <= set(
                        latest.get("identities", {})):
                    break
                time.sleep(0.2)
            require(latest is not None and set(cold["identities"]) <= set(
                latest.get("identities", {})),
                f"node side: no export of {cold['identities']} in "
                f"compilecache/{NODE_POOL_ID}/latest.json: {latest}")
            t0 = time.perf_counter()
            pool_mgr.delete_pool(store, first["substrate"], NODE_POOL_ID)
            pools.remove(first)
            node["pool_del_s"] = time.perf_counter() - t0
            # (n3) two fresh nodes, (w)'s warm run seeded from the store.
            second = _node_pool(store, creds, work / "nodes2", 2)
            pools.append(second)
            warm = _node_warm_run(store, second, "warm", warm_command,
                                  marker_env, cold["entries"])
            seeds = [s for s in trace_spans.query(store, NODE_POOL_ID,
                                                  job_id="warm")
                     if s["kind"] == trace_spans.SPAN_CACHE_SEED]
            require(len(seeds) == 1 and
                    seeds[0].get("node_id") == warm["node_id"] and
                    warm["entries"] == cold["entries"],
                    f"node side: job 2's node {warm['node_id']} holds "
                    f"{warm['entries']} after seed spans {seeds}; job 1 "
                    f"left {cold['entries']}")
            node["seed_ms"] = (seeds[0]["end"] - seeds[0]["start"]) * 1000
            # (n4) a 2-instance gang, one instance a node.
            gang = _node_job(
                store, second, "gang",
                GANG_COMMAND.format(python=python,
                                    args=" ".join(WARM_ARGS)),
                marker_env, {"num_instances": GANG_INSTANCES,
                             "jax_distributed": {
                                 "enabled": True,
                                 "coordinator_port": free_ports(1)[0]}})
        finally:
            for each in pools:
                try:
                    pool_mgr.delete_pool(store, each["substrate"],
                                         NODE_POOL_ID)
                except Exception:  # noqa: BLE001 - the phase's error wins
                    each["substrate"].deallocate_pool(NODE_POOL_ID)
        # (n5) job 4 through the CLI on the cloud substrate, on the store
        # (n1)-(n4) left; (n6) job 2's command through a store outage.
        node["cli"] = cli_leg(work, env, marker_env, warm_command, cold)
        node["outage"] = outage_leg(work, marker_env, warm_command, cold)
    rows = {}
    for name, run in (("cold", cold), ("warm", warm)):
        report = run["report"]
        start = report["warm_start"]
        rows[name] = {
            "time_to_first_step_s": start["time_to_first_step_s"],
            "first_step_ms": start["first_step_ms"],
            "steady_step_ms": report["ms_per_step"],
            "entries_added": run["added"], "built": start["built"],
            "cache": start["compile_cache"],
            "compile_events": run["compile_events"],
            "losses": report["losses"], "node_id": run["node_id"],
            "submit_to_start_s": run["submit_to_start_s"],
            "submit_to_complete_s": run["submit_to_complete_s"]}
    cold_s = rows["cold"]["time_to_first_step_s"]
    warm_s = rows["warm"]["time_to_first_step_s"]
    rows["speedup"] = cold_s / warm_s
    warmup = [e for e in warm["compile_events"] if e.get("what") == "warmup"]
    require(len(cold["identities"]) == 1 and
            warm["identities"] == cold["identities"] and
            sorted(rows["cold"]["built"]) == sorted(
                attn_ops.libraries("cuda") +
                loss_ops.libraries("kernel", "cuda", 128)) and
            len(cold["added"]) == len(rows["cold"]["built"]),
            f"warm start: run 1 built {rows['cold']['built']}, added "
            f"{cold['added']} in {cold['identities']}")
    require(not warm["added"] and not rows["warm"]["built"] and
            len(warmup) == 1 and warmup[0].get("cache_hit") is True and
            rows["warm"]["cache"]["hits"] >= 1,
            f"warm start: run 2 added {warm['added']}, built "
            f"{rows['warm']['built']}, compile events "
            f"{warm['compile_events']}, cache {rows['warm']['cache']}")
    require(rows["cold"]["losses"] == rows["warm"]["losses"],
            f"warm start: losses {rows['cold']['losses']} (cold) vs "
            f"{rows['warm']['losses']} (warm)")
    # The gang: every instance in a group of GANG_INSTANCES, rank 0's
    # report over both ranks, the losses within the dp tolerance of job
    # 1's (one rank on the same global batch).
    members = [json.loads(out.strip().splitlines()[-1])
               for out in gang["stdout"]]
    report = json.loads(gang["stdout"][0].strip().splitlines()[-2])
    layers = int(WARM_ARGS[WARM_ARGS.index("--n-layers") + 1])
    want = _gang_launches(layers)
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(report["losses"], rows["cold"]["losses"]))
    node["gang"] = {
        "members": members, "mesh": report["mesh"],
        "losses": report["losses"], "max_loss_rel": rel,
        "tol": MESH_LOSS_RTOL, "ms_per_step": report["ms_per_step"],
        "launches_per_step_by_rank": [r["launches_per_step"]
                                      for r in report["per_rank"]],
        "submit_to_start_s": gang["submit_to_start_s"],
        "submit_to_complete_s": gang["submit_to_complete_s"]}
    require(sorted(m["rank"] for m in members) ==
            list(range(GANG_INSTANCES)) and
            all(m["process_count"] == GANG_INSTANCES for m in members) and
            len(report["per_rank"]) == GANG_INSTANCES,
            f"node side: gang members {members}, "
            f"{len(report['per_rank'])} ranks reported")
    require(len(report["losses"]) == len(rows["cold"]["losses"]) and
            rel <= MESH_LOSS_RTOL,
            f"node side: the gang's losses off job 1's: {node['gang']}")
    for entry in report["per_rank"]:
        require(entry["launches_per_step"] == want and
                not entry["plain_calls"],
                f"node side: gang rank {entry['rank']} launched "
                f"{entry['launches_per_step']} a step (want {want}), plain "
                f"{entry['plain_calls']}")
    require(len({str(r["params_sha256"]) for r in report["per_rank"]}) == 1,
            "node side: the gang's ranks hold different parameters")
    node.update({"node_prep_s": {
        **{f"pool1:{k}": v["seconds"]
           for k, v in first["node_prep"].items()},
        **{f"pool2:{k}": v["seconds"]
           for k, v in second["node_prep"].items()}},
        "pool_add_s": [first["add_s"], second["add_s"]],
        "gpus": first["gpus"], "phase_s": time.perf_counter() - started})
    rows["node"] = node
    print(f"warm start (w): time to first step cold {cold_s:.3f} s, warm "
          f"(--aot-precompile, no nvcc) {warm_s:.3f} s, speedup "
          f"{rows['speedup']:.2f}x; first step vs steady step: cold "
          f"{rows['cold']['first_step_ms']:.1f} vs "
          f"{rows['cold']['steady_step_ms']:.2f} ms, warm "
          f"{rows['warm']['first_step_ms']:.1f} vs "
          f"{rows['warm']['steady_step_ms']:.2f} ms; entries added "
          f"{len(cold['added'])} / {len(warm['added'])}; cold nvcc seconds "
          f"by library {json.dumps(rows['cold']['built'])}; losses equal "
          f"bit for bit", flush=True)
    print("warm start " + json.dumps(rows), flush=True)
    print(f"node side (n): node prep {json.dumps(node['node_prep_s'])} s "
          f"({node['gpus']} GPUs, torch_cuda_ready:True); pool add "
          f"{node['pool_add_s'][0]:.2f} / {node['pool_add_s'][1]:.2f} s; "
          f"submit -> task start / complete: cold "
          f"{rows['cold']['submit_to_start_s']:.2f} / "
          f"{rows['cold']['submit_to_complete_s']:.2f} s, warm (seeded "
          f"in {node['seed_ms']:.1f} ms) "
          f"{rows['warm']['submit_to_start_s']:.2f} / "
          f"{rows['warm']['submit_to_complete_s']:.2f} s, gang "
          f"{node['gang']['submit_to_start_s']:.2f} / "
          f"{node['gang']['submit_to_complete_s']:.2f} s; gang "
          f"{node['gang']['ms_per_step']:.2f} ms a step over "
          f"{GANG_INSTANCES} ranks, losses within "
          f"{node['gang']['max_loss_rel']:.3g} of job 1's; phase "
          f"{node['phase_s']:.1f} s", flush=True)
    return rows


def mark(phase: str) -> None:
    """A line with the seconds since the script started, as a phase
    starts: where a run's time went."""
    print(f"chip_smoke at {time.perf_counter() - STARTED:.1f} s: {phase}",
          flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    sources = ("flash_attention", "decode_attention", "chunked_loss",
               "fused_norm", "quantization", "ring_collectives")
    workdir = tempfile.TemporaryDirectory()
    tmp = pathlib.Path(workdir.name)
    # One fault build per source, and one per fault of FAULTS_ONE_BY_ONE
    # (keyed (source, index)).
    fault_builds = [(name, None) for name in FAULTS
                    if len(FAULTS_ONE_BY_ONE.get(name, ())) <
                    len(FAULTS[name])]
    fault_builds += [(name, i) for name, indices in FAULTS_ONE_BY_ONE.items()
                     for i in indices]
    # Phase 1 builds through the compile cache, into a fresh dir: every
    # library a cold build, a new entry.
    shutil.rmtree(SMOKE_CACHE, ignore_errors=True)
    cache = cc_manager.enable(str(SMOKE_CACHE), model_digest="chip_smoke")
    with concurrent.futures.ThreadPoolExecutor(
            len(sources) + len(fault_builds)) as pool, \
            cache.track("chip_smoke_build") as tracked:
        started = [pool.submit(_build.build, name) for name in sources]
        faulty = {name if i is None else (name, i):
                  pool.submit(build_fault_library, tmp, name, i)
                  for name, i in fault_builds}
        builds = [f.result() for f in started]
        faulty = {key: f.result() for key, f in faulty.items()}
    require(tracked["new_entries"] == len(sources) and
            not tracked["cache_hit"] and
            all(seconds > 0 for _, seconds in builds),
            f"phase 1's builds into the fresh cache {cache.cache_dir}: "
            f"{tracked}, {[s for _, s in builds]} s")
    nvcc_seconds = {name: seconds
                    for name, (_, seconds) in zip(sources, builds)}
    print(f"compile cache {cache.cache_dir}: {tracked['new_entries']} "
          f"libraries built cold in {tracked['elapsed_seconds']:.1f} s; "
          f"cold nvcc seconds by library (side by side with the fault "
          f"builds) {json.dumps(nvcc_seconds)}", flush=True)
    for path, _ in builds:
        install_library(path)
    fault_libs = {}
    for key, (path, seconds) in faulty.items():
        fault_libs[key] = _build.load(
            path, key if isinstance(key, str) else key[0])
        print(f"build {path.name} (planted faults): {seconds:.1f} s",
              flush=True)
    reports = {}
    for name, (path, seconds) in zip(sources, builds):
        print(f"build {path.name}: {seconds:.1f} s", flush=True)
        reports[name] = ptxas_report(_build.log_path(path).read_text())
        for kernel, usage in reports[name].items():
            print(f"ptxas {name} {kernel}: {usage.get('registers')} "
                  f"registers a thread, {usage.get('smem', 0)} bytes static "
                  f"shared memory, spill stores/loads "
                  f"{usage.get('spill_stores', 0)}/"
                  f"{usage.get('spill_loads', 0)} bytes")
    resources = flash_resources(reports["flash_attention"])
    resources.update(decode_resources(_build.log_path(
        builds[sources.index("decode_attention")][0]).read_text()))
    resources["int8_matmul"] = quant_resources(reports["quantization"])

    mark("kernel checks")
    decode_faults = check_kernels(device, [
        fault_libs[("decode_attention", i)]
        for i in range(len(DECODE_FAULTS))])
    check_flash(device)
    loss_readings = check_loss(device, fault_libs["chunked_loss"])
    norm_readings = check_norm(device, fault_libs["fused_norm"])
    quant_readings = check_quant(device, fault_libs["quantization"])
    split_readings = check_quant_split(device, fault_libs["quantization"])
    reset_launch_counts()
    virtual_readings = check_virtual(
        device, fault_libs["ring_collectives"],
        [fault_libs[("ring_collectives", i)] for i in VREDUCE_FAULTS])
    mark("kernel timings")
    timing = time_virtual(device, virtual_readings)
    virtual_launches = {key: rc.launches[key] for key in
                        ("virtual_all_gather", "virtual_reduce_scatter")}
    timing.update(time_kernels(device))
    timing.update(time_flash(device, fault_libs["flash_attention"]))
    for shape, rows in time_flash_vision(device).items():
        for key, row in rows.items():
            timing[key].setdefault("vision", {})[shape] = row
    timing.update(time_loss(device, loss_readings))
    timing.update(time_norm(device, norm_readings))
    timing.update(time_quant(device, quant_readings))
    timing.update(time_quant_split(device, split_readings))
    for key, usage in resources.items():
        timing[key]["resources"] = usage

    # The unfused training phase reads no marker (the loss is the plain
    # slab path); the fused and int8 phases read one that records the
    # K3-K5 check, as one bench run resolves ``auto`` alike for each.
    os.environ[kernel_select.MARKER_ENV] = str(tmp / "no_marker.json")
    mark("train")
    trained = train(device)
    marker = tmp / "KERNEL_VALIDATION.json"
    marker.write_text(json.dumps({loss_ops.VALIDATION_NAME: {
        "ok": True, "backend": kernel_select.BACKEND}}))
    os.environ[kernel_select.MARKER_ENV] = str(marker)
    try:
        fused = train(device, fused=True)
        int8 = train(device, quantize=True)
        mark("node side")
        warm = node_side({kernel_select.MARKER_ENV: str(marker)})
        # The sp ranks: the ring checks and timings, one numerics step,
        # then --sp 4 training, all under the same marker.
        mark("sp")
        sp_checks = sp_collectives(device, faulty["ring_collectives"][0],
                                   numerics_dir=tmp)
        timing.update(sp_checks["timing"])
        sp_numerics(device, tmp)
        mark("train mesh")
        # --sp 4 and the mesh's (a) side by side: their ranks' launches,
        # not their steps, set the time (their times are shared).
        marker_env = {kernel_select.MARKER_ENV: str(marker)}
        ports = free_ports(2)
        first = side_by_side({
            "sp": functools.partial(train_sp, device, marker_env,
                                    port=ports[0]),
            "recipe": functools.partial(train_mesh_run, "recipe",
                                        marker_env, port=ports[1])})
        sp_trained = first["sp"]
        meshed = train_mesh(device, marker_env, sp_trained["losses"],
                            faulty["ring_collectives"][0],
                            recipe=first["recipe"])
        mark("checkpoint")
        checkpoint_phase(device, {kernel_select.MARKER_ENV: str(marker)})
        mark("moe")
        moe = moe_phase(device)
        # K12-K14's worst error over the sp ring's checks and the mesh's
        # (the all-reduce's under both K13 and K14).
        mesh_err = meshed["collectives"]["max_abs_err"]
        for key, parts in (("ring_permute", ("ring_permute",)),
                           ("ring_all_gather", ("ring_all_gather",
                                                "ring_all_reduce")),
                           ("ring_reduce_scatter", ("ring_reduce_scatter",
                                                    "ring_all_reduce"))):
            timing[key]["max_abs_err_mesh"] = max(
                mesh_err.get(part, 0.0) for part in parts)
            timing[key]["max_abs_err"] = max(
                timing[key]["max_abs_err"], timing[key]["max_abs_err_mesh"])
    finally:
        os.environ.pop(kernel_select.MARKER_ENV)
        workdir.cleanup()
    mark("vision")
    seen = vision(device, smi)
    mark("serve")
    graphs = {name: decode_graph(name, device) for name, _ in SERVED}
    served = {}
    for name, kernel in SERVED:
        served[kernel] = serve(name, kernel, device)
        served[kernel]["graph_check"] = graphs[name]
    mark("serve speculative")
    speculative = serve_speculative(device)
    mark("serving tier")
    tier = serving_tier(device)

    kernels = []
    for key, meta in KERNELS.items():
        t = timing[key]
        row = {"name": f"{meta['label']} {key}", "route": meta["route"],
               "source": meta["source"], "replaces": meta["replaces"],
               # Phase 1's cold build of the kernel's source, side by
               # side with the others and the fault builds.
               "nvcc_s": nvcc_seconds[pathlib.Path(meta["source"]).stem]}
        if pathlib.Path(meta["source"]).stem in warm["cold"]["built"]:
            # (w) run 1's build of it, alone, inside the first step.
            row["nvcc_alone_s"] = warm["cold"]["built"][
                pathlib.Path(meta["source"]).stem]
        main_run = next((run for run in (trained, fused, int8)
                         if key in run["launches"]), None)
        if key in RING_KEYS:
            # K12-K14: rank 0's launches over the sp run's counted steps
            # (every rank's per-step counts are in the train sp row).
            row["launches"] = sp_trained["launches_rank0"][key]
            row["launches_per_train_step"] = \
                sp_trained["launches_per_step"][0][key]
            row["launches_per_step_by_rank"] = {
                rank: counts[key] for rank, counts in
                sp_trained["launches_per_step"].items()}
            # Device kernels a wrapper call: K12 two copies, K13 and K14
            # ring (rank 0's profiled step).
            row["device_kernels_per_call"] = (
                sp_trained["profile"][0]["ring_kernel_calls_per_step"][key] /
                sp_trained["launches_per_step"][0][key])
            for name in MESH_RUNS:
                row[f"launches_mesh_{name}_rank0"] = \
                    meshed[name]["launches_rank0"].get(key, 0)
            # The MoE ranks' (m2, m3): K13/K14 on the ep ring (and the
            # tokens and data rings in m3).
            for name in MOE_RUNS:
                row[f"launches_moe_{name}_rank0"] = \
                    moe[name]["launches_rank0"].get(key, 0)
                row[f"launches_moe_{name}_per_step_by_axis"] = {
                    k: n for k, n in
                    moe[name]["launches_per_step_rank0"].items()
                    if k.startswith(key + ".")}
        elif key in TP_ONLY_KEYS:
            # K10's halves run only where a row is split over tp ranks:
            # rank 0's launches over the int8 tp mesh run's counted steps.
            run = meshed["int8_tp"]
            row["launches"] = run["launches_rank0"][key]
            row["launches_per_train_step"] = run["launches_per_step"][0][key]
            row["launches_phase"] = "train mesh (d) --sp 2 --tp 2 --int8"
        elif key in virtual_launches:
            # K15/K16 run on no training or serving path: their launches
            # in their own check and timing phase.
            row["launches"] = virtual_launches[key]
            row["launches_phase"] = "one-device check and timing"
        elif main_run is not None:
            row["launches"] = main_run["launches"][key]
            row["launches_per_train_step"] = \
                main_run["launches_per_step"][key]
            for name, run in (("fused", fused), ("int8", int8)):
                if run is not main_run and key in run["launches"]:
                    row[f"launches_{name}_train"] = run["launches"][key]
            if key in sp_trained["launches_rank0"]:
                row["launches_sp_train_rank0"] = \
                    sp_trained["launches_rank0"][key]
            if key in moe["m1"]["launches"]:
                row["launches_moe_m1"] = moe["m1"]["launches"][key]
                for name in MOE_RUNS:
                    row[f"launches_moe_{name}_rank0"] = \
                        moe[name]["launches_rank0"][key]
            for name in MESH_RUNS:
                if key in meshed[name]["launches_rank0"]:
                    row[f"launches_mesh_{name}_rank0"] = \
                        meshed[name]["launches_rank0"][key]
        else:
            # The wrappers' count (the eager warm-up step and the
            # capture), and the traced replays' count a decode step.
            row["launches"] = served[key]["launches"]
            row["launches_counted"] = served[key]["launches_counted"]
            row["launches_per_replayed_step"] = \
                served[key]["launches_per_replayed_step"]
            if key in ("paged_decode", "paged_decode_int8"):
                row["planted_fault_err_over_tol"] = \
                    decode_faults["fault_err_over_tol"]
            if key == "paged_decode":
                # The serving tier's fp32 engines: both failover
                # replicas' warm-up, and one SLO arm's.
                row["launches_failover_r1"] = tier["failover"][
                    "r1_preempt"]["paged_decode_launches"]
                row["launches_slo_arm"] = tier["slo_load"][
                    "prefix_cache_on"]["paged_decode_launches"]
            if key == "dense_decode_int8":
                # The speculative (s3) run: the int8 draft's steps at D 16.
                s3 = speculative["s3"]
                row["launches_speculative_s3"] = s3["launches"][key]
                row["launches_per_replayed_speculative_step"] = \
                    s3["decode_profile"]["attention_launches_per_step"]
        if key in ("flash_fwd", "flash_bwd"):
            # The vision runs (v3): VISION_WARMUP + VISION_STEPS steps
            # and the profile's VISION_PROFILE_RUNS each, the DiT's K1
            # also DIT_LAYERS a DDIM step.
            row["launches_vision"] = {
                name: seen[name]["launches_run"][key]
                for name in (*VIT_RUNS, "dit")}
        if key in ("ring_all_gather", "ring_reduce_scatter"):
            row["launches_per_step_resnet_dp"] = [
                r.get(key, 0) for r in
                seen["resnet_dp"]["launches_per_step_by_rank"]]
        row.update({k: t[k] for k in ("max_abs_err", "max_tile_err", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "int_mm_ms", "per",
                                      "timing_shape_equal",
                                      "device_kernels_per_call",
                                      "bound_nvlink_ms",
                                      "ms_per_rank", "note", "joint",
                                      "max_abs_err_mesh", "tflops",
                                      "ceiling_ms", "k10_same_rows_ms",
                                      "fwd_bwd_ms", "library_fwd_bwd_ms",
                                      "served_lengths", "draft_d16",
                                      "resources", "vision")
                    if k in t})
        kernels.append(row)
    print(f"chip_smoke total: {time.perf_counter() - STARTED:.1f} s "
          f"(vision phase {seen['phase_s']:.1f} s)", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
