// Single-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of batch_shipyard_tpu:
//   K6 ops/paged_attention.py:_paged_decode_kernel       (paged, fp32/bf16)
//   K7 ops/paged_attention.py:_paged_decode_kernel_int8  (paged, int8 + scales)
//   K8 ops/decode_attention.py:_dense_decode_kernel_int8 (dense, int8 + scales)
// All three are one split-sequence cluster design (decode_cluster), entered
// through two kernels: paged_decode_cluster_kernel (K6, K7) over the paged
// pool and dense_decode_cluster_kernel (K8) over the dense cache. They
// differ only in how a run of rows is addressed (the kDense branches).
//
// What bounds them: device-memory bytes. One query row meets every live
// cached row once, so the work is ~4*D flops per 2*D*elt bytes read.
// HBM bytes = sum_b len_b*H*D*2*elt (+ sum_b len_b*H*2*4 for the int8
// scales). With 8 slots at length 512, H=16, D=64 that is 16.8 MB (bf16)
// or 8.9 MB (int8) per layer-step: about 5.0 us and 2.7 us at 3.35 TB/s.
// The serving step launches the kernel of its cache once per layer.
//
// At the served shape a one-block-per-(slot, head) design has 128 blocks,
// one per SM, each keeping a few rows in flight (and, paged, looking up
// the block table before every row): the card waits on latency, not
// bandwidth. Here:
//   1. Each (slot, head) is split over a thread-block cluster of S blocks,
//      two units a block at the cache's full length: a unit is a page of
//      the paged pool (S = 4 at 512 keys in pages of 64, 512 blocks), or a
//      box of tile_rows rows of the dense cache (S = 2 at 512 keys in
//      units of 128, 256 blocks). The slot's live units are cut into S
//      contiguous runs of ceil(units / S); a block whose run is empty
//      contributes (m = -inf, l = 0, acc = 0).
//   2. Paged, a block reads its run's block-table entries once (one lane
//      per page); dense, a run is rows [p0 * tile_rows, ...) of the slot
//      and needs no table, so the chain before the first load is length ->
//      TMA, and rank 0's run starts at row 0 whatever the length, so its
//      first K and V boxes are issued before the length has arrived (each
//      took 0.2-0.45 us off every length, trace/decode_sweep.py on one
//      H100). Then one thread issues every unit's K and V tiles at once as
//      4-D TMA boxes {D, rows, 1, 1}: over the [P, page, H, D] pool
//      (coordinate 3 the page id) or over the [B, L, H, D] cache
//      (coordinate 1 the row, coordinate 3 the slot), each completing on
//      its stage's mbarrier. Where a run's tiles all fit in shared memory
//      K tile i has stage i and V tile i a stage at a fixed offset past
//      the K tiles; where they do not (fp32 pages, D 128/256, long runs)
//      they stream through a ring of stages, each refilled as soon as the
//      block has read it. Boxes reaching past L read zeros and those rows
//      are never used. The int8 scales are 4 bytes a row at a stride of
//      H*4, below TMA's 16-byte minimum: the block's threads load them once
//      per (row, head) into shared memory while the tiles fly.
//   3. Compute stays on CUDA cores, from shared memory: one query row per
//      (slot, head) leaves no tensor-core shape to fill (wgmma's M is at
//      least 64, so 63 of 64 rows would be padding). q.k: D/8 lanes a row,
//      8 values a lane, a shuffle reduction; the block then takes one max
//      and one sum over its scores; P.V: each warp takes every fourth row,
//      each lane D/32 output values (at D 16, the draft model's depth, a
//      half-warp takes a row, each lane one value, and the two halves'
//      sums meet by one shuffle; an int8 row is then 16 bytes, TMA's
//      narrowest box). The tiles land unswizzled: every read
//      is of whole rows by consecutive lanes, so the 8 lanes of a
//      quarter-warp (or the 32 of a warp, for narrower loads) read one
//      contiguous span and hit distinct banks without a swizzle.
//   4. The blocks merge through distributed shared memory: each block
//      writes its (acc[D], m, l) into its own row of rank 0's shared memory
//      (map_shared_rank); after one cluster barrier, rank 0 merges the rows
//      in rank order and writes the output. The push waits on a cluster
//      barrier whose relaxed arrive each block makes at entry, so every
//      block of the cluster is known to have started before any reaches
//      another's shared memory. (Rank 0 reading every rank's shared memory
//      instead needs a second barrier, to keep the others' alive, and
//      measured 0.7-1.0 us slower.) The result is deterministic, with no
//      workspace and no second launch. A slot of at most kSoloPages live
//      units is rank 0's alone: the other ranks leave at once and rank 0
//      writes the output with no barrier and no merge (the same numbers:
//      the merge of one non-empty run is that run).
// Numerics follow the TPU kernels: fp32 scores and sums; for bf16 pages p
// is rounded to bf16 before P.V; for int8 rows K and V are dequantized to
// fp32 (the scale applied to the dot and to p). Rows t >= length are never
// used, table entries past the slot's live pages are never read, and a
// length-0 slot writes zeros. One launch, on the caller's stream; no
// allocation and no synchronisation, so a CUDA graph can capture it (the
// tensor maps are built from the cache's own pointers, which the serving
// engine never moves, and baked into the graph at capture).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kVec = 8;        // row elements per lane
constexpr int kPagedThreads = 128;
constexpr int kPagedWarps = kPagedThreads / 32;
constexpr int kMaxSplits = 8;    // the portable cluster size
constexpr int kSoloPages = 1;    // a slot of this many units is rank 0's alone
constexpr int kMaxStages = 8;    // mbarriers of the tile ring
constexpr int kTileRows = 64;    // rows of one page in one TMA box, at most
constexpr int kMaxBoxRows = 256; // TMA's largest box dimension
constexpr int kStageBudget = 128 * 1024;  // shared memory of the ring
constexpr int kSmemLimit = 232448;        // a block's, on an H100

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <int kBytes>
struct Raw;
template <>
struct Raw<1> { using type = uint8_t; };
template <>
struct Raw<2> { using type = uint16_t; };
template <>
struct Raw<4> { using type = uint32_t; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

// C consecutive elements at p (aligned to their C * sizeof(T) bytes), in
// one load, as floats.
template <typename T, int C>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  using R = typename Raw<C * sizeof(T)>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  T vals[C];
  memcpy(vals, &raw, sizeof(raw));
#pragma unroll
  for (int e = 0; e < C; ++e) out[e] = to_float(vals[e]);
}

// The block's max (kMax) or sum of x, every thread's; s_warp holds one
// float a warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = x;
  __syncthreads();
  float r = s_warp[0];
#pragma unroll
  for (int w = 1; w < kPagedWarps; ++w)
    r = kMax ? fmaxf(r, s_warp[w]) : r + s_warp[w];
  __syncthreads();
  return r;
}

// --------------------- K6, K7, K8: the split cluster ---------------------

struct ClusterArgs {
  const void* q;           // [B, 1, H, D]
  const float* k_scale;    // int8: [P, page, H] (paged) or [B, L, H] (dense)
  const float* v_scale;
  const int* table;        // paged: [B, max_blocks]; dense: unused
  const int* lengths;      // [B]
  void* out;               // [B, 1, H, D]
  int heads;
  int page;                // rows of a unit: a page, or a dense box
  int max_blocks;          // units a slot holds
  int cap;                 // rows a slot holds: max_blocks * page, or L
  int tile_rows;           // rows of a TMA box (<= page)
  int stages;              // ring stages
  int stage_stride;        // bytes between stages
  float scale;
};

// The split plan shared by the launches and the *_decode_plan entry
// points: a TMA box is at most box_cap rows of a unit of `page` rows.
struct Plan {
  int tile_rows, stages, stage_stride, smem;
};

Plan plan_for(int depth, int elt, int page, int max_blocks, int splits,
              bool int8, int box_cap) {
  Plan p;
  p.tile_rows = page < box_cap ? page : box_cap;
  const int tiles_per_page = (page + p.tile_rows - 1) / p.tile_rows;
  const int max_pages = (max_blocks + splits - 1) / splits;
  p.stage_stride = (p.tile_rows * depth * elt + 127) / 128 * 128;
  int stages = 2 * max_pages * tiles_per_page;
  const int fit = kStageBudget / p.stage_stride;
  stages = stages < fit ? stages : fit;
  stages = stages < kMaxStages ? stages : kMaxStages;
  p.stages = stages > 1 ? stages : 1;
  p.smem = 1024 + p.stages * p.stage_stride +
           4 * max_pages * page * (int8 ? 3 : 1) + 4 * max_pages;
  return p;
}

// One block of the cluster of its (slot, head), paged (kDense false: units
// are pages found through the block table) or dense (units are boxes of
// rows of the slot's own [L, H, D] rows). Grid: B * H * S blocks in
// clusters of S (blockIdx.x = (b * H + h) * S + rank). Dynamic shared
// memory: the tile ring (1024-aligned), then the run's scores /
// probabilities, int8 K and V scales, and page ids.
template <typename TQ, typename TKV, int D, bool kDense>
__device__ __forceinline__ void decode_cluster(const CUtensorMap* k_map,
                                               const CUtensorMap* v_map,
                                               const ClusterArgs& a) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr bool kRoundP = std::is_same<TKV, __nv_bfloat16>::value;
  constexpr int kElt = sizeof(TKV);
  // q.k: a row's D values over kLanes lanes, 8 a lane, in chunks of kChunk
  // consecutive values (16 bytes; 8 bytes for int8): chunk c of lane l
  // starts at value (c * kLanes + l) * kChunk.
  constexpr int kLanes = D / kVec;
  constexpr int kGroups = kPagedThreads / kLanes;
  constexpr int kChunk = 16 / kElt < kVec ? 16 / kElt : kVec;
  constexpr int kChunks = kVec / kChunk;
  // P.V: a row's D values over kVLanes lanes (the warp's 32; at D 16 a
  // half-warp, so a warp takes kVRows = 2 rows at once): warp w takes rows
  // w * kVRows + lane / kVLanes, then kPagedWarps * kVRows further on; lane
  // l of its row owns kDims output values, in chunks of kVChunk starting at
  // (c * kVLanes + l % kVLanes) * kVChunk. The row groups' sums meet by
  // shuffle after the loop.
  constexpr int kVLanes = D < 32 ? D : 32;
  constexpr int kVRows = 32 / kVLanes;
  constexpr int kDims = D / kVLanes;
  constexpr int kVChunk = 16 / kElt < kDims ? 16 / kElt : kDims;
  constexpr int kVChunks = kDims / kVChunk;
  static_assert(kLanes >= 2 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
                "D must be 16, 32, 64, 128 or 256");

  __shared__ uint64_t bars[kMaxStages];
  __shared__ float s_part[kPagedWarps][D];
  __shared__ float s_warp[kPagedWarps];
  __shared__ float s_all[kMaxSplits][D + 2];  // rank 0's: each rank's row
  extern __shared__ __align__(1024) unsigned char smem_raw[];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / splits;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Where the ring holds every tile of any run (whole), K tile i has stage
  // i and V tile i stage v_base + i, each stage used once; otherwise the
  // tiles stream through the ring in issue order. Dense, rank 0's run
  // starts at row 0 of the slot whatever its length: with a whole ring its
  // first K and V boxes are on their way before the length is.
  unsigned char* ring = hopper::align_1024(smem_raw);
  const int max_pages = (a.max_blocks + splits - 1) / splits;
  const int tiles_per_page = (a.page + a.tile_rows - 1) / a.tile_rows;
  const int v_base = max_pages * tiles_per_page;
  const bool whole = a.stages >= 2 * v_base;
  const bool early = kDense && rank == 0 && whole;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_barrier_init();
    if (early) {
      hopper::mbar_expect_tx(&bars[0], a.tile_rows * D * kElt);
      hopper::tma_load_4d(ring, k_map, &bars[0], 0, 0, h, b);
      hopper::mbar_expect_tx(&bars[v_base], a.tile_rows * D * kElt);
      hopper::tma_load_4d(ring + v_base * a.stage_stride, v_map,
                          &bars[v_base], 0, 0, h, b);
    }
  }

  // This block's run: units [p0, p1) of the slot's live ones, rows
  // [0, rows) of the run. A slot of at most kSoloPages live units, or any
  // slot of a one-block cluster, is rank 0's alone (solo, the same for
  // every rank of the cluster): the others leave at once, and rank 0
  // writes its output with no cluster barrier and no merge.
  const int page = a.page;
  const int len = min(max(a.lengths[b], 0), a.cap);
  const int np = (len + page - 1) / page;
  const bool solo = splits == 1 || np <= min(kSoloPages, max_pages);
  if (solo && rank != 0) return;
  const int per = solo ? np : (np + splits - 1) / splits;
  const int p0 = min(np, rank * per);
  const int p1 = min(np, p0 + per);
  const int rows = max(0, min(len, p1 * page) - p0 * page);
  const int k_tiles = (p1 - p0) * tiles_per_page;
  const int n_tiles = 2 * k_tiles;

  float* s_p = reinterpret_cast<float*>(ring + a.stages * a.stage_stride);
  float* s_ks = s_p + max_pages * page;
  float* s_vs = s_ks + max_pages * page;
  int* s_pid = reinterpret_cast<int*>(s_p + (kInt8 ? 3 : 1) * max_pages * page);

  if (!kDense && warp == 0) {
    for (int i = lane; i < p1 - p0; i += 32)
      s_pid[i] = a.table[static_cast<size_t>(b) * a.max_blocks + p0 + i];
  }
  __syncthreads();
  // Half of the barrier that must precede any access to another rank's
  // shared memory; the wait comes just before the push.
  if (!solo) hopper::cluster_arrive_relaxed();

  // Tile j < k_tiles is K, then V, in (unit, row block) order: its stage
  // and the parity of its phase there.
  auto stage_of = [&](int j) {
    return whole ? (j < k_tiles ? j : v_base + j - k_tiles) : j % a.stages;
  };
  auto phase_of = [&](int j) {
    return whole ? 0u : static_cast<uint32_t>(j / a.stages) & 1u;
  };
  // Paged: rows of page s_pid[unit]; dense: rows of slot b from the run's
  // first row.
  auto issue = [&](int j) {
    const int stage = stage_of(j);
    const int idx = j < k_tiles ? j : j - k_tiles;
    const int unit = idx / tiles_per_page;
    const int row0 = (idx % tiles_per_page) * a.tile_rows;
    hopper::mbar_expect_tx(&bars[stage], a.tile_rows * D * kElt);
    hopper::tma_load_4d(ring + stage * a.stage_stride,
                        j < k_tiles ? k_map : v_map, &bars[stage], 0,
                        kDense ? (p0 + unit) * page + row0 : row0, h,
                        kDense ? b : s_pid[unit]);
  };
  if (tid == 0) {
    for (int j = 0; j < min(a.stages, n_tiles); ++j)
      if (!early || (j != 0 && j != k_tiles)) issue(j);
    if (early && n_tiles == 0) {  // the slot is empty: let them land
      hopper::mbar_wait(&bars[0], 0);
      hopper::mbar_wait(&bars[v_base], 0);
    }
  }
  if constexpr (kInt8) {
    for (int r = tid; r < rows; r += kPagedThreads) {
      const size_t row =
          kDense ? static_cast<size_t>(b) * a.cap + p0 * page + r
                 : static_cast<size_t>(s_pid[r / page]) * page + r % page;
      const size_t at = row * a.heads + h;
      s_ks[r] = a.k_scale[at];
      s_vs[r] = a.v_scale[at];
    }
  }

  const TQ* qrow = static_cast<const TQ*>(a.q) + static_cast<size_t>(bh) * D;
  const int group = tid / kLanes;
  const int gl = tid % kLanes;
  float qf[kVec];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      qf[c * kChunk + e] = to_float(qrow[(c * kLanes + gl) * kChunk + e]);

  // The first row of tile idx in the run, and how many of its rows count.
  auto tile_span = [&](int idx, int* r0) {
    const int within = (idx % tiles_per_page) * a.tile_rows;
    *r0 = (idx / tiles_per_page) * page + within;
    return min(min(a.tile_rows, page - within), rows - *r0);
  };

  // Scores. The trip count is the same for every lane of a warp (the
  // shuffles need all 32); rows past the tile's count are masked.
  for (int j = 0; j < k_tiles; ++j) {
    const int stage = stage_of(j);
    hopper::mbar_wait(&bars[stage], phase_of(j));
    const TKV* tile =
        reinterpret_cast<const TKV*>(ring + stage * a.stage_stride);
    int r0;
    const int valid = tile_span(j, &r0);
    for (int t0 = 0; t0 < valid; t0 += kGroups) {
      const int t = t0 + group;
      float kf[kVec];
      if (t < valid) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          load_vec<TKV, kChunk>(tile + t * D + (c * kLanes + gl) * kChunk,
                                kf + c * kChunk);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = 0.f;
      }
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot += qf[e] * kf[e];
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (t < valid && gl == 0) s_p[r0 + t] = dot;
    }
    if (j + a.stages < n_tiles) {  // the stage is read: refill it
      __syncthreads();
      if (tid == 0) issue(j + a.stages);
    }
  }
  __syncthreads();

  // One softmax over the run: m, l and p (what P.V multiplies: p rounded
  // to bf16 for bf16 pages, p times the V scale for int8 pages).
  float mx = -INFINITY;
  for (int r = tid; r < rows; r += kPagedThreads) {
    float s = s_p[r] * a.scale;
    if constexpr (kInt8) s *= s_ks[r];
    s_p[r] = s;
    mx = fmaxf(mx, s);
  }
  const float m = block_reduce<true>(mx, s_warp);
  float lsum = 0.f;
  for (int r = tid; r < rows; r += kPagedThreads) {
    const float p = expf(s_p[r] - m);
    lsum += p;
    if constexpr (kInt8) {
      s_p[r] = p * s_vs[r];
    } else {
      s_p[r] = kRoundP ? __bfloat162float(__float2bfloat16(p)) : p;
    }
  }
  const float l = block_reduce<false>(lsum, s_warp);

  float acc[kDims];
#pragma unroll
  for (int e = 0; e < kDims; ++e) acc[e] = 0.f;
  for (int j = k_tiles; j < n_tiles; ++j) {
    const int stage = stage_of(j);
    hopper::mbar_wait(&bars[stage], phase_of(j));
    const TKV* tile =
        reinterpret_cast<const TKV*>(ring + stage * a.stage_stride);
    int r0;
    const int valid = tile_span(j - k_tiles, &r0);
    for (int t = warp * kVRows + lane / kVLanes; t < valid;
         t += kPagedWarps * kVRows) {
      const float p = s_p[r0 + t];
#pragma unroll
      for (int c = 0; c < kVChunks; ++c) {
        float vf[kVChunk];
        load_vec<TKV, kVChunk>(
            tile + t * D + (c * kVLanes + lane % kVLanes) * kVChunk, vf);
#pragma unroll
        for (int e = 0; e < kVChunk; ++e) acc[c * kVChunk + e] += p * vf[e];
      }
    }
    if (j + a.stages < n_tiles) {
      __syncthreads();
      if (tid == 0) issue(j + a.stages);
    }
  }
#pragma unroll
  for (int e = 0; e < kDims; ++e)
#pragma unroll
    for (int off = kVLanes; off < 32; off *= 2)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  if (lane < kVLanes) {
#pragma unroll
    for (int c = 0; c < kVChunks; ++c)
#pragma unroll
      for (int e = 0; e < kVChunk; ++e)
        s_part[warp][(c * kVLanes + lane) * kVChunk + e] =
            acc[c * kVChunk + e];
  }
  __syncthreads();
  if (solo) {  // rank 0 holds the whole slot
    TQ* o = static_cast<TQ*>(a.out) + static_cast<size_t>(bh) * D;
    for (int d = tid; d < D; d += kPagedThreads) {
      float x = s_part[0][d];
#pragma unroll
      for (int w = 1; w < kPagedWarps; ++w) x += s_part[w][d];
      store(o + d, len > 0 ? x / l : 0.f);
    }
    return;
  }
  // Every rank has started (the arrive at entry), so rank 0's shared
  // memory is live: push this rank's (acc, m, l) into its row there.
  hopper::cluster_wait();
  float* row = cluster.map_shared_rank(&s_all[0][0], 0) + rank * (D + 2);
  for (int d = tid; d < D; d += kPagedThreads) {
    float x = s_part[0][d];
#pragma unroll
    for (int w = 1; w < kPagedWarps; ++w) x += s_part[w][d];
    row[d] = x;
  }
  if (tid == 0) {
    row[D] = m;
    row[D + 1] = l;
  }
  cluster.sync();  // every rank's row is in rank 0's shared memory

  // Merge the rows in rank order on rank 0.
  if (rank == 0) {
    TQ* o = static_cast<TQ*>(a.out) + static_cast<size_t>(bh) * D;
    for (int d = tid; d < D; d += kPagedThreads) {
      float big = -INFINITY;
      for (int j = 0; j < splits; ++j) big = fmaxf(big, s_all[j][D]);
      float num = 0.f;
      float den = 0.f;
      for (int j = 0; j < splits; ++j) {
        const float* ml = s_all[j] + D;
        const float w = expf(ml[0] - big);
        den += w * ml[1];
        num += w * s_all[j][d];
      }
      store(o + d, len > 0 ? num / den : 0.f);
    }
  }
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kPagedThreads) paged_decode_cluster_kernel(
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const ClusterArgs a) {
  decode_cluster<TQ, TKV, D, false>(&k_map, &v_map, a);
}

template <typename TQ, int D>
__global__ void __launch_bounds__(kPagedThreads) dense_decode_cluster_kernel(
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const ClusterArgs a) {
  decode_cluster<TQ, int8_t, D, true>(&k_map, &v_map, a);
}

// Encodes the K and V maps (4-D, unswizzled boxes {D, tile_rows, 1, 1}),
// raises the kernel's dynamic shared memory where the plan needs it and
// launches B * H * splits blocks in clusters of `splits`.
template <typename Kernel>
cudaError_t launch_cluster(Kernel* kernel, const void* k, const void* v,
                           CUtensorMapDataType type,
                           const long long (&dims)[4],
                           const long long (&strides)[3], const Plan& plan,
                           int* smem_allowed, const ClusterArgs& args,
                           int batch, int splits, cudaStream_t stream) {
  if (plan.smem > kSmemLimit) return cudaErrorInvalidValue;
  const int box[4] = {static_cast<int>(dims[0]), plan.tile_rows, 1, 1};
  CUtensorMap k_map, v_map;
  cudaError_t err = hopper::tensor_map_4d(&k_map, k, type, dims, strides, box,
                                          CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  err = hopper::tensor_map_4d(&v_map, v, type, dims, strides, box,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  // Raised once, outside any graph capture (the first launch is eager).
  if (plan.smem > *smem_allowed) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) return err;
    *smem_allowed = plan.smem;
  }
  ClusterArgs a = args;
  a.tile_rows = plan.tile_rows;
  a.stages = plan.stages;
  a.stage_stride = plan.stage_stride;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * a.heads * splits);
  config.blockDim = dim3(kPagedThreads);
  config.dynamicSmemBytes = plan.smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  void* params[] = {&k_map, &v_map, &a};
  err = cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(kernel),
                            params);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_paged(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const void* table, const void* lengths, void* out,
                         int batch, int heads, int page, int max_blocks,
                         int num_pages, int splits, float scale,
                         cudaStream_t stream) {
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  const CUtensorMapDataType type =
      kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
            : (std::is_same<TKV, float>::value
                   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  const long long elt = sizeof(TKV);
  const long long dims[4] = {D, page, heads, num_pages};
  const long long strides[3] = {heads * D * elt, D * elt,
                                static_cast<long long>(page) * heads * D * elt};
  static int smem_allowed = 48 * 1024;
  const ClusterArgs args{q,       static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale),
                         static_cast<const int*>(table),
                         static_cast<const int*>(lengths),
                         out,     heads, page, max_blocks, max_blocks * page,
                         0,       0,     0,    scale};
  return launch_cluster(
      paged_decode_cluster_kernel<TQ, TKV, D>, k, v, type, dims, strides,
      plan_for(D, sizeof(TKV), page, max_blocks, splits, kInt8, kTileRows),
      &smem_allowed, args, batch, splits, stream);
}

template <typename TQ, typename TKV>
cudaError_t paged_depth(int depth, const void* q, const void* k,
                        const void* v, const void* k_scale,
                        const void* v_scale, const void* table,
                        const void* lengths, void* out, int batch, int heads,
                        int page, int max_blocks, int num_pages, int splits,
                        float scale, cudaStream_t stream) {
#define BS_PAGED(DEPTH)                                                     \
  launch_paged<TQ, TKV, DEPTH>(q, k, v, k_scale, v_scale, table, lengths, \
                               out, batch, heads, page, max_blocks,        \
                               num_pages, splits, scale, stream)
  switch (depth) {
    case 16: return BS_PAGED(16);
    case 32: return BS_PAGED(32);
    case 64: return BS_PAGED(64);
    case 128: return BS_PAGED(128);
    case 256: return BS_PAGED(256);
    default: return cudaErrorInvalidValue;
  }
#undef BS_PAGED
}

// K8: the dense int8 cache [B, L, H, D] (k, v) with [B, L, H] scales, in
// units of tile_rows rows, each one TMA box: a box at (0, row, h, b).
template <typename TQ, int D>
cudaError_t launch_dense(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const void* lengths, void* out, int batch, int rows,
                         int heads, int splits, int tile_rows, float scale,
                         cudaStream_t stream) {
  const int units = (rows + tile_rows - 1) / tile_rows;
  const long long dims[4] = {D, rows, heads, batch};
  const long long strides[3] = {static_cast<long long>(heads) * D, D,
                                static_cast<long long>(rows) * heads * D};
  static int smem_allowed = 48 * 1024;
  const ClusterArgs args{q,   static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale),
                         nullptr,
                         static_cast<const int*>(lengths),
                         out, heads, tile_rows, units, rows,
                         0,   0,     0,         scale};
  return launch_cluster(
      dense_decode_cluster_kernel<TQ, D>, k, v, CU_TENSOR_MAP_DATA_TYPE_UINT8,
      dims, strides,
      plan_for(D, 1, tile_rows, units, splits, true, kMaxBoxRows),
      &smem_allowed, args, batch, splits, stream);
}

template <typename TQ>
cudaError_t dense_depth(int depth, const void* q, const void* k,
                        const void* v, const void* k_scale,
                        const void* v_scale, const void* lengths, void* out,
                        int batch, int rows, int heads, int splits,
                        int tile_rows, float scale, cudaStream_t stream) {
#define BS_DENSE(DEPTH)                                                     \
  launch_dense<TQ, DEPTH>(q, k, v, k_scale, v_scale, lengths, out, batch,  \
                          rows, heads, splits, tile_rows, scale, stream)
  switch (depth) {
    case 16: return BS_DENSE(16);
    case 32: return BS_DENSE(32);
    case 64: return BS_DENSE(64);
    case 128: return BS_DENSE(128);
    case 256: return BS_DENSE(256);
    default: return cudaErrorInvalidValue;
  }
#undef BS_DENSE
}

bool valid_splits(int splits) {
  return splits == 1 || splits == 2 || splits == 4 || splits == kMaxSplits;
}

bool valid_dense(int rows, int tile_rows, int splits) {
  return valid_splits(splits) && tile_rows >= 1 && tile_rows <= rows &&
         tile_rows <= kMaxBoxRows;
}

}  // namespace

extern "C" {

// K6 (kv_dtype fp32/bf16, the page type equal to q's; scales null) and K7
// (kv_dtype int8, fp32 scales): the cluster kernel over `splits` blocks a
// (slot, head). Returns the launch's cudaError_t (0 = launched).
int bs_paged_decode_attention(int device, const void* q, const void* k_pages,
                              const void* v_pages, const void* k_scales,
                              const void* v_scales, const void* block_table,
                              const void* lengths, void* out, int batch,
                              int heads, int depth, int page, int max_blocks,
                              int num_pages, int splits, int q_dtype,
                              int kv_dtype, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid_splits(splits) || page < 1 || max_blocks < 1)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
#define BS_ARGS                                                             \
  depth, q, k_pages, v_pages, k_scales, v_scales, block_table, lengths,     \
      out, batch, heads, page, max_blocks, num_pages, splits, scale, s
  if (q_dtype == kF32 && kv_dtype == kF32)
    return paged_depth<float, float>(BS_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return paged_depth<__nv_bfloat16, __nv_bfloat16>(BS_ARGS);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return paged_depth<float, int8_t>(BS_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return paged_depth<__nv_bfloat16, int8_t>(BS_ARGS);
#undef BS_ARGS
  return cudaErrorInvalidValue;
}

// The cluster kernel's plan for these shapes: out[0] ring stages, out[1]
// bytes between stages, out[2] dynamic shared memory a block, out[3] rows
// of a TMA box. Returns cudaErrorInvalidValue where it would not launch.
int bs_paged_decode_plan(int depth, int page, int max_blocks, int splits,
                         int kv_dtype, int* out) {
  if (!valid_splits(splits) || page < 1 || max_blocks < 1 ||
      kv_dtype < kF32 || kv_dtype > kI8)
    return cudaErrorInvalidValue;
  const int elt = kv_dtype == kF32 ? 4 : (kv_dtype == kBF16 ? 2 : 1);
  const Plan plan = plan_for(depth, elt, page, max_blocks, splits,
                             kv_dtype == kI8, kTileRows);
  out[0] = plan.stages;
  out[1] = plan.stage_stride;
  out[2] = plan.smem;
  out[3] = plan.tile_rows;
  return plan.smem > kSmemLimit ? cudaErrorInvalidValue : cudaSuccess;
}

// K8: the cluster kernel over the dense int8 cache [B, rows, H, D] with
// [B, rows, H] scales, `splits` blocks a (slot, head), in units of
// tile_rows rows (one TMA box each).
int bs_dense_decode_attention_int8(int device, const void* q,
                                   const void* cache_k, const void* cache_v,
                                   const void* k_scales, const void* v_scales,
                                   const void* lengths, void* out, int batch,
                                   int rows, int heads, int depth, int splits,
                                   int tile_rows, int q_dtype, float scale,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!valid_dense(rows, tile_rows, splits)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
#define BS_ARGS                                                             \
  depth, q, cache_k, cache_v, k_scales, v_scales, lengths, out, batch,      \
      rows, heads, splits, tile_rows, scale, s
  if (q_dtype == kF32) return dense_depth<float>(BS_ARGS);
  if (q_dtype == kBF16) return dense_depth<__nv_bfloat16>(BS_ARGS);
#undef BS_ARGS
  return cudaErrorInvalidValue;
}

// The dense kernel's plan, as bs_paged_decode_plan gives the paged one's.
int bs_dense_decode_plan(int depth, int rows, int tile_rows, int splits,
                         int* out) {
  if (!valid_dense(rows, tile_rows, splits)) return cudaErrorInvalidValue;
  const Plan plan = plan_for(depth, 1, tile_rows,
                             (rows + tile_rows - 1) / tile_rows, splits, true,
                             kMaxBoxRows);
  out[0] = plan.stages;
  out[1] = plan.stage_stride;
  out[2] = plan.smem;
  out[3] = plan.tile_rows;
  return plan.smem > kSmemLimit ? cudaErrorInvalidValue : cudaSuccess;
}

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
