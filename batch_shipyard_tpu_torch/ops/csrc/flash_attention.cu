// Flash attention forward and backward over [B, T, H, D], for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of batch_shipyard_tpu:
//   K1 ops/attention.py:_flash_fwd_kernel  (forward: O and lse)
//   K2 ops/attention.py:_flash_bwd_kernel  (backward: dQ, dK, dV)
// Element types: __nv_bfloat16 (training) and float (the exact-math
// check); head depth 64 or 128. q/k/v/dO are read in place through their
// [B, T, H, D] strides (the last dim contiguous, the other strides and the
// base 16-byte aligned); O, dQ, dK, dV are written contiguous [B, T, H, D];
// lse and delta are fp32 [B*H, T].
//
// What bounds it. At the training shape (B16 H16 T2048 D64, causal, bf16)
// K1 does 4*B*H*T*T*D/2 = 137 GFLOP: 0.139 ms at the 989 TFLOP/s bf16 peak,
// against 0.080 ms to move its 268 MB. K2's five products are 0.347 ms.
// Both are bound by tensor-core operations; at D 64 the exponentials come
// as close (one ex2 per score, 0.54 G a call: ~0.15 ms at the SFU's 16 a
// cycle per SM), so the softmax has to run while products do.
//
// bf16 design (wgmma + TMA). Every kernel is a persistent grid (one block
// of three warpgroups an SM) walking row tiles in pairs, the i-th and the
// i-th from last of one b*h, so each pair is the same causal work; pairs
// go b*h-major, so the blocks in flight share their heads' K and V in L2.
// Warpgroup 0 gives up its registers (setmaxnreg) and one thread brings
// tiles by TMA through 4-D tensor maps over the strided views (dims D, T,
// H, B; boxes of 64 columns, 128-byte swizzled, two boxes a row at D 128;
// rows past T read as zeros, so the ragged tail is masked by position).
// A row tile's own rows go to one of two buffers, so the next tile's
// loads run under this one's work; the other axis streams through a ring
// of stages (full and empty mbarriers; a wait traps after ~10 s instead
// of hanging). Warpgroups 1 and 2 own 64 rows each and run wgmma m64nNk16
// (bf16 in, fp32 accumulate). The scores stay in their accumulators, whose
// layout (rows g and g + 8 of each warp's 16, columns 8j + 2t and + 1) is
// the A fragment of the next product once rounded to bf16, so P and dS
// reach the tensor cores from registers: ptxas reported no serialized
// wgmma for this route. Tiles that straddle the causal diagonal or the
// ragged tail are masked by a select against a per-row limit.
//   K1 (flash_fwd_wgmma_kernel): 128 q rows a tile; K and V tiles of kBN
//     keys (128 at D 64, 64 at D 128) through a 4-stage ring. For kv tile j
//     a warpgroup issues S_j = Q K_j^T (A and B K-major) and then O +=
//     P_{j-1} V_{j-1} (V MN-major, transposed), waits for S_j alone and
//     runs the softmax of tile j (log2 domain: one FMA, one exp2 and one
//     add a score) while P V is in flight; then rescales O. p is rounded
//     to bf16 as the A fragment. lse = (m + log2 l) ln 2, l == 0 -> 1.
//   K2 is the deterministic split. The TPU kernel carries dQ in VMEM
//     across its sequential kv axis; here blocks run in no order, and
//     FA3's route (fp32 atomics into dQ) gives results that change from
//     run to run. So two kernels, each owning its outputs and summing in
//     the same order on every run, with P and dP recomputed (seven
//     products against the five that the fused form needs):
//   flash_bwd_dkdv_wgmma_kernel: 128 keys a tile (64 a warpgroup); K and
//     V of the tile once; Q and dO (64 q rows a stage) through a 4-stage
//     ring (2 at D 128), with lse * log2(e) and delta beside them (one
//     producer warp copies those into the stage and arrives on its full
//     barrier with the TMA bytes). Per q tile: S^T = K Q^T and dP^T = V
//     dO^T (SS), P^T = exp2(S^T c - lse2) rounded to bf16 for dV += P^T
//     dO, dS^T = P^T (dP^T - delta) rounded for dK += dS^T Q (both RS, dO
//     and Q MN-major). Holding a tile's fragments across the next tile's
//     scores does not fit beside the four accumulators. dK is scaled at
//     the end. At D 128 the dK and dV accumulators (64 registers each) do
//     not fit together, so the kernel walks the q tiles twice: dV, then dK
//     (five products a tile instead of four).
//   flash_bwd_dq_wgmma_kernel: 128 q rows a tile; Q and dO once; K and V
//     tiles of 64 keys through a 4-stage ring (3 at D 128). As K1: S_j and
//     dP_j, then dQ += dS_{j-1} K_{j-1} (K MN-major), dS_j formed while
//     that update is in flight; dQ scaled at the end.
//   Rounding points follow the reference kernels: p to V's type before
//   P.V, p to dO's type for dV, dS to the operand's type for dK and dQ.
//   Registers: ptxas holds a 384-thread block at 168 a thread whatever
//   setmaxnreg asks, so the tiles are sized to it; every bf16 kernel uses
//   168 with no spill (per consumer thread at D 64: K1 S 64 + O 32 + P 32;
//   dK/dV S^T 32 + dP^T 32 + dK 32 + dV 32 + fragments 32; dQ S 32 + dP 32
//   + dQ 32 + dS 16). Dynamic shared memory a block: K1 164,960 bytes (D
//   64) and 197,728 (D 128); dK/dV 134,240 and 198,720; dQ 132,192 and
//   230,480 (bs_flash_attention_smem).
//   What bounds it now (training shape, NVIDIA H100 80GB HBM3 at 700 W;
//   the numbers in PERF.md): K1 at 2.7x its bound and 1.1x SDPA's time; the
//   softmax's issue slots and exp2s, which the two warpgroups and the
//   in-flight P V only partly hide. K2 at 3.0x the five-product bound and
//   2.2x the seven products it runs: the dK/dV kernel has no overlap
//   inside a warpgroup (registers), and its N-64 scores read both
//   operands from shared memory at its full rate. Tried and dropped:
//   ping-pong named barriers between the two warpgroups (no gain); a
//   wgmma under a branch ptxas cannot prove uniform (C7520: every wgmma
//   serialized, hence the peeled first and last kv tiles); per-element
//   mask branches (a reconvergence barrier each: K1 took 1.44x as long).
//
// fp32 design (flash_*_fma_kernel): the exact-math check's route, on no
// training path. bf16 wgmma would not hold its 2e-5 tolerance, so it
// keeps plain FMAs: one block of four warps per 64 rows walks the other
// axis in tiles of 64 (32 at D 128) staged in padded shared memory, in
// the accumulator layout of mma.sync, with the same split backward.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  const float* delta;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  int batch, heads, seq, causal;
  float scale;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The kv tiles a row block ending before `row_end` walks.
__device__ __forceinline__ int kv_tiles(const Args& a, int row_end, int bn) {
  const int n = cdiv(a.seq, bn);
  return a.causal ? min(n, cdiv(row_end, bn)) : n;
}

// ------------------------- bf16: wgmma + TMA --------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}

// A block's tiles: two buffers of kFixed tiles of kBM rows (a row tile's
// own rows: Q; K and V; Q and dO), so the next row tile's loads overlap
// this one's work, a ring of kStages stages of two kBN-row tiles each
// (the other axis), and, with kExtra, two fp32 vectors of kBN a stage
// (lse * log2 e and delta). A tile of r rows at depth D is D / 64 boxes
// [r][64] of r * 128 bytes.
template <int D, int BM, int BN, int Stages, int Fixed, bool Extra>
struct Plan {
  static constexpr int kD = D, kBM = BM, kBN = BN, kStages = Stages;
  static constexpr int kFixed = Fixed;
  static constexpr bool kExtra = Extra;
  static constexpr int kFixedBox = BM * 128;
  static constexpr int kFixedTile = BM * D * 2;
  static constexpr int kRingBox = BN * 128;
  static constexpr int kRingTile = BN * D * 2;
  static constexpr int kStageBytes = 2 * kRingTile;
  static constexpr int kTiles = 2 * Fixed * kFixedTile + Stages * kStageBytes;
  static constexpr size_t kSmem = 1024 + kTiles + (2 * Stages + 4) * 8 +
                                  (Extra ? Stages * 2 * BN * 4 : 0);
};

template <int D>
using FwdPlan = Plan<D, 128, D == 64 ? 128 : 64, 4, 1, false>;
template <int D>
using DkdvPlan = Plan<D, 128, 64, D == 64 ? 4 : 2, 2, true>;
template <int D>
using DqPlan = Plan<D, 128, 64, D == 64 ? 4 : 3, 2, false>;

constexpr int kWgThreads = 384;  // producer warpgroup + two consumers

template <class P>
struct Ring {
  unsigned char* base;
  uint64_t* full;         // [kStages]
  uint64_t* empty;        // [kStages]
  uint64_t* fixed_full;   // [2]
  uint64_t* fixed_empty;  // [2]
  float* extra;

  __device__ __forceinline__ unsigned char* fixed_tile(int buf, int i) const {
    return base + (buf * P::kFixed + i) * P::kFixedTile;
  }
  __device__ __forceinline__ unsigned char* stage(int s) const {
    return base + 2 * P::kFixed * P::kFixedTile + s * P::kStageBytes;
  }
  __device__ __forceinline__ float* lse2(int s) const {
    return extra + s * 2 * P::kBN;
  }
  __device__ __forceinline__ float* delta(int s) const {
    return extra + s * 2 * P::kBN + P::kBN;
  }
  // A consumer warp is done with stage s / fixed buffer buf.
  __device__ __forceinline__ void release(int s) const {
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[s]);
  }
  __device__ __forceinline__ void release_fixed(int buf) const {
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&fixed_empty[buf]);
  }
};

// Carves the ring out of dynamic shared memory and initialises its
// barriers (call before the role split): a stage is full when the TMA
// thread's expect_tx arrival (and, with the extra vectors, 32 more of
// the warp that copies them) and its bytes have landed; a stage or a
// fixed buffer is empty when the eight consumer warps have released it.
template <class P>
__device__ __forceinline__ Ring<P> ring_init(unsigned char* smem_raw) {
  Ring<P> r;
  r.base = hopper::align_1024(smem_raw);
  r.full = reinterpret_cast<uint64_t*>(r.base + P::kTiles);
  r.empty = r.full + P::kStages;
  r.fixed_full = r.empty + P::kStages;
  r.fixed_empty = r.fixed_full + 2;
  r.extra = reinterpret_cast<float*>(r.fixed_empty + 2);
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      hopper::mbar_init(&r.full[s], P::kExtra ? 33 : 1);
      hopper::mbar_init(&r.empty[s], 8);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&r.fixed_full[i], 1);
      hopper::mbar_init(&r.fixed_empty[i], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  return r;
}

// The row tiles of all b*h, in pairs: the i-th and the i-th from last of
// one b*h, so every pair is the same causal work (n + 1 kv tiles for n
// row tiles); pairs b*h-major, so the blocks in flight share their
// heads' K and V in L2. Block k walks pairs k, k + gridDim.x, ... (the
// grid is persistent: one block an SM), the last of the pair's tiles
// first.
struct TileIter {
  int unit, half, n_tiles, n_pairs, units;
  __device__ __forceinline__ TileIter(int tiles, int bh)
      : unit(blockIdx.x), half(0), n_tiles(tiles),
        n_pairs((tiles + 1) / 2), units((tiles + 1) / 2 * bh) {}
  __device__ __forceinline__ bool valid() const { return unit < units; }
  __device__ __forceinline__ int bh() const { return unit / n_pairs; }
  __device__ __forceinline__ int tile() const {
    const int pair = unit % n_pairs;
    return half == 0 ? n_tiles - 1 - pair : pair;
  }
  __device__ __forceinline__ void next() {
    const int pair = unit % n_pairs;
    if (half == 0 && pair != n_tiles - 1 - pair) {
      half = 1;
    } else {
      half = 0;
      unit += gridDim.x;
    }
  }
};

// Rows [row0, row0 + rows) of (b, h) in a [B, T, H, D] map into `dst`:
// D / 64 boxes, box_bytes apart.
template <int D>
__device__ __forceinline__ void load_rows_tma(unsigned char* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row0, int h,
                                              int b, int box_bytes) {
#pragma unroll
  for (int i = 0; i < D / 64; ++i)
    hopper::tma_load_4d(dst + i * box_bytes, map, bar, 64 * i, row0, h, b);
}

// wgmma descriptors over a tile of D / 64 boxes, box_bytes apart.
// K-major (the depth contracted): rows from `p`, 16-deep step kk at 32
// bytes within a box. MN-major (the rows contracted, the depth the
// product's N): step kk at 16 rows (2 KB), the boxes the leading offset.
__device__ __forceinline__ uint64_t kmajor(const unsigned char* p,
                                           int box_bytes, int kk) {
  return hopper::desc(p, 16, 1024) +
         (((kk / 4) * box_bytes + (kk % 4) * 32) >> 4);
}
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* p,
                                            int box_bytes, int kk) {
  return hopper::desc(p, box_bytes, 1024) + ((kk * 2048) >> 4);
}

// The accumulator (N columns) as bf16 A fragments: step kk's four
// registers are columns 16 kk + 2t, + 1 and 16 kk + 8 + 2t, + 1 of rows g
// and g + 8, i.e. f[4 kk + i] = (acc[8 kk + 2i], acc[8 kk + 2i + 1]).
template <int N>
__device__ __forceinline__ void to_fragments(uint32_t (&f)[N / 2],
                                             const float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) f[i] = pack_bf16x2(acc[2 * i], acc[2 * i + 1]);
}

// Writes 16 rows x D of a warp's accumulator (times mul) into a
// contiguous [B, T, H, D] tensor at (b, h); rows past seq are dropped.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* base, const float (&acc)[D / 2],
                                          int row0, const Args& a,
                                          const float (&mul)[2], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.seq) continue;
    T* out = base + static_cast<long long>(row) * a.heads * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(out + 8 * j + 2 * t, acc[4 * j + 2 * r] * mul[r],
             acc[4 * j + 2 * r + 1] * mul[r]);
  }
}

// This consumer thread's place: warpgroup wg (0 or 1) of 64 rows, warp
// and lane, rows g and g + 8 of the warp's 16.
struct Lane {
  int wg, warp, g, t;
  __device__ __forceinline__ Lane() {
    wg = threadIdx.x / 128 - 1;
    warp = threadIdx.x / 32 % 4;
    g = threadIdx.x % 32 >> 2;
    t = threadIdx.x % 4;
  }
};

// acc (+)= F . B over kBN rows of B: F the bf16 A fragments of a [64 x
// kBN] tile in registers, B a [kBN x D] tile in shared memory read
// MN-major (P.V, dS.K, P^T.dO, dS^T.Q). The first product overwrites acc
// unless `accumulate`. Every product of a kernel is issued outside any
// branch that ptxas cannot prove uniform (the first and last kv tiles
// are peeled): a wgmma under such a branch serializes them all (C7520).
template <class P>
__device__ __forceinline__ void update(float (&acc)[P::kD / 2],
                                       const uint32_t (&f)[P::kBN / 4],
                                       const unsigned char* b,
                                       bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < P::kBN / 16; ++kk)
    hopper::wgmma_bf16_rs(acc, f + 4 * kk, mnmajor(b, P::kRingBox, kk),
                          accumulate || kk > 0);
}

// acc = A . B^T over the depth: A 64 rows of a fixed tile (K-major), B a
// ring tile of kBN rows (K-major): S = Q K^T, dP = dO V^T, and their
// transposes.
template <class P>
__device__ __forceinline__ void scores(float (&acc)[P::kBN / 2],
                                       const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < P::kD / 16; ++kk)
    hopper::wgmma_bf16_ss(acc, kmajor(a, P::kFixedBox, kk),
                          kmajor(b, P::kRingBox, kk), kk > 0);
}

// K1's softmax of one scores tile, in place: p = exp2(s c - m) with the
// running max m and this thread's share l of the row sum (log2 domain)
// updated, and corr the factor that rescales the earlier sum. The max is
// taken over the raw scores (c > 0), so each score costs one FMA, one
// exp2 and one add besides. With kMasked, column 8 jj + (e & 1) of row
// half i counts as -inf from lim[i] on (keys past seq, and above the
// diagonal): a select against a per-row limit, where a per-element
// branch costs a reconvergence barrier each (K1 took 1.44x as long).
template <class P, bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[P::kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2],
                                             const int (&lim)[2], float c) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int jj = 0; jj < P::kBN / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMasked && 8 * jj + (e & 1) >= lim[e >> 1])
        sc[4 * jj + e] = kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * jj + e]);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]) * c);
    corr[i] = ex2(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int jj = 0; jj < P::kBN / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sc[4 * jj + e], c, -m[e >> 1]));
      sc[4 * jj + e] = p;
      sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
}

// softmax_tile for the kv tile at key k0: masked where it straddles the
// diagonal or the ragged tail (one branch, uniform over the warpgroup).
template <class P>
__device__ __forceinline__ void online_softmax(float (&sc)[P::kBN / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2], const Args& a,
                                               int k0, int wg_row0, int row0,
                                               int t, float c) {
  if ((a.causal && k0 + P::kBN - 1 > wg_row0) || k0 + P::kBN > a.seq) {
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lim[i] = (a.causal ? min(a.seq, row0 + 8 * i + 1) : a.seq) - k0 - 2 * t;
    softmax_tile<P, true>(sc, m, l, corr, lim, c);
  } else {
    const int lim[2] = {0, 0};
    softmax_tile<P, false>(sc, m, l, corr, lim, c);
  }
}

// K1: a persistent block walks 128-row q tiles (TileIter). For kv tile j
// a warpgroup issues S of tile j and then O += P V of tile j - 1; the
// softmax of tile j runs as soon as S is in, while P V is still in
// flight (and while the other warpgroup's products run). O is rescaled
// once P V is in.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const Args a) {
  using P = FwdPlan<D>;
  extern __shared__ unsigned char smem_raw[];
  const Ring<P> r = ring_init<P>(smem_raw);
  const int n_tiles = cdiv(a.seq, P::kBM);
  // The kv tiles the q tile at row q0 walks (the producer's and the
  // consumers' count).
  const auto kv_count = [&](int q0) {
    return kv_tiles(a, q0 + P::kBM, P::kBN);
  };
  if (threadIdx.x < 128) {
    hopper::set_max_regs_dec<40>();
    if (threadIdx.x != 0) return;
    hopper::prefetch_map(&q_map);
    hopper::prefetch_map(&k_map);
    hopper::prefetch_map(&v_map);
    int u = 0, it = 0;
    for (TileIter ti(n_tiles, a.batch * a.heads); ti.valid(); ti.next(), ++u) {
      const int b = ti.bh() / a.heads, h = ti.bh() % a.heads;
      const int q0 = ti.tile() * P::kBM, buf = u % 2;
      hopper::mbar_wait(&r.fixed_empty[buf], ((u / 2) & 1) ^ 1);
      hopper::mbar_expect_tx(&r.fixed_full[buf], P::kFixedTile);
      load_rows_tma<D>(r.fixed_tile(buf, 0), &q_map, &r.fixed_full[buf], q0,
                       h, b, P::kFixedBox);
      const int n_iter = kv_count(q0);
      for (int j = 0; j < n_iter; ++j, ++it) {
        const int s = it % P::kStages;
        hopper::mbar_wait(&r.empty[s], ((it / P::kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&r.full[s], P::kStageBytes);
        load_rows_tma<D>(r.stage(s), &k_map, &r.full[s], j * P::kBN, h, b,
                         P::kRingBox);
        load_rows_tma<D>(r.stage(s) + P::kRingTile, &v_map, &r.full[s],
                         j * P::kBN, h, b, P::kRingBox);
      }
    }
    return;
  }

  hopper::set_max_regs_inc<232>();
  const Lane ln;
  const float c = a.scale * kLog2e;
  int u = 0, it = 0;
  for (TileIter ti(n_tiles, a.batch * a.heads); ti.valid(); ti.next(), ++u) {
    const int bh = ti.bh(), b = bh / a.heads, h = bh % a.heads;
    const int q0 = ti.tile() * P::kBM, buf = u % 2;
    const int n_iter = kv_count(q0);
    const int wg_row0 = q0 + 64 * ln.wg;
    const int row0 = wg_row0 + 16 * ln.warp + ln.g;  // rows row0, row0 + 8
    const unsigned char* q_rows = r.fixed_tile(buf, 0) + 64 * ln.wg * 128;
    float sc[P::kBN / 2];
    float o[D / 2];                   // written by the first P.V
    uint32_t pf[P::kBN / 4];          // P of the tile whose P.V is pending
    float m[2] = {kNegInf, kNegInf};  // running max, log2 domain
    float l[2] = {0.f, 0.f};
    float corr[2];
    hopper::mbar_wait(&r.fixed_full[buf], (u / 2) & 1);
    hopper::mbar_wait(&r.full[it % P::kStages], (it / P::kStages) & 1);
    hopper::wgmma_fence();
    scores<P>(sc, q_rows, r.stage(it % P::kStages));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    online_softmax<P>(sc, m, l, corr, a, 0, wg_row0, row0, ln.t, c);
    to_fragments<P::kBN / 2>(pf, sc);
    for (int j = 1; j < n_iter; ++j) {
      const int s = (it + j) % P::kStages, prev = (it + j - 1) % P::kStages;
      hopper::mbar_wait(&r.full[s], ((it + j) / P::kStages) & 1);
      hopper::fence_regs(o);
      hopper::fence_regs(pf);
      hopper::wgmma_fence();
      scores<P>(sc, q_rows, r.stage(s));
      hopper::wgmma_commit();
      update<P>(o, pf, r.stage(prev) + P::kRingTile, j > 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S is in; P V runs on
      hopper::fence_regs(sc);
      online_softmax<P>(sc, m, l, corr, a, j * P::kBN, wg_row0, row0, ln.t,
                        c);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      r.release(prev);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * jj + e] *= corr[e >> 1];
      }
      to_fragments<P::kBN / 2>(pf, sc);
    }
    const int last = (it + n_iter - 1) % P::kStages;
    hopper::fence_regs(o);
    hopper::fence_regs(pf);
    hopper::wgmma_fence();
    update<P>(o, pf, r.stage(last) + P::kRingTile, n_iter > 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    r.release(last);
    r.release_fixed(buf);
    it += n_iter;

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = quad_sum(l[i]);
      const float denom = l[i] == 0.f ? 1.f : l[i];
      inv[i] = 1.f / denom;
      const int row = row0 + 8 * i;
      if (ln.t == 0 && row < a.seq)
        a.lse[static_cast<long long>(bh) * a.seq + row] =
            (m[i] + log2f(denom)) * kLn2;
    }
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) +
                        (static_cast<long long>(b) * a.seq * a.heads + h) * D;
    store_acc<__nv_bfloat16, D>(ob, o, row0, a, inv, ln.t);
  }
}

// K2, dK/dV: P^T = exp2(S^T c - lse2), rounded into pf (kDV), and dS^T =
// P^T (dP^T - delta) into df (kDK), for the q tile in ring stage s. With
// kMasked, column 8 jj + (e & 1) of key half i is 0 outside [lo[i], hi)
// (queries past seq, and before the key).
template <class P, bool kDV, bool kDK, bool kMasked>
__device__ __forceinline__ void dkdv_tile(
    const Ring<P>& r, int s, float (&sT)[P::kBN / 2],
    float (&dpT)[P::kBN / 2], uint32_t (&pf)[P::kBN / 4],
    uint32_t (&df)[P::kBN / 4], const int (&lo)[2], int hi, int t,
    float c) {
  const float* lse2 = r.lse2(s);
  const float* delta = r.delta(s);
#pragma unroll
  for (int jj = 0; jj < P::kBN / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
    const float2 dl = *reinterpret_cast<const float2*>(delta + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(sT[4 * jj + e], c, -((e & 1) ? l2.y : l2.x)));
      const int at = 8 * jj + (e & 1);
      if (kMasked && (at < lo[e >> 1] || at >= hi)) p = 0.f;
      sT[4 * jj + e] = p;
      if constexpr (kDK)
        dpT[4 * jj + e] = p * (dpT[4 * jj + e] - ((e & 1) ? dl.y : dl.x));
    }
  }
  if constexpr (kDV) to_fragments<P::kBN / 2>(pf, sT);
  if constexpr (kDK) to_fragments<P::kBN / 2>(df, dpT);
}

// dkdv_tile for the q tile at qs: masked where it straddles the diagonal
// or the ragged tail.
template <class P, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_probs(
    const Ring<P>& r, int s, float (&sT)[P::kBN / 2],
    float (&dpT)[P::kBN / 2], uint32_t (&pf)[P::kBN / 4],
    uint32_t (&df)[P::kBN / 4], const Args& a, int qs, int wg_key0,
    int key0, int t, float c) {
  if ((a.causal && qs < wg_key0 + 63) || qs + P::kBN > a.seq) {
    int lo[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lo[i] = a.causal ? key0 + 8 * i - qs - 2 * t : -2 * t;
    dkdv_tile<P, kDV, kDK, true>(r, s, sT, dpT, pf, df, lo,
                                 a.seq - qs - 2 * t, t, c);
  } else {
    const int lo[2] = {0, 0};
    dkdv_tile<P, kDV, kDK, false>(r, s, sT, dpT, pf, df, lo, 0, t, c);
  }
}

// K2, dK/dV of one kv tile over its q tiles [q_first, q_first + n_q) (ring
// position `it` advances by n_q): dV += P^T dO when kDV, dK += dS^T Q when
// kDK. Per q tile, S^T (and dP^T), the probabilities, then the updates
// (the first overwrite the accumulators). Holding one tile's fragments
// across the next tile's scores, as K1 and dQ do, takes more registers
// than the four accumulators leave.
template <class P, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_pass(const Ring<P>& r, const Args& a,
                                          const Lane& ln, int buf, int k0,
                                          int q_first, int n_q, int& it,
                                          float (&dv)[P::kD / 2],
                                          float (&dk)[P::kD / 2]) {
  const int wg_key0 = k0 + 64 * ln.wg;
  const int key0 = wg_key0 + 16 * ln.warp + ln.g;  // keys key0, key0 + 8
  const float c = a.scale * kLog2e;
  const unsigned char* k_rows = r.fixed_tile(buf, 0) + 64 * ln.wg * 128;
  const unsigned char* v_rows = r.fixed_tile(buf, 1) + 64 * ln.wg * 128;
  for (int n = 0; n < n_q; ++n, ++it) {
    const int s = it % P::kStages;
    const unsigned char* st = r.stage(s);
    hopper::mbar_wait(&r.full[s], (it / P::kStages) & 1);
    float sT[P::kBN / 2], dpT[P::kBN / 2];
    hopper::wgmma_fence();
    scores<P>(sT, k_rows, st);
    if constexpr (kDK) scores<P>(dpT, v_rows, st + P::kRingTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sT);
    if constexpr (kDK) hopper::fence_regs(dpT);
    uint32_t pf[P::kBN / 4], df[P::kBN / 4];
    dkdv_probs<P, kDV, kDK>(r, s, sT, dpT, pf, df, a, (q_first + n) * P::kBN,
                            wg_key0, key0, ln.t, c);
    if constexpr (kDV) {
      hopper::fence_regs(dv);
      hopper::fence_regs(pf);
    }
    if constexpr (kDK) {
      hopper::fence_regs(dk);
      hopper::fence_regs(df);
    }
    hopper::wgmma_fence();
    if constexpr (kDV) update<P>(dv, pf, st + P::kRingTile, n > 0);
    if constexpr (kDK) update<P>(dk, df, st, n > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if constexpr (kDV) hopper::fence_regs(dv);
    if constexpr (kDK) hopper::fence_regs(dk);
    r.release(s);
  }
}

// K2, first half: a persistent block walks 128-key kv tiles (TileIter)
// and accumulates dK and dV for each over the 64-row q tiles that can see
// it (two passes at D 128: dV, then dK).
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const Args a) {
  using P = DkdvPlan<D>;
  constexpr int kPasses = D == 64 ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  const Ring<P> r = ring_init<P>(smem_raw);
  const int n_tiles = cdiv(a.seq, P::kBM);
  // The first q tile that sees the kv tile at key k0, and how many do
  // (the producers' and the consumers' count).
  const auto q_range = [&](int k0, int& q_first, int& n) {
    const int n_q = cdiv(a.seq, P::kBN);
    q_first = a.causal ? k0 / P::kBN : 0;
    n = n_q - q_first;
  };
  if (threadIdx.x < 128) {
    hopper::set_max_regs_dec<40>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp > 1 || (warp == 0 && lane != 0)) return;
    if (warp == 0) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::prefetch_map(&do_map);
    }
    int u = 0, it = 0;
    for (TileIter ti(n_tiles, a.batch * a.heads); ti.valid(); ti.next(), ++u) {
      const int bh = ti.bh(), b = bh / a.heads, h = bh % a.heads;
      const int k0 = ti.tile() * P::kBM, buf = u % 2;
      int q_first, n;
      q_range(k0, q_first, n);
      if (warp == 0) {
        hopper::mbar_wait(&r.fixed_empty[buf], ((u / 2) & 1) ^ 1);
        hopper::mbar_expect_tx(&r.fixed_full[buf], 2 * P::kFixedTile);
        load_rows_tma<D>(r.fixed_tile(buf, 0), &k_map, &r.fixed_full[buf], k0,
                         h, b, P::kFixedBox);
        load_rows_tma<D>(r.fixed_tile(buf, 1), &v_map, &r.fixed_full[buf], k0,
                         h, b, P::kFixedBox);
      }
      // lse * log2(e) and delta of the stage's q rows (0 past seq).
      const float* lse = a.lse + static_cast<long long>(bh) * a.seq;
      const float* delta = a.delta + static_cast<long long>(bh) * a.seq;
      for (int i = 0; i < kPasses * n; ++i, ++it) {
        const int s = it % P::kStages;
        const int qs = (q_first + i % n) * P::kBN;
        hopper::mbar_wait(&r.empty[s], ((it / P::kStages) & 1) ^ 1);
        if (warp == 0) {
          hopper::mbar_expect_tx(&r.full[s], P::kStageBytes);
          load_rows_tma<D>(r.stage(s), &q_map, &r.full[s], qs, h, b,
                           P::kRingBox);
          load_rows_tma<D>(r.stage(s) + P::kRingTile, &do_map, &r.full[s],
                           qs, h, b, P::kRingBox);
        } else {
          for (int x = lane; x < P::kBN; x += 32) {
            const bool live = qs + x < a.seq;
            r.lse2(s)[x] = live ? lse[qs + x] * kLog2e : 0.f;
            r.delta(s)[x] = live ? delta[qs + x] : 0.f;
          }
          hopper::mbar_arrive(&r.full[s]);
        }
      }
    }
    return;
  }

  hopper::set_max_regs_inc<232>();
  const Lane ln;
  const float scale[2] = {a.scale, a.scale};
  const float one[2] = {1.f, 1.f};
  int u = 0, it = 0;
  for (TileIter ti(n_tiles, a.batch * a.heads); ti.valid(); ti.next(), ++u) {
    const int bh = ti.bh(), b = bh / a.heads, h = bh % a.heads;
    const int k0 = ti.tile() * P::kBM, buf = u % 2;
    int q_first, n;
    q_range(k0, q_first, n);
    const int key0 = k0 + 64 * ln.wg + 16 * ln.warp + ln.g;
    const long long out0 =
        (static_cast<long long>(b) * a.seq * a.heads + h) * D;
    __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(a.dk) + out0;
    __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(a.dv) + out0;
    hopper::mbar_wait(&r.fixed_full[buf], (u / 2) & 1);
    if constexpr (kPasses == 1) {
      float dv[D / 2], dk[D / 2];
      dkdv_pass<P, true, true>(r, a, ln, buf, k0, q_first, n, it, dv, dk);
      r.release_fixed(buf);
      store_acc<__nv_bfloat16, D>(dk_out, dk, key0, a, scale, ln.t);
      store_acc<__nv_bfloat16, D>(dv_out, dv, key0, a, one, ln.t);
    } else {
      {
        float dv[D / 2], unused[D / 2];
        dkdv_pass<P, true, false>(r, a, ln, buf, k0, q_first, n, it, dv,
                                  unused);
        store_acc<__nv_bfloat16, D>(dv_out, dv, key0, a, one, ln.t);
      }
      {
        float unused[D / 2], dk[D / 2];
        dkdv_pass<P, false, true>(r, a, ln, buf, k0, q_first, n, it, unused,
                                  dk);
        r.release_fixed(buf);
        store_acc<__nv_bfloat16, D>(dk_out, dk, key0, a, scale, ln.t);
      }
    }
  }
}

// K2, dQ: dS = P (dP - delta) with P = exp2(S c - lse2), in place in dp.
// With kMasked, column 8 jj + (e & 1) of row half i is 0 from lim[i] on
// (keys past seq, and above the diagonal).
template <class Q, bool kMasked>
__device__ __forceinline__ void dq_tile(const float (&sc)[Q::kBN / 2],
                                        float (&dp)[Q::kBN / 2],
                                        const int (&lim)[2], float c,
                                        const float (&lse2)[2],
                                        const float (&delta)[2]) {
#pragma unroll
  for (int jj = 0; jj < Q::kBN / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(sc[4 * jj + e], c, -lse2[e >> 1]));
      if (kMasked && 8 * jj + (e & 1) >= lim[e >> 1]) p = 0.f;
      dp[4 * jj + e] = p * (dp[4 * jj + e] - delta[e >> 1]);
    }
  }
}

// dq_tile for the kv tile at k0: masked where it straddles the diagonal
// or the ragged tail.
template <class Q>
__device__ __forceinline__ void dq_probs(const float (&sc)[Q::kBN / 2],
                                         float (&dp)[Q::kBN / 2],
                                         const Args& a, int k0, int wg_row0,
                                         int row0, int t, float c,
                                         const float (&lse2)[2],
                                         const float (&delta)[2]) {
  if ((a.causal && k0 + Q::kBN - 1 > wg_row0) || k0 + Q::kBN > a.seq) {
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lim[i] = (a.causal ? min(a.seq, row0 + 8 * i + 1) : a.seq) - k0 - 2 * t;
    dq_tile<Q, true>(sc, dp, lim, c, lse2, delta);
  } else {
    const int lim[2] = {0, 0};
    dq_tile<Q, false>(sc, dp, lim, c, lse2, delta);
  }
}

// K2, second half: a persistent block walks 128-row q tiles (TileIter)
// and accumulates dQ for each over the 64-key kv tiles its rows can see.
// For kv tile j a warpgroup issues S and dP of tile j, then dQ += dS K of
// tile j - 1; dS of tile j is formed while that update is in flight.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const Args a) {
  using Q = DqPlan<D>;
  extern __shared__ unsigned char smem_raw[];
  const Ring<Q> r = ring_init<Q>(smem_raw);
  const int n_tiles = cdiv(a.seq, Q::kBM);
  // The kv tiles the q tile at row q0 walks (the producer's and the
  // consumers' count).
  const auto kv_count = [&](int q0) {
    return kv_tiles(a, q0 + Q::kBM, Q::kBN);
  };
  if (threadIdx.x < 128) {
    hopper::set_max_regs_dec<40>();
    if (threadIdx.x != 0) return;
    hopper::prefetch_map(&q_map);
    hopper::prefetch_map(&k_map);
    hopper::prefetch_map(&v_map);
    hopper::prefetch_map(&do_map);
    int u = 0, it = 0;
    for (TileIter ti(n_tiles, a.batch * a.heads); ti.valid(); ti.next(), ++u) {
      const int b = ti.bh() / a.heads, h = ti.bh() % a.heads;
      const int q0 = ti.tile() * Q::kBM, buf = u % 2;
      hopper::mbar_wait(&r.fixed_empty[buf], ((u / 2) & 1) ^ 1);
      hopper::mbar_expect_tx(&r.fixed_full[buf], 2 * Q::kFixedTile);
      load_rows_tma<D>(r.fixed_tile(buf, 0), &q_map, &r.fixed_full[buf], q0,
                       h, b, Q::kFixedBox);
      load_rows_tma<D>(r.fixed_tile(buf, 1), &do_map, &r.fixed_full[buf], q0,
                       h, b, Q::kFixedBox);
      const int n_iter = kv_count(q0);
      for (int j = 0; j < n_iter; ++j, ++it) {
        const int s = it % Q::kStages;
        hopper::mbar_wait(&r.empty[s], ((it / Q::kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&r.full[s], Q::kStageBytes);
        load_rows_tma<D>(r.stage(s), &k_map, &r.full[s], j * Q::kBN, h, b,
                         Q::kRingBox);
        load_rows_tma<D>(r.stage(s) + Q::kRingTile, &v_map, &r.full[s],
                         j * Q::kBN, h, b, Q::kRingBox);
      }
    }
    return;
  }

  hopper::set_max_regs_inc<232>();
  const Lane ln;
  const float c = a.scale * kLog2e;
  const float scale[2] = {a.scale, a.scale};
  int u = 0, it = 0;
  for (TileIter ti(n_tiles, a.batch * a.heads); ti.valid(); ti.next(), ++u) {
    const int bh = ti.bh(), b = bh / a.heads, h = bh % a.heads;
    const int q0 = ti.tile() * Q::kBM, buf = u % 2;
    const int n_iter = kv_count(q0);
    const int wg_row0 = q0 + 64 * ln.wg;
    const int row0 = wg_row0 + 16 * ln.warp + ln.g;  // rows row0, row0 + 8
    float lse2[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const long long at = static_cast<long long>(bh) * a.seq + row;
      lse2[i] = row < a.seq ? a.lse[at] * kLog2e : 0.f;
      delta[i] = row < a.seq ? a.delta[at] : 0.f;
    }
    const unsigned char* q_rows = r.fixed_tile(buf, 0) + 64 * ln.wg * 128;
    const unsigned char* do_rows = r.fixed_tile(buf, 1) + 64 * ln.wg * 128;
    float sc[Q::kBN / 2], dp[Q::kBN / 2];
    float dq[D / 2];             // written by the first dS.K
    uint32_t df[Q::kBN / 4];     // dS of the tile whose dS.K is pending
    hopper::mbar_wait(&r.fixed_full[buf], (u / 2) & 1);
    hopper::mbar_wait(&r.full[it % Q::kStages], (it / Q::kStages) & 1);
    hopper::wgmma_fence();
    scores<Q>(sc, q_rows, r.stage(it % Q::kStages));
    scores<Q>(dp, do_rows, r.stage(it % Q::kStages) + Q::kRingTile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    dq_probs<Q>(sc, dp, a, 0, wg_row0, row0, ln.t, c, lse2, delta);
    to_fragments<Q::kBN / 2>(df, dp);
    for (int j = 1; j < n_iter; ++j) {
      const int s = (it + j) % Q::kStages, prev = (it + j - 1) % Q::kStages;
      hopper::mbar_wait(&r.full[s], ((it + j) / Q::kStages) & 1);
      hopper::fence_regs(dq);
      hopper::fence_regs(df);
      hopper::wgmma_fence();
      scores<Q>(sc, q_rows, r.stage(s));
      scores<Q>(dp, do_rows, r.stage(s) + Q::kRingTile);
      hopper::wgmma_commit();
      update<Q>(dq, df, r.stage(prev), j > 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S and dP are in; dS.K runs on
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      dq_probs<Q>(sc, dp, a, j * Q::kBN, wg_row0, row0, ln.t, c, lse2,
                  delta);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      r.release(prev);
      to_fragments<Q::kBN / 2>(df, dp);
    }
    const int last = (it + n_iter - 1) % Q::kStages;
    hopper::fence_regs(dq);
    hopper::fence_regs(df);
    hopper::wgmma_fence();
    update<Q>(dq, df, r.stage(last), n_iter > 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    r.release(last);
    r.release_fixed(buf);
    it += n_iter;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq) +
                         (static_cast<long long>(b) * a.seq * a.heads + h) * D;
    store_acc<__nv_bfloat16, D>(out, dq, row0, a, scale, ln.t);
  }
}

// A [B, T, H, D] bf16 view (element strides sb, st, sh) as a 4-D map of
// boxes [rows][64].
cudaError_t view_map(CUtensorMap* map, const void* base, long long sb,
                     long long st, long long sh, const Args& a, int depth,
                     int rows) {
  const long long dims[4] = {depth, a.seq, a.heads, a.batch};
  const long long strides[3] = {st * 2, sh * 2, sb * 2};
  const int box[4] = {64, rows, 1, 1};
  return hopper::tensor_map_4d(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                               dims, strides, box);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The persistent grid over rows-row tiles of every b*h: one block an SM,
// at most one a pair of tiles.
cudaError_t persistent_grid(const Args& a, int rows, int* blocks) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int pairs = (cdiv(a.seq, rows) + 1) / 2 * a.batch * a.heads;
  *blocks = min(sms, pairs);
  return err;
}

template <int D>
cudaError_t forward_bf16(const Args& a, cudaStream_t stream) {
  using P = FwdPlan<D>;
  CUtensorMap qm, km, vm;
  int blocks = 0;
  cudaError_t err = view_map(&qm, a.q, a.q_sb, a.q_st, a.q_sh, a, D, P::kBM);
  if (err == cudaSuccess)
    err = view_map(&km, a.k, a.k_sb, a.k_st, a.k_sh, a, D, P::kBN);
  if (err == cudaSuccess)
    err = view_map(&vm, a.v, a.v_sb, a.v_st, a.v_sh, a, D, P::kBN);
  if (err == cudaSuccess) err = allow_smem(flash_fwd_wgmma_kernel<D>, P::kSmem);
  if (err == cudaSuccess) err = persistent_grid(a, P::kBM, &blocks);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<D><<<blocks, kWgThreads, P::kSmem, stream>>>(
      qm, km, vm, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t backward_bf16(const Args& a, cudaStream_t stream) {
  using K = DkdvPlan<D>;
  using Q = DqPlan<D>;
  CUtensorMap qm, km, vm, dom;
  int blocks = 0;
  // dK/dV: K and V are the block's rows, Q and dO stream.
  cudaError_t err = view_map(&qm, a.q, a.q_sb, a.q_st, a.q_sh, a, D, K::kBN);
  if (err == cudaSuccess)
    err = view_map(&km, a.k, a.k_sb, a.k_st, a.k_sh, a, D, K::kBM);
  if (err == cudaSuccess)
    err = view_map(&vm, a.v, a.v_sb, a.v_st, a.v_sh, a, D, K::kBM);
  if (err == cudaSuccess)
    err = view_map(&dom, a.dout, a.do_sb, a.do_st, a.do_sh, a, D, K::kBN);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dkdv_wgmma_kernel<D>, K::kSmem);
  if (err == cudaSuccess) err = persistent_grid(a, K::kBM, &blocks);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<D><<<blocks, kWgThreads, K::kSmem, stream>>>(
      qm, km, vm, dom, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dQ: Q and dO are the block's rows, K and V stream.
  err = view_map(&qm, a.q, a.q_sb, a.q_st, a.q_sh, a, D, Q::kBM);
  if (err == cudaSuccess)
    err = view_map(&km, a.k, a.k_sb, a.k_st, a.k_sh, a, D, Q::kBN);
  if (err == cudaSuccess)
    err = view_map(&vm, a.v, a.v_sb, a.v_st, a.v_sh, a, D, Q::kBN);
  if (err == cudaSuccess)
    err = view_map(&dom, a.dout, a.do_sb, a.do_st, a.do_sh, a, D, Q::kBM);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, Q::kSmem);
  if (err == cudaSuccess) err = persistent_grid(a, Q::kBM, &blocks);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D><<<blocks, kWgThreads, Q::kSmem, stream>>>(
      qm, km, vm, dom, a);
  return cudaGetLastError();
}

// ----------------------------- fp32: FMAs -----------------------------

namespace fp32 {

constexpr int kThreads = 128;  // four warps
constexpr int kBM = 64;        // rows a block owns (16 per warp)
constexpr int kPad = 4;        // 16 bytes per row

template <int D>
struct Tile {
  static constexpr int kN = D <= 64 ? 64 : 32;  // other-axis tile
};

// Warp-level products in the m16n8 accumulator layout of mma.sync: lane
// (g = lane/4, t = lane%4) holds, for each 8-column tile j, rows g and
// g+8 at columns 8j+2t and 8j+2t+1 as acc[j][0..1] and acc[j][2..3].
// acc[NT][4] += A[16 x K] . B[NT*8 x K]^T, both row-major in shared
// memory with K contiguous.
template <int NT, int K>
__device__ __forceinline__ void nt(float (&acc)[NT][4], const float* a,
                                   int lda, const float* b, int ldb,
                                   int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a[g * lda + k];
    const float a1 = a[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = b[(8 * j + 2 * t) * ldb + k];
      const float b1 = b[(8 * j + 2 * t + 1) * ldb + k];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// acc[NT][4] += P[16 x K] . B[K x NT*8]: P in registers in the
// accumulator layout (K/8 column tiles), through this warp's [16][K + 4]
// scratch so that every lane can read whole rows of it; B row-major
// [K][ldb] in shared memory.
template <int NT, int K>
__device__ __forceinline__ void pn(float (&acc)[NT][4],
                                   const float (&p)[K / 8][4], const float* b,
                                   int ldb, float* scratch, int lane) {
  constexpr int ld = K + 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    scratch[g * ld + 8 * j + 2 * t] = p[j][0];
    scratch[g * ld + 8 * j + 2 * t + 1] = p[j][1];
    scratch[(g + 8) * ld + 8 * j + 2 * t] = p[j][2];
    scratch[(g + 8) * ld + 8 * j + 2 * t + 1] = p[j][3];
  }
  __syncwarp();
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float p0 = scratch[g * ld + k];
    const float p1 = scratch[(g + 8) * ld + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = b[k * ldb + 8 * j + 2 * t];
      const float b1 = b[k * ldb + 8 * j + 2 * t + 1];
      acc[j][0] = fmaf(p0, b0, acc[j][0]);
      acc[j][1] = fmaf(p0, b1, acc[j][1]);
      acc[j][2] = fmaf(p1, b0, acc[j][2]);
      acc[j][3] = fmaf(p1, b1, acc[j][3]);
    }
  }
  __syncwarp();
}

// rows [row0, row0 + nrows) of a [seq, D] view with row stride `stride`
// into shared memory with row stride D + pad; rows past seq become zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int nrows, int seq) {
  constexpr int kChunks = D / 4;
  constexpr int ld = D + kPad;
  for (int i = threadIdx.x; i < nrows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq)
      val = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<long long>(row0 + r) * stride + c));
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// Writes 16 rows x D of a warp's accumulator (times `mul`) into a
// contiguous [B, T, H, D] tensor; rows past seq are dropped.
template <int NT>
__device__ __forceinline__ void store_rows(float* base,
                                           const float (&acc)[NT][4],
                                           int row0, int seq, int heads,
                                           const float (&mul)[2], int lane) {
  constexpr int D = NT * 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= seq) continue;
    float* out = base + static_cast<long long>(row) * heads * D;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store2(out + 8 * j + 2 * t, acc[j][2 * r] * mul[r],
             acc[j][2 * r + 1] * mul[r]);
  }
}

template <int D>
constexpr size_t scratch_bytes() {
  return 4 * 16 * (Tile<D>::kN + 4) * sizeof(float);
}

template <int D>
constexpr size_t fwd_smem() {
  return (kBM + 2 * Tile<D>::kN) * (D + kPad) * sizeof(float) +
         scratch_bytes<D>();
}

template <int D>
constexpr size_t dkdv_smem() {
  return (2 * kBM + 2 * Tile<D>::kN) * (D + kPad) * sizeof(float) +
         2 * Tile<D>::kN * sizeof(float) + scratch_bytes<D>();
}

template <int D>
constexpr size_t dq_smem() {
  return (2 * kBM + 2 * Tile<D>::kN) * (D + kPad) * sizeof(float) +
         scratch_bytes<D>();
}

// K1: one block per (q-tile, b*h); q-tiles last first.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_fma_kernel(Args a) {
  constexpr int BN = Tile<D>::kN;
  constexpr int LD = D + kPad;
  constexpr int NTD = D / 8, NTN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = sq + kBM * LD;
  float* sv = sk + BN * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = sv + BN * LD + warp * 16 * (BN + 4);
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int seq = a.seq;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  load_rows<D>(sq, qb, a.q_st, q0, kBM, seq);

  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float o[NTD][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int n_iter = kv_tiles(a, q0 + kBM, BN);
  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(sk, kb, a.k_st, k0, BN, seq);
    load_rows<D>(sv, vb, a.v_st, k0, BN, seq);
    __syncthreads();
    float s[NTN][4] = {};
    nt<NTN, D>(s, sq + warp * 16 * LD, LD, sk, LD, lane);
    const bool masked = (a.causal && k0 + BN - 1 > q0) || k0 + BN > seq;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < NTN; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[jj][c] * a.scale;
        if (masked) {
          const int key = k0 + 8 * jj + 2 * t + (c & 1);
          const int row = row0 + 8 * (c >> 1);
          if (key >= seq || (a.causal && key > row)) x = kNegInf;
        }
        s[jj][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int jj = 0; jj < NTN; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[jj][c] = expf(s[jj][c] - m[c >> 1]);
        sum[c >> 1] += s[jj][c];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int jj = 0; jj < NTD; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) o[jj][c] *= corr[c >> 1];
    }
    pn<NTD, BN>(o, s, sv, LD, scratch, lane);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const float denom = l[r] == 0.f ? 1.f : l[r];
    inv[r] = 1.f / denom;
    const int row = row0 + 8 * r;
    if (t == 0 && row < seq)
      a.lse[static_cast<long long>(bh) * seq + row] = m[r] + logf(denom);
  }
  float* ob = static_cast<float*>(a.out) +
              (static_cast<long long>(b) * seq * a.heads + h) * D;
  store_rows<NTD>(ob, o, q0 + warp * 16, seq, a.heads, inv, lane);
}

// K2, first half: one block per (kv-tile, b*h) walks the q-tiles that can
// see it and accumulates dK and dV for its 64 keys.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_fma_kernel(Args a) {
  constexpr int BN = Tile<D>::kN;
  constexpr int LD = D + kPad;
  constexpr int NTD = D / 8, NTN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kBM * LD;
  float* sq = sv + kBM * LD;
  float* sdo = sq + BN * LD;
  float* slse = sdo + BN * LD;
  float* sdelta = slse + BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = sdelta + BN + warp * 16 * (BN + 4);
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int seq = a.seq;
  const int k0 = blockIdx.x * kBM;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<long long>(bh) * seq;
  const float* delta = a.delta + static_cast<long long>(bh) * seq;
  load_rows<D>(sk, kb, a.k_st, k0, kBM, seq);
  load_rows<D>(sv, vb, a.v_st, k0, kBM, seq);

  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  float dk[NTD][4] = {};
  float dv[NTD][4] = {};
  const int n_q = cdiv(seq, BN);
  for (int i = a.causal ? k0 / BN : 0; i < n_q; ++i) {
    const int qs = i * BN;
    __syncthreads();
    load_rows<D>(sq, qb, a.q_st, qs, BN, seq);
    load_rows<D>(sdo, dob, a.do_st, qs, BN, seq);
    for (int x = threadIdx.x; x < BN; x += kThreads) {
      const bool live = qs + x < seq;
      slse[x] = live ? lse[qs + x] : 0.f;
      sdelta[x] = live ? delta[qs + x] : 0.f;
    }
    __syncthreads();
    // P^T [16 keys x BN queries] = exp(K Q^T * scale - lse).
    float p[NTN][4] = {};
    nt<NTN, D>(p, sk + warp * 16 * LD, LD, sq, LD, lane);
    const bool masked = (a.causal && qs < k0 + kBM - 1) || qs + BN > seq;
#pragma unroll
    for (int jj = 0; jj < NTN; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * jj + 2 * t + (c & 1);
        float x = expf(p[jj][c] * a.scale - slse[col]);
        if (masked) {
          const int query = qs + col;
          const int key = key0 + 8 * (c >> 1);
          if (query >= seq || (a.causal && query < key)) x = 0.f;
        }
        p[jj][c] = x;
      }
    }
    pn<NTD, BN>(dv, p, sdo, LD, scratch, lane);
    // dP^T = V dO^T; dS^T = P^T (dP^T - delta).
    float ds[NTN][4] = {};
    nt<NTN, D>(ds, sv + warp * 16 * LD, LD, sdo, LD, lane);
#pragma unroll
    for (int jj = 0; jj < NTN; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * jj + 2 * t + (c & 1);
        ds[jj][c] = p[jj][c] * (ds[jj][c] - sdelta[col]);
      }
    }
    pn<NTD, BN>(dk, ds, sq, LD, scratch, lane);
  }
  const long long out0 = (static_cast<long long>(b) * seq * a.heads + h) * D;
  const float scale[2] = {a.scale, a.scale};
  const float one[2] = {1.f, 1.f};
  store_rows<NTD>(static_cast<float*>(a.dk) + out0, dk, k0 + warp * 16, seq,
                  a.heads, scale, lane);
  store_rows<NTD>(static_cast<float*>(a.dv) + out0, dv, k0 + warp * 16, seq,
                  a.heads, one, lane);
}

// K2, second half: one block per (q-tile, b*h) walks the kv-tiles its rows
// can see and accumulates dQ. Last q-tiles first, as in K1.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fma_kernel(Args a) {
  constexpr int BN = Tile<D>::kN;
  constexpr int LD = D + kPad;
  constexpr int NTD = D / 8, NTN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + kBM * LD;
  float* sk = sdo + kBM * LD;
  float* sv = sk + BN * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = sv + BN * LD + warp * 16 * (BN + 4);
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int seq = a.seq;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  load_rows<D>(sq, qb, a.q_st, q0, kBM, seq);
  load_rows<D>(sdo, dob, a.do_st, q0, kBM, seq);

  const int row0 = q0 + warp * 16 + g;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = static_cast<long long>(bh) * seq + row;
    lse[r] = row < seq ? a.lse[at] : 0.f;
    delta[r] = row < seq ? a.delta[at] : 0.f;
  }
  float dq[NTD][4] = {};
  const int n_iter = kv_tiles(a, q0 + kBM, BN);
  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    load_rows<D>(sk, kb, a.k_st, k0, BN, seq);
    load_rows<D>(sv, vb, a.v_st, k0, BN, seq);
    __syncthreads();
    float p[NTN][4] = {};
    nt<NTN, D>(p, sq + warp * 16 * LD, LD, sk, LD, lane);
    const bool masked = (a.causal && k0 + BN - 1 > q0) || k0 + BN > seq;
#pragma unroll
    for (int jj = 0; jj < NTN; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = expf(p[jj][c] * a.scale - lse[c >> 1]);
        if (masked) {
          const int key = k0 + 8 * jj + 2 * t + (c & 1);
          const int row = row0 + 8 * (c >> 1);
          if (key >= seq || (a.causal && key > row)) x = 0.f;
        }
        p[jj][c] = x;
      }
    }
    float ds[NTN][4] = {};
    nt<NTN, D>(ds, sdo + warp * 16 * LD, LD, sv, LD, lane);
#pragma unroll
    for (int jj = 0; jj < NTN; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ds[jj][c] = p[jj][c] * (ds[jj][c] - delta[c >> 1]);
    }
    pn<NTD, BN>(dq, ds, sk, LD, scratch, lane);
  }
  const float scale[2] = {a.scale, a.scale};
  float* out = static_cast<float*>(a.dq) +
               (static_cast<long long>(b) * seq * a.heads + h) * D;
  store_rows<NTD>(out, dq, q0 + warp * 16, seq, a.heads, scale, lane);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Args& a,
                   cudaStream_t stream) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t forward(const Args& a, cudaStream_t stream) {
  return launch(flash_fwd_fma_kernel<D>, fwd_smem<D>(),
                dim3(cdiv(a.seq, kBM), a.batch * a.heads), a, stream);
}

template <int D>
cudaError_t backward(const Args& a, cudaStream_t stream) {
  const dim3 grid(cdiv(a.seq, kBM), a.batch * a.heads);
  const cudaError_t err =
      launch(flash_bwd_dkdv_fma_kernel<D>, dkdv_smem<D>(), grid, a, stream);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq_fma_kernel<D>, dq_smem<D>(), grid, a, stream);
}

}  // namespace fp32

// ------------------------------- host ---------------------------------

template <bool kForward>
cudaError_t dispatch(int dtype, int depth, const Args& a,
                     cudaStream_t stream) {
#define BS_CASE(FWD, BWD) return kForward ? FWD(a, stream) : BWD(a, stream)
  if (dtype == kF32 && depth == 64) BS_CASE(fp32::forward<64>, fp32::backward<64>);
  if (dtype == kF32 && depth == 128)
    BS_CASE(fp32::forward<128>, fp32::backward<128>);
  if (dtype == kBF16 && depth == 64) BS_CASE(forward_bf16<64>, backward_bf16<64>);
  if (dtype == kBF16 && depth == 128)
    BS_CASE(forward_bf16<128>, backward_bf16<128>);
#undef BS_CASE
  return cudaErrorInvalidValue;
}

Args make_args(const long long* strides, int n_strides, int batch, int heads,
               int seq, int causal, float scale) {
  Args a{};
  long long* dst[12] = {&a.q_sb, &a.q_st, &a.q_sh, &a.k_sb, &a.k_st, &a.k_sh,
                        &a.v_sb, &a.v_st, &a.v_sh, &a.do_sb, &a.do_st,
                        &a.do_sh};
  for (int i = 0; i < n_strides; ++i) *dst[i] = strides[i];
  a.batch = batch;
  a.heads = heads;
  a.seq = seq;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// K1. strides: (batch, time, head) element strides of q, k, v (9 values).
// out: contiguous [B, T, H, D] in the input type; lse: fp32 [B*H, T].
int bs_flash_attention_fwd(int device, const void* q, const void* k,
                           const void* v, void* out, float* lse,
                           const long long* strides, int batch, int heads,
                           int seq, int depth, int dtype, int causal,
                           float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || heads <= 0 || seq <= 0) return cudaSuccess;
  Args a = make_args(strides, 9, batch, heads, seq, causal, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = lse;
  return dispatch<true>(dtype, depth, a, static_cast<cudaStream_t>(stream));
}

// K2: two launches (dK/dV, then dQ). strides: q, k, v, dout (12 values).
// delta = rowsum(dO * O) - g_lse, fp32 [B*H, T]; dq/dk/dv contiguous.
int bs_flash_attention_bwd(int device, const void* q, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* delta, void* dq, void* dk, void* dv,
                           const long long* strides, int batch, int heads,
                           int seq, int depth, int dtype, int causal,
                           float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || heads <= 0 || seq <= 0) return cudaSuccess;
  Args a = make_args(strides, 12, batch, heads, seq, causal, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  return dispatch<false>(dtype, depth, a, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory a block of each bf16 kernel takes at this
// depth, in bytes: bytes[0] K1, bytes[1] dK/dV, bytes[2] dQ.
int bs_flash_attention_smem(int depth, long long* bytes) {
  if (depth == 64) {
    bytes[0] = FwdPlan<64>::kSmem;
    bytes[1] = DkdvPlan<64>::kSmem;
    bytes[2] = DqPlan<64>::kSmem;
  } else if (depth == 128) {
    bytes[0] = FwdPlan<128>::kSmem;
    bytes[1] = DkdvPlan<128>::kSmem;
    bytes[2] = DqPlan<128>::kSmem;
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
