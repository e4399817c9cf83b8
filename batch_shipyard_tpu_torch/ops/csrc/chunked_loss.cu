// Fused tied-embedding cross-entropy for Hopper (sm_90a): the loss of
// h @ E^T against targets, and its two gradients, with the full [N, V]
// logits never stored.
//
// Replaces three Pallas TPU kernels of batch_shipyard_tpu:
//   K3 ops/chunked_loss.py:_fwd_kernel    (per-row lse and gold logit)
//   K4 ops/chunked_loss.py:_bwd_h_kernel  (grad_h = dlogits @ E)
//   K5 ops/chunked_loss.py:_bwd_e_kernel  (grad_E = dlogits^T @ h)
// h is [N, D] (bf16 for training, fp32 for the exact-math checks), E is
// fp32 [V, D], targets int32 [N]; lse, gold and ds (the per-row scale of
// the loss cotangent) are fp32 [N]; grad_h is fp32 [N, D] and grad_E fp32
// [V, D]. All rows contiguous; D a multiple of 32, either type of h.
//
// What bounds it. At the training shape (N 32768, D 1024, V 32000) each
// product h.E^T (or its partner) is 2*N*V*D = 2.15 TFLOP, and the
// kernels execute three for the pair of gradients: K3's logits, then in
// the backward the logits once more (the dl pass) and dl.E and dl^T.h.
// Inputs are ~0.2 GB a call, so the loss is bound by tensor-core
// operations (4.34 ms a product at the 495 TFLOP/s TF32 peak). The TPU
// kernel casts h and E to f32; here the products run in TF32 with fp32
// accumulation (operands rounded to TF32 with cvt.rna; bf16 h converts
// exactly). Plain fp32 FMAs would cost ~7x the TF32 bound.
//
// All products run on one mainloop, K3's: per block two consumer
// warpgroups of 64 rows on wgmma m64n256k8 .tf32 (A and B K-major in
// shared memory), fed by a four-stage TMA ring of 32-deep slices ([128,
// 32] A box and [256, 32] B box, 128-byte swizzled, 48 KB a stage) that
// one producer thread keeps full; wgmma.wait_group 1 retires the previous
// slice and releases its stage. TF32 wgmma reads only K-major operands
// (its transpose bits are for 16-bit types), so every operand is laid out
// with its contracted axis contiguous before it is read.
//
// K3 design. Blocks here run in no order, so the TPU grid's carried (m,
// s, gold) becomes a loop over the vocab inside one block:
//   - A pre-pass (tf32_round_kernel) writes h and E rounded to TF32 into
//     the caller's fp32 scratch: wgmma reads its operands from shared
//     memory, where they cannot be rounded on the way, and the tensor
//     cores truncate the low mantissa bits of a .tf32 operand, which
//     would shrink every logit by ~2^-11 and move lse by ~5e-4. It moves
//     ~0.46 GB at the training shape (~0.15 ms).
//   - One block per 128 rows of h (256 blocks at N 32768: two waves of
//     132 SMs at 97%; 128 blocks at an sp rank's 16384: one wave) walks
//     the vocab in 256-row E tiles, so no vocab split and no merge pass.
//   - A [64, 256] logits tile (128 fp32 registers a thread) is folded in
//     registers: row max and sum of exp2 across the thread's 64 columns and
//     a quad shuffle, one online rescale per 256-wide tile, the gold logit
//     where a column equals the target. The vocab tail is masked to -1e30
//     (finite, as the reference's _NEG); rows whose target is ignore_id
//     keep gold 0; TMA zero-fills rows past N and V, and rows past N are
//     not written.
//   What bounds it now: the TF32 tensor cores, and the L2 reads that
//   feed them. Each block re-reads its h rows once per vocab tile, and
//   every block reads all of E: ~50 GB of L2 traffic a call at the
//   training shape. The fold runs while no products of its warpgroup are
//   in flight, and ptxas keeps the consumers at 168 registers
//   (setmaxnreg notwithstanding), so the fold spills a few hundred bytes
//   a thread. A two-block cluster multicasting E would halve the E share
//   of the L2 traffic; a second accumulator set would overlap the fold,
//   but does not fit.
//
// K4 and K5 design. The TPU grid carries a [bt, D] gradient accumulator
// across vocab chunks (K4) or row chunks (K5) in VMEM. On this card it
// cannot stay on chip: a 128-row fp32 tile at D 1024 is 512 KB, more
// than the register file or shared memory, and a warpgroup's wgmma
// accumulator holds a quarter of D. So dl = (exp(logit - lse) - onehot)
// * ds is written to device memory once per vocab chunk and read back by
// two plain GEMM-shaped passes, all three on the mainloop above:
//   - Pre-pass (xent_bwd_round_kernel): h and E rounded to TF32 as K3's,
//     and the transposed copies the products read as B: E^T [D, V] for
//     grad_h (contracted over V), h^T [D, N] for grad_E (contracted over
//     rows), zero-padded to whole tiles.
//   - dl pass (xent_dl_kernel), per chunk of vocab columns (the caller's
//     width, a multiple of 256; 4096 from ops/chunked_loss.py): one
//     block per 128 rows walks the chunk's 256-wide E tiles as K3 does;
//     its epilogue forms dl in place in the accumulator (0 past V, and
//     past N where ds is 0), rounds it to TF32 and stores it twice, as dl
//     [rows, chunk] (vocab contiguous, grad_h's A) and dl^T [chunk, rows]
//     (rows contiguous, grad_E's A). Each stored warp instruction fills
//     whole 32-byte sectors.
//   - grad_h (xent_bwd_h_kernel): gh[128 x 256 tile] (+)= dl_chunk .
//     E^T_chunk, over the chunk's vocab; the first chunk writes, later
//     ones add in chunk order, so results are the same on every run (no
//     atomics). The grid runs D tiles fastest, so the blocks that share
//     a dl row tile run together and dl is read from HBM once.
//   - grad_E (xent_bwd_e_kernel): ge[chunk rows] = dl^T_chunk . h, over
//     all rows; each chunk owns its rows of ge outright.
//   dl, dl^T, E^T and h^T lie in K-panels, [K / 32][rows][32], so every
//   32-deep TMA box is one contiguous block; rows a whole contraction
//   apart (128 KB at 32768 rows) alias in L2.
//   K4 alone runs the pre-pass, and per chunk the dl pass (dl only) and
//   grad_h; K5 alone the dl pass (dl^T only) and grad_E; the joint call
//   one dl pass per chunk for both products: three products in all,
//   where computing K4 and K5 apart takes four (each recomputes the
//   logits). Scratch (the caller's): h and E rounded and transposed
//   (~0.54 GB at the training shape), dl and dl^T of one chunk: 2 * 4 *
//   N * chunk bytes, 1.07 GB at N 32768 (0.54 GB at an sp rank's 16384
//   rows; half for K4 or K5 alone).
//   What bounds it now (training shape, H100 80GB HBM3 at 700 W; the
//   numbers in PERF.md): grad_E runs near the TF32 peak (~1.1x its 4.34
//   ms product); grad_h ~1.4x, its read-add-write of grad_h once a chunk
//   (the loads go four pairs ahead of their stores; chunks twice as wide
//   save little); the dl pass ~2x, paying its two stores: the
//   epilogue's stores run from the consumer warps, which issue no
//   products meanwhile, and each warp store touches 4 to 8 lines.
//   Staging dl in shared memory for TMA stores needs room the four-stage
//   ring holds; two consumer warpgroups on alternate tiles (one storing
//   while the other multiplies) are the next step. Designs not taken:
//   splitting D across blocks keeps dl on chip but recomputes the logits
//   once more per split (+4.34 ms each); a four-block cluster trading
//   partial logits through distributed shared memory keeps dl off HBM
//   but needs two cluster barriers per vocab tile and E in both layouts
//   in every stage.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;

enum DType : int { kF32 = 0, kBF16 = 1 };

// K3's arguments.
struct Args {
  const void* h;
  const float* e;
  const int* tgt;
  float* lse;
  float* gold;
  int n, v, ignore_id;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int pad_to(int a, int b) { return cdiv(a, b) * b; }

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// ------------------------- K3: wgmma + TMA ----------------------------

namespace k3 {
constexpr int kBM = 128;  // h rows per block: two consumer warpgroups of 64
constexpr int kBN = 256;  // vocab rows per E tile: one wgmma's N
constexpr int kBK = 32;   // 32 fp32 = one 128-byte swizzled box row
constexpr int kStages = 4;
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kATile = kBM * kBK * 4;
constexpr int kBTile = kBN * kBK * 4;
constexpr int kStageBytes = kATile + kBTile;
constexpr size_t kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr float kLog2e = 1.4426950408889634f;
}  // namespace k3

// Rounds src (fp32 or bf16) to TF32 values in fp32, four elements a
// thread-step: the operands wgmma reads (bf16 widens exactly).
template <typename T>
__global__ void __launch_bounds__(256)
    tf32_round_kernel(const T* src, float* dst, long long count) {
  const long long step = 4ll * gridDim.x * blockDim.x;
  for (long long i = 4ll * (blockIdx.x * blockDim.x + threadIdx.x); i < count;
       i += step) {
    float f[4];
    if constexpr (sizeof(T) == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + i));
      f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(src + i));
      f[0] = __uint_as_float(v.x << 16), f[1] = __uint_as_float(v.x & 0xffff0000u);
      f[2] = __uint_as_float(v.y << 16), f[3] = __uint_as_float(v.y & 0xffff0000u);
    }
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(to_tf32(f[0]), to_tf32(f[1]), to_tf32(f[2]), to_tf32(f[3]));
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The running softmax state of one row: max, sum of exp(logit - max)
// and the gold logit (held by the one thread whose column it is).
struct RowState {
  float m = kNeg, s = 0.f, gold = 0.f;
};

// Folds one [64, 256] logits tile (this thread's accumulator fragment:
// rows g and g + 8 of its warp, columns 8j + 2t and 8j + 2t + 1) into the
// two rows' states. Columns at or past `lim` (the vocab tail, relative to
// column 2t) count as kNeg.
template <bool kTail>
__device__ __forceinline__ void fold_tile(RowState (&st)[2],
                                          const float (&acc)[128], int lim) {
  using k3::kLog2e;
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = kTail && 8 * j + c >= lim ? kNeg : acc[4 * j + 2 * h + c];
        mx[h] = fmaxf(mx[h], x);
      }
  float m_new[2], ml[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    m_new[h] = fmaxf(st[h].m, mx[h]);
    ml[h] = m_new[h] * kLog2e;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = kTail && 8 * j + c >= lim ? kNeg : acc[4 * j + 2 * h + c];
        sum[h] += ex2(fmaf(x, kLog2e, -ml[h]));
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    st[h].s = st[h].s * ex2(fmaf(st[h].m, kLog2e, -ml[h])) + sum[h];
    st[h].m = m_new[h];
  }
}

// The logits tile at vocab row v0 into the rows' states: the max and sum,
// and the gold logit where a row's target falls in this tile.
__device__ __forceinline__ void fold(RowState (&st)[2], const float (&acc)[128],
                                     int v0, int v, const int (&tgt)[2],
                                     int t) {
  // The gold logit first: the sum pass is each logit's last use.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int local = tgt[h] - v0 - 2 * t;  // column 8j + c of this thread
    if (static_cast<unsigned>(tgt[h] - v0) < static_cast<unsigned>(k3::kBN))
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (8 * j + c == local) st[h].gold = acc[4 * j + 2 * h + c];
  }
  const int lim = v - v0 - 2 * t;
  if (v0 + k3::kBN > v)
    fold_tile<true>(st, acc, lim);
  else
    fold_tile<false>(st, acc, lim);
}

// One 32-deep slice of the logits tile for a consumer warpgroup: wait for
// its stage, run four wgmma m64n256k8 (A = this warpgroup's 64 h rows,
// B = the E tile, both K-major), then retire the previous slice of the
// same tile and release its stage.
__device__ __forceinline__ void k3_slice(float (&acc)[128], unsigned char* smem,
                                         uint64_t* full, uint64_t* empty,
                                         int it, bool first, int wg_row) {
  using namespace k3;
  const int s = it % kStages;
  hopper::mbar_wait(&full[s], (it / kStages) & 1);
  unsigned char* stage = smem + s * kStageBytes;
  const uint64_t ad = hopper::desc(stage + wg_row * 128, 16, 1024);
  const uint64_t bd = hopper::desc(stage + kATile, 16, 1024);
  hopper::wgmma_fence();
#pragma unroll
  for (int k8 = 0; k8 < 4; ++k8)  // 8 fp32 = 32 bytes a step
    hopper::wgmma_tf32_m64n256k8(acc, ad + 2 * k8, bd + 2 * k8,
                                 !first || k8 > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<1>();
  if (!first && threadIdx.x % 32 == 0)
    hopper::mbar_arrive(&empty[(it - 1) % kStages]);
}

// K3: one block per 128 rows of h walks the vocab in 256-row E tiles,
// each tile's logits accumulated over the depth in 32-deep slices that
// the producer warpgroup brings by TMA (h_map over the TF32 copy of h,
// e_map over the TF32 copy of E).
__global__ void __launch_bounds__(k3::kThreads, 1)
    xent_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap h_map,
                          const __grid_constant__ CUtensorMap e_map,
                          const Args a, int depth) {
  using namespace k3;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int r0 = blockIdx.x * kBM;
  const int n_k = depth / kBK, n_v = cdiv(a.v, kBN);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::set_max_regs_dec<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_map(&h_map);
      hopper::prefetch_map(&e_map);
      int it = 0;
      for (int j = 0; j < n_v; ++j)
        for (int kk = 0; kk < n_k; ++kk, ++it) {
          const int s = it % kStages;
          hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          unsigned char* stage = smem + s * kStageBytes;
          hopper::mbar_expect_tx(&full[s], kStageBytes);
          hopper::tma_load(stage, &h_map, &full[s], kk * kBK, r0);
          hopper::tma_load(stage + kATile, &e_map, &full[s], kk * kBK,
                           j * kBN);
        }
    }
    return;
  }

  hopper::set_max_regs_inc<232>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row = 64 * (wg - 1);  // this warpgroup's rows in the tile
  const int rows[2] = {r0 + wg_row + 16 * warp + g,
                       r0 + wg_row + 16 * warp + g + 8};
  int tgt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int target = rows[h] < a.n ? a.tgt[rows[h]] : a.ignore_id;
    tgt[h] = target == a.ignore_id ? -1 : target;
  }
  float acc[128];  // each tile's first slice overwrites it
  RowState st[2];
  int it = 0;
  for (int j = 0; j < n_v; ++j) {
    for (int kk = 0; kk < n_k; ++kk, ++it)
      k3_slice(acc, smem, full, empty, it, kk == 0, wg_row);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kStages]);
    fold(st, acc, j * kBN, a.v, tgt, t);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st[h].gold += __shfl_xor_sync(0xffffffffu, st[h].gold, 1);
    st[h].gold += __shfl_xor_sync(0xffffffffu, st[h].gold, 2);
    if (t == 0 && rows[h] < a.n) {
      a.lse[rows[h]] = st[h].m + logf(st[h].s);
      a.gold[rows[h]] = st[h].gold;
    }
  }
}

// --------------- K4 and K5: one dl pass, two TF32 GEMMs ---------------

// One pass of the backward: C = A . B^T over K-major fp32 (TF32-valued)
// operands behind TMA maps, and what its epilogue needs. dl, dl^T, E^T
// and h^T lie in K-panels: a [rows, K] operand as [K / 32][rows][32], so
// that the 32-deep box of 128 or 256 rows is one contiguous block (rows a
// whole contraction apart, 128 KB at 32768 rows, alias in L2).
struct Pass {
  const int* tgt;
  const float* lse;
  const float* ds;
  float* dl;   // [chunk / 32][np][32] (null when grad_h is not wanted)
  float* dlt;  // [np / 32][chunk][32] (null when grad_E is not wanted)
  float* out;  // grad_h [n, d] or grad_E [v, d]
  int n, v, d, ignore_id;
  int np, chunk;  // rows padded to 128; the chunk's vocab columns
  int v0;         // the chunk's first vocab row
  int n_tiles;    // 256-wide B tiles a block walks
  int k_slices;   // 32-deep slices of the contraction
  int accumulate;  // grad_h: add into out (every chunk but the first)
};

// The ring's shared memory: kStages stages of [A tile | B tile], then the
// full and empty barriers, initialised here (call before any role split).
struct Ring {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Ring ring_init(unsigned char* smem_raw) {
  using namespace k3;
  Ring r;
  r.smem = hopper::align_1024(smem_raw);
  r.full = reinterpret_cast<uint64_t*>(r.smem + kStages * kStageBytes);
  r.empty = r.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&r.full[s], 1);
      hopper::mbar_init(&r.empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  return r;
}

// Where an operand's 32-deep slice kk lies in its map. A row-major
// [rows, K] map: the box at column 32 kk of row `row` (panel_rows 0).
// K-panels viewed as a [K / 32 * panel_rows, 32] map: the box at column
// 0 of row row + (k0 + kk) * panel_rows.
struct Coord {
  int row, panel_rows, k0;
  __device__ __forceinline__ int col_at(int kk) const {
    return panel_rows ? 0 : kk * k3::kBK;
  }
  __device__ __forceinline__ int row_at(int kk) const {
    return row + (k0 + kk) * panel_rows;
  }
};

// The producer warpgroup: gives up registers, and its first thread loads,
// for each of n_tiles B tiles (the j-th 256 rows further on) and each
// 32-deep slice kk, the A box and the B box.
__device__ __forceinline__ void produce(const CUtensorMap* a_map,
                                        const CUtensorMap* b_map,
                                        const Ring& r, Coord a, Coord b,
                                        int n_tiles, int k_slices) {
  using namespace k3;
  hopper::set_max_regs_dec<40>();
  if (threadIdx.x != 0) return;
  hopper::prefetch_map(a_map);
  hopper::prefetch_map(b_map);
  int it = 0;
  for (int j = 0; j < n_tiles; ++j)
    for (int kk = 0; kk < k_slices; ++kk, ++it) {
      const int s = it % kStages;
      hopper::mbar_wait(&r.empty[s], ((it / kStages) & 1) ^ 1);
      unsigned char* stage = r.smem + s * kStageBytes;
      hopper::mbar_expect_tx(&r.full[s], kStageBytes);
      hopper::tma_load(stage, a_map, &r.full[s], a.col_at(kk), a.row_at(kk));
      hopper::tma_load(stage + kATile, b_map, &r.full[s], b.col_at(kk),
                       b.row_at(kk) + j * kBN);
    }
}

// One [64, 256] tile of this consumer warpgroup over k_slices slices
// (ring position `it` advances), retired into acc and its last stage
// released. The fence first orders any writes to acc (the dl pass forms
// dl in place) before the products that overwrite it; without it ptxas
// serializes the wgmmas.
__device__ __forceinline__ void consume_tile(float (&acc)[128], const Ring& r,
                                             int& it, int k_slices,
                                             int wg_row) {
  hopper::fence_regs(acc);
  for (int kk = 0; kk < k_slices; ++kk, ++it)
    k3_slice(acc, r.smem, r.full, r.empty, it, kk == 0, wg_row);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  if (threadIdx.x % 32 == 0)
    hopper::mbar_arrive(&r.empty[(it - 1) % k3::kStages]);
}

// The two accumulator rows this thread holds: rows g and g + 8 of its
// warp's 16 in the warpgroup's 64 (columns 8j + 2t and 8j + 2t + 1).
struct Frag {
  int warp, g, t, wg_row;
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x % 32;
    warp = threadIdx.x / 32 % 4;
    g = lane >> 2;
    t = lane & 3;
    wg_row = 64 * (threadIdx.x / 128 - 1);
  }
  __device__ __forceinline__ int row(int m0, int h) const {
    return m0 + wg_row + 16 * warp + g + 8 * h;
  }
};

// dl = (exp(logit - lse) - onehot) * ds over one [64, 256] logits tile in
// place, rounded to TF32. v0 is column 0's vocab row; columns at or past
// v are 0. tgt is -1 for an ignored row; lse2 is lse * log2(e).
__device__ __forceinline__ void dl_tile(float (&acc)[128], int v0, int v,
                                        const int (&tgt)[2],
                                        const float (&lse2)[2],
                                        const float (&ds)[2], int t) {
  const int lim = v - v0 - 2 * t;  // columns 8j + c at or past lim are past v
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * j + c;
        float& x = acc[4 * j + 2 * h + c];
        const float p =
            col < lim ? ex2(fmaf(x, k3::kLog2e, -lse2[h])) : 0.f;
        const float onehot = v0 + 2 * t + col == tgt[h] ? 1.f : 0.f;
        x = to_tf32((p - onehot) * ds[h]);
      }
}

// This thread's dl values (times `scale`) into dl's K-panels [chunk /
// 32][np][32] at chunk column c0 (a multiple of 256): column c of row r
// at ((c / 32) * np + r) * 32 + c % 32, one 8-byte store a row and
// column pair.
__device__ __forceinline__ void store_dl(float* dl, const float (&acc)[128],
                                         float scale, const int (&row)[2],
                                         int c0, int np, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const long long panel = c0 / 32 + j / 4;
      *reinterpret_cast<float2*>(dl + (panel * np + row[h]) * 32 +
                                 8 * (j % 4) + 2 * t) =
          make_float2(acc[4 * j + 2 * h] * scale,
                      acc[4 * j + 2 * h + 1] * scale);
    }
}

// The same values into dl^T's K-panels [np / 32][chunk][32]: row r of
// column c at ((r / 32) * chunk + c) * 32 + r % 32, so the eight lanes of
// a quad column write 32 contiguous bytes.
__device__ __forceinline__ void store_dlt(float* dlt, const float (&acc)[128],
                                          float scale, const int (&row)[2],
                                          int c0, int chunk, int t) {
  float* dst[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    dst[h] = dlt + static_cast<long long>(row[h] / 32) * chunk * 32 +
             row[h] % 32;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        dst[h][(c0 + 8 * j + 2 * t + c) * 32] = acc[4 * j + 2 * h + c] * scale;
}

// The dl pass of one vocab chunk: one block per 128 rows of h (grid.y)
// walks the chunk's n_tiles E tiles (h_map over the TF32 copy of h, e_map
// over that of E) and stores each tile's dl into dl and/or dl^T.
__global__ void __launch_bounds__(k3::kThreads, 1)
    xent_dl_kernel(const __grid_constant__ CUtensorMap h_map,
                   const __grid_constant__ CUtensorMap e_map, const Pass p) {
  using namespace k3;
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int m0 = blockIdx.y * kBM;
  if (threadIdx.x < 128) {
    produce(&h_map, &e_map, r, {m0, 0, 0}, {p.v0, 0, 0}, p.n_tiles,
            p.k_slices);
    return;
  }
  hopper::set_max_regs_inc<232>();
  const Frag f;
  const int rows[2] = {f.row(m0, 0), f.row(m0, 1)};
  int tgt[2];
  float lse2[2], ds[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = rows[h] < p.n;
    const int target = live ? p.tgt[rows[h]] : p.ignore_id;
    tgt[h] = target == p.ignore_id ? -1 : target;
    lse2[h] = live ? p.lse[rows[h]] * kLog2e : 0.f;
    ds[h] = live ? p.ds[rows[h]] : 0.f;  // dl is 0 past N
  }
  float acc[128];  // each tile's first slice overwrites it
  int it = 0;
  for (int j = 0; j < p.n_tiles; ++j) {
    consume_tile(acc, r, it, p.k_slices, f.wg_row);
    const int v0 = p.v0 + j * kBN, c0 = j * kBN;
    dl_tile(acc, v0, p.v, tgt, lse2, ds, f.t);
    if (p.dl != nullptr) store_dl(p.dl, acc, 1.f, rows, c0, p.np, f.t);
    if (p.dlt != nullptr) store_dlt(p.dlt, acc, 1.f, rows, c0, p.chunk, f.t);
  }
}

// This consumer warpgroup's [64, 256] product tile into out [rows, d] at
// row0 (the tile's first row) and column n0: written, or added to when
// `accumulate`; rows at or past `rows` and columns at or past d are
// dropped. The adds load four pairs ahead of their stores, so the
// read-add-write waits on a load round trip eight times a row, not 32.
__device__ __forceinline__ void store_tile(float* out,
                                           const float (&acc)[128],
                                           const Frag& f, int row0, int rows,
                                           int n0, int d, int accumulate) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = f.row(row0, h);
    if (row >= rows) continue;
    float2* dst = reinterpret_cast<float2*>(
        out + static_cast<long long>(row) * d + n0 + 2 * f.t);
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += 4) {
      if (n0 + 8 * j0 >= d) break;  // d - n0 is a multiple of 32
      float2 old[4] = {};
      if (accumulate)
#pragma unroll
        for (int q = 0; q < 4; ++q) old[q] = dst[4 * (j0 + q)];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        dst[4 * j] = make_float2(acc[4 * j + 2 * h] + old[q].x,
                                 acc[4 * j + 2 * h + 1] + old[q].y);
      }
    }
  }
}

// K4's product over one chunk: the [128, 256] grad_h tile (row tile
// grid.y, depth tile grid.x) of dl_chunk . E^T_chunk (dl_map over dl's
// K-panels, et_map over E^T's from the chunk's first), written on the
// first chunk and added to on the later ones.
__global__ void __launch_bounds__(k3::kThreads, 1)
    xent_bwd_h_kernel(const __grid_constant__ CUtensorMap dl_map,
                      const __grid_constant__ CUtensorMap et_map,
                      const Pass p) {
  using namespace k3;
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (threadIdx.x < 128) {
    const int dp = gridDim.x * kBN;  // E^T's panel rows
    produce(&dl_map, &et_map, r, {m0, p.np, 0}, {n0, dp, p.v0 / kBK}, 1,
            p.k_slices);
    return;
  }
  hopper::set_max_regs_inc<232>();
  const Frag f;
  float acc[128];
  int it = 0;
  consume_tile(acc, r, it, p.k_slices, f.wg_row);
  store_tile(p.out, acc, f, m0, p.n, n0, p.d, p.accumulate);
}

// K5's product over one chunk: the [128, 256] grad_E tile (chunk row
// tile grid.y, depth tile grid.x) of dl^T_chunk . h over all rows
// (dlt_map and ht_map over the K-blocks of dl^T and h^T); each chunk
// owns its rows of grad_E.
__global__ void __launch_bounds__(k3::kThreads, 1)
    xent_bwd_e_kernel(const __grid_constant__ CUtensorMap dlt_map,
                      const __grid_constant__ CUtensorMap ht_map,
                      const Pass p) {
  using namespace k3;
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (threadIdx.x < 128) {
    const int dp = gridDim.x * kBN;  // h^T's panel rows
    produce(&dlt_map, &ht_map, r, {m0, p.chunk, 0}, {n0, dp, 0}, 1,
            p.k_slices);
    return;
  }
  hopper::set_max_regs_inc<232>();
  const Frag f;
  float acc[128];
  int it = 0;
  consume_tile(acc, r, it, p.k_slices, f.wg_row);
  store_tile(p.out, acc, f, p.v0 + m0, p.v, n0, p.d, 0);
}

// The backward's pre-pass over one [rows, cols] operand (fp32 or bf16):
// its TF32 rounding into dst [rows, cols] (if dst), and the rounding
// transposed into dst_t (if dst_t): [cols_t, rows_t] in K-panels
// [rows_t / 32][cols_t][32], zero past the operand. One block per 32 x
// 32 tile of the padded extent; a tile's transpose is 4 KB contiguous.
template <typename T>
__global__ void __launch_bounds__(256)
    xent_bwd_round_kernel(const T* src, int rows, int cols, float* dst,
                          float* dst_t, int rows_t, int cols_t) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    float x = 0.f;
    if (r < rows && c < cols) {
      const long long at = static_cast<long long>(r) * cols + c;
      if constexpr (sizeof(T) == 4)
        x = to_tf32(src[at]);
      else
        x = __bfloat162float(src[at]);  // exact, and a TF32 value
      if (dst != nullptr) dst[at] = x;
    }
    tile[i][tx] = x;
  }
  if (dst_t == nullptr) return;
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i;  // dst_t row c, column r0 + tx
    if (c < cols_t)
      dst_t[(static_cast<long long>(blockIdx.y) * cols_t + c) * 32 + tx] =
          tile[tx][i];
  }
}

// ------------------------------- host ---------------------------------

template <typename T>
cudaError_t round_tf32(const T* src, float* dst, long long count,
                       cudaStream_t stream) {
  const long long threads = (count + 3) / 4;
  const int blocks =
      static_cast<int>(threads < 132 * 32 * 256 ? (threads + 255) / 256
                                                : 132 * 32);
  tf32_round_kernel<T><<<blocks, 256, 0, stream>>>(src, dst, count);
  return cudaGetLastError();
}

// K3: h and E rounded to TF32 into the scratch copies h32 [n, d] and e32
// [v, d], then the wgmma kernel over them.
cudaError_t run_fwd(const Args& a, int dtype, int depth, float* h32,
                    float* e32, cudaStream_t stream) {
  using namespace k3;
  cudaError_t err =
      dtype == kBF16
          ? round_tf32(static_cast<const __nv_bfloat16*>(a.h), h32,
                       static_cast<long long>(a.n) * depth, stream)
          : round_tf32(static_cast<const float*>(a.h), h32,
                       static_cast<long long>(a.n) * depth, stream);
  if (err != cudaSuccess) return err;
  err = round_tf32(a.e, e32, static_cast<long long>(a.v) * depth, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap h_map, e_map;
  err = hopper::tensor_map(&h_map, h32, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                           a.n, depth, kBM, kBK);
  if (err != cudaSuccess) return err;
  err = hopper::tensor_map(&e_map, e32, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                           a.v, depth, kBN, kBK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(xent_fwd_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  xent_fwd_wgmma_kernel<<<cdiv(a.n, kBM), k3::kThreads, kSmem, stream>>>(
      h_map, e_map, a, depth);
  return cudaGetLastError();
}

// The backward's pre-pass over one operand: src [rows, cols] rounded into
// dst, and transposed into dst_t's K-panels [rows_t / 32][cols_t][32]
// (either may be null; rows_t a multiple of 32).
template <typename T>
cudaError_t round_operand(const T* src, int rows, int cols, float* dst,
                          float* dst_t, int rows_t, int cols_t,
                          cudaStream_t stream) {
  if (dst_t == nullptr) rows_t = rows, cols_t = cols;
  const dim3 grid(cdiv(cols_t, 32), cdiv(rows_t, 32));
  xent_bwd_round_kernel<T><<<grid, 256, 0, stream>>>(src, rows, cols, dst,
                                                     dst_t, rows_t, cols_t);
  return cudaGetLastError();
}

// The backward's buffers: the operands rounded (h32 [n, d], e32 [v, d])
// and transposed (E^T [dp, vp] when grad_h is wanted, h^T [dp, np] when
// grad_E is), and one chunk of dl [np, chunk] (grad_h) and dl^T [chunk,
// np] (grad_E), where np = n rounded up to 128, vp = v and dp = d to
// 256. These four lie in K-panels: et [vp / 32][dp][32], ht [np / 32][dp]
// [32], dl [chunk / 32][np][32], dlt [np / 32][chunk][32].
struct Scratch {
  float *h32, *e32, *et, *ht, *dl, *dlt;
};

cudaError_t run_bwd(const void* h, int dtype, const float* e, Pass p,
                    float* gh, float* ge, const Scratch& s,
                    cudaStream_t stream) {
  using namespace k3;
  const int vp = pad_to(p.v, kBN), dp = pad_to(p.d, kBN);
  cudaError_t err =
      dtype == kBF16
          ? round_operand(static_cast<const __nv_bfloat16*>(h), p.n, p.d,
                          s.h32, ge ? s.ht : nullptr, p.np, dp, stream)
          : round_operand(static_cast<const float*>(h), p.n, p.d, s.h32,
                          ge ? s.ht : nullptr, p.np, dp, stream);
  if (err != cudaSuccess) return err;
  err = round_operand(e, p.v, p.d, s.e32, gh ? s.et : nullptr, vp, dp,
                      stream);
  if (err != cudaSuccess) return err;
  constexpr CUtensorMapDataType kF = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap h_map, e_map, dl_map, et_map, dlt_map, ht_map;
  err = hopper::tensor_map(&h_map, s.h32, kF, 4, p.n, p.d, kBM, kBK);
  if (err == cudaSuccess)
    err = hopper::tensor_map(&e_map, s.e32, kF, 4, p.v, p.d, kBN, kBK);
  // K-panels as [K / 32 * rows, 32] maps: every box lies in one panel.
  const long long dl_rows = static_cast<long long>(p.chunk) * p.np / kBK;
  if (err == cudaSuccess && gh != nullptr)
    err = hopper::tensor_map(&dl_map, s.dl, kF, 4, dl_rows, kBK, kBM, kBK);
  if (err == cudaSuccess && gh != nullptr)
    err = hopper::tensor_map(&et_map, s.et, kF, 4,
                             static_cast<long long>(vp) / kBK * dp, kBK, kBN,
                             kBK);
  if (err == cudaSuccess && ge != nullptr)
    err = hopper::tensor_map(&dlt_map, s.dlt, kF, 4, dl_rows, kBK, kBM, kBK);
  if (err == cudaSuccess && ge != nullptr)
    err = hopper::tensor_map(&ht_map, s.ht, kF, 4,
                             static_cast<long long>(p.np) / kBK * dp, kBK,
                             kBN, kBK);
  for (const void* kernel : {reinterpret_cast<const void*>(xent_dl_kernel),
                             reinterpret_cast<const void*>(xent_bwd_h_kernel),
                             reinterpret_cast<const void*>(xent_bwd_e_kernel)})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  p.dl = gh != nullptr ? s.dl : nullptr;
  p.dlt = ge != nullptr ? s.dlt : nullptr;
  for (int v0 = 0; v0 < p.v; v0 += p.chunk) {
    p.v0 = v0;
    p.n_tiles = cdiv(min(p.chunk, p.v - v0), kBN);
    p.k_slices = p.d / kBK;
    xent_dl_kernel<<<dim3(1, p.np / kBM), kThreads, kSmem, stream>>>(
        h_map, e_map, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (gh != nullptr) {
      Pass q = p;
      q.out = gh;
      q.k_slices = p.n_tiles * (kBN / kBK);
      q.accumulate = v0 > 0;
      xent_bwd_h_kernel<<<dim3(dp / kBN, p.np / kBM), kThreads, kSmem,
                          stream>>>(dl_map, et_map, q);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (ge != nullptr) {
      Pass q = p;
      q.out = ge;
      q.k_slices = p.np / kBK;
      xent_bwd_e_kernel<<<dim3(dp / kBN, cdiv(p.n_tiles * kBN, kBM)),
                          kThreads, kSmem, stream>>>(dlt_map, ht_map, q);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K3. h [n, d] (dtype 0 fp32, 1 bf16), e fp32 [v, d], tgt int32 [n] ->
// lse, gold fp32 [n]; h32 [n, d] and e32 [v, d] are fp32 scratch. Any d
// that is a multiple of 32, with either dtype.
int bs_xent_fwd(int device, const void* h, const float* e, const int* tgt,
                float* lse, float* gold, float* h32, float* e32, int n, int v,
                int d, int dtype, int ignore_id, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (d <= 0 || d % k3::kBK != 0 || (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  if (n <= 0 || v <= 0) return cudaSuccess;
  Args a{};
  a.h = h;
  a.e = e;
  a.tgt = tgt;
  a.lse = lse;
  a.gold = gold;
  a.n = n;
  a.v = v;
  a.ignore_id = ignore_id;
  return run_fwd(a, dtype, d, h32, e32, static_cast<cudaStream_t>(stream));
}

// K4 and K5. lse from K3; ds fp32 [n] is g * mask / count. gh (grad_h,
// fp32 [n, d]) and ge (grad_E, fp32 [v, d]) are each computed when not
// null: gh alone is K4, ge alone K5, both the joint backward (one dl pass
// a chunk). Scratch (Scratch above, fp32): h32 [n, d], e32 [v, d]; with gh
// et and dl; with ge ht and dlt, in K-panels. chunk is a multiple of
// 256, at most vp; d a multiple of 32.
int bs_xent_bwd(int device, const void* h, const float* e, const int* tgt,
                const float* lse, const float* ds, float* gh, float* ge,
                float* h32, float* e32, float* et, float* ht, float* dl,
                float* dlt, int n, int v, int d, int dtype, int ignore_id,
                int chunk, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (d <= 0 || d % k3::kBK != 0 || (dtype != kF32 && dtype != kBF16) ||
      chunk <= 0 || chunk % k3::kBN != 0 ||
      (gh == nullptr && ge == nullptr))
    return cudaErrorInvalidValue;
  if (n <= 0 || v <= 0) return cudaSuccess;
  Pass p{};
  p.tgt = tgt;
  p.lse = lse;
  p.ds = ds;
  p.n = n;
  p.v = v;
  p.d = d;
  p.ignore_id = ignore_id;
  p.np = pad_to(n, k3::kBM);
  p.chunk = chunk;
  const Scratch s{h32, e32, et, ht, dl, dlt};
  return run_bwd(h, dtype, e, p, gh, ge, s, static_cast<cudaStream_t>(stream));
}

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
