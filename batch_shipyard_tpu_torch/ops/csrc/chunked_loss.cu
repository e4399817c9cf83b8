// Fused tied-embedding cross-entropy for Hopper (sm_90a): the loss of
// h @ E^T against targets, and its two gradients, with the [N, V] logits
// never stored.
//
// Replaces three Pallas TPU kernels of batch_shipyard_tpu:
//   K3 ops/chunked_loss.py:_fwd_kernel    (per-row lse and gold logit)
//   K4 ops/chunked_loss.py:_bwd_h_kernel  (grad_h = dlogits @ E)
//   K5 ops/chunked_loss.py:_bwd_e_kernel  (grad_E = dlogits^T @ h)
// h is [N, D] (bf16 for training, fp32 for the exact-math checks), E is
// fp32 [V, D], targets int32 [N]; lse, gold and ds (the per-row scale of
// the loss cotangent) are fp32 [N]; grad_h is fp32 [N, D] and grad_E fp32
// [V, D]. All rows contiguous. K3 takes any D that is a multiple of 32
// with either type of h; K4 and K5 take D of 128, 256, 512 or 1024 (1024
// only with bf16 h: fp32 h and E tiles would not fit in shared memory).
//
// What bounds it. At the training shape (N 32768, D 1024, V 32000) each
// product h.E^T (or its partner) is 2*N*V*D = 2.15 TFLOP, and the
// kernels execute five: one in K3, two in K4 (recompute, dl.E), two in
// K5 (recompute, dl^T.h). Inputs are ~0.2 GB a call, so all three are
// bound by tensor-core operations (4.34 ms a product at the 495 TFLOP/s
// TF32 peak). The TPU kernel casts h and E to f32; here the products run
// in TF32 with fp32 accumulation (operands rounded to TF32 with cvt.rna;
// bf16 h converts exactly). Plain fp32 FMAs would cost ~7x the TF32
// bound.
//
// K3 design (wgmma + TMA). Blocks here run in no order, so the TPU grid's
// carried (m, s, gold) becomes a loop over the vocab inside one block:
//   - A pre-pass (tf32_round_kernel) writes h and E rounded to TF32 into
//     the caller's fp32 scratch: wgmma reads its operands from shared
//     memory, where they cannot be rounded on the way, and the tensor
//     cores truncate the low mantissa bits of a .tf32 operand, which
//     would shrink every logit by ~2^-11 and move lse by ~5e-4. It moves
//     ~0.46 GB at the training shape (~0.15 ms).
//   - One block per 128 rows of h (256 blocks at N 32768: two waves of
//     132 SMs at 97%; 128 blocks at an sp rank's 16384: one wave), so no
//     vocab split and no merge pass. Warpgroup 0 gives up registers
//     (setmaxnreg) and one of its threads keeps a four-stage ring full by
//     TMA: per 32-deep slice the [128, 32] h box and the [256, 32] E box,
//     both 128-byte swizzled and K-major (48 KB), completing on the
//     stage's full mbarrier. Warpgroups 1 and 2 own 64 rows each and run
//     four wgmma m64n256k8 .tf32 a slice, A and B from shared memory;
//     wgmma.wait_group 1 retires the previous slice and its stage (the
//     eight consumer warps arrive on its empty mbarrier), so the ring stays
//     ahead of the tensor cores.
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
//   training shape (the earlier 32-row design read ~134 GB). The fold
//   runs while no products of its warpgroup are in flight, and ptxas
//   keeps the consumers at 168 registers (setmaxnreg notwithstanding),
//   so the fold spills a few hundred bytes a thread. A two-block cluster
//   multicasting E would halve the E share of the L2 traffic; a second
//   accumulator set would overlap the fold, but does not fit.
//
// K4 and K5 design. The TPU grid carries a [bt, D] accumulator across
// V-chunks in K4 and a [bv, D] one across T-chunks in K5, in VMEM; here
// each carried axis is a loop inside one block, and nothing is
// accumulated across blocks (no atomics: results are the same on every
// run).
//   A block keeps a 32-row tile over the full depth D (h rows in K4, E
//   rows in K5) and streams the other operand in 16-row tiles through
//   two shared-memory stages: tile j + 1 arrives by cp.async while tile j
//   is used (K5's per-row inputs of tile j + 1 come into registers). A
//   [32, D] fp32 gradient accumulator is 128 KB at D = 1024: it lives in
//   registers, 128 a thread across eight warps (warp w owns columns
//   w * D/8). Shared memory then holds 32 E rows (128 KB) and 32 h rows
//   (bf16, 64 KB), so every streamed tile is read from L2 once per block
//   and serves both the logits product and the gradient product. One
//   block fits an SM. The products are TF32 mma.sync m16n8k8, E and fp32
//   h rounded as fragments are read, dl as it is stored.
//   The [32, 16] (or [16, 32]) logits tile is split over the depth: each
//   warp computes all of it over one eighth of D, so every fragment serves
//   two or four products, and the eight partials are summed in a fixed
//   order through shared memory. Within each 8-deep step lane t takes
//   depths 2t and 2t + 1 for the mma's k = t and t + 4 (the same
//   permutation on both operands leaves the sum unchanged), so each
//   operand pair is one 32- or 64-bit load.
//   K4: one block per 32 rows of h walks the vocab; recomputes the logits
//     tile, forms dl = (exp(logit - lse) - onehot) * ds, and adds
//     dl @ E_tile into its [32, D] accumulator.
//   K5: one block per 32 rows of E walks the rows of h: recomputes dl,
//     adds dl^T @ h_tile into its [32, D] accumulator.
//   The ragged row and vocab tails are masked in the kernels (zero rows
//   in shared memory, ds = 0 past N, p = 0 past V): nothing is padded in
//   device memory. Each row tile of K4 re-reads all of E from L2 (each
//   vocab tile of K5 all of h).
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kHold = 32;      // rows a block keeps (h in K4, E in K5)
constexpr int kStream = 16;    // rows of a streamed tile (E in K4, h in K5)
constexpr int kLDL = 20;       // row stride of the dl tile [32][16]
constexpr int kPartFloats = kHold * (kStream + 4);  // one warp's partial
constexpr float kNeg = -1e30f;

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* h;
  const float* e;
  const int* tgt;
  float* lse;
  float* gold;
  const float* ds;
  float* gh;
  float* ge;
  int n, v, ignore_id;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One operand element as TF32 bits: fp32 values (E, fp32 h) round to
// TF32 as they are read (dl is stored rounded, and rounding is
// idempotent); bf16 -> fp32 is exact, and an fp32 with a bf16 mantissa is
// a TF32 value.
__device__ __forceinline__ uint32_t bits(const float* p) {
  return __float_as_uint(to_tf32(*p));
}
__device__ __forceinline__ uint32_t bits(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16;
}

// Two depth-adjacent elements (depths k, k + 1) as TF32 bits.
__device__ __forceinline__ void pair(const float* p, uint32_t& lo,
                                     uint32_t& hi) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  lo = __float_as_uint(to_tf32(v.x));
  hi = __float_as_uint(to_tf32(v.y));
}
__device__ __forceinline__ void pair(const __nv_bfloat16* p, uint32_t& lo,
                                     uint32_t& hi) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  lo = v << 16;
  hi = v & 0xffff0000u;
}

// Shared memory: 32 rows of E and 32 of h (in K4 the E rows are two
// 16-row stages and the h rows the kept tile; in K5 the reverse), the
// eight warps' partial logits, the dl tile and the per-row inputs. Row
// strides are padded so that fragment loads fall in distinct banks.
template <typename TH, int D>
struct Layout {
  static constexpr int kLDH = D + 8;
  static constexpr int kLDE = D + 8;
  static constexpr size_t kSmem =
      kHold * kLDE * sizeof(float) + kHold * kLDH * sizeof(TH) +
      (kWarps * kPartFloats + kHold * kLDL + 3 * kHold) * sizeof(float);
};

struct Smem {
  float* e;
  void* h;
  float* part;
  float* dl;
  float* lse;
  float* ds;
  int* tgt;
};

template <typename TH, int D>
__device__ __forceinline__ Smem carve(unsigned char* smem) {
  Smem s;
  s.e = reinterpret_cast<float*>(smem);
  TH* h = reinterpret_cast<TH*>(s.e + kHold * Layout<TH, D>::kLDE);
  s.h = h;
  s.part = reinterpret_cast<float*>(h + kHold * Layout<TH, D>::kLDH);
  s.dl = s.part + kWarps * kPartFloats;
  s.lse = s.dl + kHold * kLDL;
  s.ds = s.lse + kHold;
  s.tgt = reinterpret_cast<int*>(s.ds + kHold);
  return s;
}

// Rows [r0, r0 + kRows) of a contiguous [rows, D] tensor into shared
// memory with row stride ld, as 16-byte cp.async copies that are all in
// flight at once; rows past `rows` become zeros.
template <typename T, int D, int kRows>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int r0,
                                          int rows, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
#pragma unroll 4
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    T* to = dst + r * ld + c;
    if (r0 + r < rows) {
      const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(to));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src + static_cast<long long>(r0 + r) * D + c));
    } else {
      *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The per-row inputs of one row: its target (-1 where ignored or past N),
// lse and ds (0 past N, so dl is 0 there). fetch() reads them into
// registers, put() stores them, so a caller can overlap the two.
struct RowIn {
  int tgt = -1;
  float lse = 0.f, ds = 0.f;

  __device__ __forceinline__ void fetch(const Args& a, int row) {
    if (row >= a.n) return;
    const int t = a.tgt[row];
    tgt = t == a.ignore_id ? -1 : t;
    lse = a.lse[row];
    ds = a.ds[row];
  }
  __device__ __forceinline__ void put(const Smem& sm, int at) const {
    sm.tgt[at] = tgt;
    sm.lse[at] = lse;
    sm.ds[at] = ds;
  }
};

// Per-row inputs of rows [r0, r0 + count) into sm at [0, count).
__device__ __forceinline__ void load_rows(const Args& a, const Smem& sm,
                                          int r0, int count) {
  if (threadIdx.x < count) {
    RowIn in;
    in.fetch(a, r0 + threadIdx.x);
    in.put(sm, threadIdx.x);
  }
}

// This warp's partial of the [R, C] logits tile h_s . e_s^T (R h rows, C
// E rows), over depths [warp * D/8, (warp + 1) * D/8), into its slot of
// `part` ([R][C + 4]). Each fragment serves R/16 or C/8 products. Within
// each 8-deep step lane t takes depths 2t and 2t + 1 for the mma's k = t
// and t + 4: the same permutation on both operands leaves the sum
// unchanged, and each operand pair is one 32- or 64-bit load.
template <typename TH, int D, int R, int C>
__device__ __forceinline__ void logits_partial(float* part, const TH* h_s,
                                               const float* e_s, int warp,
                                               int lane) {
  constexpr int ldh = Layout<TH, D>::kLDH, lde = Layout<TH, D>::kLDE;
  constexpr int kMT = R / 16, kNT = C / 8, ldp = C + 4;
  const int g = lane >> 2, t = lane & 3;
  const int k_begin = warp * (D / kWarps);
  float acc[kMT][kNT][4] = {};
#pragma unroll 4
  for (int k0 = k_begin; k0 < k_begin + D / kWarps; k0 += 8) {
    uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const TH* row = h_s + (16 * i + g) * ldh + k0 + 2 * t;
      pair(row, a[i][0], a[i][2]);
      pair(row + 8 * ldh, a[i][1], a[i][3]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      pair(e_s + (8 * j + g) * lde + k0 + 2 * t, b[j][0], b[j][1]);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(acc[i][j], a[i], b[j][0], b[j][1]);
  }
  float* out = part + warp * kPartFloats;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out + (16 * i + g + 8 * r) * ldp + 8 * j +
                                   2 * t) =
            make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
}

// Logits (row, col) and (row, col + 1) of the [R, C] tile: the eight
// partials summed in order. The softmax and dl passes give each row
// 256 / R threads, two columns each.
template <int C>
__device__ __forceinline__ void gather_logits(float (&x)[2], const float* part,
                                              int row, int col) {
  const float* p = part + row * (C + 4) + col;
  x[0] = p[0];
  x[1] = p[1];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    x[0] += p[w * kPartFloats];
    x[1] += p[w * kPartFloats + 1];
  }
}

// dl = (p - onehot) * ds for logits (hrow, vcol), (hrow, vcol + 1) of the
// tile, rounded to TF32, into dl_s at [hrow][vcol] (K4) or [vcol][hrow]
// (K5, kTransposed). vocab0 is the tile's first vocab row; the row
// inputs are indexed by hrow.
template <bool kTransposed>
__device__ __forceinline__ void write_dl(float* dl_s, const float (&x)[2],
                                         const float* lse_s,
                                         const float* ds_s, const int* tgt_s,
                                         int vocab0, int v, int hrow,
                                         int vcol) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int cl = vcol + c;
    const int col = vocab0 + cl;
    const float p = col < v ? expf(x[c] - lse_s[hrow]) : 0.f;
    const float onehot = col == tgt_s[hrow] ? 1.f : 0.f;
    dl_s[kTransposed ? cl * kLDL + hrow : hrow * kLDL + cl] =
        to_tf32((p - onehot) * ds_s[hrow]);
  }
}

// acc[2][D/64][4] += A[32 x 16] . B[16 x D/8]: A = a_s (row stride kLDL,
// TF32 values), B = b_s[k][col0 + ...] (row stride ldb). The warp's block
// is all 32 rows, columns col0 .. col0 + D/8.
template <int D, typename TB>
__device__ __forceinline__ void grad_product(float (&acc)[2][D / 64][4],
                                             const float* a_s, const TB* b_s,
                                             int ldb, int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < kStream; k0 += 8) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* p = a_s + (16 * i + g) * kLDL + k0 + t;
      a[i][0] = bits(p);
      a[i][1] = bits(p + 8 * kLDL);
      a[i][2] = bits(p + 4);
      a[i][3] = bits(p + 8 * kLDL + 4);
    }
    const TB* b = b_s + (k0 + t) * ldb + col0 + g;
#pragma unroll
    for (int j = 0; j < D / 64; ++j) {
      const uint32_t b0 = bits(b + 8 * j), b1 = bits(b + 4 * ldb + 8 * j);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_tf32(acc[i][j], a[i], b0, b1);
    }
  }
}

// Writes this warp's [32, D/8] accumulator block into rows row0.. of a
// contiguous fp32 [rows, D] tensor; rows at or past `rows` are dropped.
template <int D>
__device__ __forceinline__ void store_block(float* out,
                                            const float (&acc)[2][D / 64][4],
                                            int row0, int rows, int col0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * i + g + 8 * r;
      if (row >= rows) continue;
      float* dst = out + static_cast<long long>(row) * D + col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 64; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
    }
  }
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

// K4: one block per 32-row tile of h walks the vocab in 16-row E tiles
// (two stages: tile j + 1 is copied while tile j is used) and accumulates
// dl @ E_tile into [32, D]; warp w owns columns w * D/8 of it.
template <typename TH, int D>
__global__ void __launch_bounds__(kThreads, 1) xent_bwd_h_kernel(Args a) {
  constexpr int ldh = Layout<TH, D>::kLDH, lde = Layout<TH, D>::kLDE;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = carve<TH, D>(smem);
  TH* h_s = static_cast<TH*>(sm.h);
  const int* tgt_s = sm.tgt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = threadIdx.x >> 3, col = 2 * (threadIdx.x & 7);
  const int r0 = blockIdx.x * kHold;
  const int col0 = warp * (D / kWarps);
  copy_rows<TH, D, kHold>(h_s, static_cast<const TH*>(a.h), r0, a.n, ldh);
  wait_copies();
  load_rows(a, sm, r0, kHold);
  copy_rows<float, D, kStream>(sm.e, a.e, 0, a.v, lde);
  float acc[2][D / 64][4] = {};
  const int n_v = cdiv(a.v, kStream);
  for (int j = 0; j < n_v; ++j) {
    const int v0 = j * kStream;
    const float* e_s = sm.e + (j & 1) * kStream * lde;
    wait_copies();
    __syncthreads();  // tile j is in place; tile j - 1's readers are done
    if (j + 1 < n_v)
      copy_rows<float, D, kStream>(sm.e + ((j + 1) & 1) * kStream * lde, a.e,
                                   v0 + kStream, a.v, lde);
    logits_partial<TH, D, kHold, kStream>(sm.part, h_s, e_s, warp, lane);
    __syncthreads();
    float x[2];
    gather_logits<kStream>(x, sm.part, row, col);
    write_dl<false>(sm.dl, x, sm.lse, sm.ds, tgt_s, v0, a.v, row, col);
    __syncthreads();
    grad_product<D>(acc, sm.dl, e_s, lde, col0, lane);
  }
  store_block<D>(a.gh, acc, r0, a.n, col0, lane);
}

// K5: one block per 32-row tile of E keeps it and walks the rows of h in
// 16-row tiles (two stages, with their targets, lse and ds), accumulating
// dl^T @ h_tile into [32, D] as K4 does.
template <typename TH, int D>
__global__ void __launch_bounds__(kThreads, 1) xent_bwd_e_kernel(Args a) {
  constexpr int ldh = Layout<TH, D>::kLDH, lde = Layout<TH, D>::kLDE;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = carve<TH, D>(smem);
  TH* h_base = static_cast<TH*>(sm.h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = threadIdx.x >> 4, col = 2 * (threadIdx.x & 15);
  const int v0 = blockIdx.x * kHold;
  const int col0 = warp * (D / kWarps);
  copy_rows<float, D, kHold>(sm.e, a.e, v0, a.v, lde);
  wait_copies();
  copy_rows<TH, D, kStream>(h_base, static_cast<const TH*>(a.h), 0, a.n, ldh);
  load_rows(a, sm, 0, kStream);
  float acc[2][D / 64][4] = {};
  const int n_t = cdiv(a.n, kStream);
  for (int i = 0; i < n_t; ++i) {
    const int r0 = i * kStream, stage = i & 1, next = stage ^ 1;
    const TH* h_s = h_base + stage * kStream * ldh;
    wait_copies();
    __syncthreads();  // tile i is in place; tile i - 1's readers are done
    // The next tile's rows: h by cp.async, the per-row inputs into
    // registers now and into their stage after this tile's product.
    RowIn in;
    const bool more = i + 1 < n_t;
    if (more) {
      copy_rows<TH, D, kStream>(h_base + next * kStream * ldh,
                                static_cast<const TH*>(a.h), r0 + kStream,
                                a.n, ldh);
      if (threadIdx.x < kStream) in.fetch(a, r0 + kStream + threadIdx.x);
    }
    logits_partial<TH, D, kStream, kHold>(sm.part, h_s, sm.e, warp, lane);
    if (more && threadIdx.x < kStream) in.put(sm, next * kStream + threadIdx.x);
    __syncthreads();
    float x[2];
    gather_logits<kHold>(x, sm.part, row, col);
    write_dl<true>(sm.dl, x, sm.lse + stage * kStream,
                   sm.ds + stage * kStream, sm.tgt + stage * kStream, v0,
                   a.v, row, col);
    __syncthreads();
    grad_product<D>(acc, sm.dl, h_s, ldh, col0, lane);
  }
  store_block<D>(a.ge, acc, v0, a.v, col0, lane);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int blocks, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

enum Which : int { kFwd = 0, kBwdH = 1, kBwdE = 2 };

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

template <typename TH, int D>
cudaError_t run(Which which, const Args& a, cudaStream_t stream) {
  const size_t smem = Layout<TH, D>::kSmem;
  if (which == kBwdH)
    return launch(xent_bwd_h_kernel<TH, D>, smem, cdiv(a.n, kHold), a,
                  stream);
  return launch(xent_bwd_e_kernel<TH, D>, smem, cdiv(a.v, kHold), a, stream);
}

cudaError_t dispatch(Which which, int dtype, int depth, const Args& a,
                     cudaStream_t stream) {
#define BS_CASE(TYPE, DEPTH) return run<TYPE, DEPTH>(which, a, stream)
  if (dtype == kBF16 && depth == 128) BS_CASE(__nv_bfloat16, 128);
  if (dtype == kBF16 && depth == 256) BS_CASE(__nv_bfloat16, 256);
  if (dtype == kBF16 && depth == 512) BS_CASE(__nv_bfloat16, 512);
  if (dtype == kBF16 && depth == 1024) BS_CASE(__nv_bfloat16, 1024);
  if (dtype == kF32 && depth == 128) BS_CASE(float, 128);
  if (dtype == kF32 && depth == 256) BS_CASE(float, 256);
  if (dtype == kF32 && depth == 512) BS_CASE(float, 512);
#undef BS_CASE
  return cudaErrorInvalidValue;
}

int entry(Which which, int device, const Args& a, int depth, int dtype,
          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.n <= 0 || a.v <= 0) return cudaSuccess;
  return dispatch(which, dtype, depth, a, static_cast<cudaStream_t>(stream));
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

// K4 (which 1) -> out = grad_h fp32 [n, d]; K5 (which 2) -> out = grad_E
// fp32 [v, d]. lse from K3; ds fp32 [n] is g * mask / count.
int bs_xent_bwd(int which, int device, const void* h, const float* e,
                const int* tgt, const float* lse, const float* ds, float* out,
                int n, int v, int d, int dtype, int ignore_id, void* stream) {
  if (which != kBwdH && which != kBwdE) return cudaErrorInvalidValue;
  Args a{};
  a.h = h;
  a.e = e;
  a.tgt = tgt;
  a.lse = const_cast<float*>(lse);
  a.ds = ds;
  a.gh = out;
  a.ge = out;
  a.n = n;
  a.v = v;
  a.ignore_id = ignore_id;
  return entry(static_cast<Which>(which), device, a, d, dtype, stream);
}

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
