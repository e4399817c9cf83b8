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
// [V, D]. All rows contiguous. D is 128, 256, 512 or 1024 (1024 only with
// bf16 h: fp32 h and E tiles would not fit in shared memory).
//
// What bounds it. At the training shape (N 32768, D 1024, V 32000) each
// product h.E^T (or its partner) is 2*N*V*D = 2.15 TFLOP, and the
// kernels execute five: one in K3, two in K4 (recompute, dl.E), two in
// K5 (recompute, dl^T.h). Inputs are ~0.2 GB a call, so all three are
// bound by tensor-core operations. The TPU kernel casts h and E to f32;
// here the products run on TF32 mma.sync m16n8k8 with fp32 accumulation
// (E and fp32 h rounded to TF32 with cvt.rna as fragments are read, dl
// as it is stored; bf16 h converts exactly). Plain fp32 FMAs would cost
// ~7x the TF32 bound.
//
// Design. The TPU grid carries (m, s, gold) across V-chunks in K3, a
// [bt, D] accumulator across V-chunks in K4 and a [bv, D] one across
// T-chunks in K5, all in VMEM. Blocks here run in no order, so each
// carried axis is a loop inside one block, and nothing is accumulated
// across blocks (no atomics: results are the same on every run).
//   A block keeps a 32-row tile over the full depth D (h rows in K3/K4,
//   E rows in K5) and streams the other operand in 16-row tiles through
//   two shared-memory stages: tile j + 1 arrives by cp.async while tile j
//   is used (K5's per-row inputs of tile j + 1 come into registers). A
//   [32, D] fp32 gradient accumulator is 128 KB at D = 1024: it lives in
//   registers, 128 a thread across eight warps (warp w owns columns
//   w * D/8). Shared memory then holds 32 E rows (128 KB) and 32 h rows
//   (bf16, 64 KB), so every streamed tile is read from L2 once per block
//   and serves both the logits product and the gradient product. One
//   block fits an SM.
//   The [32, 16] (or [16, 32]) logits tile is split over the depth: each
//   warp computes all of it over one eighth of D, so every fragment serves
//   two or four products, and the eight partials are summed in a fixed
//   order through shared memory. Within each 8-deep step lane t takes
//   depths 2t and 2t + 1 for the mma's k = t and t + 4 (the same
//   permutation on both operands leaves the sum unchanged), so each
//   operand pair is one 32- or 64-bit load.
//   K3: one block per 32 rows of h walks the vocab: logits tile on tensor
//     cores, the vocab tail masked to -1e30 (finite, as the reference's
//     _NEG), online max and sum per row, the gold logit picked where col
//     == target. Rows whose target is ignore_id keep gold 0.
//   K4: one block per 32 rows of h walks the vocab; recomputes the logits
//     tile, forms dl = (exp(logit - lse) - onehot) * ds, and adds
//     dl @ E_tile into its [32, D] accumulator.
//   K5: one block per 32 rows of E walks the rows of h: recomputes dl,
//     adds dl^T @ h_tile into its [32, D] accumulator.
// The ragged row and vocab tails are masked in the kernels (zero rows in
// shared memory, ds = 0 past N, p = 0 past V): nothing is padded in
// device memory. Kernels launch on the caller's stream, allocate nothing
// and do not synchronise. Each row tile of K3/K4 re-reads all of E from
// L2 (each vocab tile of K5 all of h): larger tiles (a cluster sharing
// them), TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kHold = 32;      // rows a block keeps (h in K3/K4, E in K5)
constexpr int kStream = 16;    // rows of a streamed tile (E in K3/K4, h in K5)
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

// Shared memory: 32 rows of E and 32 of h (in K3/K4 the E rows are two
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

  __device__ __forceinline__ void fetch(const Args& a, int row,
                                        bool grads) {
    if (row >= a.n) return;
    const int t = a.tgt[row];
    tgt = t == a.ignore_id ? -1 : t;
    if (grads) {
      lse = a.lse[row];
      ds = a.ds[row];
    }
  }
  __device__ __forceinline__ void put(const Smem& sm, int at) const {
    sm.tgt[at] = tgt;
    sm.lse[at] = lse;
    sm.ds[at] = ds;
  }
};

// Per-row inputs of rows [r0, r0 + count) into sm at [0, count).
__device__ __forceinline__ void load_rows(const Args& a, const Smem& sm,
                                          int r0, int count, bool grads) {
  if (threadIdx.x < count) {
    RowIn in;
    in.fetch(a, r0 + threadIdx.x, grads);
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

// K3: one block per 32-row tile of h walks the vocab in 16-row E tiles,
// two stages: tile j + 1 is copied while tile j is used. The softmax
// update gives each row eight threads, two columns each.
template <typename TH, int D>
__global__ void __launch_bounds__(kThreads, 1) xent_fwd_kernel(Args a) {
  constexpr int ldh = Layout<TH, D>::kLDH, lde = Layout<TH, D>::kLDE;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = carve<TH, D>(smem);
  TH* h_s = static_cast<TH*>(sm.h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = threadIdx.x >> 3, col = 2 * (threadIdx.x & 7);
  const int r0 = blockIdx.x * kHold;
  copy_rows<TH, D, kHold>(h_s, static_cast<const TH*>(a.h), r0, a.n, ldh);
  wait_copies();
  load_rows(a, sm, r0, kHold, false);
  copy_rows<float, D, kStream>(sm.e, a.e, 0, a.v, lde);
  float m = kNeg, sum = 0.f, gold = 0.f;
  const int n_v = cdiv(a.v, kStream);
  for (int j = 0; j < n_v; ++j) {
    const int v0 = j * kStream;
    float* e_s = sm.e + (j & 1) * kStream * lde;
    wait_copies();
    __syncthreads();  // tile j is in place; tile j - 1's readers are done
    if (j + 1 < n_v)
      copy_rows<float, D, kStream>(sm.e + ((j + 1) & 1) * kStream * lde, a.e,
                                   v0 + kStream, a.v, lde);
    logits_partial<TH, D, kHold, kStream>(sm.part, h_s, e_s, warp, lane);
    __syncthreads();
    float x[2];
    gather_logits<kStream>(x, sm.part, row, col);
    float mx = m;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (v0 + col + c >= a.v) x[c] = kNeg;
      mx = fmaxf(mx, x[c]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const int local = sm.tgt[row] - v0;
    float part = 0.f, hit = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      part += expf(x[c] - mx);
      if (col + c == local) hit = x[c];
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, o);
      hit += __shfl_xor_sync(0xffffffffu, hit, o);
    }
    sum = sum * expf(m - mx) + part;
    m = mx;
    gold += hit;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  if (col == 0 && r0 + row < a.n) {
    a.lse[r0 + row] = m + logf(sum);
    a.gold[r0 + row] = gold;
  }
}

// K4: one block per 32-row tile of h walks the vocab in 16-row E tiles
// (two stages, as K3) and accumulates dl @ E_tile into [32, D]; warp w
// owns columns w * D/8 of it.
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
  load_rows(a, sm, r0, kHold, true);
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
  load_rows(a, sm, 0, kStream, true);
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
      if (threadIdx.x < kStream) in.fetch(a, r0 + kStream + threadIdx.x, true);
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

template <typename TH, int D>
cudaError_t run(Which which, const Args& a, cudaStream_t stream) {
  const size_t smem = Layout<TH, D>::kSmem;
  if (which == kFwd)
    return launch(xent_fwd_kernel<TH, D>, smem, cdiv(a.n, kHold), a, stream);
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
// lse, gold fp32 [n].
int bs_xent_fwd(int device, const void* h, const float* e, const int* tgt,
                float* lse, float* gold, int n, int v, int d, int dtype,
                int ignore_id, void* stream) {
  Args a{};
  a.h = h;
  a.e = e;
  a.tgt = tgt;
  a.lse = lse;
  a.gold = gold;
  a.n = n;
  a.v = v;
  a.ignore_id = ignore_id;
  return entry(kFwd, device, a, d, dtype, stream);
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
