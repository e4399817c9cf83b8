// Flash attention forward and backward over [B, T, H, D], for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of batch_shipyard_tpu:
//   K1 ops/attention.py:_flash_fwd_kernel  (forward: O and lse)
//   K2 ops/attention.py:_flash_bwd_kernel  (backward: dQ, dK, dV)
// One source serves both, templated on the element type (float for the
// exact-math check, __nv_bfloat16 for training) and the head depth (64,
// 128). q/k/v/dO are read in place through their [B, T, H, D] strides (the
// last dim contiguous); O, dQ, dK, dV are written contiguous [B, T, H, D];
// lse and delta are fp32 [B*H, T].
//
// What bounds it. At the training shape (B16 H16 T2048 D64, causal, bf16)
// K1 does 4*B*H*T*T*D/2 = 137 GFLOP: 0.139 ms at the 989 TFLOP/s bf16 peak,
// against 0.080 ms to move its 268 MB. K2 does 2.5x K1's product work
// (five products per tile, half masked away): 0.347 ms. Both are bound by
// tensor-core operations, so the products run on mma.sync m16n8k16 (bf16
// in, fp32 accumulate) and the scores never leave registers.
//
// Design. The TPU grid runs in order on one core; here blocks run in no
// order on 132 SMs, so every sequential grid axis becomes a loop inside a
// block. A block of four warps owns 64 rows (16 per warp) and walks the
// other sequence axis in tiles of kBlockN (64 at D=64, 32 at D=128, to keep
// the accumulators in registers). Tiles are staged in shared memory with
// rows padded by 16 bytes (conflict-free fragment loads).
//   K1: one block per (b*h, q-tile); online softmax with fp32 m, l and O
//     accumulator; p is rounded to V's type before P.V; lse = m + log(l),
//     l == 0 -> 1. Causal: tiles below the diagonal run unmasked, tiles
//     that straddle it (or the ragged tail) are masked, tiles above are
//     never loaded.
//   K2: the TPU kernel carries dQ in VMEM scratch across its sequential
//     kv axis. That cannot carry over, so K2 is the deterministic split:
//     one kernel per (b*h, kv-tile) loops over q-tiles for dK and dV, a
//     second per (b*h, q-tile) loops over kv-tiles for dQ. P and dP are
//     recomputed once more (four products in the first, three in the
//     second, against five fused), but there are no atomics and no fp32
//     dQ buffer with a cast pass: results are the same on every run.
//     Rounding points follow the TPU kernel: p -> dO's type for dV; ds ->
//     the operand's type for dK and dQ; both scaled by 1/sqrt(D).
// The fp32 instantiation runs the same tiles through a plain FMA loop in
// the accumulator layout of mma.sync, so the softmax code is shared.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; cp.async/TMA double buffering and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kBM = 64;        // rows a block owns (16 per warp)
constexpr float kNegInf = -1e30f;

enum DType : int { kF32 = 0, kBF16 = 1 };

template <int D>
struct Tile {
  static constexpr int kN = D <= 64 ? 64 : 32;  // other-axis tile
};

template <typename T>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);  // 16 bytes per row
  static constexpr bool kScratch = std::is_same<T, float>::value;
};

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
  int heads, seq, causal;
  float scale;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  uint16_t a, b;
  memcpy(&a, &lo, 2);
  memcpy(&b, &hi, 2);
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Warp-level products. Accumulators use the m16n8 layout of mma.sync: lane
// (g = lane/4, t = lane%4) holds, for each 8-column tile j, rows g and g+8
// at columns 8j+2t and 8j+2t+1 as acc[j][0..1] and acc[j][2..3].
template <typename T>
struct Warp;

template <>
struct Warp<__nv_bfloat16> {
  using T = __nv_bfloat16;

  // acc[NT][4] += A[16 x K] . B[NT*8 x K]^T, both row-major in shared
  // memory with K contiguous.
  template <int NT, int K>
  static __device__ __forceinline__ void nt(float (&acc)[NT][4], const T* a,
                                            int lda, const T* b, int ldb,
                                            float*, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const uint32_t af[4] = {ld_pair(a + g * lda + k0 + 2 * t),
                              ld_pair(a + (g + 8) * lda + k0 + 2 * t),
                              ld_pair(a + g * lda + k0 + 2 * t + 8),
                              ld_pair(a + (g + 8) * lda + k0 + 2 * t + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* row = b + (8 * j + g) * ldb + k0 + 2 * t;
        const uint32_t bf[2] = {ld_pair(row), ld_pair(row + 8)};
        mma_bf16(acc[j], af, bf);
      }
    }
  }

  // acc[NT][4] += P[16 x K] . B[K x NT*8]: P in registers in the
  // accumulator layout (K/8 column tiles), rounded to bf16 here; B
  // row-major [K][ldb] in shared memory.
  template <int NT, int K>
  static __device__ __forceinline__ void pn(float (&acc)[NT][4],
                                            const float (&p)[K / 8][4],
                                            const T* b, int ldb, float*,
                                            int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      const uint32_t af[4] = {pack_f32(p[2 * kk][0], p[2 * kk][1]),
                              pack_f32(p[2 * kk][2], p[2 * kk][3]),
                              pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      const T* rows = b + (16 * kk + 2 * t) * ldb;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + g;
        const uint32_t bf[2] = {
            pack_bf16(rows[col], rows[ldb + col]),
            pack_bf16(rows[8 * ldb + col], rows[9 * ldb + col])};
        mma_bf16(acc[j], af, bf);
      }
    }
  }
};

template <>
struct Warp<float> {
  using T = float;

  template <int NT, int K>
  static __device__ __forceinline__ void nt(float (&acc)[NT][4], const T* a,
                                            int lda, const T* b, int ldb,
                                            float*, int lane) {
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

  // P goes through this warp's [16][K + 4] fp32 scratch so that every
  // lane can read whole rows of it.
  template <int NT, int K>
  static __device__ __forceinline__ void pn(float (&acc)[NT][4],
                                            const float (&p)[K / 8][4],
                                            const T* b, int ldb,
                                            float* scratch, int lane) {
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
};

// rows [row0, row0 + nrows) of a [seq, D] view with row stride `stride`
// into shared memory with row stride D + pad; rows past seq become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int row0,
                                          int nrows, int seq) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int ld = D + Smem<T>::kPad;
  for (int i = threadIdx.x; i < nrows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq)
      val = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * stride + c));
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Writes 16 rows x D of a warp's accumulator (times `mul`) into a
// contiguous [B, T, H, D] tensor; rows past seq are dropped.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* base, const float (&acc)[NT][4],
                                           int row0, int seq, int heads,
                                           const float (&mul)[2], int lane) {
  constexpr int D = NT * 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= seq) continue;
    T* out = base + static_cast<long long>(row) * heads * D;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store2(out + 8 * j + 2 * t, acc[j][2 * r] * mul[r],
             acc[j][2 * r + 1] * mul[r]);
  }
}

template <typename T, int D>
constexpr size_t scratch_bytes() {
  return Smem<T>::kScratch ? 4 * 16 * (Tile<D>::kN + 4) * sizeof(float) : 0;
}

template <typename T, int D>
constexpr size_t fwd_smem() {
  return (kBM + 2 * Tile<D>::kN) * (D + Smem<T>::kPad) * sizeof(T) +
         scratch_bytes<T, D>();
}

template <typename T, int D>
constexpr size_t dkdv_smem() {
  return (2 * kBM + 2 * Tile<D>::kN) * (D + Smem<T>::kPad) * sizeof(T) +
         2 * Tile<D>::kN * sizeof(float) + scratch_bytes<T, D>();
}

template <typename T, int D>
constexpr size_t dq_smem() {
  return (2 * kBM + 2 * Tile<D>::kN) * (D + Smem<T>::kPad) * sizeof(T) +
         scratch_bytes<T, D>();
}

// K1: one block per (q-tile, b*h). q-tiles are taken last first, so the
// longest causal rows start first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int BN = Tile<D>::kN;
  constexpr int LD = D + Smem<T>::kPad;
  constexpr int NTD = D / 8, NTN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kBM * LD;
  T* sv = sk + BN * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = reinterpret_cast<float*>(sv + BN * LD) + warp * 16 * (BN + 4);
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int seq = a.seq;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  load_rows<T, D>(sq, qb, a.q_st, q0, kBM, seq);

  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float o[NTD][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int n_kv = cdiv(seq, BN);
  const int n_iter = a.causal ? min(n_kv, cdiv(q0 + kBM, BN)) : n_kv;
  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D>(sk, kb, a.k_st, k0, BN, seq);
    load_rows<T, D>(sv, vb, a.v_st, k0, BN, seq);
    __syncthreads();
    float s[NTN][4] = {};
    Warp<T>::template nt<NTN, D>(s, sq + warp * 16 * LD, LD, sk, LD, scratch,
                                 lane);
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
    Warp<T>::template pn<NTD, BN>(o, s, sv, LD, scratch, lane);
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
  T* ob = static_cast<T*>(a.out) +
          (static_cast<long long>(b) * seq * a.heads + h) * D;
  store_rows<T, NTD>(ob, o, q0 + warp * 16, seq, a.heads, inv, lane);
}

// K2, first half: one block per (kv-tile, b*h) walks the q-tiles that can
// see it and accumulates dK and dV for its 64 keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  constexpr int BN = Tile<D>::kN;
  constexpr int LD = D + Smem<T>::kPad;
  constexpr int NTD = D / 8, NTN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + kBM * LD;
  T* sq = sv + kBM * LD;
  T* sdo = sq + BN * LD;
  float* slse = reinterpret_cast<float*>(sdo + BN * LD);
  float* sdelta = slse + BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = sdelta + BN + warp * 16 * (BN + 4);
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int seq = a.seq;
  const int k0 = blockIdx.x * kBM;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const float* lse = a.lse + static_cast<long long>(bh) * seq;
  const float* delta = a.delta + static_cast<long long>(bh) * seq;
  load_rows<T, D>(sk, kb, a.k_st, k0, kBM, seq);
  load_rows<T, D>(sv, vb, a.v_st, k0, kBM, seq);

  const int key0 = k0 + warp * 16 + g;  // this lane's keys: key0, key0 + 8
  float dk[NTD][4] = {};
  float dv[NTD][4] = {};
  const int n_q = cdiv(seq, BN);
  for (int i = a.causal ? k0 / BN : 0; i < n_q; ++i) {
    const int qs = i * BN;
    __syncthreads();
    load_rows<T, D>(sq, qb, a.q_st, qs, BN, seq);
    load_rows<T, D>(sdo, dob, a.do_st, qs, BN, seq);
    for (int x = threadIdx.x; x < BN; x += kThreads) {
      const bool live = qs + x < seq;
      slse[x] = live ? lse[qs + x] : 0.f;
      sdelta[x] = live ? delta[qs + x] : 0.f;
    }
    __syncthreads();
    // P^T [16 keys x BN queries] = exp(K Q^T * scale - lse).
    float p[NTN][4] = {};
    Warp<T>::template nt<NTN, D>(p, sk + warp * 16 * LD, LD, sq, LD, scratch,
                                 lane);
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
    Warp<T>::template pn<NTD, BN>(dv, p, sdo, LD, scratch, lane);
    // dP^T = V dO^T; dS^T = P^T (dP^T - delta).
    float ds[NTN][4] = {};
    Warp<T>::template nt<NTN, D>(ds, sv + warp * 16 * LD, LD, sdo, LD,
                                 scratch, lane);
#pragma unroll
    for (int jj = 0; jj < NTN; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * jj + 2 * t + (c & 1);
        ds[jj][c] = p[jj][c] * (ds[jj][c] - sdelta[col]);
      }
    }
    Warp<T>::template pn<NTD, BN>(dk, ds, sq, LD, scratch, lane);
  }
  const long long out0 = (static_cast<long long>(b) * seq * a.heads + h) * D;
  const float scale[2] = {a.scale, a.scale};
  const float one[2] = {1.f, 1.f};
  store_rows<T, NTD>(static_cast<T*>(a.dk) + out0, dk, k0 + warp * 16, seq,
                     a.heads, scale, lane);
  store_rows<T, NTD>(static_cast<T*>(a.dv) + out0, dv, k0 + warp * 16, seq,
                     a.heads, one, lane);
}

// K2, second half: one block per (q-tile, b*h) walks the kv-tiles its rows
// can see and accumulates dQ. Last q-tiles first, as in K1.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int BN = Tile<D>::kN;
  constexpr int LD = D + Smem<T>::kPad;
  constexpr int NTD = D / 8, NTN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + kBM * LD;
  T* sk = sdo + kBM * LD;
  T* sv = sk + BN * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* scratch = reinterpret_cast<float*>(sv + BN * LD) + warp * 16 * (BN + 4);
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int seq = a.seq;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  load_rows<T, D>(sq, qb, a.q_st, q0, kBM, seq);
  load_rows<T, D>(sdo, dob, a.do_st, q0, kBM, seq);

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
  const int n_kv = cdiv(seq, BN);
  const int n_iter = a.causal ? min(n_kv, cdiv(q0 + kBM, BN)) : n_kv;
  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    load_rows<T, D>(sk, kb, a.k_st, k0, BN, seq);
    load_rows<T, D>(sv, vb, a.v_st, k0, BN, seq);
    __syncthreads();
    float p[NTN][4] = {};
    Warp<T>::template nt<NTN, D>(p, sq + warp * 16 * LD, LD, sk, LD, scratch,
                                 lane);
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
    Warp<T>::template nt<NTN, D>(ds, sdo + warp * 16 * LD, LD, sv, LD,
                                 scratch, lane);
#pragma unroll
    for (int jj = 0; jj < NTN; ++jj) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ds[jj][c] = p[jj][c] * (ds[jj][c] - delta[c >> 1]);
    }
    Warp<T>::template pn<NTD, BN>(dq, ds, sk, LD, scratch, lane);
  }
  const float scale[2] = {a.scale, a.scale};
  T* out = static_cast<T*>(a.dq) +
           (static_cast<long long>(b) * seq * a.heads + h) * D;
  store_rows<T, NTD>(out, dq, q0 + warp * 16, seq, a.heads, scale, lane);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t forward(const Args& a, int bh, cudaStream_t stream) {
  return launch(flash_fwd_kernel<T, D>, fwd_smem<T, D>(),
                dim3(cdiv(a.seq, kBM), bh), a, stream);
}

template <typename T, int D>
cudaError_t backward(const Args& a, int bh, cudaStream_t stream) {
  const dim3 grid(cdiv(a.seq, kBM), bh);
  cudaError_t err = launch(flash_bwd_dkdv_kernel<T, D>, dkdv_smem<T, D>(),
                           grid, a, stream);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq_kernel<T, D>, dq_smem<T, D>(), grid, a, stream);
}

template <bool kForward>
cudaError_t dispatch(int dtype, int depth, const Args& a, int bh,
                     cudaStream_t stream) {
#define BS_CASE(TYPE, DEPTH)                                       \
  return kForward ? forward<TYPE, DEPTH>(a, bh, stream)            \
                  : backward<TYPE, DEPTH>(a, bh, stream)
  if (dtype == kF32 && depth == 64) BS_CASE(float, 64);
  if (dtype == kF32 && depth == 128) BS_CASE(float, 128);
  if (dtype == kBF16 && depth == 64) BS_CASE(__nv_bfloat16, 64);
  if (dtype == kBF16 && depth == 128) BS_CASE(__nv_bfloat16, 128);
#undef BS_CASE
  return cudaErrorInvalidValue;
}

Args make_args(const long long* strides, int n_strides, int heads, int seq,
               int causal, float scale) {
  Args a{};
  long long* dst[12] = {&a.q_sb, &a.q_st, &a.q_sh, &a.k_sb, &a.k_st, &a.k_sh,
                        &a.v_sb, &a.v_st, &a.v_sh, &a.do_sb, &a.do_st,
                        &a.do_sh};
  for (int i = 0; i < n_strides; ++i) *dst[i] = strides[i];
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
  Args a = make_args(strides, 9, heads, seq, causal, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = lse;
  return dispatch<true>(dtype, depth, a, batch * heads,
                        static_cast<cudaStream_t>(stream));
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
  Args a = make_args(strides, 12, heads, seq, causal, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  return dispatch<false>(dtype, depth, a, batch * heads,
                         static_cast<cudaStream_t>(stream));
}

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
