// Fused RMSNorm + matmul for Hopper (sm_90a): y = (rmsnorm(x) * scale) @ W
// with the normalized rows never stored.
//
// Replaces the Pallas TPU kernel K9 of batch_shipyard_tpu:
//   ops/fused_norm.py:_fused_kernel
// x is [M, K] and W [K, N] (row-major, the reference's [in, out] layout),
// both bf16 (training) or both fp32 (the exact-math check); scale is fp32
// [K]; y is [M, N] in x's type. Statistics and accumulation are fp32; the
// normalized rows are cast to W's type before the product, as in the
// reference kernel. K is a multiple of 32 and N of 8; rows contiguous.
//
// What bounds it. At the training shapes (M 32768, K 1024, N 3072 for
// the qkv projection and 5632 for gate/up) a call is 0.21 or 0.38 TFLOP
// against 0.27 or 0.44 GB moved: bound by tensor-core operations (0.21 /
// 0.38 ms at the 989 TFLOP/s bf16 peak). So the product runs on mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), and the norm is recomputed per
// output tile: each block reads its 128 rows of x twice (statistics, then
// the K loop), which costs L2 traffic, not device-memory bytes.
//
// Design. One block of eight warps per (128 x 128) output tile, tiles
// walked n fastest so that consecutive blocks share their rows of x. A
// first pass computes r = rsqrt(mean(x^2) + eps) per row in fp32 (one
// warp per 16 rows, four rows' loads in flight at once). The K loop (32
// deep, two stages) then applies x * r * scale in fp32 to the x slice
// held in registers, casts it to W's type into shared memory, and runs
// the warp products (64 x 32 per warp) while the next x slice comes into
// registers and the next W slice [32, 128] comes by cp.async, as it
// lies. Fragments come by ldmatrix, B's transposed (.trans), since W's
// rows run along k. The fp32 instantiation runs the same tiles through
// plain FMAs in the accumulator layout of mma.sync.
// Rows past M and columns past N are masked. Launches on the caller's stream,
// allocates nothing and does not synchronise; TMA and wgmma are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* x;
  const float* scale;
  const void* w;
  void* out;
  int m, n, k;
  float eps;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Two stages of x and W tiles (double buffering).
template <typename T>
struct Layout {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int kLDX = kBK + kPad;
  static constexpr int kLDW = kBN + kPad;
  static constexpr int kStage = kBM * kLDX + kBK * kLDW;
  static constexpr size_t kSmem = kBM * sizeof(float) + 2 * kStage * sizeof(T);
};

// Four 8 x 8 bf16 matrices from shared memory, one register each; lane l
// gives the address of row l % 8 of matrix l / 8. With kTrans each
// matrix arrives transposed (the B operand from W's [k][n] rows).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Element type helpers: 16-byte vectors of x and W, and the cast of the
// normalized values to W's type.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void to_float(const uint4& v,
                                                  float (&f)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(p[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ uint4 from_float(const float (&f)[8]) {
    uint4 v;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void to_float(const uint4& v,
                                                  float (&f)[4]) {
    memcpy(f, &v, 16);
  }
  static __device__ __forceinline__ uint4 from_float(const float (&f)[4]) {
    uint4 v;
    memcpy(&v, f, 16);
    return v;
  }
};

// Warp products over one kBK slice: acc[4][4][4] (four m16 by four n8
// tiles, rows wm.., columns wn..) += A[64 x kBK] . B[kBK x 32], A = x_s
// row-major [m][k], B = w_s row-major [k][n].
template <typename T>
struct Warp;

template <>
struct Warp<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ void product(float (&acc)[4][4][4],
                                                 const T* x_s, const T* w_s,
                                                 int wm, int wn, int lane) {
    constexpr int ldx = Layout<T>::kLDX, ldw = Layout<T>::kLDW;
    // Matrix l / 8 of an x4 load: its row and column offsets (8 each).
    const int mat = lane >> 3, r8 = lane & 7;
    const int off_lo = 8 * (mat & 1), off_hi = 8 * (mat >> 1);
#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 16) {
      // B for n-tiles j, j + 1: (k0, j), (k0 + 8, j), (k0, j + 1),
      // (k0 + 8, j + 1), each transposed into the mma's col layout.
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldmatrix_x4<true>(r, w_s + (k0 + off_lo + r8) * ldw + wn + 8 * j +
                                 off_hi);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
      // A for m-tile i: rows 0-7 / 8-15 by depths 0-7 / 8-15.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t af[4];
        ldmatrix_x4<false>(af, x_s + (wm + 16 * i + off_lo + r8) * ldx + k0 +
                                   off_hi);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, bf[j]);
      }
    }
  }
};

template <>
struct Warp<float> {
  using T = float;
  static __device__ __forceinline__ void product(float (&acc)[4][4][4],
                                                 const T* x_s, const T* w_s,
                                                 int wm, int wn, int lane) {
    constexpr int ldx = Layout<T>::kLDX, ldw = Layout<T>::kLDW;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = w_s[k * ldw + wn + 8 * j + 2 * t];
        b[j][1] = w_s[k * ldw + wn + 8 * j + 2 * t + 1];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a0 = x_s[(wm + 16 * i + g) * ldx + k];
        const float a1 = x_s[(wm + 16 * i + g + 8) * ldx + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j][0] = fmaf(a0, b[j][0], acc[i][j][0]);
          acc[i][j][1] = fmaf(a0, b[j][1], acc[i][j][1]);
          acc[i][j][2] = fmaf(a1, b[j][0], acc[i][j][2]);
          acc[i][j][3] = fmaf(a1, b[j][1], acc[i][j][3]);
        }
      }
    }
  }
};

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The x slice [kBM, kBK] at k0: each thread's kXPer 16-byte vectors, read
// into registers (rows past M read as zeros).
template <typename T>
struct XSlice {
  using V = Vec<T>;
  static constexpr int kChunks = kBK / V::kN;
  static constexpr int kPer = kBM * kChunks / kThreads;
  uint4 v[kPer];

  __device__ __forceinline__ void load(const T* x, int m0, int k0,
                                       const Args& a) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kChunks, c = (i % kChunks) * V::kN;
      v[j] = m0 + r < a.m
                 ? __ldg(reinterpret_cast<const uint4*>(
                       x + static_cast<long long>(m0 + r) * a.k + k0 + c))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // x * r * scale in fp32, cast to T, into the stage's x tile.
  __device__ __forceinline__ void store(T* x_s, const float* r_s, int k0,
                                        const Args& a) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kChunks, c = (i % kChunks) * V::kN;
      float f[V::kN], sc[V::kN];
      V::to_float(v[j], f);
#pragma unroll
      for (int q = 0; q < V::kN; q += 4)
        *reinterpret_cast<float4*>(sc + q) =
            __ldg(reinterpret_cast<const float4*>(a.scale + k0 + c + q));
#pragma unroll
      for (int q = 0; q < V::kN; ++q) f[q] = f[q] * r_s[r] * sc[q];
      *reinterpret_cast<uint4*>(x_s + r * Layout<T>::kLDX + c) =
          V::from_float(f);
    }
  }
};

// The W slice [kBK, kBN] at k0 into the stage's W tile as cp.async copies;
// columns past N become zeros.
template <typename T>
__device__ __forceinline__ void copy_w(T* w_s, const T* w, int n0, int k0,
                                       const Args& a) {
  constexpr int kChunks = kBN / Vec<T>::kN;
#pragma unroll
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * Vec<T>::kN;
    T* to = w_s + r * Layout<T>::kLDW + c;
    if (n0 + c < a.n) {
      const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(to));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(w + static_cast<long long>(k0 + r) * a.n + n0 + c));
    } else {
      *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// K9: one block per (n-tile, m-tile).
template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_matmul_kernel(Args a) {
  using V = Vec<T>;
  constexpr int kStage = Layout<T>::kStage;
  extern __shared__ __align__(16) unsigned char smem[];
  float* r_s = reinterpret_cast<float*>(smem);
  T* stages = reinterpret_cast<T*>(r_s + kBM);  // [2][x tile | W tile]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);

  // The first slices start on their way, then the row statistics over
  // the full K in fp32, the loads of all of a warp's 16 rows in flight
  // together; rows past M get 0.
  XSlice<T> next;
  next.load(x, m0, 0, a);
  copy_w(stages + kBM * Layout<T>::kLDX, w, n0, 0, a);
  constexpr int kRows = kBM / 8, kGroup = kRows;
  for (int rr = 0; rr < kRows; rr += kGroup) {
    float ss[kGroup] = {};
    for (int c = lane * V::kN; c < a.k; c += 32 * V::kN) {
      uint4 raw[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const int row = m0 + warp * kRows + rr + q;
        raw[q] = row < a.m
                     ? __ldg(reinterpret_cast<const uint4*>(
                           x + static_cast<long long>(row) * a.k + c))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        float f[V::kN];
        V::to_float(raw[q], f);
#pragma unroll
        for (int i = 0; i < V::kN; ++i) ss[q] = fmaf(f[i], f[i], ss[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ss[q] += __shfl_xor_sync(0xffffffffu, ss[q], o);
      const int rl = warp * kRows + rr + q;
      if (lane == 0)
        r_s[rl] = m0 + rl < a.m
                      ? rsqrtf(ss[q] / static_cast<float>(a.k) + a.eps)
                      : 0.f;
    }
  }
  __syncthreads();  // r_s is complete

  // Two stages: slice i is normalized into stage i % 2 while slice i + 1
  // is on its way (x into registers, W by cp.async into the other stage).
  const int wm = 64 * (warp & 1), wn = 32 * (warp >> 1);
  float acc[4][4][4] = {};
  int stage = 0;
  for (int k0 = 0; k0 < a.k; k0 += kBK) {
    T* x_s = stages + stage * kStage;
    T* w_s = x_s + kBM * Layout<T>::kLDX;
    next.store(x_s, r_s, k0, a);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // this stage is complete; the other one is free
    if (k0 + kBK < a.k) {
      next.load(x, m0, k0 + kBK, a);
      copy_w(stages + (stage ^ 1) * kStage + kBM * Layout<T>::kLDX, w, n0,
             k0 + kBK, a);
    }
    Warp<T>::product(acc, x_s, w_s, wm, wn, lane);
    stage ^= 1;
  }

  const int g = lane >> 2, t = lane & 3;
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm + 16 * i + g + 8 * r;
      if (row >= a.m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;
        if (col < a.n)
          store2(out + static_cast<long long>(row) * a.n + col,
                 acc[i][j][2 * r], acc[i][j][2 * r + 1]);
      }
    }
  }
}

template <typename T>
cudaError_t run(const Args& a, cudaStream_t stream) {
  auto kernel = rmsnorm_matmul_kernel<T>;
  const size_t smem = Layout<T>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(cdiv(a.n, kBN), cdiv(a.m, kBM)), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K9. x [m, k] and w [k, n] of one type (dtype 0 fp32, 1 bf16), scale fp32
// [k] -> out [m, n] in that type. k % 32 == 0, n % 8 == 0.
int bs_rmsnorm_matmul(int device, const void* x, const float* scale,
                      const void* w, void* out, int m, int n, int k,
                      int dtype, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k % kBK != 0 || n % 8 != 0) return cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return cudaSuccess;
  Args a{};
  a.x = x;
  a.scale = scale;
  a.w = w;
  a.out = out;
  a.m = m;
  a.n = n;
  a.k = k;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return run<__nv_bfloat16>(a, s);
  if (dtype == kF32) return run<float>(a, s);
  return cudaErrorInvalidValue;
}

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
