// Int8 quantization for Hopper (sm_90a): per-row absmax quantization with
// stochastic rounding (K10) and the int8 tensor-core matmul (K11), the two
// kernels of the int8 training lever (QuantDense -> quantized_linear).
//
// Replaces the Pallas TPU kernels of batch_shipyard_tpu:
//   K10 ops/quantization.py:_quantize_kernel
//   K11 ops/quantization.py:_int8_matmul_kernel
//
// K10. x [M, K] (bf16 or fp32) and caller-supplied int32 bits [M, K] ->
// int8 values [M, K] and fp32 scales [M]: scale = max(absmax, 1e-8) * (1 /
// 127) (the fp32 reciprocal multiply XLA makes of the reference's / 127),
// v = clip(floor(x / scale + u), -127, 127), u = (bits & 0xFFFFFF) * 2^-24.
// The division is IEEE (nvcc's default -prec-div=true; no fast math) and
// every step is an explicitly rounded intrinsic, so the kernel equals its
// plain PyTorch version bit for bit. What bounds it: bytes. Per element it
// reads 2 (bf16) or 4 bytes of x and 4 of bits and writes 1, for a handful
// of fp32 operations. Design: one block of 128 threads per row; the row is
// read once into registers as 16-byte vectors (up to 8 a thread, so K <=
// 8192 in bf16 and 4096 in fp32), its absmax reduced by warp shuffles and
// shared memory, then each thread reads its bits, rounds and stores its
// int8 values as one vector. K % 16 == 0 keeps every row 16-byte aligned.
//
// K11. x_q [M, K] int8 and w_q [N, K] int8 (the weight's own [out, in]
// rows, which is mma's .col B operand as it lies), fp32 x_scales [M] and
// w_scales [N] -> out [M, N] fp32 = (float(acc) * x_scale[row]) *
// w_scale[col], acc the exact int32 sum, in the reference's order. What
// bounds it: at the training shapes the fp32 output's bytes (M 32768, K
// 1024: 0.05 ms for N 1024) or the int8 operations (K 2816: 0.096 ms at
// 1979 TOP/s). Design: one block of eight warps per 128 x 128 output tile;
// K in 64-byte slices through a three-stage cp.async ring (zero-filled
// past M, N and K); fragments by ldmatrix (an int8 pair is one b16) into
// mma.sync m16n8k32 s8 with int32 accumulators, 64 x 32 per warp. K % 16
// == 0. Any M and N. wgmma and TMA are later work.
//
// Both launch on the caller's stream, allocate nothing and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

enum DType : int { kF32 = 0, kBF16 = 1 };

}  // namespace

namespace quant {

constexpr int kThreads = 128;
constexpr int kMaxVec = 8;  // 16-byte vectors of x a thread holds

struct Args {
  const void* x;
  const int32_t* bits;
  int8_t* values;
  float* scales;
  int m, k;
};

// 16-byte vectors of x as fp32, and kN int8 values packed for one store.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Packed = uint2;
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
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Packed = uint32_t;
  static __device__ __forceinline__ void to_float(const uint4& v,
                                                  float (&f)[4]) {
    memcpy(f, &v, 16);
  }
};

// K10: one block per row.
template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_int8_kernel(Args a) {
  using V = Vec<T>;
  __shared__ float warp_max[kThreads / 32];
  const int row = blockIdx.x;
  const int n_vec = a.k / V::kN;
  const long long base = static_cast<long long>(row) * a.k;
  const uint4* x = reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) +
                                                  base);

  uint4 raw[kMaxVec];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int v = threadIdx.x + j * kThreads;
    if (v < n_vec) {
      raw[j] = __ldg(x + v);
      float f[V::kN];
      V::to_float(raw[j], f);
#pragma unroll
      for (int q = 0; q < V::kN; ++q) amax = fmaxf(amax, fabsf(f[q]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  if (threadIdx.x == 0) a.scales[row] = scale;

#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) {
    const int v = threadIdx.x + j * kThreads;
    if (v < n_vec) {
      float f[V::kN];
      V::to_float(raw[j], f);
      int4 bv[V::kN / 4];
#pragma unroll
      for (int q = 0; q < V::kN / 4; ++q)
        bv[q] = __ldg(
            reinterpret_cast<const int4*>(a.bits + base + v * V::kN) + q);
      const int32_t* b = reinterpret_cast<const int32_t*>(bv);
      int8_t out[V::kN];
#pragma unroll
      for (int q = 0; q < V::kN; ++q) {
        const float s = __fdiv_rn(f[q], scale);
        const float u = __fmul_rn(__int2float_rn(b[q] & 0xFFFFFF),
                                  1.0f / 16777216.0f);
        const float r = floorf(__fadd_rn(s, u));
        out[q] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
      }
      typename V::Packed packed;
      memcpy(&packed, out, sizeof(packed));
      *reinterpret_cast<typename V::Packed*>(a.values + base + v * V::kN) =
          packed;
    }
  }
}

template <typename T>
cudaError_t run(const Args& a, cudaStream_t stream) {
  if (a.k > kMaxVec * kThreads * Vec<T>::kN) return cudaErrorInvalidValue;
  quantize_int8_kernel<T><<<a.m, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace quant

namespace mm {

constexpr int kThreads = 256;  // eight warps
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;  // bytes (int8 values) of k per slice
constexpr int kStages = 3;
constexpr int kLD = kBK + 16;  // padded row: ldmatrix rows hit distinct banks
constexpr int kTile = kBM * kLD;  // one operand's slice (kBM == kBN)
constexpr int kSmem = kStages * 2 * kTile;

struct Args {
  const int8_t* x;   // [m, k]
  const float* xs;   // [m]
  const int8_t* w;   // [n, k]
  const float* ws;   // [n]
  float* out;        // [m, n]
  int m, n, k;
};

// Four 8 x 8 b16 matrices (8 rows of 16 int8 values) from shared memory;
// lane l gives the address of row l % 8 of matrix l / 8, and receives
// from each matrix row l / 4, bytes 4 (l % 4) .. + 3: mma's s8 fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows row0 .. row0 + 127 of an [rows, k] int8 operand, bytes k0 .. k0 +
// 63, into a stage by cp.async; rows past `rows` and bytes past k become
// zeros (src-size 0 reads nothing).
__device__ __forceinline__ void copy_slice(int8_t* s, const int8_t* g,
                                           int row0, int rows, int k0,
                                           int k) {
  constexpr int kChunks = kBK / 16;
#pragma unroll
  for (int j = 0; j < kBM * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 16;
    const bool ok = row0 + r < rows && k0 + c < k;
    const int8_t* src = ok ? g + static_cast<long long>(row0 + r) * k + k0 + c
                           : g;
    const uint32_t dst =
        static_cast<uint32_t>(__cvta_generic_to_shared(s + r * kLD + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0));
  }
}

// Warp products over one slice: acc[4][4][4] (four m16 by four n8 tiles,
// rows wm.., columns wn..) += x_s[64 rows, kBK] . w_s[32 rows, kBK]^T.
__device__ __forceinline__ void product(int (&acc)[4][4][4], const int8_t* x_s,
                                        const int8_t* w_s, int wm, int wn,
                                        int lane) {
  const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int k0 = 0; k0 < kBK; k0 += 32) {
    // B for n-tiles j, j + 1: (j, k 0-15), (j, k 16-31), (j + 1, ...).
    uint32_t bf[4][2];
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, w_s + (wn + 8 * j + 8 * (mat >> 1) + r8) * kLD + k0 +
                         16 * (mat & 1));
      bf[j][0] = r[0];
      bf[j][1] = r[1];
      bf[j + 1][0] = r[2];
      bf[j + 1][1] = r[3];
    }
    // A for m-tile i: rows 0-7 / 8-15 by k 0-15 / 16-31.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t af[4];
      ldmatrix_x4(af, x_s + (wm + 16 * i + 8 * (mat & 1) + r8) * kLD + k0 +
                          16 * (mat >> 1));
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af, bf[j]);
    }
  }
}

// K11: one block per (n-tile, m-tile).
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(Args a) {
  extern __shared__ __align__(16) int8_t smem[];  // [stage][x slice | w slice]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int n_k = cdiv(a.k, kBK);

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) {
      copy_slice(smem + s * 2 * kTile, a.x, m0, a.m, s * kBK, a.k);
      copy_slice(smem + s * 2 * kTile + kTile, a.w, n0, a.n, s * kBK, a.k);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  const int wm = 64 * (warp & 1), wn = 32 * (warp >> 1);
  int acc[4][4][4] = {};
  for (int kt = 0; kt < n_k; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // slice kt has landed; slice kt - 1's stage is free
    const int next = kt + kStages - 1;
    if (next < n_k) {
      int8_t* s = smem + (next % kStages) * 2 * kTile;
      copy_slice(s, a.x, m0, a.m, next * kBK, a.k);
      copy_slice(s + kTile, a.w, n0, a.n, next * kBK, a.k);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const int8_t* x_s = smem + (kt % kStages) * 2 * kTile;
    product(acc, x_s, x_s + kTile, wm, wn, lane);
  }

  // (float(acc) * x_scale) * w_scale, the reference's order.
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (a.n & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm + 16 * i + g + 8 * r;
      if (row >= a.m) continue;
      const float xs = a.xs[row];
      float* out = a.out + static_cast<long long>(row) * a.n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;
        float y[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          y[c] = col + c < a.n
                     ? __fmul_rn(
                           __fmul_rn(__int2float_rn(acc[i][j][2 * r + c]), xs),
                           a.ws[col + c])
                     : 0.f;
        if (pairs && col + 1 < a.n) {
          *reinterpret_cast<float2*>(out + col) = make_float2(y[0], y[1]);
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (col + c < a.n) out[col + c] = y[c];
        }
      }
    }
  }
}

cudaError_t run(const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int8_matmul_kernel<<<dim3(cdiv(a.n, kBN), cdiv(a.m, kBM)), kThreads, kSmem,
                       stream>>>(a);
  return cudaGetLastError();
}

}  // namespace mm

extern "C" {

// K10. x [m, k] (dtype 0 fp32, 1 bf16), bits int32 [m, k] -> values int8
// [m, k], scales fp32 [m]. k % 16 == 0.
int bs_quantize_int8(int device, const void* x, const int32_t* bits,
                     int8_t* values, float* scales, int m, int k, int dtype,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k <= 0 || k % 16 != 0) return cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  quant::Args a{};
  a.x = x;
  a.bits = bits;
  a.values = values;
  a.scales = scales;
  a.m = m;
  a.k = k;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return quant::run<__nv_bfloat16>(a, s);
  if (dtype == kF32) return quant::run<float>(a, s);
  return cudaErrorInvalidValue;
}

// K11. x [m, k] and w [n, k] int8, xs [m] and ws [n] fp32 -> out [m, n]
// fp32. k % 16 == 0.
int bs_int8_matmul(int device, const int8_t* x, const float* xs,
                   const int8_t* w, const float* ws, float* out, int m, int n,
                   int k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k <= 0 || k % 16 != 0) return cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return cudaSuccess;
  mm::Args a{};
  a.x = x;
  a.xs = xs;
  a.w = w;
  a.ws = ws;
  a.out = out;
  a.m = m;
  a.n = n;
  a.k = k;
  return mm::run(a, static_cast<cudaStream_t>(stream));
}

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
