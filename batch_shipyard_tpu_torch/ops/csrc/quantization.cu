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
// rows), fp32 x_scales [M] and w_scales [N] -> out [M, N] fp32 =
// (float(acc) * x_scale[row]) * w_scale[col], acc the exact int32 sum, in
// the reference's order. What bounds it: at the training shapes the fp32
// output's bytes (M 32768, K 1024, N 1024: 128 of the 161 MB, 0.048 ms) or
// the int8 operations (K 2816: 0.096 ms at 1979 TOP/s). So the epilogue's
// stores are the largest stream, and only wgmma reaches the int8 peak.
// Design (int8_matmul_wgmma_kernel): a persistent block per SM walks the
// 128 x 256 output tiles, n fastest, so the blocks in flight share their
// x rows in L2 and all of w stays there. Warp-specialised: warpgroup 0
// gives up registers (setmaxnreg) and one of its threads keeps a
// three-stage ring full by TMA across tiles (per 128-byte k-slice the x
// box [128 rows][128 k] and the w box [256 rows][128 k], both 128-byte
// swizzled, 48 KB, on the stage's full mbarrier; TMA zero-fills rows past
// M and N and k past K). Warpgroups 1 and 2 own 64 rows each: four
// wgmma m64n256k32 s8 a slice read both operands K-major as they lie
// (8-bit wgmma takes no transposed operand; w's [N, K] rows are B's
// K-major layout), into 128 s32 registers a thread; wgmma.wait_group 1
// retires the previous slice, whose stage the eight consumer warps release
// on its empty mbarrier. The epilogue scales the accumulator in fp32 into
// the warpgroup's 32 KB staging buffer (four 128-byte-swizzled [64][32]
// boxes), half the tile's columns at a time, and one thread stores each
// half by TMA, which clips rows past M and columns past N; it waits for a
// half's stores to have read the buffer only before the buffer is written
// again, so the tile's second half stores under the next tile's loads and
// products. Where TMA cannot address the output (N % 4 != 0: a row is not
// a multiple of 16 bytes) the same kernel stores from registers instead.
// K % 16 == 0, any M and N. Measured on one H100 at the training shapes
// (trace/int8_matmul_sweep.py with edited copies): stores from registers
// instead of TMA were 1.5-2.3x as long, and 128 x 128 tiles (four stages,
// 64 KB of staging) 1.09-1.18x; the products alone, without stores, take
// 1.35-1.8x their operation bound, every tile's operands read from L2.
//
// K10's two halves, for rows whose elements lie on several tp ranks (a
// row-parallel product: x [M, K/tp], w [N, K/tp]; they replace no TPU
// kernel: the reference's K10 sees the global rows under GSPMD, and the
// port makes the max over the ranks itself, with a ring all-gather
// between the halves, ops/quantization.py quantize_split_rows):
//   bs_row_absmax: x [M, K] -> fp32 [M], each row's largest |x|;
//   bs_quantize_scaled: x [M, K], bits int32 [M, K] and fp32 scales [M]
//     -> int8 [M, K], K10's rounding (the same intrinsics, in the same
//     order) against the given scales.
// What bounds them: bytes, like K10 (absmax reads x; the quantize reads x
// and the bits and writes int8), so together they read x twice where K10
// reads it once. Design: K10's, one block of 128 threads per row, 16-byte
// vectors; a thread walks its vectors in a loop rather than holding the
// row in registers, since nothing is reused across the halves, so any
// K % 16 == 0 is taken.
//
// All launch on the caller's stream, allocate nothing and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

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

struct SplitArgs {
  const void* x;
  const int32_t* bits;   // bs_quantize_scaled's inputs
  const float* scales;
  int8_t* values;        // bs_quantize_scaled's output
  float* absmax;         // bs_row_absmax's output
  int k;
};

// bs_row_absmax: one block per row.
template <typename T>
__global__ void __launch_bounds__(kThreads) row_absmax_kernel(SplitArgs a) {
  using V = Vec<T>;
  __shared__ float part_max[kThreads / 32];
  const int row = blockIdx.x;
  const int vectors = a.k / V::kN;
  const uint4* x = reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.x) + static_cast<long long>(row) * a.k);
  float top = 0.f;
  for (int v = threadIdx.x; v < vectors; v += kThreads) {
    float f[V::kN];
    V::to_float(__ldg(x + v), f);
#pragma unroll
    for (int q = 0; q < V::kN; ++q) top = fmaxf(top, fabsf(f[q]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, o));
  if (threadIdx.x % 32 == 0) part_max[threadIdx.x / 32] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
    float row_max = part_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w)
      row_max = fmaxf(row_max, part_max[w]);
    a.absmax[row] = row_max;
  }
}

// bs_quantize_scaled: one block per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_scaled_kernel(SplitArgs a) {
  using V = Vec<T>;
  const int row = blockIdx.x;
  const int vectors = a.k / V::kN;
  const long long at = static_cast<long long>(row) * a.k;
  const uint4* x = reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) +
                                                  at);
  const float row_scale = __ldg(a.scales + row);
  for (int v = threadIdx.x; v < vectors; v += kThreads) {
    float f[V::kN];
    V::to_float(__ldg(x + v), f);
    int4 bv[V::kN / 4];
#pragma unroll
    for (int q = 0; q < V::kN / 4; ++q)
      bv[q] = __ldg(reinterpret_cast<const int4*>(a.bits + at + v * V::kN) + q);
    const int32_t* b = reinterpret_cast<const int32_t*>(bv);
    int8_t out[V::kN];
#pragma unroll
    for (int q = 0; q < V::kN; ++q) {
      const float scaled = __fdiv_rn(f[q], row_scale);
      const float noise = __fmul_rn(__int2float_rn(b[q] & 0xFFFFFF),
                                    1.0f / 16777216.0f);
      const float down = floorf(__fadd_rn(scaled, noise));
      out[q] = static_cast<int8_t>(fminf(fmaxf(down, -127.f), 127.f));
    }
    typename V::Packed packed;
    memcpy(&packed, out, sizeof(packed));
    *reinterpret_cast<typename V::Packed*>(a.values + at + v * V::kN) = packed;
  }
}

template <typename T>
cudaError_t run_split(const SplitArgs& a, int m, bool absmax,
                      cudaStream_t stream) {
  if (absmax)
    row_absmax_kernel<T><<<m, kThreads, 0, stream>>>(a);
  else
    quantize_scaled_kernel<T><<<m, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t split(const SplitArgs& a, int m, int dtype, bool absmax,
                  cudaStream_t stream) {
  if (a.k <= 0 || a.k % 16 != 0) return cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  if (dtype == kBF16) return run_split<__nv_bfloat16>(a, m, absmax, stream);
  if (dtype == kF32) return run_split<float>(a, m, absmax, stream);
  return cudaErrorInvalidValue;
}

}  // namespace quant

namespace mm {

constexpr int kBM = 128;  // two consumer warpgroups of 64 rows
constexpr int kBN = 256;  // one wgmma's N
constexpr int kBK = 128;  // bytes (int8 values) of k a slice: one swizzled row
constexpr int kStages = 3;
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kXTile = kBM * kBK;  // [128 rows][128 k]
constexpr int kWTile = kBN * kBK;  // [256 rows][128 k]
constexpr int kStageBytes = kXTile + kWTile;
constexpr int kOutBox = 64 * 32 * 4;   // [64 rows][32 n] fp32
constexpr int kOutTile = 4 * kOutBox;  // a consumer warpgroup's rows, 128 n
constexpr int kRing = kStages * kStageBytes;
constexpr int kScales = 2 * kBN * 4;   // each consumer's copy of w_scales
constexpr size_t kSmem =
    kRing + 2 * kOutTile + kScales + 2 * kStages * 8 + 1024;

struct Args {
  const float* xs;   // [m]
  const float* ws;   // [n]
  float* out;        // [m, n]
  int m, n, k;
  int direct;        // 1: store from registers (N % 4 != 0)
};

// K11: a persistent block per SM walks the output tiles (n fastest). One
// thread brings each 128-byte k-slice by TMA (full barrier); the consumer
// warpgroups multiply and release it (empty barrier). The ring runs on
// across tiles, and each tile's TMA stores under the next tile's work.
__global__ void __launch_bounds__(kThreads, 1)
    int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                             const __grid_constant__ CUtensorMap w_map,
                             const __grid_constant__ CUtensorMap y_map,
                             const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  float* s_ws = reinterpret_cast<float*>(smem + kRing + 2 * kOutTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_ws + 2 * kBN);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int n_k = cdiv(a.k, kBK);
  const int per_row = cdiv(a.n, kBN);
  const int n_tiles = cdiv(a.m, kBM) * per_row;
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
    if (threadIdx.x != 0) return;
    hopper::prefetch_map(&x_map);
    hopper::prefetch_map(&w_map);
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile / per_row * kBM, n0 = tile % per_row * kBN;
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* stage = smem + s * kStageBytes;
        hopper::mbar_expect_tx(&full[s], kStageBytes);
        hopper::tma_load(stage, &x_map, &full[s], kt * kBK, m0);
        hopper::tma_load(stage + kXTile, &w_map, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 (wg - 1).. of each tile; thread
  // (warp, g, t) holds rows 16 warp + g + 8 h and columns 8 j + 2 t + c
  // of them in acc[4 j + 2 h + c].
  hopper::set_max_regs_inc<232>();
  const int g = lane >> 2, t = lane & 3, leader = threadIdx.x % 128 == 0;
  const int tid = threadIdx.x % 128;
  unsigned char* out_tile = smem + kRing + (wg - 1) * kOutTile;
  float* ws = s_ws + (wg - 1) * kBN;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile / per_row * kBM, n0 = tile % per_row * kBN;
    const int row0 = m0 + 64 * (wg - 1) + 16 * warp + g;
    // The tile's scales, read while the products run (the warpgroup's
    // previous epilogue has read its w_scales copy: its last barrier).
    float xs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      xs[h] = row0 + 8 * h < a.m ? a.xs[row0 + 8 * h] : 0.f;
    for (int c = tid; c < kBN; c += 128)
      ws[c] = n0 + c < a.n ? a.ws[n0 + c] : 0.f;
    // The first slice's products overwrite the accumulator. Zeroing it
    // instead makes ptxas serialize the wgmmas.
    int acc[128];
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const uint32_t accumulate = kt > 0;
      const int s = it % kStages;
      hopper::mbar_wait(&full[s], (it / kStages) & 1);
      unsigned char* stage = smem + s * kStageBytes;
      // A: this warpgroup's 64 x rows, B: the tile's 256 w rows, both
      // K-major, 8-row groups 1024 bytes apart, k32 steps 32 bytes.
      const uint64_t ad = hopper::desc(stage + 64 * (wg - 1) * kBK, 16, 1024);
      const uint64_t bd = hopper::desc(stage + kXTile, 16, 1024);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hopper::wgmma_s8_m64n256k32(acc, ad + 2 * ks, bd + 2 * ks,
                                    accumulate | ks);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kStages]);

    // (float(acc) * x_scale) * w_scale, the reference's order, in two
    // halves of 128 columns. Each half waits for the stores that last read
    // the staging buffer, goes in as four 128-byte-swizzled [64][32]
    // boxes (16-byte chunk q of row r at chunk q ^ (r % 8)), and one
    // thread stores it by TMA.
    const int rows0 = m0 + 64 * (wg - 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (leader && !a.direct) hopper::tma_store_wait_read();
      hopper::named_barrier(wg, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * warp + g + 8 * h;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int j = 16 * half + jj, col = 8 * j + 2 * t;
          const float y0 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), xs[h]), ws[col]);
          const float y1 = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), xs[h]),
              ws[col + 1]);
          if (a.direct) {
            float* out = a.out + static_cast<long long>(rows0 + row) * a.n;
            if (rows0 + row < a.m && n0 + col < a.n) out[n0 + col] = y0;
            if (rows0 + row < a.m && n0 + col + 1 < a.n)
              out[n0 + col + 1] = y1;
          } else {
            *reinterpret_cast<float2*>(
                out_tile + (jj / 4) * kOutBox + row * 128 +
                (((2 * (jj % 4) + (t >> 1)) ^ g) << 4) + 8 * (t & 1)) =
                make_float2(y0, y1);
          }
        }
      }
      hopper::fence_proxy_async();
      hopper::named_barrier(wg, 128);
      if (leader && !a.direct && rows0 < a.m) {
        for (int q = 0; q < 4 && n0 + 128 * half + 32 * q < a.n; ++q)
          hopper::tma_store(&y_map, out_tile + q * kOutBox,
                            n0 + 128 * half + 32 * q, rows0);
        hopper::tma_store_commit();
      }
    }
  }
  if (leader) hopper::tma_store_wait_read();
}

cudaError_t run(const int8_t* x, const int8_t* w, const Args& a,
                cudaStream_t stream) {
  CUtensorMap x_map, w_map, y_map = {};
  cudaError_t err = hopper::tensor_map(&x_map, x, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                       1, a.m, a.k, kBM, kBK);
  if (err != cudaSuccess) return err;
  err = hopper::tensor_map(&w_map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.n,
                           a.k, kBN, kBK);
  if (err != cudaSuccess) return err;
  if (!a.direct) {
    err = hopper::tensor_map(&y_map, a.out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                             4, a.m, a.n, 64, 32);
    if (err != cudaSuccess) return err;
  }
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(int8_matmul_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
  }
  const int tiles = cdiv(a.m, kBM) * cdiv(a.n, kBN);
  int8_matmul_wgmma_kernel<<<tiles < sms ? tiles : sms, kThreads, kSmem,
                             stream>>>(x_map, w_map, y_map, a);
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

// x [m, k] (dtype 0 fp32, 1 bf16) -> out fp32 [m], each row's largest |x|.
// k % 16 == 0.
int bs_row_absmax(int device, const void* x, float* out, int m, int k,
                  int dtype, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  quant::SplitArgs a{};
  a.x = x;
  a.absmax = out;
  a.k = k;
  return quant::split(a, m, dtype, true, static_cast<cudaStream_t>(stream));
}

// x [m, k] (dtype 0 fp32, 1 bf16), bits int32 [m, k], scales fp32 [m] ->
// values int8 [m, k], K10's rounding against the given scales. k % 16 == 0.
int bs_quantize_scaled(int device, const void* x, const int32_t* bits,
                       const float* scales, int8_t* values, int m, int k,
                       int dtype, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  quant::SplitArgs a{};
  a.x = x;
  a.bits = bits;
  a.scales = scales;
  a.values = values;
  a.k = k;
  return quant::split(a, m, dtype, false, static_cast<cudaStream_t>(stream));
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
  a.xs = xs;
  a.ws = ws;
  a.out = out;
  a.m = m;
  a.n = n;
  a.k = k;
  a.direct = n % 4 != 0;
  return mm::run(x, w, a, static_cast<cudaStream_t>(stream));
}

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
