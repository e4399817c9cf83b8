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
// 0.38 ms at the 989 TFLOP/s bf16 peak).
//
// Design. Two kernels a call, on the caller's stream:
//   rms_stats_kernel: r = rsqrt(mean(x^2) + eps) per row in fp32, one
//     warp a row, into the caller's scratch [M] (x read once more, M
//     floats written). Every output tile then reads its rows' r instead of
//     recomputing it.
//   bf16, rmsnorm_matmul_wgmma_kernel: a persistent block per SM walks
//     the 128 x 256 output tiles, n fastest, so the blocks in flight share
//     their x rows in L2 and all of W stays there. Warp-specialised:
//     warpgroup 0 gives up registers (setmaxnreg) and one of its threads
//     keeps a three-stage ring full by TMA, across tiles (per 64-deep
//     k-slice: the x box [128, 64] and four W boxes [64 k, 64 n], all
//     128-byte swizzled, 48 KB, completing on the stage's full mbarrier).
//     Warpgroups 1 and 2 own 64 rows each: per k-slice each thread
//     applies r * scale in fp32 to 32 of its x values and rounds them to
//     bf16 (the reference's rounding point) in place in the stage; then
//     four wgmma m64n256k16 read A (K-major) and W as it lies (MN-major,
//     transposed mode) from the stage. wgmma.wait_group 1 retires the
//     previous slice, whose stage the eight consumer warps release on its
//     empty mbarrier. The 64 x 256 fp32 accumulator per warpgroup (128
//     registers a thread) is rounded to bf16 into the warpgroup's output
//     buffer and stored by TMA while the next tile's products run. TMA
//     zero-fills rows past M, k past K and W columns past N, and clips the
//     stores.
//     What bounds it now: shared memory. A slice moves ~160 KB through
//     it (TMA writes 48, the wgmma operand reads of both warpgroups 80,
//     the normalization 32) for 4.2 MFLOP. Tried and dropped: A from
//     registers (a second register set to overlap the normalization with
//     the products made ptxas serialize the wgmmas at its 168-register
//     budget); an A tile beside the ring (more shared-memory traffic);
//     the normalization in three producer warps (too few threads to keep
//     up); one block per tile (each tile paid its ring fill and its
//     store). A zeroed accumulator also makes ptxas serialize the wgmmas,
//     so the first slice's products overwrite it instead.
//   fp32, rmsnorm_matmul_fma_kernel: the exact-math check's route. TF32
//     wgmma would not hold its 1e-5 tolerance, so it keeps plain FMAs:
//     one block of eight warps per 128 x 128 tile, two stages of 32-deep
//     slices (x normalized through registers into shared memory, W by
//     cp.async), each warp 64 x 32 outputs.
// Nothing is allocated here and nothing synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* x;
  const float* scale;
  const void* w;
  void* out;
  float* rstd;  // [m], written by rms_stats_kernel
  int m, n, k;
  float eps;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// 16-byte vectors of x as floats.
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
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void to_float(const uint4& v,
                                                  float (&f)[4]) {
    memcpy(f, &v, 16);
  }
};

// r = rsqrt(mean(x^2) + eps) of each row, one warp a row.
template <typename T>
__global__ void __launch_bounds__(256) rms_stats_kernel(Args a) {
  using V = Vec<T>;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= a.m) return;
  const T* x = static_cast<const T*>(a.x) + static_cast<long long>(row) * a.k;
  float ss = 0.f;
  for (int c = lane * V::kN; c < a.k; c += 32 * V::kN) {
    float f[V::kN];
    V::to_float(__ldg(reinterpret_cast<const uint4*>(x + c)), f);
#pragma unroll
    for (int i = 0; i < V::kN; ++i) ss = fmaf(f[i], f[i], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0)
    a.rstd[row] = rsqrtf(ss / static_cast<float>(a.k) + a.eps);
}

// ------------------------- bf16: wgmma + TMA --------------------------

namespace k9 {
constexpr int kBM = 128;  // two consumer warpgroups of 64 rows
constexpr int kBN = 256;  // one wgmma's N
constexpr int kBK = 64;   // 64 bf16 = one 128-byte swizzled box row
constexpr int kStages = 3;
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kXTile = kBM * kBK * 2;  // [128 rows][64 k]
constexpr int kWBox = kBK * 64 * 2;    // [64 k][64 n]
constexpr int kWTile = 4 * kWBox;      // [64 k][256 n] as four boxes
constexpr int kStageBytes = kXTile + kWTile;
constexpr int kOutBox = 64 * 64 * 2;   // [64 rows][64 n] of the output
constexpr int kOutTile = 4 * kOutBox;  // a consumer warpgroup's rows
constexpr int kRing = kStages * kStageBytes;
constexpr size_t kSmem = kRing + 2 * kOutTile + 2 * kStages * 8 + 1024;
}  // namespace k9

// bf16(float(x) * r * scale) of eight bf16 values, fp32 in between.
__device__ __forceinline__ uint4 norm8(uint4 x, float r, const float (&s)[8]) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    const __nv_bfloat162 y = __floats2bfloat162_rn(
        __fmul_rn(f.x * r, s[2 * i]), __fmul_rn(f.y * r, s[2 * i + 1]));
    w[i] = *reinterpret_cast<const uint32_t*>(&y);
  }
  return x;
}

// x * r * scale in fp32, rounded to bf16 (the reference's rounding
// point), in place over the 16-byte chunk `chunk` of rows row + 16 q of a
// warpgroup's [64][64] x rows (chunk c of row r holds the eight columns
// from 8 (c ^ (r % 8)), col here); rr holds those rows' r.
__device__ __forceinline__ void normalize(unsigned char* x_rows, const Args& a,
                                          int col, const float (&rr)[4],
                                          int row, int chunk) {
  float sc[8] = {};
  if (col < a.k) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(a.scale + col));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(a.scale + col + 4));
    sc[0] = lo.x, sc[1] = lo.y, sc[2] = lo.z, sc[3] = lo.w;
    sc[4] = hi.x, sc[5] = hi.y, sc[6] = hi.z, sc[7] = hi.w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4* p =
        reinterpret_cast<uint4*>(x_rows + (row + 16 * q) * 128 + 16 * chunk);
    *p = norm8(*p, rr[q], sc);
  }
}

// The output tile (m0, n0) of the persistent schedule's tile index.
struct Tile {
  int m0, n0;
  __device__ __forceinline__ Tile(int tile, int n) {
    const int per_row = cdiv(n, k9::kBN);
    m0 = (tile / per_row) * k9::kBM;
    n0 = (tile % per_row) * k9::kBN;
  }
};

// K9, bf16: a persistent block per SM walks the output tiles (n fastest,
// so the blocks in flight share their x rows in L2). One thread brings
// each 64-deep k-slice by TMA (full barrier); the consumer warpgroups
// normalize their x rows in place, multiply and release it (empty
// barrier). The ring runs on across tiles.
__global__ void __launch_bounds__(k9::kThreads, 1)
    rmsnorm_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                                const __grid_constant__ CUtensorMap w_map,
                                const __grid_constant__ CUtensorMap y_map,
                                const Args a) {
  using namespace k9;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing + 2 * kOutTile);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int n_k = cdiv(a.k, kBK);
  const int n_tiles = cdiv(a.m, kBM) * cdiv(a.n, kBN);
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
      const Tile at(tile, a.n);
      const int boxes = min(4, cdiv(a.n - at.n0, 64));  // W boxes inside N
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* stage = smem + s * kStageBytes;
        hopper::mbar_expect_tx(&full[s], kXTile + boxes * kWBox);
        hopper::tma_load(stage, &x_map, &full[s], kt * kBK, at.m0);
        for (int q = 0; q < boxes; ++q)
          hopper::tma_load(stage + kXTile + q * kWBox, &w_map, &full[s],
                           at.n0 + 64 * q, kt * kBK);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 (wg - 1).. of each tile.
  hopper::set_max_regs_inc<232>();
  const int g = lane >> 2, t = lane & 3, leader = threadIdx.x % 128 == 0;
  // Each thread normalizes chunk norm_chunk of rows norm_row + 16 q.
  const int norm_row = threadIdx.x % 128 / 8, norm_chunk = threadIdx.x % 8;
  unsigned char* out_tile = smem + kRing + (wg - 1) * kOutTile;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const Tile at(tile, a.n);
    // The first slice's products overwrite the accumulator. Zeroing it
    // instead makes ptxas serialize the wgmmas.
    float acc[128];
    float rr[4];  // r of the rows this thread normalizes
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = at.m0 + 64 * (wg - 1) + norm_row + 16 * q;
      rr[q] = row < a.m ? a.rstd[row] : 0.f;
    }
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const uint32_t accumulate = kt > 0;
      const int s = it % kStages;
      hopper::mbar_wait(&full[s], (it / kStages) & 1);
      unsigned char* stage = smem + s * kStageBytes;
      unsigned char* x_rows = stage + 64 * (wg - 1) * 128;
      normalize(x_rows, a, kt * kBK + 8 * (norm_chunk ^ (norm_row % 8)), rr,
                norm_row, norm_chunk);
      hopper::fence_proxy_async();
      hopper::named_barrier(wg, 128);  // the A rows are complete
      // A: this warpgroup's normalized x rows, K-major, 8-row groups 1024
      // bytes apart, k16 steps 32 bytes. W: four [64 k][64 n] boxes 8 KB
      // apart (the leading offset), 8-deep row groups 1024 bytes apart
      // (the stride offset), k16 steps 2 KB.
      const uint64_t ad = hopper::desc(x_rows, 16, 1024);
      const uint64_t wd = hopper::desc(stage + kXTile, kWBox, 1024);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        hopper::wgmma_bf16_m64n256k16(acc, ad + 2 * ks, wd + ks * (2048 >> 4),
                                      accumulate | ks);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kStages]);

    // The output rows through shared memory: the previous tile's stores
    // must have read it; then the fragment (rows g and g + 8 of the
    // warp's 16, columns 8j + 2t and 8j + 2t + 1) goes in as four
    // 128-byte-swizzled [64][64] boxes, which one thread stores by TMA
    // while the next tile's products run. TMA clips rows past M and
    // columns past N.
    if (leader) hopper::tma_store_wait_read();
    hopper::named_barrier(wg, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            out_tile + (j / 8) * kOutBox + row * 128 +
            (((j % 8) ^ g) << 4) + 4 * t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(wg, 128);
    const int row0 = at.m0 + 64 * (wg - 1);
    if (leader && row0 < a.m) {
      for (int q = 0; q < 4 && at.n0 + 64 * q < a.n; ++q)
        hopper::tma_store(&y_map, out_tile + q * kOutBox, at.n0 + 64 * q,
                          row0);
      hopper::tma_store_commit();
    }
  }
  if (leader) hopper::tma_store_wait_read();
}

// ------------------------- fp32: plain FMAs ---------------------------

namespace k9f {
constexpr int kThreads = 256;  // eight warps
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLDX = kBK + 4;
constexpr int kLDW = kBN + 4;
constexpr int kStage = kBM * kLDX + kBK * kLDW;
constexpr size_t kSmem = (kBM + 2 * kStage) * sizeof(float);
}  // namespace k9f

// The warp's 64 x 32 outputs (rows wm.., columns wn..) += x_s . w_s over
// one slice, in the accumulator layout of mma.sync m16n8.
__device__ __forceinline__ void fma_product(float (&acc)[4][4][4],
                                            const float* x_s, const float* w_s,
                                            int wm, int wn, int lane) {
  using namespace k9f;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    float b[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j][0] = w_s[k * kLDW + wn + 8 * j + 2 * t];
      b[j][1] = w_s[k * kLDW + wn + 8 * j + 2 * t + 1];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a0 = x_s[(wm + 16 * i + g) * kLDX + k];
      const float a1 = x_s[(wm + 16 * i + g + 8) * kLDX + k];
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

// The x slice [kBM, kBK] at k0, four floats a vector, in registers
// (rows past M read as zeros).
struct XSlice {
  static constexpr int kChunks = k9f::kBK / 4;
  static constexpr int kPer = k9f::kBM * kChunks / k9f::kThreads;
  float4 v[kPer];

  __device__ __forceinline__ void load(const float* x, int m0, int k0,
                                       const Args& a) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * k9f::kThreads;
      const int r = i / kChunks, c = (i % kChunks) * 4;
      v[j] = m0 + r < a.m
                 ? __ldg(reinterpret_cast<const float4*>(
                       x + static_cast<long long>(m0 + r) * a.k + k0 + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // x * r * scale into the stage's x tile.
  __device__ __forceinline__ void store(float* x_s, const float* r_s, int k0,
                                        const Args& a) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * k9f::kThreads;
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const float4 sc =
          __ldg(reinterpret_cast<const float4*>(a.scale + k0 + c));
      *reinterpret_cast<float4*>(x_s + r * k9f::kLDX + c) =
          make_float4(v[j].x * r_s[r] * sc.x, v[j].y * r_s[r] * sc.y,
                      v[j].z * r_s[r] * sc.z, v[j].w * r_s[r] * sc.w);
    }
  }
};

// The W slice [kBK, kBN] at k0 into the stage's W tile by cp.async;
// columns past N become zeros.
__device__ __forceinline__ void copy_w(float* w_s, const float* w, int n0,
                                       int k0, const Args& a) {
  using namespace k9f;
  constexpr int kChunks = kBN / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float* to = w_s + r * kLDW + c;
    if (n0 + c < a.n) {
      const uint32_t s = hopper::smem_addr(to);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(w + static_cast<long long>(k0 + r) * a.n + n0 + c));
    } else {
      *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// K9, fp32: one block per (n-tile, m-tile); slice i is normalized into
// stage i % 2 while slice i + 1 is on its way.
__global__ void __launch_bounds__(k9f::kThreads)
    rmsnorm_matmul_fma_kernel(const Args a) {
  using namespace k9f;
  extern __shared__ __align__(16) unsigned char smem[];
  float* r_s = reinterpret_cast<float*>(smem);
  float* stages = r_s + kBM;  // [2][x tile | W tile]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  if (threadIdx.x < kBM)
    r_s[threadIdx.x] = m0 + threadIdx.x < a.m ? a.rstd[m0 + threadIdx.x] : 0.f;
  XSlice next;
  next.load(x, m0, 0, a);
  copy_w(stages + kBM * kLDX, w, n0, 0, a);
  __syncthreads();  // r_s is complete

  const int wm = 64 * (warp & 1), wn = 32 * (warp >> 1);
  float acc[4][4][4] = {};
  int stage = 0;
  for (int k0 = 0; k0 < a.k; k0 += kBK) {
    float* x_s = stages + stage * kStage;
    float* w_s = x_s + kBM * kLDX;
    next.store(x_s, r_s, k0, a);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // this stage is complete; the other one is free
    if (k0 + kBK < a.k) {
      next.load(x, m0, k0 + kBK, a);
      copy_w(stages + (stage ^ 1) * kStage + kBM * kLDX, w, n0, k0 + kBK, a);
    }
    fma_product(acc, x_s, w_s, wm, wn, lane);
    stage ^= 1;
  }

  const int g = lane >> 2, t = lane & 3;
  float* out = static_cast<float*>(a.out);
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
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * a.n +
                                     col) =
              make_float2(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
      }
    }
  }
}

// ------------------------------- host ---------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t run_bf16(const Args& a, cudaStream_t stream) {
  using namespace k9;
  CUtensorMap x_map, w_map, y_map;
  cudaError_t err = hopper::tensor_map(
      &x_map, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.m, a.k, kBM, kBK);
  if (err != cudaSuccess) return err;
  err = hopper::tensor_map(&w_map, a.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                           a.k, a.n, kBK, 64);
  if (err != cudaSuccess) return err;
  err = hopper::tensor_map(&y_map, a.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                           a.m, a.n, 64, 64);
  if (err != cudaSuccess) return err;
  err = allow_smem(rmsnorm_matmul_wgmma_kernel, kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(a.m, kBM) * cdiv(a.n, kBN);
  rmsnorm_matmul_wgmma_kernel<<<min(tiles, sms), kThreads, kSmem, stream>>>(
      x_map, w_map, y_map, a);
  return cudaGetLastError();
}

cudaError_t run_fp32(const Args& a, cudaStream_t stream) {
  using namespace k9f;
  const cudaError_t err = allow_smem(rmsnorm_matmul_fma_kernel, kSmem);
  if (err != cudaSuccess) return err;
  rmsnorm_matmul_fma_kernel<<<dim3(cdiv(a.n, kBN), cdiv(a.m, kBM)), kThreads,
                              kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K9. x [m, k] and w [k, n] of one type (dtype 0 fp32, 1 bf16), scale fp32
// [k] -> out [m, n] in that type; rstd is fp32 scratch [m]. k % 32 == 0,
// n % 8 == 0.
int bs_rmsnorm_matmul(int device, const void* x, const float* scale,
                      const void* w, void* out, float* rstd, int m, int n,
                      int k, int dtype, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k % 32 != 0 || n % 8 != 0 || (dtype != kBF16 && dtype != kF32))
    return cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return cudaSuccess;
  Args a{};
  a.x = x;
  a.scale = scale;
  a.w = w;
  a.out = out;
  a.rstd = rstd;
  a.m = m;
  a.n = n;
  a.k = k;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    rms_stats_kernel<__nv_bfloat16><<<cdiv(m, 8), 256, 0, s>>>(a);
  else
    rms_stats_kernel<float><<<cdiv(m, 8), 256, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dtype == kBF16 ? run_bf16(a, s) : run_fp32(a, s);
}

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
