// Single-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of batch_shipyard_tpu:
//   K6 ops/paged_attention.py:_paged_decode_kernel       (paged, fp32/bf16)
//   K7 ops/paged_attention.py:_paged_decode_kernel_int8  (paged, int8 + scales)
//   K8 ops/decode_attention.py:_dense_decode_kernel_int8 (dense, int8 + scales)
// One templated kernel serves all three: templated on the query/output
// type, the cache storage type (float, __nv_bfloat16, int8_t with fp32
// per-(position, head) scales) and the addressing (paged through a block
// table, or dense [B, L, H, D]).
//
// What bounds it: device-memory bytes. One query row meets every live
// cached row once, so the work is ~4*D flops per 2*D*elt bytes read.
// HBM bytes = sum_b len_b*H*D*2*elt (+ sum_b len_b*H*2*4 for the int8
// scales). With 8 slots at length 512, H=16, D=64 that is 16.8 MB (bf16)
// or 8.9 MB (int8) per layer-step: about 5.0 us and 2.7 us at 3.35 TB/s.
// The serving step launches it once per layer.
//
// Design. The TPU kernel walks a sequential grid axis over pages with
// the online-softmax state in VMEM scratch. Here that axis becomes a loop
// inside one thread block per (slot, head): the block reads only the
// slot's live rows (ceil(len/page) table entries, loaded by the block
// itself, so stale ids in the dead tail of a table row are never read).
// A row of D values is split across D/8 lanes (8 values each, a 16-byte
// load for bf16); the block's lanes form groups that take rows
// round-robin, two rows per group in flight, and q.k is a shuffle
// reduction inside the group. Each group keeps its own running max,
// denominator and fp32 output slice; the groups merge through shared
// memory at the end. Numerics follow the TPU kernel: fp32 scores and
// sums; for bf16 pages p is rounded to bf16 before P.V; for int8 pages
// q, K and V are dequantized to fp32 and the recurrence stays fp32.
// Masked scores are never formed: only rows t < length are visited, and
// a length-0 slot writes zeros. The kernel launches on the caller's
// stream, allocates nothing and does not synchronise; wgmma, TMA and
// split-K over the sequence are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads per (slot, head) block
constexpr int kVec = 8;        // row elements per lane
constexpr int kUnroll = 2;     // rows per group in flight
constexpr float kNegInf = -1e30f;

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T>
struct Load;

template <>
struct Load<float> {
  static __device__ __forceinline__ void row(const float* p, float* out) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

template <>
struct Load<__nv_bfloat16> {
  static __device__ __forceinline__ void row(const __nv_bfloat16* p,
                                             float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 pair;
      memcpy(&pair, &words[i], sizeof(pair));
      const float2 f = __bfloat1622float2(pair);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Load<int8_t> {
  static __device__ __forceinline__ void row(const int8_t* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const uint32_t words[2] = {raw.x, raw.y};
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const uint32_t byte = (words[i / 4] >> (8 * (i % 4))) & 0xffu;
      out[i] = static_cast<float>(static_cast<int8_t>(byte));
    }
  }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// q [B, 1, H, D]; out [B, 1, H, D]; lengths [B].
// Paged: k/v [P, page, H, D], scales [P, page, H], table [B, max_blocks].
// Dense: k/v [B, rows, H, D], scales [B, rows, H]; table unused.
template <typename TQ, typename TKV, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ lengths, TQ* __restrict__ out, int heads,
    int page, int max_blocks, int rows, float scale) {
  constexpr int kLanes = D / kVec;            // lanes per cached row
  constexpr int kGroups = kThreads / kLanes;  // rows in flight per pass
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  constexpr bool kRoundP = std::is_same<TKV, __nv_bfloat16>::value;
  static_assert(D % kVec == 0 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
                "D must be 8 times a power of two, at most 256");
  __shared__ float s_m[kGroups];
  __shared__ float s_l[kGroups];
  __shared__ float s_acc[kGroups * D];

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int tid = threadIdx.x;
  const int group = tid / kLanes;
  const int lane = tid % kLanes;
  const int cap = kPaged ? max_blocks * page : rows;
  const int n = min(max(lengths[b], 0), cap);
  TQ* o = out + (static_cast<size_t>(b) * heads + h) * D;
  if (n == 0) {
    for (int d = tid; d < D; d += kThreads) store(o + d, 0.f);
    return;
  }

  float qf[kVec];
  Load<TQ>::row(q + (static_cast<size_t>(b) * heads + h) * D + lane * kVec,
                qf);

  // Index of (token t, head h) in the [rows, H] row space of k/v.
  auto row_of = [&](int t) -> size_t {
    if (kPaged) {
      const int pid = table[static_cast<size_t>(b) * max_blocks + t / page];
      return (static_cast<size_t>(pid) * page + t % page) * heads + h;
    }
    return (static_cast<size_t>(b) * rows + t) * heads + h;
  };

  float m = kNegInf;
  float l = 0.f;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  // The trip count is the same for every thread (the shuffles below need
  // all 32 lanes of each warp); rows past the length are masked per group.
  for (int base = 0; base < n; base += kGroups * kUnroll) {
    float kf[kUnroll][kVec];
    float vf[kUnroll][kVec];
    float s[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + group + u * kGroups;
      valid[u] = t < n;
      if (valid[u]) {
        const size_t r = row_of(t);
        Load<TKV>::row(k + r * D + lane * kVec, kf[u]);
        Load<TKV>::row(v + r * D + lane * kVec, vf[u]);
        if (kInt8) {
          const float ks = k_scale[r];
          const float vs = v_scale[r];
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            kf[u][e] *= ks;
            vf[u][e] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot += qf[e] * kf[u][e];
      // Every lane shuffles; groups of one warp may differ in validity.
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u] = dot * scale;
      if (valid[u]) m_new = fmaxf(m_new, s[u]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!valid[u]) continue;
      const float p = expf(s[u] - m_new);
      l += p;
      const float pv = kRoundP ? __bfloat162float(__float2bfloat16(p)) : p;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] += pv * vf[u][e];
    }
    m = m_new;
  }

  if (lane == 0) {
    s_m[group] = m;
    s_l[group] = l;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) s_acc[group * D + lane * kVec + e] = acc[e];
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float big = kNegInf;
    for (int g = 0; g < kGroups; ++g) big = fmaxf(big, s_m[g]);
    float denom = 0.f;
    float num = 0.f;
    for (int g = 0; g < kGroups; ++g) {
      const float w = expf(s_m[g] - big);
      denom += s_l[g] * w;
      num += s_acc[g * D + d] * w;
    }
    store(o + d, num / denom);
  }
}

template <typename TQ, typename TKV, bool kPaged>
cudaError_t launch(int depth, const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* table, const void* lengths, void* out,
                   int batch, int heads, int page, int max_blocks, int rows,
                   float scale, cudaStream_t stream) {
  const dim3 grid(batch * heads);
  const auto* q_ = static_cast<const TQ*>(q);
  const auto* k_ = static_cast<const TKV*>(k);
  const auto* v_ = static_cast<const TKV*>(v);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* tbl = static_cast<const int*>(table);
  const auto* len = static_cast<const int*>(lengths);
  auto* o = static_cast<TQ*>(out);
#define BS_LAUNCH(DEPTH)                                                   \
  decode_attention_kernel<TQ, TKV, DEPTH, kPaged>                          \
      <<<grid, kThreads, 0, stream>>>(q_, k_, v_, ks, vs, tbl, len, o,     \
                                      heads, page, max_blocks, rows, scale)
  switch (depth) {
    case 32: BS_LAUNCH(32); break;
    case 64: BS_LAUNCH(64); break;
    case 128: BS_LAUNCH(128); break;
    case 256: BS_LAUNCH(256); break;
    default: return cudaErrorInvalidValue;
  }
#undef BS_LAUNCH
  return cudaGetLastError();
}

template <bool kPaged>
cudaError_t dispatch(int q_dtype, int kv_dtype, int depth, const void* q,
                     const void* k, const void* v, const void* k_scale,
                     const void* v_scale, const void* table,
                     const void* lengths, void* out, int batch, int heads,
                     int page, int max_blocks, int rows, float scale,
                     cudaStream_t stream) {
#define BS_ARGS                                                           \
  depth, q, k, v, k_scale, v_scale, table, lengths, out, batch, heads,    \
      page, max_blocks, rows, scale, stream
  if constexpr (kPaged) {  // the dense cache is int8 only (K8)
    if (q_dtype == kF32 && kv_dtype == kF32)
      return launch<float, float, kPaged>(BS_ARGS);
    if (q_dtype == kBF16 && kv_dtype == kBF16)
      return launch<__nv_bfloat16, __nv_bfloat16, kPaged>(BS_ARGS);
  }
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch<float, int8_t, kPaged>(BS_ARGS);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch<__nv_bfloat16, int8_t, kPaged>(BS_ARGS);
#undef BS_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K6 (kv_dtype fp32/bf16, scales null) and K7 (kv_dtype int8).
// Returns the launch's cudaError_t (0 = launched).
int bs_paged_decode_attention(int device, const void* q, const void* k_pages,
                              const void* v_pages, const void* k_scales,
                              const void* v_scales, const void* block_table,
                              const void* lengths, void* out, int batch,
                              int heads, int depth, int page, int max_blocks,
                              int q_dtype, int kv_dtype, float scale,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return dispatch<true>(q_dtype, kv_dtype, depth, q, k_pages, v_pages,
                        k_scales, v_scales, block_table, lengths, out, batch,
                        heads, page, max_blocks, 0, scale,
                        static_cast<cudaStream_t>(stream));
}

// K8: dense int8 cache [B, rows, H, D] with [B, rows, H] scales.
int bs_dense_decode_attention_int8(int device, const void* q,
                                   const void* cache_k, const void* cache_v,
                                   const void* k_scales, const void* v_scales,
                                   const void* lengths, void* out, int batch,
                                   int rows, int heads, int depth,
                                   int q_dtype, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return dispatch<false>(q_dtype, kI8, depth, q, cache_k, cache_v, k_scales,
                         v_scales, nullptr, lengths, out, batch, heads, 1, 0,
                         rows, scale, static_cast<cudaStream_t>(stream));
}

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
