// Ring collectives for Hopper (sm_90a): the ring permute of ring attention
// (K12), the ring all-gather (K13) and reduce-scatter (K14) that make the
// sequence-parallel gradient all-reduce, and their one-device schedules
// (K15, K16).
//
// Replaces the Pallas TPU kernels of batch_shipyard_tpu:
//   K12 ops/ring_collectives.py:_ring_permute_kernel
//   K13 ops/ring_collectives.py:_ring_all_gather_kernel
//   K14 ops/ring_collectives.py:_ring_reduce_scatter_kernel
//   K15 ops/ring_collectives.py:_virtual_all_gather_kernel
//   K16 ops/ring_collectives.py:_virtual_reduce_scatter_kernel
//
// What bounds them: bytes. They copy (K12, K13, K15) or add fp32 (K14, K16);
// on one card each rank's call moves its inputs once and its outputs once
// at the memory rate, across cards the bytes a rank sends over NVLink
// (450 GB/s each way) bound it.
//
// Address problem and design. The TPU kernels write straight into the
// neighbour's freshly allocated output with a remote DMA. A CUDA peer cannot
// know a fresh allocation's address without an exchange on every call, so
// each ring group owns persistent symmetric buffers: one cudaMalloc per rank
// and buffer kind, whose IPC handle (cudaIpcGetMemHandle) every other rank
// opens once (cudaIpcOpenMemHandle). A buffer is a 256-byte signal pad
// followed by two data slots. The design is PULL: a rank copies what it
// sends into its own slot and raises "ready"; the rank that needs it reads
// the slot straight into its ordinary torch output and raises "consumed" on
// the sender's pad. Outputs therefore stay plain torch.empty tensors.
//
// Signals. Every counter in the pad is an epoch that only grows, never a
// flag that is reset, so a late reader of one call can never be confused
// with the next call. Writes into a buffer are numbered W = 1, 2, ... over
// the buffer's life; write W goes to slot W % 2, and before it the writer
// waits until consumed[W % 2] >= W - 2 (the slot's previous content has
// been read): the double buffering and capacity handshake of the TPU
// kernels, where a slot goes back upstream only after it was copied out and
// forwarded. Data in peer slots is read with ld.global.cg (L2, never a
// stale L1 line).
//
// Waits off the SMs. The TPU kernels wait on DMA semaphores; here every
// wait and signal of K12-K14 is a stream-ordered memory operation of the
// CUDA driver API: cuStreamWaitValue64(GEQ) on the epoch word (own or a
// peer's, mapped by IPC), cuStreamWriteValue64 of the epoch with the
// default flag, whose memory barrier makes the preceding kernel's stores
// visible before the signal. The plans (which waits, copies and writes a
// call makes, in order) are ops/ring_collectives.py's permute_plan,
// all_gather_plan and reduce_scatter_plan; this file gives their copy
// kernels, one launch per copy (K12: two a call, into the own slot and out
// of the peer's; K13 and K14: ring a call). K14's copies add: each step's
// kernel writes the left neighbour's partial plus this rank's part of the
// step's chunk into the own next slot (the last step: the output). No
// block ever waits on another rank or another block, so a copy is a small
// grid sized to its bytes. A rank whose stream stands at a wait has no
// work on the card, and the card's time-slicer runs the other contexts:
// four ranks on one card do not pay their neighbours' waits in timeslices.
//
// A hang becomes an error. A stream wait has no bound of its own: the ring
// group (parallel/mesh.py RingGroup) times each with an event pair, and
// its watchdog, once a wait has stood longer than the timeout or the error
// word is set, sets the word and writes a poison epoch (2^63) into every
// word its streams stand waiting on, from a private stream, after the
// same error into the group's device-side abort word. The copy kernels
// read the abort word first and copy nothing once it is set, so the rank
// drains. A copy also marks the slot it fills (written[s] = W) and checks
// the mark of the peer slot it reads: a slot whose write was skipped (its
// signal released by a poisoned wait) sets both words (kUnfilled) instead
// of being read, so a failed rank's neighbours fail too rather than read
// stale data. RingGroup.check raises on the word: before each ring call,
// after the train workload's synchronise, and in RingGroup.close.
// spin_wait_kernel keeps the in-kernel wait the ring kernels used to make
// (thread 0 of one block per SM spinning on the pad, bounded by
// %globaltimer), for trace/ring_wait_probe.py to time against the stream
// wait.
//
// K14/K16 add in ring order. Chunk c's partial starts at rank c+1 and each
// later rank adds its own contribution to what arrived: ((x_{c+1} + x_{c+2})
// + ...) + x_c, the schedule of rs_chunk_index, each add T(float + float).
// The plain versions add in the same order, so kernel and plain version
// agree bit for bit; against a plain sum over ranks the difference is fp32
// rounding.
//
// K15: one pass. Every output row of the one-device all-gather is the
// concatenation of the shards, so K15 reads the shards once, as one run
// of ring * nbytes bytes in tiles, and stores each tile at the same offset
// of every output row; no slot, no scratch, one launch. The unit picks
// the design. Where the shards' bytes and addresses allow 16-byte units,
// the bulk design: one thread a block moves 32 KB tiles by cp.async.bulk
// into a ring of shared-memory stages and out by ring bulk stores. In
// narrower units, the register design: each thread loads its units once
// (ld.global.nc) and stores them ring times with streaming stores
// (st.global.cs), so the ring-fold output does not evict L2. Both were
// built in 16-byte units: at chip_smoke.py's timing shape (ring 4, 187 MB
// a shard) the bulk design took 1.3160 ms and the register design 1.4562
// (bound 1.1160; trace/ring_copy_sweep.py, H100), so 16-byte units run
// the bulk design alone.
//
// K16: one pass. The reference's slot schedule moves partials between
// members' slots because a TPU member's DMA semaphores need them; one
// device does not. Each element of output row j (member j's reduced
// chunk j) is read from the ring members once, added in the schedule's
// order (so the result keeps its bits) and stored once: no slot, no
// scratch, one launch. At ring 4 the slot schedule read 7 chunks and
// wrote 4 for each output chunk, 2.2 times one pass's 4 and 1. The unit
// picks the design. In 16-byte units, the bulk design: a persistent
// block an SM, whose producer thread loads each tile's ring member parts
// with cp.async.bulk into one of three 64 KB shared-memory stages and
// whose 256 consumer threads add them and store with st.global.cs. In
// narrower units, the register design: two 256-thread blocks an SM, each
// thread loading the parts of 4 members for its 4 units (16 loads in
// flight, ld.global.nc.L1::no_allocate) before their adds. Both were
// built in 16-byte units: at chip_smoke.py's timing shape (ring 4, 187
// MB a member's chunk) the bulk design took 1.2584-1.2600 ms on 132-528
// blocks, the register design 1.4632-1.5485 (bound 1.1160;
// trace/ring_copy_sweep.py, H100), so 16-byte units run the bulk design.
//
// Everything launches on the caller's stream and does not synchronise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 512;
constexpr long long kPadBytes = 256;
enum DType : int { kF32 = 0, kBF16 = 1 };
enum RingError : int { kOk = 0, kTimeout = 1, kUnfilled = 2 };

using u64 = unsigned long long;

// The signal pad at the head of every symmetric buffer.
struct Pad {
  u64 ready[2];     // slot s holds write ready[s] (set by the owner)
  u64 consumed[2];  // write consumed[s] of slot s was read (set by reader)
  u64 wait_ns;      // ns block 0 of spin_wait_kernel spent waiting
  u64 written[2];   // the write a copy last put into slot s
};
static_assert(sizeof(Pad) <= kPadBytes, "pad");

struct Ctl {
  int* error;        // host-mapped error word
  long long timeout_ns;
};

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Block-wide: thread 0 spins until *p >= want. False (for every thread)
// when the error word is set or the wait outlives the timeout, which then
// sets it.
__device__ bool wait_at_least(const u64* p, u64 want, const Ctl& c,
                              u64* wait_ns) {
  __shared__ int ok;
  __syncthreads();  // every thread has read the previous wait's ``ok``
  if (threadIdx.x == 0) {
    const u64 t0 = global_ns();
    int good = 1;
    unsigned spins = 0;
    while (ld_acquire(p) < want) {
      if ((++spins & 63u) == 0) {
        if (*reinterpret_cast<volatile int*>(c.error) != kOk) {
          good = 0;
          break;
        }
        if (static_cast<long long>(global_ns() - t0) > c.timeout_ns) {
          *reinterpret_cast<volatile int*>(c.error) = kTimeout;
          __threadfence_system();
          good = 0;
          break;
        }
      }
      __nanosleep(128);
    }
    if (blockIdx.x == 0) atomicAdd(wait_ns, global_ns() - t0);
    ok = good;
  }
  __syncthreads();
  return ok != 0;
}

// A copy unit of U bytes.
template <int U>
struct Unit;
template <>
struct Unit<16> { using T = uint4; };
template <>
struct Unit<8> { using T = uint2; };
template <>
struct Unit<4> { using T = unsigned int; };
template <>
struct Unit<2> { using T = unsigned short; };
template <>
struct Unit<1> { using T = unsigned char; };

// V consecutive elements of T as one 16-byte (V > 1) or scalar access.
template <typename T, int V>
struct Lanes {
  T v[V];
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
__device__ __forceinline__ Lanes<T, V> load_cg(const T* p) {
  Lanes<T, V> r;
  if constexpr (sizeof(T) * V == 16) {
    const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if constexpr (sizeof(T) == 4) {
        const unsigned int u =
            __ldcg(reinterpret_cast<const unsigned int*>(p + i));
        memcpy(&r.v[i], &u, 4);
      } else {
        const unsigned short u =
            __ldcg(reinterpret_cast<const unsigned short*>(p + i));
        memcpy(&r.v[i], &u, 2);
      }
    }
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_cg(T* p, const Lanes<T, V>& r) {
  if constexpr (sizeof(T) * V == 16) {
    uint4 u;
    memcpy(&u, &r, 16);
    __stcg(reinterpret_cast<uint4*>(p), u);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = r.v[i];
  }
}

// a = T(float(a) + float(b)), lane by lane: the add of K14 and K16.
template <typename T, int V>
__device__ __forceinline__ void add_into(Lanes<T, V>& a,
                                         const Lanes<T, V>& b) {
#pragma unroll
  for (int j = 0; j < V; ++j) a.v[j] = from_f<T>(to_f(a.v[j]) + to_f(b.v[j]));
}

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  return n;
}

// ----------------------- stream memory operations -------------------------

// The CUDA driver API's 64-bit stream wait and write, taken from the
// library the runtime already loaded (cudaGetDriverEntryPoint), so this
// library needs no link against libcuda.
using StreamValue64 = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t,
                                   unsigned int);
using DeviceAttribute = CUresult (*)(int*, CUdevice_attribute, CUdevice);
using ErrorString = CUresult (*)(CUresult, const char**);

void* entry_point(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found) !=
          cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return p;
}

struct CuApi {
  StreamValue64 wait, write;
  DeviceAttribute attribute;
  ErrorString error_string;
};

const CuApi& cu() {
  static const CuApi d{
      reinterpret_cast<StreamValue64>(entry_point("cuStreamWaitValue64")),
      reinterpret_cast<StreamValue64>(entry_point("cuStreamWriteValue64")),
      reinterpret_cast<DeviceAttribute>(entry_point("cuDeviceGetAttribute")),
      reinterpret_cast<ErrorString>(entry_point("cuGetErrorString"))};
  return d;
}

// A failed CUDA driver API call returns kCuError + its CUresult.
constexpr int kCuError = 100000;

int cu_rc(CUresult r) {
  return r == CUDA_SUCCESS ? 0 : kCuError + static_cast<int>(r);
}

}  // namespace

// The in-kernel wait the ring kernels used to make: a grid of one block
// per SM whose thread 0 spins on ``word`` (trace/ring_wait_probe.py times
// it against the stream-ordered wait).
__global__ void __launch_bounds__(kThreads, 1)
    spin_wait_kernel(const u64* word, u64 value, Ctl ctl, u64* wait_ns) {
  wait_at_least(word, value, ctl, wait_ns);
}

// --------------------------- K12, K13, K14 --------------------------------

__device__ __forceinline__ int rs_chunk(int me, int step, int ring) {
  return ((me - step - 2) % ring + ring) % ring;
}

namespace ringcopy {

// One copy of a K12, K13 or K14 plan: segment i moves nbytes from src[i]
// to dst[i] and, if dst2[i] is set, to dst2[i] too (K13 files a chunk and
// forwards it in one pass); K14 adds ``local`` (if set) on the way.
struct Copy {
  const char* src[2];
  char* dst[2];
  char* dst2[2];
  const char* local;  // K14: this rank's part of the step's chunk, or null
  int segments;
  long long nbytes;
  u64* mark;          // written[s] of the own slot this copy fills, or null
  u64 mark_value;     // the write number it puts there
  const u64* filled;  // written[s] of the peer slot this copy reads, or null
  u64 filled_value;   // the write that must be in that slot
  int* error;         // the group's host-mapped error word
  u64* abort;         // its device-side copy, which the copies read
};

// Block-wide, before any byte moves: false once the group's abort word is
// set, and when the peer slot to read does not hold the write the plan
// waited for (its copy was skipped), which sets the abort word and the
// error word. Otherwise block 0 marks the own slot this copy fills; the
// stream write after the kernel publishes the mark with the data. The
// copies read the device-side abort word, not the host-mapped error word:
// a read of host memory crosses PCIe, and one per block costs ~1 us each,
// one after another.
__device__ bool copy_may_run(const Copy& c) {
  __shared__ int go;
  if (threadIdx.x == 0) {
    int ok = *reinterpret_cast<volatile u64*>(c.abort) == kOk;
    if (ok && c.filled != nullptr && ld_acquire(c.filled) != c.filled_value) {
      st_release(c.abort, kUnfilled);
      *reinterpret_cast<volatile int*>(c.error) = kUnfilled;
      __threadfence_system();
      ok = 0;
    }
    if (ok && c.mark != nullptr && blockIdx.x == 0) *c.mark = c.mark_value;
    go = ok;
  }
  __syncthreads();
  return go != 0;
}

constexpr int kUnroll = 4;

// Units of U bytes, grid-strided, kUnroll loads in flight per thread before
// their stores; ``dst2`` (if not null) gets a second copy. Peer data is
// read through L2 only.
template <int U>
__device__ __forceinline__ void copy_lanes(char* dst, char* dst2,
                                           const char* src,
                                           long long nbytes) {
  using T = typename Unit<U>::T;
  const long long n = nbytes / U;
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  T* d2 = reinterpret_cast<T*>(dst2);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v[j] = __ldcg(s + i + j * stride);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      __stcg(d + i + j * stride, v[j]);
      if (d2 != nullptr) __stcg(d2 + i + j * stride, v[j]);
    }
  }
  for (; i < n; i += stride) {
    const T v = __ldcg(s + i);
    __stcg(d + i, v);
    if (d2 != nullptr) __stcg(d2 + i, v);
  }
}

// K12's copies: (K, V) into the own slot, or out of the source rank's slot
// into the outputs, one segment each.
template <int U>
__global__ void __launch_bounds__(kThreads) ring_permute_kernel(Copy c) {
  if (!copy_may_run(c)) return;
  for (int i = 0; i < c.segments; ++i)
    copy_lanes<U>(c.dst[i], c.dst2[i], c.src[i], c.nbytes);
}

// K13's copies: the own chunk into its output row and the first slot, then
// at each step the left neighbour's slot into its output row and (but at
// the last step) the own next slot.
template <int U>
__global__ void __launch_bounds__(kThreads) ring_all_gather_kernel(Copy c) {
  if (!copy_may_run(c)) return;
  copy_lanes<U>(c.dst[0], c.dst2[0], c.src[0], c.nbytes);
}

// dst = src, plus ``local`` in lanes [0, added): lanes of V elements of T,
// grid-strided, kUnroll lanes in flight per thread. src is a peer's slot
// (or this rank's input), read through L2 only.
template <typename T, int V>
__device__ __forceinline__ void add_lanes(T* dst, const T* src,
                                          const T* local, long long lanes,
                                          long long added) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < lanes; i += kUnroll * stride) {
    Lanes<T, V> a[kUnroll], b[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long k = i + j * stride;
      if (k < lanes) a[j] = load_cg<T, V>(src + k * V);
      if (k < added) b[j] = load_cg<T, V>(local + k * V);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long k = i + j * stride;
      if (k < added) add_into(a[j], b[j]);
      if (k < lanes) store_cg<T, V>(dst + k * V, a[j]);
    }
  }
}

// K14's copies: this rank's part of its first chunk into the own slot (no
// local part), then at each step the left neighbour's partial plus this
// rank's part of the step's chunk into the own next slot or, at the last
// step, the output.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    ring_reduce_scatter_kernel(Copy c) {
  if (!copy_may_run(c)) return;
  const long long lanes = c.nbytes / static_cast<long long>(sizeof(T) * V);
  const long long added = c.local != nullptr ? lanes : 0;
  add_lanes<T, V>(reinterpret_cast<T*>(c.dst[0]),
                  reinterpret_cast<const T*>(c.src[0]),
                  reinterpret_cast<const T*>(c.local), lanes, added);
}

// Blocks for ``bytes``: one per kBytesPerBlock, at most kMaxBlocks. From
// trace/ring_copy_sweep.py on an H100: K12's 2 x 32 MiB copy takes 0.1050
// ms on 16 blocks, 0.0661 on 33, 0.0568 on 66, 0.0531 on 132 (copy_:
// 0.0518) and slower on more; K13's chunk copy is flat from 66 blocks.
constexpr long long kBytesPerBlock = 256ll << 10;
constexpr int kMaxBlocks = 132;

int blocks_for(long long bytes) {
  const long long b = (bytes + kBytesPerBlock - 1) / kBytesPerBlock;
  return static_cast<int>(b < 1 ? 1 : b > kMaxBlocks ? kMaxBlocks : b);
}

template <int U>
cudaError_t run(int kernel, const Copy& c, int blocks, cudaStream_t stream) {
  if (kernel == 0)
    ring_permute_kernel<U><<<blocks, kThreads, 0, stream>>>(c);
  else
    ring_all_gather_kernel<U><<<blocks, kThreads, 0, stream>>>(c);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run_add(const Copy& c, int blocks, cudaStream_t stream) {
  ring_reduce_scatter_kernel<T, V><<<blocks, kThreads, 0, stream>>>(c);
  return cudaGetLastError();
}

}  // namespace ringcopy

// ------------------------------ K15 ---------------------------------------

namespace vgather {

// A tile: kTileUnits units of the shards' run, kUnroll a thread (the
// stage of the bulk design is one 16-byte tile, 32 KB). The wrapper's
// ring_collectives.VIRTUAL_TILE_UNITS mirrors kTileUnits;
// bs_virtual_gather_tile_units reports it.
constexpr int kUnroll = 4;
constexpr long long kTileUnits = static_cast<long long>(kThreads) * kUnroll;
constexpr int kStages = 4;
constexpr int kStageBytes = static_cast<int>(kTileUnits * 16);

// The register design (units of 1, 2, 4 or 8 bytes): x [ring, n] units
// read as one run of ring * n; tile t holds units [t * kTileUnits,
// (t + 1) * kTileUnits), thread i its units i + j * kThreads. Each is
// loaded once and stored at the same offset of every output row (row r
// starts at unit r * ring * n): row r's columns of shard s are shard s.
template <int U>
__global__ void __launch_bounds__(kThreads)
    virtual_all_gather_kernel(const char* x, char* out, long long nbytes,
                              int ring) {
  using T = typename Unit<U>::T;
  const long long n = nbytes / U;
  const long long total = n * ring;
  const T* src = reinterpret_cast<const T*>(x);
  T* dst = reinterpret_cast<T*>(out);
  const long long tiles = (total + kTileUnits - 1) / kTileUnits;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long first = t * kTileUnits + threadIdx.x;
    T v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long u = first + j * kThreads;
      if (u < total) v[j] = __ldg(src + u);
    }
    for (int r = 0; r < ring; ++r) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long u = first + j * kThreads;
        const long long at = r * total + u;
        if (u < total) __stcs(dst + at, v[j]);
      }
    }
  }
}

__device__ __forceinline__ void bulk_load(void* smem, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_addr(smem)),
      "l"(src), "r"(bytes), "r"(hopper::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* smem,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(hopper::smem_addr(smem)), "r"(bytes)
      : "memory");
}

// At most one bulk group of stores still reading its shared memory.
__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// The bulk design (16-byte units): thread 0 of each block
// loads its tiles of the run (kStageBytes, the last one ragged) into a
// ring of kStages shared-memory stages with cp.async.bulk, kStages - 1
// ahead, completed on an mbarrier, and stores each stage into every
// output row with ring bulk stores in one bulk group; a stage is loaded
// again once the group before the newest has read it.
__global__ void __launch_bounds__(32)
    virtual_all_gather_bulk_kernel(const char* x, char* out,
                                   long long nbytes, int ring) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full[kStages];
  if (threadIdx.x != 0) return;
  const long long total = nbytes * ring;
  const long long tiles = (total + kStageBytes - 1) / kStageBytes;
  if (blockIdx.x >= tiles) return;
  const long long mine = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
  for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
  hopper::fence_barrier_init();
  auto start_of = [&](long long it) {
    return (blockIdx.x + it * gridDim.x) * static_cast<long long>(kStageBytes);
  };
  auto bytes_of = [&](long long start) {
    const long long left = total - start;
    return static_cast<uint32_t>(left < kStageBytes ? left : kStageBytes);
  };
  auto load = [&](long long it) {
    const int s = static_cast<int>(it % kStages);
    const long long start = start_of(it);
    const uint32_t bytes = bytes_of(start);
    hopper::mbar_expect_tx(&full[s], bytes);
    bulk_load(stage + s * kStageBytes, x + start, bytes, &full[s]);
  };
  for (long long it = 0; it < kStages - 1 && it < mine; ++it) load(it);
  for (long long it = 0; it < mine; ++it) {
    const int s = static_cast<int>(it % kStages);
    hopper::mbar_wait(&full[s], static_cast<uint32_t>((it / kStages) & 1));
    const long long start = start_of(it);
    const uint32_t bytes = bytes_of(start);
    for (int r = 0; r < ring; ++r)
      bulk_store(out + r * total + start, stage + s * kStageBytes, bytes);
    hopper::tma_store_commit();
    if (it + kStages - 1 < mine) {
      bulk_wait_read_1();
      load(it + kStages - 1);
    }
  }
  hopper::tma_store_wait_read();
}

template <int U>
cudaError_t run(const char* x, char* out, long long nbytes, int ring,
                int blocks, cudaStream_t stream) {
  virtual_all_gather_kernel<U><<<blocks, kThreads, 0, stream>>>(
      x, out, nbytes, ring);
  return cudaGetLastError();
}

cudaError_t run_bulk(const char* x, char* out, long long nbytes, int ring,
                     int blocks, cudaStream_t stream) {
  constexpr int smem = kStages * kStageBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      virtual_all_gather_bulk_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  virtual_all_gather_bulk_kernel<<<blocks, 32, smem, stream>>>(x, out, nbytes,
                                                                ring);
  return cudaGetLastError();
}

}  // namespace vgather

// ------------------------------ K16 ---------------------------------------

namespace vreduce {

// The bulk design (16-byte units): a stage of kStageBytes holds one tile
// of every member, so its tile is kStageBytes / (16 * ring) units; the
// register design (narrower units) tiles by kTileUnits, kUnroll units a
// thread. tile_units() gives both; the wrapper's
// ring_collectives.virtual_reduce_tile_units mirrors it, and
// bs_virtual_reduce_tile_units reports it.
constexpr int kBlock = 256;
constexpr int kUnroll = 4;
constexpr long long kTileUnits = static_cast<long long>(kBlock) * kUnroll;
constexpr int kStages = 3;
constexpr int kStageBytes = 65536;
// Members a thread of the register design loads before their adds.
constexpr int kBatch = 4;

__host__ __device__ inline bool bulk(int ring, int unit) {
  return unit == 16 && ring <= kStageBytes / 16;
}

__host__ __device__ inline long long tile_units(int ring, int unit) {
  return bulk(ring, unit) ? kStageBytes / (16 * ring) : kTileUnits;
}

// Out row j's term k: the part of chunk j that member j + 1 + k (mod ring)
// holds. Member j + 1 seeds the chain (rs_chunk_index(j + 1, -1) is j),
// then j + 2, ..., j add in turn, as the slot schedule adds them.
__device__ __forceinline__ int chain_member(int j, int k, int ring) {
  return (j + 1 + k) % ring;
}

// Where member m's part of chunk j starts in x [ring, ring * n], in units.
__device__ __forceinline__ long long part_at(int m, int j, int ring,
                                             long long n) {
  return (static_cast<long long>(m) * ring + j) * n;
}

// One unit read once: ld.global.nc that allocates no L1 line.
__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 load_once(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned int load_once(const unsigned int* p) {
  unsigned int v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];"
      : "=r"(v)
      : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned short load_once(const unsigned short* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.u16 %0, [%1];"
      : "=h"(v)
      : "l"(p));
  return v;
}

// Both designs: x [ring, ring * n] -> out [ring, n] in units (n units a
// chunk); out row j is chunk j summed over the members in the chain's
// order, each add T(float + float), as the plain version adds. Row j's
// units are cut into tiles; grid tile t is tile t % per_row of row
// t / per_row.

// The bulk design (16-byte units, V elements of T each): thread kBlock
// (the producer) loads a tile's ring member parts with cp.async.bulk into
// a stage, slot k holding term k, completed on full[s]; kBlock consumer
// threads add the slots in order, store with st.global.cs, and release
// the stage on empty[s] (one arrival a warp).
template <typename T>
__global__ void __launch_bounds__(kBlock + 32, 1)
    virtual_reduce_scatter_bulk_kernel(const char* x, char* out,
                                       long long nbytes, int ring) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const long long n = nbytes / 16;
  const long long tile = tile_units(ring, 16);
  const long long per_row = (n + tile - 1) / tile;
  const long long tiles = per_row * ring;
  if (blockIdx.x >= tiles) return;
  const long long mine = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kBlock / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= kBlock) {
    if (threadIdx.x != kBlock) return;
    for (long long it = 0; it < mine; ++it) {
      const int s = static_cast<int>(it % kStages);
      if (it >= kStages)
        hopper::mbar_wait(&empty[s],
                          static_cast<uint32_t>((it / kStages - 1) & 1));
      const long long t = blockIdx.x + it * gridDim.x;
      const int j = static_cast<int>(t / per_row);
      const long long start = (t - j * per_row) * tile;
      const long long left = n - start;
      const uint32_t bytes =
          static_cast<uint32_t>((left < tile ? left : tile) * 16);
      hopper::mbar_expect_tx(&full[s], bytes * ring);
      for (int k = 0; k < ring; ++k)
        vgather::bulk_load(
            stage + s * kStageBytes + k * tile * 16,
            x + (part_at(chain_member(j, k, ring), j, ring, n) + start) * 16,
            bytes, &full[s]);
    }
    return;
  }
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (long long it = 0; it < mine; ++it) {
    const int s = static_cast<int>(it % kStages);
    hopper::mbar_wait(&full[s], static_cast<uint32_t>((it / kStages) & 1));
    const long long t = blockIdx.x + it * gridDim.x;
    const int j = static_cast<int>(t / per_row);
    const long long start = (t - j * per_row) * tile;
    const long long left = n - start;
    const int units = static_cast<int>(left < tile ? left : tile);
    const uint4* slots =
        reinterpret_cast<const uint4*>(stage + s * kStageBytes);
    for (int u = threadIdx.x; u < units; u += kBlock) {
      Lanes<T, V> acc, part;
      uint4 w = slots[u];
      memcpy(&acc, &w, 16);
      for (int k = 1; k < ring; ++k) {
        w = slots[k * tile + u];
        memcpy(&part, &w, 16);
        add_into(acc, part);
      }
      memcpy(&w, &acc, 16);
      __stcs(dst + j * n + start + u, w);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&empty[s]);
  }
}

// The register design (units of U bytes, V elements of T each): thread i
// adds units i + q * kBlock of its tile, q < kUnroll. For each batch of
// kBatch members it loads their parts of its kUnroll units (16 loads in
// flight) before the batch's adds; each unit is stored once, with a
// streaming store.
template <typename T, int U>
__global__ void __launch_bounds__(kBlock, 2)
    virtual_reduce_scatter_kernel(const char* x, char* out, long long nbytes,
                                  int ring) {
  using W = typename Unit<U>::T;
  constexpr int V = U / static_cast<int>(sizeof(T));
  const long long n = nbytes / U;
  const long long per_row = (n + kTileUnits - 1) / kTileUnits;
  const long long tiles = per_row * ring;
  const W* src = reinterpret_cast<const W*>(x);
  W* dst = reinterpret_cast<W*>(out);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int j = static_cast<int>(t / per_row);
    const long long first = (t - j * per_row) * kTileUnits + threadIdx.x;
    Lanes<T, V> acc[kUnroll];
    for (int b = 0; b < ring; b += kBatch) {
      W part[kBatch][kUnroll];
#pragma unroll
      for (int g = 0; g < kBatch; ++g) {
        const int k = b + g;
        const W* s = src + part_at(chain_member(j, k, ring), j, ring, n);
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const long long u = first + q * kBlock;
          if (k < ring && u < n) part[g][q] = load_once(s + u);
        }
      }
#pragma unroll
      for (int g = 0; g < kBatch; ++g) {
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          Lanes<T, V> v;
          memcpy(&v, &part[g][q], U);
          if (b + g == 0)
            acc[q] = v;
          else if (b + g < ring)
            add_into(acc[q], v);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long long u = first + q * kBlock;
      if (u < n) {
        W w;
        memcpy(&w, &acc[q], U);
        __stcs(dst + j * n + u, w);
      }
    }
  }
}

// The unit picks the design: 16-byte units (while a stage holds a unit of
// every member) the bulk one, narrower units the register one.
template <typename T, int U>
cudaError_t run(const char* x, char* out, long long nbytes, int ring,
                int blocks, cudaStream_t stream) {
  if (!bulk(ring, U)) {
    virtual_reduce_scatter_kernel<T, U>
        <<<blocks, kBlock, 0, stream>>>(x, out, nbytes, ring);
    return cudaGetLastError();
  }
  constexpr int smem = kStages * kStageBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      virtual_reduce_scatter_bulk_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  virtual_reduce_scatter_bulk_kernel<T>
      <<<blocks, kBlock + 32, smem, stream>>>(x, out, nbytes, ring);
  return cudaGetLastError();
}

}  // namespace vreduce

extern "C" {

// A zeroed device buffer of ``bytes`` (pad included) for a ring group.
int bs_ring_alloc(int device, long long bytes, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  return cudaDeviceSynchronize();
}

int bs_ring_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaFree(ptr);
}

// The buffer's IPC handle, written to ``handle`` (CUDA_IPC_HANDLE_SIZE = 64
// bytes).
int bs_ring_export(int device, void* ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, ptr);
  if (err != cudaSuccess) return err;
  memcpy(handle, &h, sizeof(h));
  return cudaSuccess;
}

// Map another process's buffer from its IPC handle.
int bs_ring_import(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int bs_ring_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaIpcCloseMemHandle(ptr);
}

// A zeroed int in host-mapped pinned memory: the error word the kernels
// write and the host reads without a synchronise.
int bs_ring_flag_alloc(int device, int** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaHostAlloc(reinterpret_cast<void**>(ptr), sizeof(int),
                      cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return err;
  **ptr = kOk;
  return cudaSuccess;
}

int bs_ring_flag_free(int* ptr) { return cudaFreeHost(ptr); }

// One copy of a K12 (kernel 0), K13 (kernel 1) or K14 (kernel 2) plan on
// ``stream``: src0 -> dst0 (and dst2_0 if not null), and src1 -> dst1 if
// src1 is not null, nbytes each, in units of ``unit`` bytes. Kernel 2
// adds ``local`` (if not null) on the way, in elements of ``dtype`` (0
// fp32, 1 bf16), 16-byte lanes where ``unit`` is 16, else one element at
// a time (``unit`` the element's size). ``mark``/``mark_value``: the own
// slot's written word and the write this copy puts there (null: none);
// ``filled``/``filled_value``: the peer slot's written word and the write
// it must hold (null: the source is not a peer slot). ``error``: the
// group's host-mapped error word; ``abort``: its device-side word (a
// zeroed device u64). ``blocks`` 0 sizes the grid to the bytes.
int bs_ring_copy(int device, int kernel, const void* src0, void* dst0,
                 void* dst2_0, const void* src1, void* dst1,
                 const void* local, long long nbytes, int unit, int dtype,
                 void* mark, unsigned long long mark_value,
                 const void* filled, unsigned long long filled_value,
                 int* error, void* abort, int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbytes <= 0 || unit <= 0 || kernel < 0 || kernel > 2 ||
      error == nullptr || abort == nullptr ||
      (local != nullptr && kernel != 2) ||
      (kernel == 2 && (src1 != nullptr || dst2_0 != nullptr)))
    return cudaErrorInvalidValue;
  ringcopy::Copy c{};
  c.src[0] = static_cast<const char*>(src0);
  c.dst[0] = static_cast<char*>(dst0);
  c.dst2[0] = static_cast<char*>(dst2_0);
  c.src[1] = static_cast<const char*>(src1);
  c.dst[1] = static_cast<char*>(dst1);
  c.local = static_cast<const char*>(local);
  c.segments = src1 == nullptr ? 1 : 2;
  c.nbytes = nbytes;
  c.mark = static_cast<u64*>(mark);
  c.mark_value = mark_value;
  c.filled = static_cast<const u64*>(filled);
  c.filled_value = filled_value;
  c.error = error;
  c.abort = static_cast<u64*>(abort);
  if (blocks <= 0) blocks = ringcopy::blocks_for(nbytes * c.segments);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 2) {
    if (nbytes % unit != 0) return cudaErrorInvalidValue;
    if (dtype == kF32 && unit == 16)
      return ringcopy::run_add<float, 4>(c, blocks, s);
    if (dtype == kF32 && unit == 4)
      return ringcopy::run_add<float, 1>(c, blocks, s);
    if (dtype == kBF16 && unit == 16)
      return ringcopy::run_add<__nv_bfloat16, 8>(c, blocks, s);
    if (dtype == kBF16 && unit == 2)
      return ringcopy::run_add<__nv_bfloat16, 1>(c, blocks, s);
    return cudaErrorInvalidValue;
  }
  switch (unit) {
    case 16: return ringcopy::run<16>(kernel, c, blocks, s);
    case 8: return ringcopy::run<8>(kernel, c, blocks, s);
    case 4: return ringcopy::run<4>(kernel, c, blocks, s);
    case 2: return ringcopy::run<2>(kernel, c, blocks, s);
    case 1: return ringcopy::run<1>(kernel, c, blocks, s);
  }
  return cudaErrorInvalidValue;
}

// K15. x [ring, nbytes] -> out [ring, ring * nbytes], one launch, in
// units of ``unit`` bytes: the TMA bulk-copy design in 16-byte units, the
// register design in narrower ones. ``blocks`` 0: one block per SM (bulk)
// or two (registers), at most one per tile.
int bs_virtual_all_gather(int device, const void* x, void* out,
                          long long nbytes, int ring, int unit, int blocks,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbytes <= 0 || ring < 2 || unit <= 0 || nbytes % unit != 0)
    return cudaErrorInvalidValue;
  if (blocks <= 0) {
    const int sms = sm_count(device);
    if (sms <= 0) return cudaErrorInvalidDevice;
    const long long tile = vgather::kTileUnits * unit;
    const long long tiles = (nbytes * ring + tile - 1) / tile;
    const long long want = unit == 16 ? sms : 2ll * sms;
    blocks = static_cast<int>(tiles < want ? tiles : want);
  }
  const char* src = static_cast<const char*>(x);
  char* dst = static_cast<char*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return vgather::run_bulk(src, dst, nbytes, ring, blocks, s);
    case 8: return vgather::run<8>(src, dst, nbytes, ring, blocks, s);
    case 4: return vgather::run<4>(src, dst, nbytes, ring, blocks, s);
    case 2: return vgather::run<2>(src, dst, nbytes, ring, blocks, s);
    case 1: return vgather::run<1>(src, dst, nbytes, ring, blocks, s);
  }
  return cudaErrorInvalidValue;
}

// K15's tile in copy units (a tile is kTileUnits * unit bytes).
long long bs_virtual_gather_tile_units() { return vgather::kTileUnits; }

// K16. x [ring, ring * nbytes] -> out [ring, nbytes] (dtype 0 fp32, 1
// bf16), one launch, no scratch, in units of ``unit`` bytes (16, 8, 4, or
// bf16's 2): the bulk design in 16-byte units, the register design in
// narrower ones. ``blocks`` 0: one block per SM (bulk) or two (registers),
// at most one per tile.
int bs_virtual_reduce_scatter(int device, const void* x, void* out,
                              long long nbytes, int ring, int dtype, int unit,
                              int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbytes <= 0 || ring < 2 || unit <= 0 || nbytes % unit != 0)
    return cudaErrorInvalidValue;
  if (blocks <= 0) {
    const int sms = sm_count(device);
    if (sms <= 0) return cudaErrorInvalidDevice;
    const long long tile = vreduce::tile_units(ring, unit);
    const long long tiles = (nbytes / unit + tile - 1) / tile * ring;
    const long long want = vreduce::bulk(ring, unit) ? sms : 2ll * sms;
    blocks = static_cast<int>(tiles < want ? tiles : want);
  }
  const char* src = static_cast<const char*>(x);
  char* dst = static_cast<char*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    switch (unit) {
      case 16: return vreduce::run<float, 16>(src, dst, nbytes, ring,
                                              blocks, s);
      case 8: return vreduce::run<float, 8>(src, dst, nbytes, ring, blocks,
                                            s);
      case 4: return vreduce::run<float, 4>(src, dst, nbytes, ring, blocks,
                                            s);
    }
  } else if (dtype == kBF16) {
    using B = __nv_bfloat16;
    switch (unit) {
      case 16: return vreduce::run<B, 16>(src, dst, nbytes, ring, blocks, s);
      case 8: return vreduce::run<B, 8>(src, dst, nbytes, ring, blocks, s);
      case 4: return vreduce::run<B, 4>(src, dst, nbytes, ring, blocks, s);
      case 2: return vreduce::run<B, 2>(src, dst, nbytes, ring, blocks, s);
    }
  }
  return cudaErrorInvalidValue;
}

// K16's tile in units of ``unit`` bytes at this ring (a tile is that many
// units of one output row).
long long bs_virtual_reduce_tile_units(int ring, int unit) {
  return vreduce::tile_units(ring, unit);
}

// 1 in *supported when the CUDA driver offers 64-bit stream waits and
// writes on ``device`` (CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS
// and the two entry points), else 0.
int bs_stream_mem_ops(int device, int* supported) {
  *supported = 0;
  const CuApi& d = cu();
  if (d.attribute == nullptr || d.wait == nullptr || d.write == nullptr)
    return cudaSuccess;
  return cu_rc(d.attribute(
      supported, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS,
      static_cast<CUdevice>(device)));
}

// A stream of its own for the ring group's watchdog (non-blocking: it
// never waits for the legacy default stream).
int bs_ring_stream_create(int device, void** stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaStreamCreateWithFlags(reinterpret_cast<cudaStream_t*>(stream),
                                   cudaStreamNonBlocking);
}

int bs_ring_stream_destroy(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaStreamDestroy(static_cast<cudaStream_t>(stream));
}

// Stream-ordered: ``stream`` waits until the 64-bit word at ``addr`` (this
// rank's or a mapped peer's) is >= value.
int bs_stream_wait(int device, void* addr, unsigned long long value,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const CuApi& d = cu();
  if (d.wait == nullptr) return cudaErrorNotSupported;
  return cu_rc(d.wait(static_cast<CUstream>(stream),
                          reinterpret_cast<CUdeviceptr>(addr), value,
                          CU_STREAM_WAIT_VALUE_GEQ));
}

// Stream-ordered: write ``value`` to the 64-bit word at ``addr`` once the
// work before it on ``stream`` is done. The default flag keeps the memory
// barrier, so the preceding kernels' stores are visible first.
int bs_stream_write(int device, void* addr, unsigned long long value,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const CuApi& d = cu();
  if (d.write == nullptr) return cudaErrorNotSupported;
  return cu_rc(d.write(static_cast<CUstream>(stream),
                           reinterpret_cast<CUdeviceptr>(addr), value,
                           CU_STREAM_WRITE_VALUE_DEFAULT));
}

// spin_wait_kernel on ``stream``: one block per SM until *word >= value.
int bs_ring_spin_wait(int device, const void* word, unsigned long long value,
                      int* error, long long timeout_ns, void* wait_ns,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = sm_count(device);
  if (blocks <= 0) return cudaErrorInvalidDevice;
  Ctl ctl{error, timeout_ns};
  spin_wait_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(word), value, ctl, static_cast<u64*>(wait_ns));
  return cudaGetLastError();
}

const char* bs_error_string(int code) {
  if (code >= kCuError) {
    const char* msg = nullptr;
    const CuApi& d = cu();
    if (d.error_string == nullptr ||
        d.error_string(static_cast<CUresult>(code - kCuError), &msg) !=
            CUDA_SUCCESS ||
        msg == nullptr)
      return "CUDA driver error";
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
