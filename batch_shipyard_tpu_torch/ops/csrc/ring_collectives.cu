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
// K12 and K13: waits off the SMs. The TPU kernels wait on DMA semaphores;
// here every wait and signal of K12 and K13 is a stream-ordered memory
// operation of the CUDA driver API: cuStreamWaitValue64(GEQ) on the epoch
// word (own or a peer's, mapped by IPC), cuStreamWriteValue64 of the
// epoch with the default flag, whose memory barrier makes the preceding copy's stores
// visible before the signal. The plans (which waits, copies and writes a
// call makes, in order) are ops/ring_collectives.py's permute_plan and
// all_gather_plan; this file gives their copy kernels, one launch per copy
// (K12: two a call, into the own slot and out of the peer's; K13: ring a
// call). No block of K12 or K13 ever waits on another rank, so a copy is a
// small grid sized to its bytes. A rank whose stream stands at a wait has
// no work on the card, and the card's time-slicer runs the other contexts:
// four ranks on one card no longer pay their neighbours' waits in
// timeslices.
//
// K14: waits inside the kernel. K14 keeps its in-kernel protocol: ranks
// wait on each other and the blocks of one rank never wait on each other,
// so its grid must be resident at once, one block per SM (one wave);
// thread 0 of each block spins (wait_at_least) on ld.acquire.sys of the
// epoch words, which the owner's blocks raise with st.release.sys when the
// last of them has arrived (arrive). Such a spinning grid keeps its
// context's timeslices on a shared card.
//
// A hang becomes an error. K14's spins are bounded by %globaltimer: after
// timeout_ns a block writes the group's error word (host-mapped memory)
// and returns; every later wait that reads the word returns within 64
// spins. A stream wait has no bound of its own: the ring group
// (parallel/mesh.py RingGroup) times each with an event pair, and its
// watchdog, once a wait has stood longer than the timeout or the error
// word is set, sets the word and writes a poison epoch (2^63) into every
// word its streams stand waiting on, from a private stream, after the
// same error into the group's device-side abort word. The copy kernels
// read the abort word first and copy nothing once it is set, so the rank
// drains. A copy also marks the slot it fills (written[s] = W) and checks
// the mark of the peer slot it reads: a slot whose write was skipped (its
// signal released by a poisoned wait) sets both words (kUnfilled) instead
// of being read, so a failed rank's neighbours fail too rather than read
// stale data. RingGroup.check raises on the word:
// before each ring call, after the train workload's synchronise, and in
// RingGroup.close.
//
// K14/K16 add in ring order. Chunk c's partial starts at rank c+1 and each
// later rank adds its own contribution to what arrived: ((x_{c+1} + x_{c+2})
// + ...) + x_c, the schedule of rs_chunk_index. The plain versions add in
// the same order, so kernel and plain version agree bit for bit; against a
// plain sum over ranks the difference is fp32 rounding.
//
// K15/K16 run K13's and K14's slot schedule over ring members held on one
// device, one launch per ring step (so no block ever waits for another):
// members [ring, 2, chunk] slots in a scratch buffer the wrapper allocates.
//
// Everything launches on the caller's stream and does not synchronise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

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
  u64 arrive_w[2];  // the owner's blocks that finished writing slot s
  u64 arrive_r[2];  // the owner's blocks that finished reading a peer slot
  u64 wait_ns;      // ns block 0 of the owner's K14 kernels spent waiting
  u64 written[2];   // the write a K12/K13 copy last put into slot s
};
static_assert(sizeof(Pad) <= kPadBytes, "pad");

struct Ctl {
  int* error;        // host-mapped error word
  long long timeout_ns;
};

__device__ __forceinline__ Pad* pad_of(char* base) {
  return reinterpret_cast<Pad*>(base);
}

__device__ __forceinline__ char* slot_ptr(char* base, long long stride,
                                          int s) {
  return base + kPadBytes + s * stride;
}

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

// Block-wide: count this block in; the block that completes the
// ``arrivals``-th full grid raises *signal = value.
__device__ void arrive(u64* counter, u64 arrivals, u64* signal, u64 value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    const u64 old = atomicAdd(counter, 1ull);
    if (old + 1 == arrivals * gridDim.x) {
      __threadfence_system();
      st_release(signal, value);
    }
  }
}

// Arrivals of a full grid at slot W % 2 up to and including write W.
__device__ __forceinline__ u64 slot_round(u64 w) { return (w + 1) / 2; }

// Copy units of U bytes, grid-strided; ``dst2`` (if not null) gets a second
// copy. Peer data is read through L2 only.
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

template <int U>
__device__ void copy_units(char* dst, char* dst2, const char* src,
                           long long nbytes) {
  using T = typename Unit<U>::T;
  const long long n = nbytes / U;
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  T* d2 = reinterpret_cast<T*>(dst2);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const T v = __ldcg(s + i);
    __stcg(d + i, v);
    if (d2 != nullptr) __stcg(d2 + i, v);
  }
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

// The in-kernel wait K14 makes: a grid of one block per SM whose thread
// 0 spins on ``word`` (trace/ring_wait_probe.py times it against the
// stream-ordered wait).
__global__ void __launch_bounds__(kThreads, 1)
    spin_wait_kernel(const u64* word, u64 value, Ctl ctl, u64* wait_ns) {
  wait_at_least(word, value, ctl, wait_ns);
}

// ----------------------------- K12, K13 -----------------------------------

__device__ __forceinline__ int ag_source(int me, int step, int ring) {
  return ((me - step - 1) % ring + ring) % ring;
}

__device__ __forceinline__ int rs_chunk(int me, int step, int ring) {
  return ((me - step - 2) % ring + ring) % ring;
}

namespace ringcopy {

// One copy of a K12 or K13 plan: segment i moves nbytes from src[i] to
// dst[i] and, if dst2[i] is set, to dst2[i] too (K13 files a chunk and
// forwards it in one pass).
struct Copy {
  const char* src[2];
  char* dst[2];
  char* dst2[2];
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

}  // namespace ringcopy

// ------------------------------ K14 ---------------------------------------

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

// dst[i] = T(float(received[i]) + float(local[i])), grid-strided in lanes
// of V: the arriving partial plus this member's own contribution.
template <typename T, int V>
__device__ void add_chunk(T* dst, const T* received, const T* local,
                          long long n) {
  const long long lanes = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < lanes; i += stride) {
    const Lanes<T, V> a = load_cg<T, V>(received + i * V);
    const Lanes<T, V> b = load_cg<T, V>(local + i * V);
    Lanes<T, V> c;
#pragma unroll
    for (int j = 0; j < V; ++j) c.v[j] = from_f<T>(to_f(a.v[j]) + to_f(b.v[j]));
    store_cg<T, V>(dst + i * V, c);
  }
}

template <typename T, int V>
__device__ void copy_chunk(T* dst, const T* src, long long n) {
  const long long lanes = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < lanes; i += stride)
    store_cg<T, V>(dst + i * V, load_cg<T, V>(src + i * V));
}

namespace reduce {

struct Args {
  const void* x;  // [ring * chunk] elements
  void* out;      // [chunk]
  char* self;
  char* left;
  long long chunk;  // elements
  long long slot_stride;
  int rank, ring;
  u64 base;
  Ctl ctl;
};

// The first slot holds this rank's part of chunk rs_chunk(rank, -1); at
// step t the left neighbour's partial of chunk rs_chunk(rank, t) is pulled,
// this rank's part added, and the sum goes to the next slot (or, at the
// last step, where the chunk is this rank's own, to the output).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
    ring_reduce_scatter_kernel(Args a) {
  Pad* me = pad_of(a.self);
  Pad* left = pad_of(a.left);
  const T* x = static_cast<const T*>(a.x);
  u64 w = a.base + 1;
  int s = static_cast<int>(w % 2);
  if (!wait_at_least(&me->consumed[s], w >= 2 ? w - 2 : 0, a.ctl,
                     &me->wait_ns))
    return;
  const int c0 = rs_chunk(a.rank, -1, a.ring);
  copy_chunk<T, V>(reinterpret_cast<T*>(slot_ptr(a.self, a.slot_stride, s)),
                   x + c0 * a.chunk, a.chunk);
  arrive(&me->arrive_w[s], slot_round(w), &me->ready[s], w);
  for (int t = 0; t < a.ring - 1; ++t) {
    const u64 r = a.base + 1 + t;
    const int rs = static_cast<int>(r % 2);
    if (!wait_at_least(&left->ready[rs], r, a.ctl, &me->wait_ns)) return;
    const int c = rs_chunk(a.rank, t, a.ring);
    const T* from =
        reinterpret_cast<const T*>(slot_ptr(a.left, a.slot_stride, rs));
    T* dst = static_cast<T*>(a.out);
    const bool last = t == a.ring - 2;
    if (!last) {
      w = r + 1;
      s = static_cast<int>(w % 2);
      if (!wait_at_least(&me->consumed[s], w - 2, a.ctl, &me->wait_ns))
        return;
      dst = reinterpret_cast<T*>(slot_ptr(a.self, a.slot_stride, s));
    }
    add_chunk<T, V>(dst, from, x + c * a.chunk, a.chunk);
    if (!last) arrive(&me->arrive_w[s], slot_round(w), &me->ready[s], w);
    arrive(&me->arrive_r[rs], slot_round(r), &left->consumed[rs], r);
  }
}

template <typename T, int V>
cudaError_t run(const Args& a, int blocks, cudaStream_t stream) {
  ring_reduce_scatter_kernel<T, V><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace reduce

// ------------------------------ K15 ---------------------------------------

namespace vgather {

struct Args {
  const char* x;  // [ring, nbytes]
  char* out;      // [ring, ring * nbytes]
  char* comm;     // [ring, 2, nbytes]
  long long nbytes;
  int ring;
  int step;  // -1 seeds, 0 .. ring-2 moves, ring-1 copies out the last
};

__device__ __forceinline__ char* comm_slot(const Args& a, int member,
                                           int s) {
  return a.comm + (static_cast<long long>(member) * 2 + s) * a.nbytes;
}

// blockIdx.y is the ring member i. Seed: own shard to its output row and
// slot 0. Step t: slot t % 2 moves to member i+1's other slot while (from
// step 1) the chunk that arrived at step t-1 is copied out. Last launch:
// the chunk of the last step is copied out.
template <int U>
__global__ void __launch_bounds__(kThreads) virtual_all_gather_kernel(Args a) {
  const int i = blockIdx.y;
  const int ring = a.ring;
  const long long n = a.nbytes;
  char* row = a.out + static_cast<long long>(i) * ring * n;
  if (a.step < 0) {
    copy_units<U>(row + i * n, comm_slot(a, i, 0),
                  a.x + static_cast<long long>(i) * n, n);
    return;
  }
  const int slot = a.step % 2;
  if (a.step < ring - 1) {
    copy_units<U>(comm_slot(a, (i + 1) % ring, 1 - slot), nullptr,
                  comm_slot(a, i, slot), n);
  }
  if (a.step > 0) {
    const int src = ag_source(i, a.step - 1, ring);
    copy_units<U>(row + src * n, nullptr, comm_slot(a, i, slot), n);
  }
}

template <int U>
cudaError_t run(const Args& base, int blocks, cudaStream_t stream) {
  Args a = base;
  const dim3 grid(blocks, a.ring);
  for (int step = -1; step < a.ring; ++step) {
    a.step = step;
    virtual_all_gather_kernel<U><<<grid, kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace vgather

// ------------------------------ K16 ---------------------------------------

namespace vreduce {

struct Args {
  const void* x;  // [ring, ring * chunk]
  void* out;      // [ring, chunk]
  void* comm;     // [ring, 2, chunk]
  long long chunk;
  int ring;
  int step;  // -1 seeds, 0 .. ring-2 moves and adds
};

// blockIdx.y is the ring member j. Seed: slot 0 holds the member's part of
// chunk rs_chunk(j, -1). Step t: member j receives member j-1's slot t % 2
// and adds its own part of chunk rs_chunk(j, t) into its other slot, or at
// the last step into its output row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    virtual_reduce_scatter_kernel(Args a) {
  const int j = blockIdx.y;
  const int ring = a.ring;
  const long long n = a.chunk;
  const T* x = static_cast<const T*>(a.x) + static_cast<long long>(j) * ring * n;
  T* comm = static_cast<T*>(a.comm);
  if (a.step < 0) {
    const int c0 = rs_chunk(j, -1, ring);
    copy_chunk<T, V>(comm + static_cast<long long>(j) * 2 * n, x + c0 * n, n);
    return;
  }
  const int slot = a.step % 2;
  const int prev = (j - 1 + ring) % ring;
  const int c = rs_chunk(j, a.step, ring);
  T* dst = a.step == ring - 2
               ? static_cast<T*>(a.out) + static_cast<long long>(j) * n
               : comm + (static_cast<long long>(j) * 2 + 1 - slot) * n;
  add_chunk<T, V>(dst, comm + (static_cast<long long>(prev) * 2 + slot) * n,
                  x + c * n, n);
}

template <typename T, int V>
cudaError_t run(const Args& base, int blocks, cudaStream_t stream) {
  Args a = base;
  const dim3 grid(blocks, a.ring);
  for (int step = -1; step < a.ring - 1; ++step) {
    a.step = step;
    virtual_reduce_scatter_kernel<T, V><<<grid, kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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

// The pad of this rank's buffer (its 12 counters) into ``out``;
// synchronises the device.
int bs_ring_read_pad(int device, const void* ptr, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return err;
  return cudaMemcpy(out, ptr, sizeof(Pad), cudaMemcpyDeviceToHost);
}

// One copy of a K12 (kernel 0) or K13 (kernel 1) plan on ``stream``:
// src0 -> dst0 (and dst2_0 if not null), and src1 -> dst1 if src1 is not
// null, nbytes each, in units of ``unit`` bytes. ``mark``/``mark_value``:
// the own slot's written word and the write this copy puts there (null:
// none); ``filled``/``filled_value``: the peer slot's written word and the
// write it must hold (null: the source is not a peer slot). ``error``: the
// group's host-mapped error word; ``abort``: its device-side word (a
// zeroed device u64). ``blocks`` 0 sizes the grid to the bytes.
int bs_ring_copy(int device, int kernel, const void* src0, void* dst0,
                 void* dst2_0, const void* src1, void* dst1, long long nbytes,
                 int unit, void* mark, unsigned long long mark_value,
                 const void* filled, unsigned long long filled_value,
                 int* error, void* abort, int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbytes <= 0 || (kernel != 0 && kernel != 1) || error == nullptr ||
      abort == nullptr)
    return cudaErrorInvalidValue;
  ringcopy::Copy c{};
  c.src[0] = static_cast<const char*>(src0);
  c.dst[0] = static_cast<char*>(dst0);
  c.dst2[0] = static_cast<char*>(dst2_0);
  c.src[1] = static_cast<const char*>(src1);
  c.dst[1] = static_cast<char*>(dst1);
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
  switch (unit) {
    case 16: return ringcopy::run<16>(kernel, c, blocks, s);
    case 8: return ringcopy::run<8>(kernel, c, blocks, s);
    case 4: return ringcopy::run<4>(kernel, c, blocks, s);
    case 2: return ringcopy::run<2>(kernel, c, blocks, s);
    case 1: return ringcopy::run<1>(kernel, c, blocks, s);
  }
  return cudaErrorInvalidValue;
}

// K14. x (ring * chunk elements, dtype 0 fp32 / 1 bf16) -> out (chunk).
// ``vector``: 16-byte lanes (chunk and addresses allow them).
int bs_ring_reduce_scatter(int device, const void* x, void* out, void* self,
                           void* left, long long chunk, long long slot_stride,
                           int rank, int ring, unsigned long long base,
                           int dtype, int vector, int* error,
                           long long timeout_ns, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (chunk <= 0 || ring < 2 || rank < 0 || rank >= ring)
    return cudaErrorInvalidValue;
  reduce::Args a{};
  a.x = x;
  a.out = out;
  a.self = static_cast<char*>(self);
  a.left = static_cast<char*>(left);
  a.chunk = chunk;
  a.slot_stride = slot_stride;
  a.rank = rank;
  a.ring = ring;
  a.base = base;
  a.ctl.error = error;
  a.ctl.timeout_ns = timeout_ns;
  const int blocks = sm_count(device);
  if (blocks <= 0) return cudaErrorInvalidDevice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return vector ? reduce::run<float, 4>(a, blocks, s)
                  : reduce::run<float, 1>(a, blocks, s);
  if (dtype == kBF16)
    return vector ? reduce::run<__nv_bfloat16, 8>(a, blocks, s)
                  : reduce::run<__nv_bfloat16, 1>(a, blocks, s);
  return cudaErrorInvalidValue;
}

// K15. x [ring, nbytes] -> out [ring, ring * nbytes]; comm: scratch of
// ring * 2 * nbytes.
int bs_virtual_all_gather(int device, const void* x, void* out, void* comm,
                          long long nbytes, int ring, int unit, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbytes <= 0 || ring < 2 || ring > 65535) return cudaErrorInvalidValue;
  vgather::Args a{};
  a.x = static_cast<const char*>(x);
  a.out = static_cast<char*>(out);
  a.comm = static_cast<char*>(comm);
  a.nbytes = nbytes;
  a.ring = ring;
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int blocks = (sms + ring - 1) / ring * 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return vgather::run<16>(a, blocks, s);
    case 8: return vgather::run<8>(a, blocks, s);
    case 4: return vgather::run<4>(a, blocks, s);
    case 2: return vgather::run<2>(a, blocks, s);
    case 1: return vgather::run<1>(a, blocks, s);
  }
  return cudaErrorInvalidValue;
}

// K16. x [ring, ring * chunk] -> out [ring, chunk] (dtype 0 fp32 / 1 bf16);
// comm: scratch of ring * 2 * chunk elements.
int bs_virtual_reduce_scatter(int device, const void* x, void* out,
                              void* comm, long long chunk, int ring,
                              int dtype, int vector, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (chunk <= 0 || ring < 2 || ring > 65535) return cudaErrorInvalidValue;
  vreduce::Args a{};
  a.x = x;
  a.out = out;
  a.comm = comm;
  a.chunk = chunk;
  a.ring = ring;
  const int sms = sm_count(device);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int blocks = (sms + ring - 1) / ring * 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return vector ? vreduce::run<float, 4>(a, blocks, s)
                  : vreduce::run<float, 1>(a, blocks, s);
  if (dtype == kBF16)
    return vector ? vreduce::run<__nv_bfloat16, 8>(a, blocks, s)
                  : vreduce::run<__nv_bfloat16, 1>(a, blocks, s);
  return cudaErrorInvalidValue;
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
