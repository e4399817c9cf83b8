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
// forwarded. ready/consumed are stored with st.release.sys and read with
// ld.acquire.sys; data in peer slots is read with ld.global.cg (L2, never a
// stale L1 line). Within one rank, the blocks of a grid count their
// arrivals on a per-slot counter; the last block raises the signal.
//
// Progress and the grid. Ranks wait on each other, and the blocks of one
// rank never wait on each other, so a rank's grid must be resident at once:
// every collective launches one block per SM (one wave). Four processes on
// one card have one context each and the card time-slices them (no MPS):
// a block spinning on a neighbour keeps its context on the card until the
// timeslice ends, so progress is sure but a wait costs timeslices.
//
// A hang becomes an error. Every spin is bounded by %globaltimer: after
// timeout_ns a block writes an error word into host-mapped memory and
// returns; every later wait that reads the word returns within 64 spins,
// and RingGroup.check raises: before the wrapper's next launch, after the
// train workload's synchronise, and in RingGroup.close. A rank that never
// arrives fails the run within the group's timeout (RingGroup.timeout_s).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 512;
constexpr long long kPadBytes = 256;
enum DType : int { kF32 = 0, kBF16 = 1 };
enum RingError : int { kOk = 0, kTimeout = 1 };

using u64 = unsigned long long;

// The signal pad at the head of every symmetric buffer.
struct Pad {
  u64 ready[2];     // slot s holds write ready[s] (set by the owner)
  u64 consumed[2];  // write consumed[s] of slot s was read (set by reader)
  u64 arrive_w[2];  // the owner's blocks that finished writing slot s
  u64 arrive_r[2];  // the owner's blocks that finished reading a peer slot
  u64 wait_ns;      // ns block 0 of the owner's kernels spent waiting
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

}  // namespace

// ------------------------------ K12 ---------------------------------------

namespace permute {

struct Args {
  const char* k;
  const char* v;
  char* k_out;
  char* v_out;
  char* self;  // this rank's symmetric buffer
  char* src;   // the buffer of the rank this one receives from
  long long nbytes;     // bytes of k (and of v)
  long long v_offset;   // v's offset inside a slot
  long long slot_stride;
  u64 epoch;  // this buffer's call number, from 1
  Ctl ctl;
};

// Send this rank's (K, V) ``shift`` hops round the ring: copy them into
// slot epoch % 2, raise ready, then pull the source rank's slot into the
// outputs and raise consumed on its pad.
template <int U>
__global__ void __launch_bounds__(kThreads, 1) ring_permute_kernel(Args a) {
  Pad* me = pad_of(a.self);
  Pad* src_pad = pad_of(a.src);
  const int s = static_cast<int>(a.epoch % 2);
  const u64 prior = a.epoch >= 2 ? a.epoch - 2 : 0;
  if (!wait_at_least(&me->consumed[s], prior, a.ctl, &me->wait_ns)) return;
  char* mine = slot_ptr(a.self, a.slot_stride, s);
  copy_units<U>(mine, nullptr, a.k, a.nbytes);
  copy_units<U>(mine + a.v_offset, nullptr, a.v, a.nbytes);
  arrive(&me->arrive_w[s], slot_round(a.epoch), &me->ready[s], a.epoch);
  if (!wait_at_least(&src_pad->ready[s], a.epoch, a.ctl, &me->wait_ns))
    return;
  const char* from = slot_ptr(a.src, a.slot_stride, s);
  copy_units<U>(a.k_out, nullptr, from, a.nbytes);
  copy_units<U>(a.v_out, nullptr, from + a.v_offset, a.nbytes);
  arrive(&me->arrive_r[s], slot_round(a.epoch), &src_pad->consumed[s],
         a.epoch);
}

template <int U>
cudaError_t run(const Args& a, int blocks, cudaStream_t stream) {
  ring_permute_kernel<U><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace permute

// ------------------------------ K13 ---------------------------------------

__device__ __forceinline__ int ag_source(int me, int step, int ring) {
  return ((me - step - 1) % ring + ring) % ring;
}

__device__ __forceinline__ int rs_chunk(int me, int step, int ring) {
  return ((me - step - 2) % ring + ring) % ring;
}

namespace gather {

struct Args {
  const char* x;  // this rank's chunk, nbytes
  char* out;      // [ring * nbytes]
  char* self;
  char* left;
  long long nbytes;
  long long slot_stride;
  int rank, ring;
  u64 base;  // writes into this buffer before this call
  Ctl ctl;
};

// The own chunk goes to its output row and to the first slot; at step t the
// chunk the left neighbour holds (source ag_source(rank, t)) is pulled into
// its output row and, except at the last step, into this rank's next slot
// for the right neighbour to pull.
template <int U>
__global__ void __launch_bounds__(kThreads, 1) ring_all_gather_kernel(Args a) {
  Pad* me = pad_of(a.self);
  Pad* left = pad_of(a.left);
  const long long n = a.nbytes;
  u64 w = a.base + 1;
  int s = static_cast<int>(w % 2);
  if (!wait_at_least(&me->consumed[s], w >= 2 ? w - 2 : 0, a.ctl,
                     &me->wait_ns))
    return;
  copy_units<U>(a.out + a.rank * n, slot_ptr(a.self, a.slot_stride, s), a.x,
                n);
  arrive(&me->arrive_w[s], slot_round(w), &me->ready[s], w);
  for (int t = 0; t < a.ring - 1; ++t) {
    const u64 r = a.base + 1 + t;  // the left neighbour's write for step t
    const int rs = static_cast<int>(r % 2);
    if (!wait_at_least(&left->ready[rs], r, a.ctl, &me->wait_ns)) return;
    const int src = ag_source(a.rank, t, a.ring);
    const char* from = slot_ptr(a.left, a.slot_stride, rs);
    char* fwd = nullptr;
    if (t < a.ring - 2) {
      w = r + 1;
      s = static_cast<int>(w % 2);
      if (!wait_at_least(&me->consumed[s], w - 2, a.ctl, &me->wait_ns))
        return;
      fwd = slot_ptr(a.self, a.slot_stride, s);
    }
    copy_units<U>(a.out + src * n, fwd, from, n);
    if (fwd != nullptr)
      arrive(&me->arrive_w[s], slot_round(w), &me->ready[s], w);
    arrive(&me->arrive_r[rs], slot_round(r), &left->consumed[rs], r);
  }
}

template <int U>
cudaError_t run(const Args& a, int blocks, cudaStream_t stream) {
  ring_all_gather_kernel<U><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace gather

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

// The pad of this rank's buffer (5 x 2 + 1 counters) into ``out``;
// synchronises the device.
int bs_ring_read_pad(int device, const void* ptr, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return err;
  return cudaMemcpy(out, ptr, sizeof(Pad), cudaMemcpyDeviceToHost);
}

// K12. k, v -> k_out, v_out (nbytes each) from the source rank's slot.
int bs_ring_permute(int device, const void* k, const void* v, void* k_out,
                    void* v_out, void* self, void* src, long long nbytes,
                    long long v_offset, long long slot_stride,
                    unsigned long long epoch, int unit, int* error,
                    long long timeout_ns, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbytes <= 0 || epoch == 0) return cudaErrorInvalidValue;
  permute::Args a{};
  a.k = static_cast<const char*>(k);
  a.v = static_cast<const char*>(v);
  a.k_out = static_cast<char*>(k_out);
  a.v_out = static_cast<char*>(v_out);
  a.self = static_cast<char*>(self);
  a.src = static_cast<char*>(src);
  a.nbytes = nbytes;
  a.v_offset = v_offset;
  a.slot_stride = slot_stride;
  a.epoch = epoch;
  a.ctl.error = error;
  a.ctl.timeout_ns = timeout_ns;
  const int blocks = sm_count(device);
  if (blocks <= 0) return cudaErrorInvalidDevice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return permute::run<16>(a, blocks, s);
    case 8: return permute::run<8>(a, blocks, s);
    case 4: return permute::run<4>(a, blocks, s);
    case 2: return permute::run<2>(a, blocks, s);
    case 1: return permute::run<1>(a, blocks, s);
  }
  return cudaErrorInvalidValue;
}

// K13. x (nbytes) -> out (ring * nbytes).
int bs_ring_all_gather(int device, const void* x, void* out, void* self,
                       void* left, long long nbytes, long long slot_stride,
                       int rank, int ring, unsigned long long base, int unit,
                       int* error, long long timeout_ns, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbytes <= 0 || ring < 2 || rank < 0 || rank >= ring)
    return cudaErrorInvalidValue;
  gather::Args a{};
  a.x = static_cast<const char*>(x);
  a.out = static_cast<char*>(out);
  a.self = static_cast<char*>(self);
  a.left = static_cast<char*>(left);
  a.nbytes = nbytes;
  a.slot_stride = slot_stride;
  a.rank = rank;
  a.ring = ring;
  a.base = base;
  a.ctl.error = error;
  a.ctl.timeout_ns = timeout_ns;
  const int blocks = sm_count(device);
  if (blocks <= 0) return cudaErrorInvalidDevice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return gather::run<16>(a, blocks, s);
    case 8: return gather::run<8>(a, blocks, s);
    case 4: return gather::run<4>(a, blocks, s);
    case 2: return gather::run<2>(a, blocks, s);
    case 1: return gather::run<1>(a, blocks, s);
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

const char* bs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
