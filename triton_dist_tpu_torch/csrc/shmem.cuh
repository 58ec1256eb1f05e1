// The device half of the port's shmem layer: `__device__` functions that the
// collective kernels of this directory include.
//
// Counterpart of triton_dist_tpu/shmem/device.py (my_pe, n_pes, pe_at,
// putmem_nbi/putmem_block, signal_op, signal_wait_until, quiet, fence,
// barrier_all, barrier_pair) and of language.py's dl.* names (rank,
// num_ranks, wait, consume_token, notify, symm_at).
//
// How n ranks run on one card: one process, one launch per collective call,
// the rank as the grid's y dimension (my_pe() == blockIdx.y). Every block of
// the launch is resident at once (the launches are cooperative, and a grid
// that does not fit is refused), so a block may spin on a flag that a block
// of another rank sets. A kernel reaches a peer's buffer only through a
// PeerTable: the n base pointers of a symmetric buffer, filled by the host
// and passed by value. It never computes a peer's address from its own, so
// pointers mapped from other processes or cards can fill the same table.
//
// Signals are 32-bit words of a symmetric signal pad, one pad per kernel
// family (the port's collective_id_for: two families never share a word).
// signal_wait_until consumes what it waited for, as the TPU's semaphores do,
// so a pad is all zeros again after every call and the next call starts
// clean. Memory order: a producer's threads store, the block meets at
// __syncthreads(), then one thread fences and signals with a release; the
// consumer spins with an acquire load, the block meets, and the data is read
// with ld.global.cg (L2, never a stale L1 line). TDT_SHMEM_SCOPE is the one
// switch of scope: "gpu" for ranks on one card, "sys" for cards joined by
// NVLink.
//
// Groups: a collective over one axis (or several) of a multi-axis mesh
// runs in groups, the ranks that share every other coordinate. One launch
// still covers every rank of the mesh; a Group carries each rank's index
// in its group and its group's flat ids (row-major over the axes, as JAX's
// pe_at_group gives them), and a rank signals, waits on and puts to the
// members of its own group only. The whole mesh is one group.
//
// Every spin is bounded: a wait that runs past its budget (about a second)
// claims the launch's error report, writes which kernel, rank and signal
// starved, and makes its block return; the host raises when it reads the
// report. A protocol bug fails its call instead of hanging the card.
//
// The traced build (compiled with -DTDT_SHMEM_TRACE; analysis/capture.py
// loads it) logs the protocol instead of running it: every signal (the
// raw red_release_add included, so the kernels that call it directly are
// covered), every wait, every putmem_block, the barriers' signals and
// waits, and the puts, reads and writes a kernel marks with TDT_TRACE_PUT,
// TDT_TRACE_READ and TDT_TRACE_WRITE append one fixed-size record (a global sequence number
// from one atomicAdd, rank, lane, kind, word address, value, dst and src
// address, bytes, and the launch it came from) to a log in device memory.
// A traced wait records and
// returns true at once: it neither spins nor consumes, so a broken protocol
// runs to its end and the checker (analysis/checker.py) decides, over the
// whole log, what would starve or deadlock. Without the switch the marks
// compile to nothing and every kernel is what it was.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <tuple>

#ifndef TDT_SHMEM_SCOPE
#define TDT_SHMEM_SCOPE "gpu"
#endif

namespace tdt_shmem {

constexpr int kMaxPes = 8;

// the kernels that report a starved spin (shmem/device.py KERNELS)
enum Kernel : int {
  kBarrierAll = 1,
  kRingPing = 2,
  kAgPush = 3,
  kAgRing = 4,
  kRsRing = 5,
  kLlAgMerge = 6,
  kAgGemm = 7,
  kGemmRs = 8,
  kA2aPush = 9,
  kA2aSeg = 10,
  kFdFoldDist = 11,
  kPoolAg = 12,
  kPagedTransport = 13,
  kAgMoe = 14,
  kMoeRs = 15,
  kAgLl = 16,
  kAgPush2d = 17,
  kBcast = 18,
  kAgGemm2d = 19,
  kAgMoe2d = 20,
  kRingAttnFwd = 21,
  kRingAttnBwd = 22,
  kGallery = 23,
};

// The n base pointers of one symmetric buffer, rank r's at ptr[r].
struct PeerTable {
  void* ptr[kMaxPes];
};

// The groups of a launch: rank r is member index[r] of a group of n ranks,
// whose member i is flat rank pe[r][i].
struct Group {
  int n;
  signed char index[kMaxPes];
  signed char pe[kMaxPes][kMaxPes];
};

// What every launch of the layer carries: the error report and the budget
// of a spin.
struct Launch {
  int* claim;                  // device word: 0 until an error claims it
  volatile int* report;        // mapped host memory: set, kernel, rank, signal
  unsigned long long budget_ns;
  int kernel;
};

// the table of `n` pointers from the host's array (entries past n are null)
inline PeerTable make_table(const void* const* ptrs, int n) {
  PeerTable t;
  for (int i = 0; i < kMaxPes; ++i) t.ptr[i] = i < n ? const_cast<void*>(ptrs[i]) : nullptr;
  return t;
}

#ifdef TDT_SHMEM_TRACE
__global__ void trace_next_launch();  // the traced build's log, below
#endif

// One launch covering every rank: cooperative, so a grid whose blocks
// cannot all be resident at once is refused at launch (a spin would
// otherwise wait on a block that never runs). Each argument is converted to the kernel's
// parameter type. Returns the launch's cudaError_t.
template <typename... KArgs, typename... Args>
inline int launch_cooperative(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem,
                              void* stream, Args... args) {
  static_assert(sizeof...(KArgs) == sizeof...(Args), "one value per kernel parameter");
  std::tuple<KArgs...> values(static_cast<KArgs>(args)...);
  void* params[sizeof...(KArgs)];
  std::apply([&](auto&... v) {
    int i = 0;
    ((params[i++] = static_cast<void*>(&v)), ...);
  }, values);
#ifdef TDT_SHMEM_TRACE
  trace_next_launch<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
#endif
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                                    block, params, smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the most blocks of one launch a collective keeps on each SM: the rest of
// the SM stays free for the compute it overlaps
constexpr int kLaneBlocksPerSm = 2;

// `lanes` cut to what a grid (lanes, n) of `kernel` can keep resident on
// the current device (its SM count times the blocks of `threads`, each with
// `smem` bytes of dynamic shared memory, an SM holds at once, at most
// `per_sm_cap`: kLaneBlocksPerSm for a collective beside compute, more for
// a kernel whose lanes are the compute); 0 when not one lane fits or the
// device cannot be asked.
template <typename K>
inline int resident_lanes(K kernel, int threads, int lanes, int n, size_t smem = 0,
                          int per_sm_cap = kLaneBlocksPerSm) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return 0;
  const int fit = sms * (per_sm < per_sm_cap ? per_sm : per_sm_cap) / n;
  return lanes < fit ? lanes : fit;
}

inline Launch make_launch(void* claim, void* report, unsigned long long budget_ns, int kernel) {
  return Launch{static_cast<int*>(claim), static_cast<volatile int*>(report), budget_ns, kernel};
}

// ---------------------------------------------------------------------------
// identity
// ---------------------------------------------------------------------------

__device__ __forceinline__ int my_pe() { return blockIdx.y; }
__device__ __forceinline__ int n_pes() { return gridDim.y; }
// the flat id of the rank at `index` along the launch's axis (wrapped)
__device__ __forceinline__ int pe_at(int index) {
  const int n = n_pes();
  return ((index % n) + n) % n;
}

// this rank's index in its group, the group's size, and the flat id of
// the member at `index` (wrapped)
__device__ __forceinline__ int group_me(const Group& g) { return g.index[blockIdx.y]; }
__device__ __forceinline__ int group_n(const Group& g) { return g.n; }
__device__ __forceinline__ int group_pe(const Group& g, int index) {
  const int n = g.n;
  return g.pe[blockIdx.y][((index % n) + n) % n];
}

// rank `pe`'s buffer of a symmetric tensor: the reference's symm_at
template <typename T>
__device__ __forceinline__ T* symm_at(const PeerTable& t, int pe) {
  return static_cast<T*>(t.ptr[pe]);
}

// ---------------------------------------------------------------------------
// the traced build's log
// ---------------------------------------------------------------------------

// record kinds (analysis/capture.py TRACE_KINDS)
enum TraceKind : int {
  kTrSignal = 1,
  kTrSignalSet = 2,
  kTrWait = 3,
  kTrWaitPeek = 4,
  kTrPut = 5,
  kTrRead = 6,
  kTrWrite = 7,
};
constexpr int kTraceWords = 10;  // int64 words a record

#ifdef TDT_SHMEM_TRACE
// the log: records of kTraceWords int64 each, the count of records taken
// (past `capacity` they are counted, not written: the host raises), and
// the launch counter, which every cooperative launch of a traced library
// raises by one before it starts (launch_cooperative)
struct TraceLog {
  long long* rec;
  unsigned long long* count;
  long long capacity;
  unsigned long long* launch;
};
__device__ TraceLog g_trace_log;

__global__ void trace_next_launch() {
  if (g_trace_log.launch != nullptr) atomicAdd(g_trace_log.launch, 1ULL);
}

// one record from the calling thread: seq, rank, lane, kind, word, value,
// dst, src, bytes
__device__ __noinline__ void trace_record(int kind, const void* word, long long value,
                                          const void* dst, const void* src, long long bytes) {
  if (g_trace_log.count == nullptr || g_trace_log.launch == nullptr) return;
  const unsigned long long i = atomicAdd(g_trace_log.count, 1ULL);
  if ((long long)i >= g_trace_log.capacity) return;
  long long* r = g_trace_log.rec + i * kTraceWords;
  r[0] = (long long)i;
  r[1] = blockIdx.y;
  r[2] = blockIdx.x;
  r[3] = kind;
  r[4] = reinterpret_cast<long long>(word);
  r[5] = value;
  r[6] = reinterpret_cast<long long>(dst);
  r[7] = reinterpret_cast<long long>(src);
  r[8] = bytes;
  r[9] = (long long)*reinterpret_cast<volatile unsigned long long*>(g_trace_log.launch);
}
#define TDT_TRACE(...) ::tdt_shmem::trace_record(__VA_ARGS__)
// a read or write of [ptr, ptr + bytes) that the ordering rule checks, and
// a put written as a kernel's own copy loop (putmem_block logs itself); all
// threads of the block call them, thread 0 records
#define TDT_TRACE_PUT(dst, src, bytes)                                            \
  do {                                                                            \
    if (threadIdx.x == 0)                                                         \
      ::tdt_shmem::trace_record(::tdt_shmem::kTrPut, nullptr, 0, (dst), (src),     \
                                (long long)(bytes));                              \
  } while (0)
#define TDT_TRACE_READ(ptr, bytes)                                                \
  do {                                                                            \
    if (threadIdx.x == 0)                                                         \
      ::tdt_shmem::trace_record(::tdt_shmem::kTrRead, nullptr, 0, nullptr, (ptr),  \
                                (long long)(bytes));                              \
  } while (0)
#define TDT_TRACE_WRITE(ptr, bytes)                                               \
  do {                                                                            \
    if (threadIdx.x == 0)                                                         \
      ::tdt_shmem::trace_record(::tdt_shmem::kTrWrite, nullptr, 0, (ptr), nullptr, \
                                (long long)(bytes));                              \
  } while (0)
#else
#define TDT_TRACE(...) ((void)0)
#define TDT_TRACE_PUT(dst, src, bytes) ((void)0)
#define TDT_TRACE_READ(ptr, bytes) ((void)0)
#define TDT_TRACE_WRITE(ptr, bytes) ((void)0)
#endif

// ---------------------------------------------------------------------------
// ordered loads and stores of signal words
// ---------------------------------------------------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire." TDT_SHMEM_SCOPE ".global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  TDT_TRACE(kTrSignal, p, v, nullptr, nullptr, 0);
  asm volatile("red.release." TDT_SHMEM_SCOPE ".global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_release(int* p, int v) {
  TDT_TRACE(kTrSignalSet, p, v, nullptr, nullptr, 0);
  asm volatile("st.release." TDT_SHMEM_SCOPE ".global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void red_relaxed_add(int* p, int v) {
  asm volatile("red.relaxed." TDT_SHMEM_SCOPE ".global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---------------------------------------------------------------------------
// ordering
// ---------------------------------------------------------------------------

// every store this thread made is performed for the peers (the reference's
// quiet; the port's puts are plain stores, so completion is a fence)
__device__ __forceinline__ void quiet() { __threadfence(); }
// puts to one peer stay in order (the reference's fence)
__device__ __forceinline__ void fence() { __threadfence(); }

// ---------------------------------------------------------------------------
// signals
// ---------------------------------------------------------------------------

enum SignalOp : int { kSignalSet = 0, kSignalAdd = 1 };

// one thread: `sig` (a word of some rank's pad) set to or increased by
// `value`, with a release, so that what this thread stored before is seen
// by whoever acquires the word
__device__ __forceinline__ void signal_op(int* sig, int value, int op = kSignalAdd) {
  if (op == kSignalSet)
    st_release(sig, value);
  else
    red_release_add(sig, value);
}

// one thread: record that `signal` of `kernel` starved on this rank; the
// first error of the launch wins the claim and writes the report
__device__ __noinline__ void report_starved(const Launch& L, int signal) {
  if (atomicCAS(L.claim, 0, 1) == 0) {
    L.report[1] = L.kernel;
    L.report[2] = my_pe();
    L.report[3] = signal;
    __threadfence_system();
    L.report[0] = 1;
    __threadfence_system();
  }
}

// one thread: spin until `*sig >= value` (acquire), then, with `consume`,
// take `value` back off the word as the TPU's semaphore wait does. Returns
// false, after reporting, when the budget runs out or another block of the
// launch has already reported. The traced build records the wait and
// returns true.
__device__ __noinline__ bool signal_wait_until(int* sig, int value, bool consume,
                                               const Launch& L, int signal) {
#ifdef TDT_SHMEM_TRACE
  TDT_TRACE(consume ? kTrWait : kTrWaitPeek, sig, value, nullptr, nullptr, 0);
  return true;
#endif
  const unsigned long long t0 = global_ns();
  for (unsigned polls = 1; ld_acquire(sig) < value; ++polls) {
    if (polls % 64 == 0) {
      if (*reinterpret_cast<volatile int*>(L.claim) != 0) return false;
      if (global_ns() - t0 > L.budget_ns) {
        report_starved(L, signal);
        return false;
      }
    }
    __nanosleep(32);
  }
  if (consume) red_relaxed_add(sig, -value);
  return true;
}

// The block's stores so far, then one signal: the producer's half of every
// protocol. All threads of the block call it.
__device__ __forceinline__ void signal_op_block(int* sig, int value, int op = kSignalAdd) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    signal_op(sig, value, op);
  }
}

// The consumer's half: one thread waits, the block meets, and every thread
// may read what the signal covers. All threads call it; false on error.
__device__ __forceinline__ bool wait_block(int* sig, int value, bool consume, const Launch& L,
                                           int signal) {
  int ok = 1;
  if (threadIdx.x == 0) ok = signal_wait_until(sig, value, consume, L, signal);
  return __syncthreads_and(ok);
}

// ---------------------------------------------------------------------------
// puts: block-cooperative copies into a peer's buffer
// ---------------------------------------------------------------------------

// bytes [0, nbytes) of src to dst by every thread of the block, 16 bytes at
// a time where both are 16-byte aligned; the source is read through L2, so a
// segment that another block delivered is never read stale
__device__ __forceinline__ void putmem_block(void* dst, const void* src, long long nbytes) {
  if (threadIdx.x == 0) TDT_TRACE(kTrPut, nullptr, 0, dst, src, nbytes);
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) % 16) == 0;
  long long done = 0;
  if (vec) {
    const long long nv = nbytes / 16;
    const uint4* s = static_cast<const uint4*>(src);
    uint4* d = static_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) d[i] = __ldcg(s + i);
    done = nv * 16;
  }
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(dst);
  for (long long i = done + threadIdx.x; i < nbytes; i += blockDim.x) d[i] = __ldcg(s + i);
}

// the put of the reference's nbi form: the port's stores are issued at once
// and completed by quiet(), so it is the same copy
__device__ __forceinline__ void putmem_nbi_block(void* dst, const void* src, long long nbytes) {
  putmem_block(dst, src, nbytes);
}

// put, then signal the peer's word once every thread's stores are performed
__device__ __forceinline__ void putmem_signal_block(void* dst, const void* src, long long nbytes,
                                                    int* sig, int value, int op = kSignalAdd) {
  putmem_block(dst, src, nbytes);
  signal_op_block(sig, value, op);
}

// ---------------------------------------------------------------------------
// barriers
// ---------------------------------------------------------------------------

// Barrier of the blocks at this blockIdx.x across every rank of the launch,
// on `word` of the family's pad: signal every other rank, wait for n - 1
// arrivals and consume them. Stores made before it are seen after it. All
// threads call it; false on error.
__device__ __forceinline__ bool barrier_all_block(const PeerTable& pads, int word, const Launch& L) {
  const int me = my_pe();
  const int n = n_pes();
  __syncthreads();
  int ok = 1;
  if (threadIdx.x == 0) {
    __threadfence();
    for (int p = 0; p < n; ++p)
      if (p != me) red_release_add(symm_at<int>(pads, p) + word, 1);
    ok = signal_wait_until(symm_at<int>(pads, me) + word, n - 1, true, L, word);
  }
  return __syncthreads_and(ok);
}

// The same barrier across the members of this rank's group only.
__device__ __forceinline__ bool barrier_group_block(const PeerTable& pads, int word, const Group& g,
                                                    const Launch& L) {
  const int me = group_me(g);
  const int n = group_n(g);
  __syncthreads();
  int ok = 1;
  if (threadIdx.x == 0) {
    __threadfence();
    for (int p = 0; p < n; ++p)
      if (p != me) red_release_add(symm_at<int>(pads, group_pe(g, p)) + word, 1);
    ok = signal_wait_until(symm_at<int>(pads, my_pe()) + word, n - 1, true, L, word);
  }
  return __syncthreads_and(ok);
}

// Barrier of this block with the one at the same blockIdx.x on `peer`.
__device__ __forceinline__ bool barrier_pair_block(const PeerTable& pads, int word, int peer,
                                                   const Launch& L) {
  __syncthreads();
  int ok = 1;
  if (threadIdx.x == 0) {
    __threadfence();
    red_release_add(symm_at<int>(pads, peer) + word, 1);
    ok = signal_wait_until(symm_at<int>(pads, my_pe()) + word, 1, true, L, word);
  }
  return __syncthreads_and(ok);
}

// ---------------------------------------------------------------------------
// counted arrivals and the finish word of the overlap kernels
// ---------------------------------------------------------------------------

// The pad of an overlap kernel (grid (lanes, n)): words [0, lanes) are the
// entry barrier (consumed by its wait), [lanes + s] counts arrivals for
// segment s, and [lanes + n] is the rank's finish word. Many blocks wait on
// one count, so no wait consumes it: each block, once it reads no count any
// more, adds one to the finish word, and the last block of the rank waits
// for every count to be complete, consumes it and zeroes the finish word,
// so the pad is zero again after the call.
__device__ __forceinline__ int count_word(int s) { return gridDim.x + s; }
__device__ __forceinline__ int finish_word() { return gridDim.x + gridDim.y; }

// One thread: this block's arrival on a finish word counted by `lanes`
// blocks; true for the last to arrive. The traced build logs the arrival as
// a signal of 1 and the last block's decision as a wait that takes all
// `lanes` arrivals: what the last block does next happens after every
// block's arrival.
__device__ __forceinline__ bool arrive_last(int* finish, int lanes) {
  TDT_TRACE(kTrSignal, finish, 1, nullptr, nullptr, 0);
  const bool last = atomicAdd(finish, 1) == lanes - 1;
  if (last) TDT_TRACE(kTrWait, finish, lanes, nullptr, nullptr, 0);
  return last;
}

// The end of the call for one block, which reads no count of its rank's pad
// any more: the last block of the rank to get here waits until the count of
// every segment but `skip` holds `value`, consumes them all and zeroes the
// finish word. The segments are the launch's ranks, or the `segments`
// members of a group. All threads call it; false on error.
__device__ __noinline__ bool finish_block(int* pad, int value, int skip, const Launch& L,
                                          int segments = -1) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = arrive_last(pad + finish_word(), (int)gridDim.x);
  }
  __syncthreads();
  if (!last) return true;
  if (segments < 0) segments = (int)gridDim.y;
  for (int s = 0; s < segments; ++s)
    if (s != skip && !wait_block(pad + count_word(s), value, true, L, count_word(s)))
      return false;
  if (threadIdx.x == 0) atomicExch(pad + finish_word(), 0);
  return true;
}

}  // namespace tdt_shmem

#ifdef TDT_SHMEM_TRACE
// Point the traced library's kernels at a log: `records` holds `capacity`
// records of kTraceWords int64, `count` the number taken, `launch` the
// launch counter (zero both before a capture). Returns the cudaError_t of
// the copy.
extern "C" int tdt_trace_attach(void* records, void* count, long long capacity, void* launch) {
  const tdt_shmem::TraceLog log{static_cast<long long*>(records),
                                static_cast<unsigned long long*>(count), capacity,
                                static_cast<unsigned long long*>(launch)};
  return (int)cudaMemcpyToSymbol(tdt_shmem::g_trace_log, &log, sizeof(log));
}
#endif

// The names of the reference's distributed language (language.py's dl.*).
namespace dl {

__device__ __forceinline__ int rank() { return tdt_shmem::my_pe(); }
__device__ __forceinline__ int num_ranks() { return tdt_shmem::n_pes(); }

template <typename T>
__device__ __forceinline__ T* symm_at(const tdt_shmem::PeerTable& t, int pe) {
  return tdt_shmem::symm_at<T>(t, pe);
}

// block-wide wait until `*sig >= value`, without consuming; the token it
// returns orders the loads that consume_token guards
__device__ __forceinline__ bool wait(int* sig, int value, const tdt_shmem::Launch& L, int signal) {
  return tdt_shmem::wait_block(sig, value, false, L, signal);
}

// the acquire and the block's barrier in wait() already order every later
// load, so the value passes through
template <typename T>
__device__ __forceinline__ T consume_token(T value, bool /*token*/) {
  return value;
}

// set or add `value` on rank `pe`'s word `word` of the pad, after this
// block's stores
__device__ __forceinline__ void notify(const tdt_shmem::PeerTable& pads, int pe, int word, int value,
                                       int op = tdt_shmem::kSignalAdd) {
  tdt_shmem::signal_op_block(tdt_shmem::symm_at<int>(pads, pe) + word, value, op);
}

}  // namespace dl
