// The host-level barrier (B14) and the ring ping of the shmem layer, written
// by hand for Hopper (sm_90a), and the mapped host memory of the layer's
// error report.
//
// Replaces the TPU kernel B14, barrier_all_op (the pallas_call at
// triton_dist_tpu/ops/common.py:112, over shmem/device.py:326-360's
// barrier_all): every rank signals every other rank's barrier word and
// waits for n - 1 arrivals, then writes 1. The ring ping is the port of
// tutorials/t01_notify_wait.py, the layer's first gate: each rank puts its
// block into its right neighbour's buffer and signals, and waits for its
// left neighbour's block.
//
// Over an axis inside a multi-axis mesh the barrier runs in groups (a
// Group, shmem.cuh): one launch still covers every rank, and each rank
// signals and waits on the members of its own group only.
//
// What bounds them on this card: latency. A barrier is a few hundred bytes
// of signal traffic; its time is the L2 round trips of n - 1 release adds
// and one acquire spin. The ping adds one block-cooperative copy.
//
// What the design does about it: one block per rank, one launch for all
// ranks, the signals released by one thread after the block has met, the
// spin an acquire load with a short sleep. Both are in shmem.cuh, which
// the collectives reuse as their entry barrier.

#include "shmem.cuh"

#include <string.h>

using namespace tdt_shmem;

namespace {

constexpr int kThreads = 128;

// grid (1, n); out [n] int32, rank r's word at r
__global__ void __launch_bounds__(kThreads)
    barrier_all_kernel(PeerTable pads, int* out, Group G, Launch L) {
  if (!barrier_group_block(pads, 0, G, L)) return;
  if (threadIdx.x == 0) out[my_pe()] = 1;
}

// grid (1, n). Pad words: [0] the entry barrier, [1] the delivery flag.
// `silent` names a rank that puts but never signals (the hang check); -1
// for none.
__global__ void __launch_bounds__(kThreads)
    ring_ping_kernel(PeerTable src, PeerTable dst, long long nbytes, PeerTable pads, int silent,
                     Launch L) {
  const int me = my_pe();
  if (!barrier_all_block(pads, 0, L)) return;
  const int right = pe_at(me + 1);
  putmem_nbi_block(symm_at<unsigned char>(dst, right), symm_at<const unsigned char>(src, me),
                   nbytes);
  if (me != silent)
    signal_op_block(symm_at<int>(pads, right) + 1, 1);
  else
    __syncthreads();
  if (!wait_block(symm_at<int>(pads, me) + 1, 1, true, L, 1)) return;
  quiet();
}

}  // namespace

extern "C" {

// pads: n pointers to each rank's barrier pad (>= 1 int32 word, zero);
// out: [n] int32; group: the barrier's groups over the n ranks.
int tdt_barrier_all(const void* const* pads, int n, void* out, const void* group, void* claim,
                    void* report, unsigned long long budget_ns, void* stream) {
  if (n < 1 || n > kMaxPes || out == nullptr || group == nullptr)
    return (int)cudaErrorInvalidValue;
  const Group G = *static_cast<const Group*>(group);
  return launch_cooperative(barrier_all_kernel, dim3(1, n), dim3(kThreads), 0, stream,
                            make_table(pads, n), out, G,
                            make_launch(claim, report, budget_ns, kBarrierAll));
}

// src / dst: n pointers to each rank's nbytes-long block; pads: n pointers
// to pads of >= 2 zero words.
int tdt_ring_ping(const void* const* src, const void* const* dst, long long nbytes,
                  const void* const* pads, int n, int silent, void* claim, void* report,
                  unsigned long long budget_ns, void* stream) {
  if (n < 1 || n > kMaxPes || nbytes <= 0) return (int)cudaErrorInvalidValue;
  return launch_cooperative(ring_ping_kernel, dim3(1, n), dim3(kThreads), 0, stream,
                            make_table(src, n), make_table(dst, n), nbytes, make_table(pads, n),
                            silent, make_launch(claim, report, budget_ns, kRingPing));
}

// `words` int32 of zeroed host memory mapped into the device's address
// space: the error report the kernels write and the host reads without a
// synchronisation. *host and *dev receive its two addresses.
int tdt_shmem_host_alloc(int words, void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, (size_t)words * sizeof(int), cudaHostAllocMapped);
  if (e != cudaSuccess) return (int)e;
  memset(*host, 0, (size_t)words * sizeof(int));
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
