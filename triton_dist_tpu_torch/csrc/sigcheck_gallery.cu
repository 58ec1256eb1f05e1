// The broken-protocol gallery (B26): eight kernels that wire the shmem
// layer's signal protocol wrong on purpose, each in one way, written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel B26: the specimens of
// triton_dist_tpu/analysis/gallery.py (:36-196), which _dma_call (:213, its
// pallas_call at :222) and _flag_call (:239, :248) run. Each specimen is
// written over shmem.cuh as the port's B9 push (allgather.cu) and the
// counted-signal families write their protocols, with the reference's
// defect. The traced build (-DTDT_SHMEM_TRACE) logs the protocol, and the
// checker (analysis/checker.py) must flag each specimen with its kind of
// finding; the untraced build runs it, so a starved specimen reports its
// kernel, rank and word through the bounded spin, and an over-signalled one
// leaves its residue in the pad.
//
// One launch covers every rank: grid (1, n), one block (lane) a rank, the
// rank on y, cooperative. Each rank's shard is `bytes` (8 rows of 128 f32,
// the reference's _M); `out` holds n slots of a shard a rank. Pad words:
// [0] the entry barrier or the specimen's one counter, [1 + s] the delivery
// of slot s (missing_wait), [1] and [2] the low and high halves
// (swapped_sem).

#include "shmem.cuh"

using namespace tdt_shmem;

namespace {

constexpr int kThreads = 128;

enum Specimen : int {
  kMissingWait = 0,
  kDroppedSignal = 1,
  kSegDroppedSignal = 2,
  kLendDroppedLastSignal = 3,
  kFoldDroppedSliceSignal = 4,
  kOverSignal = 5,
  kSwappedSem = 6,
  kWaitCycle = 7,
  kSpecimens = 8,
};

// one thread: add `inc` to word `word` of rank `pe`'s pad
__device__ __forceinline__ void signal_to(const PeerTable& pads, int pe, int word, int inc) {
  __threadfence();
  signal_op(symm_at<int>(pads, pe) + word, inc);
}

// the flag specimens' payload: the shard into the rank's first slot
__device__ void copy_shard(const PeerTable& in, const PeerTable& out, long long bytes) {
  const int me = my_pe();
  const unsigned char* s = symm_at<const unsigned char>(in, me);
  unsigned char* d = symm_at<unsigned char>(out, me);
  for (long long i = threadIdx.x; i < bytes; i += blockDim.x) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
    gallery_kernel(int specimen, PeerTable in, PeerTable out, long long bytes, PeerTable pads,
                   Launch L) {
  const int me = my_pe();
  const int n = n_pes();
  int* pad = symm_at<int>(pads, me);
  const unsigned char* shard = symm_at<const unsigned char>(in, me);
  unsigned char* mine = symm_at<unsigned char>(out, me);
  const int t0 = threadIdx.x == 0;
  switch (specimen) {
    case kMissingWait: {
      // B9's push, whose consumer reads the gathered slots with no wait
      if (!barrier_all_block(pads, 0, L)) return;
      putmem_block(mine + me * bytes, shard, bytes);
      for (int p = 1; p < n; ++p) {
        const int dst = (me + p) % n;
        putmem_signal_block(symm_at<unsigned char>(out, dst) + me * bytes, shard, bytes,
                            symm_at<int>(pads, dst) + 1 + me, 1);
      }
      __syncthreads();
      // BUG: no wait on any peer's delivery before slot 0 is read
      TDT_TRACE_READ(mine, bytes);
      TDT_TRACE_WRITE(mine + me * bytes, bytes);
      const float* s0 = reinterpret_cast<const float*>(mine);
      float* own = reinterpret_cast<float*>(mine + me * bytes);
      for (long long i = threadIdx.x; i < bytes / 4; i += blockDim.x) own[i] = __ldcg(s0 + i) + 1.f;
      quiet();
      return;
    }
    case kDroppedSignal:
      // an arrival count that forgets the self-arrival: n - 1 signals, n awaited
      if (t0)
        for (int p = 1; p < n; ++p) signal_to(pads, (me + p) % n, 0, 1);
      if (!wait_block(pad, n, true, L, 0)) return;
      break;
    case kSegDroppedSignal: {
      // two segments a peer are budgeted; segment 1 is never announced
      const int segments = 2;
      if (t0)
        for (int p = 1; p < n; ++p)
          for (int s = 0; s < segments - 1; ++s) signal_to(pads, (me + p) % n, 0, 1);
      if (!wait_block(pad, segments * (n - 1), true, L, 0)) return;
      break;
    }
    case kLendDroppedLastSignal: {
      // the lender announces pages - 1 of its pages; the borrower awaits all
      const int pages = 3, lender = 0, borrower = 1;
      if (me == lender && t0)
        for (int p = 0; p < pages - 1; ++p) signal_to(pads, borrower, 0, 1);
      if (me == borrower && !wait_block(pad, pages, true, L, 0)) return;
      break;
    }
    case kFoldDroppedSliceSignal:
      // rank 0 never announces its slab; every rank folds n - 1 slabs
      if (me != 0 && t0)
        for (int p = 1; p < n; ++p) signal_to(pads, (me + p) % n, 0, 1);
      for (int s = 0; s < n - 1; ++s)
        if (!wait_block(pad, 1, true, L, 0)) return;
      break;
    case kOverSignal:
      // increments of 2 against a budget of 1 a peer: n - 1 left behind
      if (t0)
        for (int p = 1; p < n; ++p) signal_to(pads, (me + p) % n, 0, 2);
      if (!wait_block(pad, n - 1, true, L, 0)) return;
      break;
    case kSwappedSem: {
      // two halves to the right neighbour, each announced on its own word
      // (the high half first); the consumer reads the low half after the
      // high half's word, which does not cover the low half's put
      if (!barrier_all_block(pads, 0, L)) return;
      const long long half = bytes / 2;
      unsigned char* right = symm_at<unsigned char>(out, (me + 1) % n);
      int* right_pad = symm_at<int>(pads, (me + 1) % n);
      putmem_signal_block(right + half, shard + half, half, right_pad + 2, 1);
      putmem_signal_block(right, shard, half, right_pad + 1, 1);
      float* lo = reinterpret_cast<float*>(mine);
      float* hi = reinterpret_cast<float*>(mine + half);
      // BUG: the low half's read waits on the high half's word
      if (!wait_block(pad + 2, 1, true, L, 2)) return;
      TDT_TRACE_READ(mine, half);
      TDT_TRACE_WRITE(mine, half);
      for (long long i = threadIdx.x; i < half / 4; i += blockDim.x) lo[i] = __ldcg(lo + i) + 1.f;
      if (!wait_block(pad + 1, 1, true, L, 1)) return;
      TDT_TRACE_READ(mine + half, half);
      TDT_TRACE_WRITE(mine + half, half);
      for (long long i = threadIdx.x; i < half / 4; i += blockDim.x) hi[i] = __ldcg(hi + i) + 1.f;
      quiet();
      return;
    }
    case kWaitCycle:
      // every rank waits for its left neighbour's token before sending its own
      if (!wait_block(pad, 1, true, L, 0)) return;
      if (t0) signal_to(pads, (me + 1) % n, 0, 1);
      break;
  }
  copy_shard(in, out, bytes);
}

}  // namespace

extern "C" {

// One specimen over n ranks: in, out and pads are n pointers each (a
// shard of `bytes`, n slots of it, a pad of >= 3 zero words a rank).
int tdt_sigcheck_gallery(int specimen, const void* const* in, const void* const* out,
                         long long bytes, const void* const* pads, int n, void* claim,
                         void* report, unsigned long long budget_ns, void* stream) {
  if (specimen < 0 || specimen >= kSpecimens || n < 2 || n > kMaxPes || bytes <= 0 ||
      bytes % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return launch_cooperative(gallery_kernel, dim3(1, n), dim3(kThreads), 0, stream, specimen,
                            make_table(in, n), make_table(out, n), bytes, make_table(pads, n),
                            make_launch(claim, report, budget_ns, kGallery));
}

const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
