// The paged KV transport between two roles, written by hand for Hopper
// (sm_90a): the disaggregated engine's prefill-to-decode page migration and
// the cluster's page lending.
//
// Replaces the TPU kernel B23, paged_transport (the pallas_call at
// triton_dist_tpu/ops/page_migrate.py:238 over _transport_kernel :67). The
// pools are symmetric: each rank holds [L, P + 1, Hkv, page_size, D] of K
// and of V, page 0 of each its scratch page. One cooperative launch covers
// every rank of the mesh, behind an entry barrier (the pad's words are
// reused from call to call):
//
// - the producer's lanes copy each (page i, layer l) of K and of V from its
//   page src_ids[i] to the consumer's page dst_ids[i], for i < n_pages
//   only (an entry past n_pages is never read), then each lane signals the
//   consumer's chunk word with the count of (page, layer) puts it made,
//   after its stores: n_pages x L arrivals for the chunk in all;
// - the consumer waits for those n_pages x L arrivals (consumed, so the
//   pad is zero after the call) and only then writes its landed report
//   (n_pages, tag): the report is never seen before every covered page has
//   landed. The producer reports (n_pages, tag) after its puts;
// - ranks outside the pair take part in the entry barrier only and report
//   (0, tag).
//
// The page ids, n_pages and the tag are read from device memory, so one
// build serves every chunk. With `silent` the producer puts but never
// signals: the consumer's wait runs out of its budget and reports, and the
// host raises (the starvation check).
//
// What bounds it on this card: bytes, 2 x n_pages x L pages read once and
// written once. What the design does about it: the n_pages x L (page,
// layer) items are spread over every resident lane of the producer, each
// page a block-cooperative copy in 16-byte vectors read through L2.

#include "shmem.cuh"

using namespace tdt_shmem;

namespace {

constexpr int kThreads = 256;

// grid (lanes, n). kpool / vpool: each rank's pools, L layers of pages
// pages of page_bytes; src / dst: [pmax] int32 page ids; nt: (n_pages, tag);
// landed: [n, 2] int32, each rank's report. Pad words: [0, lanes) the entry
// barrier, word lanes the consumer's chunk word.
__global__ void __launch_bounds__(kThreads)
    transport_kernel(PeerTable kpool, PeerTable vpool, const int* __restrict__ src,
                     const int* __restrict__ dst, const int* __restrict__ nt,
                     int* __restrict__ landed, int L, int pages, long long page_bytes,
                     int producer, int consumer, int silent, PeerTable pads, Group G,
                     Launch Lr) {
  const int me = group_me(G);
  const int lane = blockIdx.x;
  const int lanes = gridDim.x;
  if (!barrier_group_block(pads, lane, G, Lr)) return;
  const int n_pages = nt[0];
  const int tag = nt[1];
  int* report = landed + 2 * my_pe();
  if (lane == 0 && threadIdx.x == 0) {  // (0, tag) until a role reports
    report[0] = 0;
    report[1] = tag;
  }
  if (me == producer) {
    const int peer = group_pe(G, consumer);
    const unsigned char* ks = symm_at<const unsigned char>(kpool, my_pe());
    const unsigned char* vs = symm_at<const unsigned char>(vpool, my_pe());
    unsigned char* kd = symm_at<unsigned char>(kpool, peer);
    unsigned char* vd = symm_at<unsigned char>(vpool, peer);
    int puts = 0;
    for (int item = lane; item < n_pages * L; item += lanes) {
      const int i = item / L;
      const int l = item - i * L;
      const size_t from = ((size_t)l * pages + src[i]) * page_bytes;
      const size_t to = ((size_t)l * pages + dst[i]) * page_bytes;
      putmem_block(kd + to, ks + from, page_bytes);
      putmem_block(vd + to, vs + from, page_bytes);
      ++puts;
    }
    if (puts && !silent) signal_op_block(symm_at<int>(pads, peer) + lanes, puts);
    if (lane == 0 && threadIdx.x == 0) {
      report[0] = n_pages;
      report[1] = tag;
    }
  } else if (me == consumer) {
    if (lane == 0 &&
        wait_block(symm_at<int>(pads, my_pe()) + lanes, n_pages * L, true, Lr, lanes) &&
        threadIdx.x == 0) {
      report[0] = n_pages;
      report[1] = tag;
    }
  }
}

}  // namespace

extern "C" {

// kpool / vpool: n pointers to each rank's pools of L * pages pages of
// page_bytes (16-byte aligned); src / dst: [pmax] int32 ids in [0, pages);
// nt: (n_pages, tag) int32 with n_pages <= pmax; landed: [n, 2] int32,
// each rank's report; pads: n pointers to
// pads of >= lanes + 1 zero words; group: the role axis's groups.
// `producer` and `consumer` are indices in a group.
int tdt_paged_transport(const void* const* kpool, const void* const* vpool, const void* src,
                        const void* dst, const void* nt, void* landed, int L, int pages,
                        long long page_bytes, int producer, int consumer, int silent, int lanes,
                        const void* const* pads, int n, const void* group, void* claim,
                        void* report, unsigned long long budget_ns, void* stream) {
  if (n < 2 || n > kMaxPes || L < 1 || pages < 1 || page_bytes <= 0 || page_bytes % 16 ||
      lanes < 1 || group == nullptr || producer == consumer)
    return (int)cudaErrorInvalidValue;
  const Group G = *static_cast<const Group*>(group);
  if (G.n < 2 || G.n > n || producer < 0 || producer >= G.n || consumer < 0 || consumer >= G.n)
    return (int)cudaErrorInvalidValue;
  lanes = resident_lanes(transport_kernel, kThreads, lanes, n);
  if (lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return launch_cooperative(transport_kernel, dim3(lanes, n), dim3(kThreads), 0, stream,
                            make_table(kpool, n), make_table(vpool, n),
                            static_cast<const int*>(src), static_cast<const int*>(dst),
                            static_cast<const int*>(nt), static_cast<int*>(landed), L, pages,
                            page_bytes, producer, consumer, silent, make_table(pads, n), G,
                            make_launch(claim, report, budget_ns, kPagedTransport));
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
