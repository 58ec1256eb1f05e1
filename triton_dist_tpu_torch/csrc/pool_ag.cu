// The start-local gather of the K and V page pools across the SP ranks,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel B6, pool_ag_start_local (the pallas_call at
// triton_dist_tpu/ops/flash_decode.py:597 over _pool_ag_kernel :516): each
// SP rank holds a slice [P / n, Hkv, page_size, D] of each pool, and every
// rank assembles the full pools [P, ...] in page order. After the entry
// barrier (shmem.cuh), a rank copies its OWN slice into its own slot of its
// full pools first, with no gate: the local pages are ready while the
// remote slices are still in flight. Then it puts its slice into slot `me`
// of every peer's full pools and announces it with one counted signal per
// peer; it waits for n - 1 announcements (consumed, so the pad is zero
// after the call). The result is the page-order concatenation, bit for bit
// the push gather's (B9), so the attention walk after it keeps its order.
// Over an axis inside a multi-axis mesh it runs in groups (a Group): one
// launch covers every rank of the mesh, each rank gathers its own group's
// slices, and a slice's slot is its rank's index in the group.
//
// What bounds it on this card: bytes. Each slice is read once for the
// local copy and once for the puts, and written n times (every replica's
// slot); on one card every rank's traffic shares one HBM.
//
// What the design does about it: one launch covers every rank (grid
// (lanes, n)); each slice is cut into `lanes` chunks of 16-byte multiples,
// and the blocks at one lane form an independent gather of their chunk,
// with their own barrier and announcement words. K and V ride together in
// each block, 16-byte vectors read through L2.

#include "shmem.cuh"

using namespace tdt_shmem;

namespace {

constexpr int kThreads = 256;

// bytes [b0, b1) of src to dst, 16 bytes a thread where aligned
__device__ __forceinline__ void copy_range(unsigned char* dst, const unsigned char* src,
                                           long long b0, long long b1) {
  if (b1 <= b0) return;
  putmem_block(dst + b0, src + b0, b1 - b0);
}

// grid (lanes, n). kin / vin: each rank's slices (nbytes each); kout /
// vout: each rank's full pools (g * nbytes, g the group size). Pad words:
// [0, lanes) the entry barrier, [lanes, 2 lanes) the announcements.
__global__ void __launch_bounds__(kThreads)
    pool_ag_kernel(PeerTable kin, PeerTable vin, PeerTable kout, PeerTable vout, long long nbytes,
                   long long per, PeerTable pads, Group G, Launch L) {
  const int me = group_me(G);
  const int n = group_n(G);
  const int lane = blockIdx.x;
  const int lanes = gridDim.x;
  if (!barrier_group_block(pads, lane, G, L)) return;
  const long long b0 = (long long)lane * per;
  const long long b1 = b0 + per < nbytes ? b0 + per : nbytes;
  const unsigned char* ks = symm_at<const unsigned char>(kin, my_pe());
  const unsigned char* vs = symm_at<const unsigned char>(vin, my_pe());
  const size_t slot = (size_t)me * nbytes;
  // start local: my own slice lands with no gate
  copy_range(symm_at<unsigned char>(kout, my_pe()) + slot, ks, b0, b1);
  copy_range(symm_at<unsigned char>(vout, my_pe()) + slot, vs, b0, b1);
  // then my slice into slot `me` of every peer, nearest peer first
  for (int p = 1; p < n; ++p) {
    const int peer = group_pe(G, me + p);
    copy_range(symm_at<unsigned char>(kout, peer) + slot, ks, b0, b1);
    copy_range(symm_at<unsigned char>(vout, peer) + slot, vs, b0, b1);
  }
  __syncthreads();
  int ok = 1;
  if (threadIdx.x == 0) {
    __threadfence();
    for (int p = 1; p < n; ++p)
      signal_op(symm_at<int>(pads, group_pe(G, me + p)) + lanes + lane, 1);
    ok = signal_wait_until(symm_at<int>(pads, my_pe()) + lanes + lane, n - 1, true, L,
                           lanes + lane);
  }
  if (!__syncthreads_and(ok)) return;
  quiet();
}

}  // namespace

extern "C" {

// kin / vin: n pointers to each rank's slice of nbytes (16-byte aligned);
// kout / vout: n pointers to each rank's full pools of g * nbytes; pads: n
// pointers to pads of >= 2 * lanes zero words; group: the gather's groups
// (g >= 2). `lanes` is cut to what the card keeps resident at once.
int tdt_pool_ag(const void* const* kin, const void* const* vin, const void* const* kout,
                const void* const* vout, long long nbytes, int lanes, const void* const* pads,
                int n, const void* group, void* claim, void* report,
                unsigned long long budget_ns, void* stream) {
  if (n < 2 || n > kMaxPes || nbytes <= 0 || nbytes % 16 || lanes < 1 || group == nullptr)
    return (int)cudaErrorInvalidValue;
  const Group G = *static_cast<const Group*>(group);
  if (G.n < 2 || G.n > n) return (int)cudaErrorInvalidValue;
  lanes = resident_lanes(pool_ag_kernel, kThreads, lanes, n);
  if (lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long per = ((nbytes + lanes - 1) / lanes + 15) / 16 * 16;
  return launch_cooperative(pool_ag_kernel, dim3(lanes, n), dim3(kThreads), 0, stream,
                            make_table(kin, n), make_table(vin, n), make_table(kout, n),
                            make_table(vout, n), nbytes, per, make_table(pads, n), G,
                            make_launch(claim, report, budget_ns, kPoolAg));
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
