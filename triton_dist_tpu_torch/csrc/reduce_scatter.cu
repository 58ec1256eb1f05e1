// The ring reduce-scatter across ranks that share one card, written by hand
// for Hopper (sm_90a).
//
// Replaces the TPU kernel B13, _rs_call (the pallas_call at
// triton_dist_tpu/ops/reduce_scatter.py:85; _rs_ring_kernel :32-76). Each
// rank holds a full-size contribution of n segments; segment j starts at
// rank j + 1 and travels n - 1 right-hops to its owner j, each rank adding
// its own contribution as it passes. Two relay slots per rank carry the
// travelling partial, and a rank may refill a slot of its right neighbour
// only after an ack credit from it. The sum is taken in the shard's own
// type and rounded at every hop (acc = comm[slot] + loc, :71), so a bf16
// ring gives the JAX kernel's bits, not an f32 sum's.
//
// What bounds it on this card: bytes. Each hop reads the arriving partial
// and the local segment and writes one segment into the neighbour's slot;
// on one card every rank's hops share one HBM.
//
// Over an axis inside a multi-axis mesh the rings run in groups (a Group,
// shmem.cuh): one launch covers every rank of the mesh, and each rank's ring
// is its group's, segments indexed by the index in the group. The
// hierarchical ring_2d (_rs_ring_2d, :175-209) is this kernel once per axis,
// innermost first, over the pre-permuted contributions
// (ops/reduce_scatter.py).
//
// What the design does about it: one launch covers every rank (grid
// (lanes, N), the rank on y), and each segment is cut into `lanes` chunks
// of whole 16-byte vectors: the blocks at one lane run an independent ring
// over their chunk, with their own barrier word, two delivery flags and an
// ack counter, so no block waits for another lane. The hop never stores the
// partial locally: it reads the slot that arrived and the local segment,
// adds in float, rounds to the type, and stores into the neighbour's slot.
// Signals are released once per hop after the block's stores, and every
// wait consumes its signal, so the pad is zero after the call (the last two
// acks are drained, as the JAX kernel does).

#include <cuda_bf16.h>

#include "shmem.cuh"

using namespace tdt_shmem;

namespace {

constexpr int kThreads = 256;

// one 16-byte vector: a + b in float, rounded to the type
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b, float) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  float4 r;
  r.x = __fadd_rn(x.x, y.x);
  r.y = __fadd_rn(x.y, y.y);
  r.z = __fadd_rn(x.z, y.z);
  r.w = __fadd_rn(x.w, y.w);
  return *reinterpret_cast<uint4*>(&r);
}

__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b, __nv_bfloat16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 out;
  __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]);
    const float2 fy = __bfloat1622float2(y[i]);
    r[i] = __floats2bfloat162_rn(__fadd_rn(fx.x, fy.x), __fadd_rn(fx.y, fy.y));
  }
  return out;
}

// Pad words, by lane c of `lanes`: [c] the entry barrier, [lanes + slot *
// lanes + c] the delivery into relay slot `slot`, [3 lanes + c] the acks.
struct Words {
  int lanes, lane;
  __device__ int barrier() const { return lane; }
  __device__ int recv(int slot) const { return lanes + slot * lanes + lane; }
  __device__ int ack() const { return 3 * lanes + lane; }
};

// grid (lanes, N), every rank of the mesh; the rings run over G's groups
// of n ranks. in: each rank's contribution, n segments of seg_vecs
// vectors; out: each rank's reduced segment; comm: each rank's two relay
// slots of seg_vecs vectors. Lane c owns vectors [c * per, (c + 1) * per)
// of every segment. The tables are indexed by flat rank, the segments by
// the index in the group. A `silent` rank (-1 for none) never signals its
// deliveries (the hang check).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rs_ring_kernel(PeerTable in, PeerTable out, PeerTable comm, long long seg_vecs, long long per,
                   PeerTable pads, Group G, int silent, Launch L) {
  const int me = group_me(G);
  const int n = group_n(G);
  const int pe = my_pe();
  const Words w{(int)gridDim.x, (int)blockIdx.x};
  if (!barrier_group_block(pads, w.barrier(), G, L)) return;
  const long long v0 = (long long)blockIdx.x * per;
  const long long v1 = v0 + per < seg_vecs ? v0 + per : seg_vecs;
  const uint4* x = symm_at<const uint4>(in, pe);
  uint4* y = symm_at<uint4>(out, pe);
  if (n == 1) {
    for (long long i = v0 + threadIdx.x; i < v1; i += kThreads) y[i] = __ldcg(x + i);
    return;
  }
  const auto wrap = [n](int i) { return ((i % n) + n) % n; };
  const int right = group_pe(G, me + 1);
  const int left = group_pe(G, me - 1);
  const uint4* slot_mine = symm_at<const uint4>(comm, pe);
  uint4* slot_right = symm_at<uint4>(comm, right);
  int* pad_me = symm_at<int>(pads, pe);
  const long long bytes = v1 > v0 ? (v1 - v0) * 16 : 0;

  for (int s = 0; s < n - 1; ++s) {
    const int slot = s % 2;
    // the right neighbour has read what I put into this slot two hops ago
    if (s >= 2 && !wait_block(pad_me + w.ack(), 1, true, L, w.ack())) return;
    uint4* dst = slot_right + (size_t)slot * seg_vecs;
    if (s == 0) {
      // my contribution to segment me - 1 starts its ring
      const uint4* loc = x + (size_t)wrap(me - 1) * seg_vecs;
      TDT_TRACE_PUT(dst + v0, loc + v0, bytes);
      for (long long i = v0 + threadIdx.x; i < v1; i += kThreads) dst[i] = __ldcg(loc + i);
    } else {
      // what arrived last hop plus my contribution to its segment
      const uint4* got = slot_mine + (size_t)((s - 1) % 2) * seg_vecs;
      const uint4* loc = x + (size_t)wrap(me - s - 1) * seg_vecs;
      TDT_TRACE_READ(got + v0, bytes);
      TDT_TRACE_PUT(dst + v0, loc + v0, bytes);
      for (long long i = v0 + threadIdx.x; i < v1; i += kThreads)
        dst[i] = add_vec(__ldcg(got + i), __ldcg(loc + i), T());
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (pe != silent) signal_op(symm_at<int>(pads, right) + w.recv(slot), 1);
      if (s >= 1) signal_op(symm_at<int>(pads, left) + w.ack(), 1);  // I read my slot
    }
    if (!wait_block(pad_me + w.recv(slot), 1, true, L, w.recv(slot))) return;
  }
  // the last arrival plus my contribution to my own segment
  const uint4* got = slot_mine + (size_t)((n - 2) % 2) * seg_vecs;
  const uint4* loc = x + (size_t)me * seg_vecs;
  TDT_TRACE_READ(got + v0, bytes);
  for (long long i = v0 + threadIdx.x; i < v1; i += kThreads)
    y[i] = add_vec(__ldcg(got + i), __ldcg(loc + i), T());
  signal_op_block(symm_at<int>(pads, left) + w.ack(), 1);
  // drain the acks of the last sends, never waited on (at most two)
  wait_block(pad_me + w.ack(), n - 1 < 2 ? n - 1 : 2, true, L, w.ack());
}

template <typename T>
int launch_rs(const void* const* in, const void* const* out, const void* const* comm,
              long long seg_vecs, int lanes, const void* const* pads, int n, const void* group,
              int silent, void* claim, void* report, unsigned long long budget_ns, void* stream) {
  if (n < 1 || n > kMaxPes || seg_vecs <= 0 || lanes < 1 || group == nullptr)
    return (int)cudaErrorInvalidValue;
  const Group G = *static_cast<const Group*>(group);
  if (G.n < 1 || G.n > n) return (int)cudaErrorInvalidValue;
  lanes = resident_lanes(rs_ring_kernel<T>, kThreads, lanes, n);
  if (lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long per = (seg_vecs + lanes - 1) / lanes;
  return launch_cooperative(rs_ring_kernel<T>, dim3(lanes, n), dim3(kThreads), 0, stream,
                            make_table(in, n), make_table(out, n), make_table(comm, n), seg_vecs,
                            per, make_table(pads, n), G, silent,
                            make_launch(claim, report, budget_ns, kRsRing));
}

}  // namespace

extern "C" {

// in: n pointers to each rank's contribution (g * seg_vecs 16-byte
// vectors, g the group size); out: n pointers to each rank's segment
// (seg_vecs); comm: n pointers to each rank's relay slots (2 * seg_vecs);
// pads: n pointers to pads of >= 4 * lanes zero words; group: the rings'
// groups over the n ranks (shmem.cuh Group). `lanes` is cut to what the card
// keeps resident at once (resident_lanes, shmem.cuh).
int tdt_rs_ring_f32(const void* const* in, const void* const* out, const void* const* comm,
                    long long seg_vecs, int lanes, const void* const* pads, int n,
                    const void* group, int silent, void* claim, void* report,
                    unsigned long long budget_ns, void* stream) {
  return launch_rs<float>(in, out, comm, seg_vecs, lanes, pads, n, group, silent, claim, report,
                          budget_ns, stream);
}

int tdt_rs_ring_bf16(const void* const* in, const void* const* out, const void* const* comm,
                     long long seg_vecs, int lanes, const void* const* pads, int n,
                     const void* group, int silent, void* claim, void* report,
                     unsigned long long budget_ns, void* stream) {
  return launch_rs<__nv_bfloat16>(in, out, comm, seg_vecs, lanes, pads, n, group, silent, claim,
                                  report, budget_ns, stream);
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
