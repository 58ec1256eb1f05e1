// The push and ring all-gathers, written by hand for Hopper (sm_90a): the
// one-rank copy, and the puts across ranks that share one card.
//
// Replaces the TPU kernel B9, _ag_call (the pallas_call at
// triton_dist_tpu/ops/allgather.py:262): _ag_push_kernel (:38-68), where
// every rank puts its shard [m, ...] into slot `me` of every peer's
// gathered [n * m, ...] and waits for n - 1 deliveries, and _ag_ring_kernel
// (:71-96), where each rank forwards the newest segment to its right
// neighbour, n - 1 hops, each segment landing in its final slot. Both start
// with the entry barrier (barrier_all, shmem.cuh), as the JAX kernels do:
// signals persist between calls, and the barrier keeps a fast rank's next
// call from meeting a slow rank's current one once ranks are processes.
// At one rank both are the copy of the shard into slot 0 (tdt_ag_copy).
// Over an axis inside a multi-axis mesh they run in groups (a Group,
// shmem.cuh): one launch covers every rank of the mesh, and each rank
// gathers its own group's shards, talking to the members of its group
// only; the slot of a shard is its rank's index in the group.
//
// Beside them, three more TPU kernels of that file:
//
// - B11, _ag_push_2d (the pallas_call at :377; _ag_push_2d_kernel :396):
//   the gather over several axes of the mesh in one kernel, over the 2-tier
//   relay of ag_relay_2d.cuh (ag_overlap_protocol_2d). Remote segments land
//   in their slots of the output directly; the emit copies the own shard
//   into its slot.
// - B10, all_gather_ll (the pallas_call at :188; _ag_ll_kernel :99): the
//   low-latency push with no entry barrier. Arrivals land in a persistent
//   symmetric workspace [2][n][nbytes] keyed by the call's parity, and their
//   signals in pad words keyed [parity][segment]; the own shard goes
//   straight to the output, each remote slot is copied out after its wait.
//   The parity guards the TPU's one-call-ahead race (a peer's call k + 1
//   putting into a slot of call k); that race cannot show while every rank
//   runs in one launch, as here. The port gives each kernel family its own
//   pad (ops/common.py family_pad), so the interleaving hazard of the TPU
//   kernel (its signals aliasing another kernel's semaphores) cannot arise.
// - B12, broadcast (the pallas_call at :464; _bcast_kernel :420): after the
//   entry barrier the root puts its block into every member's output and
//   signals; each other member waits for one delivery.
//
// Every kernel takes a `silent` rank (-1 for none) that puts but never
// signals its deliveries: its peers' waits run out and the call raises
// (the hang check of chip_smoke.py).
//
// What bounds them on this card: bytes. The push reads each shard once and
// writes it n times (every replica's slot); the ring reads and writes each
// segment once a hop. On one card every rank's traffic shares one HBM.
//
// What the design does about it: one launch covers every rank (grid
// (lanes, n), the rank on y). Each shard is cut into `lanes` chunks of
// 16-byte multiples, and the blocks at one lane form an independent
// collective over their chunk: their own barrier word and delivery flags,
// so no block waits for another lane. The push reads a 16-byte vector once
// and stores it to all n replicas; the ring's hop is a block-cooperative
// copy read through L2. Delivery is signalled once per (lane, segment)
// after the block's stores, and consumed by the receiver's wait.

#include "ag_relay_2d.cuh"
#include "shmem.cuh"

using namespace tdt_shmem;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // a few waves of the H100's 132 SMs

__global__ void __launch_bounds__(kThreads)
    ag_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long vecs,
                   const unsigned char* __restrict__ src_tail,
                   unsigned char* __restrict__ dst_tail, int tail) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < vecs; v += stride)
    dst[v] = src[v];
  if (blockIdx.x == 0 && threadIdx.x < tail) dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

// this block's chunk [b0, b1) of a shard of nbytes
__device__ __forceinline__ void lane_range(long long nbytes, long long per, long long* b0,
                                           long long* b1) {
  *b0 = (long long)blockIdx.x * per;
  *b1 = *b0 + per < nbytes ? *b0 + per : nbytes;
}

// Pad words: [0, lanes) the entry barrier; [lanes + s * lanes + c] the
// delivery of segment s's chunk c.
__device__ __forceinline__ int flag_word(int seg, int lane) {
  return gridDim.x + seg * gridDim.x + lane;
}

// grid (lanes, n). in: each rank's shard (nbytes); out: each rank's
// replica (n * nbytes).
__global__ void __launch_bounds__(kThreads)
    ag_push_kernel(PeerTable in, PeerTable out, long long nbytes, long long per, PeerTable pads,
                   Group G, int silent, Launch L) {
  const int me = group_me(G);
  const int n = group_n(G);
  const int lane = blockIdx.x;
  if (!barrier_group_block(pads, lane, G, L)) return;
  long long b0, b1;
  lane_range(nbytes, per, &b0, &b1);
  const unsigned char* src = symm_at<const unsigned char>(in, my_pe());
  const size_t slot = (size_t)me * nbytes;
  const long long len = b1 > b0 ? b1 - b0 : 0;
  for (int p = 0; p < n; ++p)
    TDT_TRACE_PUT(symm_at<unsigned char>(out, group_pe(G, p)) + slot + b0, src + b0, len);
  if (nbytes % 16 == 0) {
    // one 16-byte load, n stores: my slot of every replica
    for (long long i = b0 / 16 + threadIdx.x; i < b1 / 16; i += kThreads) {
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src) + i);
      for (int p = 0; p < n; ++p)
        reinterpret_cast<uint4*>(symm_at<unsigned char>(out, group_pe(G, p)) + slot)[i] = v;
    }
  } else {
    for (long long i = b0 + threadIdx.x; i < b1; i += kThreads) {
      const unsigned char v = __ldcg(src + i);
      for (int p = 0; p < n; ++p) symm_at<unsigned char>(out, group_pe(G, p))[slot + i] = v;
    }
  }
  __syncthreads();
  int ok = 1;
  if (threadIdx.x == 0) {
    __threadfence();
    for (int p = 0; p < n && my_pe() != silent; ++p)
      if (p != me) signal_op(symm_at<int>(pads, group_pe(G, p)) + flag_word(me, lane), 1);
    for (int s = 0; s < n && ok; ++s)
      if (s != me)
        ok = signal_wait_until(symm_at<int>(pads, my_pe()) + flag_word(s, lane), 1, true, L,
                               flag_word(s, lane));
  }
  if (!__syncthreads_and(ok)) return;
  // the replica goes to the caller: this lane's chunk of every slot
  for (int s = 0; s < n; ++s)
    TDT_TRACE_READ(symm_at<unsigned char>(out, my_pe()) + (size_t)s * nbytes + b0, len);
  quiet();
}

// grid (lanes, n): my shard into my own slot, then n - 1 hops to the right,
// each forwarding the segment that arrived last.
__global__ void __launch_bounds__(kThreads)
    ag_ring_kernel(PeerTable in, PeerTable out, long long nbytes, long long per, PeerTable pads,
                   Group G, int silent, Launch L) {
  const int me = group_me(G);
  const int n = group_n(G);
  const int lane = blockIdx.x;
  if (!barrier_group_block(pads, lane, G, L)) return;
  long long b0, b1;
  lane_range(nbytes, per, &b0, &b1);
  const long long len = b1 > b0 ? b1 - b0 : 0;
  const int right = group_pe(G, me + 1);
  unsigned char* mine = symm_at<unsigned char>(out, my_pe());
  unsigned char* next = symm_at<unsigned char>(out, right);
  const unsigned char* shard = symm_at<const unsigned char>(in, my_pe()) + b0;
  putmem_block(mine + (size_t)me * nbytes + b0, shard, len);
  for (int s = 0; s < n - 1; ++s) {
    const int seg = ((me - s) % n + n) % n;  // the newest segment I hold
    // hop 0 forwards my shard from its source; later hops what arrived
    const unsigned char* from = s == 0 ? shard : mine + (size_t)seg * nbytes + b0;
    putmem_block(next + (size_t)seg * nbytes + b0, from, len);
    __syncthreads();
    if (threadIdx.x == 0 && my_pe() != silent) {
      __threadfence();
      signal_op(symm_at<int>(pads, right) + flag_word(seg, lane), 1);
    }
    const int prev = ((me - s - 1) % n + n) % n;
    if (!wait_block(symm_at<int>(pads, my_pe()) + flag_word(prev, lane), 1, true, L,
                    flag_word(prev, lane)))
      return;
  }
  // the replica goes to the caller: this lane's chunk of every slot
  for (int s = 0; s < n; ++s) TDT_TRACE_READ(mine + (size_t)s * nbytes + b0, len);
  quiet();
}

// B11: grid (lanes, N), the relay over R's tiers. in: each rank's shard
// (nbytes); out: each rank's replica, n slots of nbytes; pads: >= lanes + N
// + 1 zero words.
__global__ void __launch_bounds__(kThreads)
    ag_push_2d_kernel(PeerTable in, PeerTable out, long long nbytes, long long per,
                      PeerTable pads, Relay2d R, int silent, Launch L) {
  long long b0, b1;
  lane_range(nbytes, per, &b0, &b1);
  if (b0 > nbytes) b0 = nbytes;
  unsigned char* mine = symm_at<unsigned char>(out, my_pe());
  const int my_seg = group_me(R.all);
  relay_2d(R, out, pads, symm_at<const unsigned char>(in, my_pe()), nbytes, b0, b1, silent, L,
           [&](const unsigned char* src, int seg) {
             // remote segments landed in their slots; the own one is copied
             if (seg == my_seg && b1 > b0)
               putmem_block(mine + (size_t)seg * nbytes + b0, src + b0, b1 - b0);
           });
}

// B10: grid (lanes, N), no entry barrier. ws: each rank's arrival slots
// [2][n][nbytes]; pad words [(phase * n + s) * lanes + lane] signal segment
// s's chunk of this lane in a call of that parity.
__global__ void __launch_bounds__(kThreads)
    ag_ll_kernel(PeerTable in, PeerTable ws, PeerTable out, long long nbytes, long long per,
                 int phase, PeerTable pads, Group G, int silent, Launch L) {
  const int me = group_me(G);
  const int n = group_n(G);
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  long long b0, b1;
  lane_range(nbytes, per, &b0, &b1);
  const unsigned char* src = symm_at<const unsigned char>(in, my_pe());
  unsigned char* mine = symm_at<unsigned char>(out, my_pe());
  const size_t slot = ((size_t)phase * n + me) * nbytes;
  // one read of each 16-byte vector: my own slot of my output, and slot
  // (phase, me) of every peer's workspace
  if (nbytes % 16 == 0) {
    for (long long i = b0 / 16 + threadIdx.x; i < b1 / 16; i += kThreads) {
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src) + i);
      reinterpret_cast<uint4*>(mine + (size_t)me * nbytes)[i] = v;
      for (int p = 0; p < n; ++p)
        if (p != me)
          reinterpret_cast<uint4*>(symm_at<unsigned char>(ws, group_pe(G, p)) + slot)[i] = v;
    }
  } else {
    for (long long i = b0 + threadIdx.x; i < b1; i += kThreads) {
      const unsigned char v = __ldcg(src + i);
      mine[(size_t)me * nbytes + i] = v;
      for (int p = 0; p < n; ++p)
        if (p != me) symm_at<unsigned char>(ws, group_pe(G, p))[slot + i] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && my_pe() != silent) {
    __threadfence();
    for (int p = 0; p < n; ++p)
      if (p != me)
        signal_op(symm_at<int>(pads, group_pe(G, p)) + (phase * n + me) * lanes + lane, 1);
  }
  // each remote slot of this parity, once it has arrived, into the output
  const unsigned char* arrived = symm_at<const unsigned char>(ws, my_pe());
  int* pad = symm_at<int>(pads, my_pe());
  for (int k = 1; k < n; ++k) {
    const int s = (me + k) % n;
    const int word = (phase * n + s) * lanes + lane;
    if (!wait_block(pad + word, 1, true, L, word)) return;
    if (b1 > b0)
      putmem_block(mine + (size_t)s * nbytes + b0,
                   arrived + ((size_t)phase * n + s) * nbytes + b0, b1 - b0);
  }
  quiet();
}

// B12: grid (lanes, N). in: each rank's candidate block (nbytes); out: each
// rank's copy of the root's; pads: [0, lanes) the entry barrier, [lanes +
// lane] the delivery.
__global__ void __launch_bounds__(kThreads)
    bcast_kernel(PeerTable in, PeerTable out, long long nbytes, long long per, int root,
                 PeerTable pads, Group G, int silent, Launch L) {
  const int me = group_me(G);
  const int n = group_n(G);
  const int lane = blockIdx.x;
  const int word = gridDim.x + lane;
  if (!barrier_group_block(pads, lane, G, L)) return;
  if (me != root) {
    wait_block(symm_at<int>(pads, my_pe()) + word, 1, true, L, word);
    return;
  }
  long long b0, b1;
  lane_range(nbytes, per, &b0, &b1);
  const unsigned char* src = symm_at<const unsigned char>(in, my_pe());
  if (nbytes % 16 == 0) {
    for (long long i = b0 / 16 + threadIdx.x; i < b1 / 16; i += kThreads) {
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src) + i);
      for (int p = 0; p < n; ++p)
        reinterpret_cast<uint4*>(symm_at<unsigned char>(out, group_pe(G, p)))[i] = v;
    }
  } else {
    for (long long i = b0 + threadIdx.x; i < b1; i += kThreads) {
      const unsigned char v = __ldcg(src + i);
      for (int p = 0; p < n; ++p) symm_at<unsigned char>(out, group_pe(G, p))[i] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && my_pe() != silent) {
    __threadfence();
    for (int p = 0; p < n; ++p)
      if (p != me) signal_op(symm_at<int>(pads, group_pe(G, p)) + word, 1);
  }
  quiet();
}

// the lanes a launch of `kernel` keeps resident over n ranks, and the
// 16-byte multiple of a shard each lane moves
template <typename K>
int lane_plan(K kernel, long long nbytes, int* lanes, int n, long long* per) {
  *lanes = resident_lanes(kernel, kThreads, *lanes, n);
  if (*lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *per = ((nbytes + *lanes - 1) / *lanes + 15) / 16 * 16;
  return 0;
}

template <typename K>
int launch_gather(K kernel, int kernel_id, const void* const* in, const void* const* out,
                  long long nbytes, int lanes, const void* const* pads, int n, const void* group,
                  int silent, void* claim, void* report, unsigned long long budget_ns,
                  void* stream) {
  if (n < 2 || n > kMaxPes || nbytes <= 0 || lanes < 1 || group == nullptr)
    return (int)cudaErrorInvalidValue;
  const Group G = *static_cast<const Group*>(group);
  if (G.n < 2 || G.n > n) return (int)cudaErrorInvalidValue;
  long long per;
  if (const int e = lane_plan(kernel, nbytes, &lanes, n, &per)) return e;
  return launch_cooperative(kernel, dim3(lanes, n), dim3(kThreads), 0, stream,
                            make_table(in, n), make_table(out, n), nbytes, per,
                            make_table(pads, n), G, silent,
                            make_launch(claim, report, budget_ns, kernel_id));
}

}  // namespace

extern "C" {

// shard: nbytes; out: at least (slot + 1) * nbytes. The shard and the
// slot 16-byte aligned. Returns the launch's cudaError_t.
int tdt_ag_copy(const void* shard, void* out, long long nbytes, int slot, void* stream) {
  if (nbytes <= 0 || slot < 0) return (int)cudaErrorInvalidValue;
  const unsigned char* src = static_cast<const unsigned char*>(shard);
  unsigned char* dst = static_cast<unsigned char*>(out) + (size_t)slot * nbytes;
  if (((uintptr_t)src | (uintptr_t)dst) % 16) return (int)cudaErrorInvalidValue;
  const long long vecs = nbytes / 16;
  const int tail = (int)(nbytes % 16);
  long long blocks = (vecs + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  ag_copy_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst), vecs,
      src + vecs * 16, dst + vecs * 16, tail);
  return (int)cudaGetLastError();
}

// in: n pointers to each rank's shard of nbytes; out: n pointers to each
// rank's replica of g * nbytes (16-byte aligned), g the group size; pads: n
// pointers to pads of >= (g + 1) * lanes zero words; group: the gather's
// groups over the n ranks (g >= 2). `lanes` is cut to what the card keeps
// resident at once (resident_lanes, shmem.cuh).
int tdt_ag_push(const void* const* in, const void* const* out, long long nbytes, int lanes,
                const void* const* pads, int n, const void* group, int silent, void* claim,
                void* report, unsigned long long budget_ns, void* stream) {
  return launch_gather(ag_push_kernel, kAgPush, in, out, nbytes, lanes, pads, n, group, silent,
                       claim, report, budget_ns, stream);
}

int tdt_ag_ring(const void* const* in, const void* const* out, long long nbytes, int lanes,
                const void* const* pads, int n, const void* group, int silent, void* claim,
                void* report, unsigned long long budget_ns, void* stream) {
  return launch_gather(ag_ring_kernel, kAgRing, in, out, nbytes, lanes, pads, n, group, silent,
                       claim, report, budget_ns, stream);
}

// B11. in: n pointers to each rank's shard of nbytes; out: n pointers to
// each rank's replica of g * nbytes (16-byte aligned), g = relay->all.n;
// pads: n pointers to pads of >= lanes + n + 1 zero words; relay: the
// tiers (Relay2d) over the n ranks.
int tdt_ag_push_2d(const void* const* in, const void* const* out, long long nbytes, int lanes,
                   const void* const* pads, int n, const void* relay, int silent, void* claim,
                   void* report, unsigned long long budget_ns, void* stream) {
  if (n < 1 || n > kMaxPes || nbytes <= 0 || lanes < 1 || relay == nullptr)
    return (int)cudaErrorInvalidValue;
  const Relay2d R = *static_cast<const Relay2d*>(relay);
  if (R.all.n < 2 || R.all.n > n || R.outer.n * R.inner.n != R.all.n)
    return (int)cudaErrorInvalidValue;
  long long per;
  if (const int e = lane_plan(ag_push_2d_kernel, nbytes, &lanes, n, &per)) return e;
  return launch_cooperative(ag_push_2d_kernel, dim3(lanes, n), dim3(kThreads), 0, stream,
                            make_table(in, n), make_table(out, n), nbytes, per,
                            make_table(pads, n), R, silent,
                            make_launch(claim, report, budget_ns, kAgPush2d));
}

// B10. in: n pointers to each rank's shard of nbytes; ws: n pointers to
// each rank's workspace of 2 * g * nbytes; out: n pointers to each rank's
// replica of g * nbytes; phase: the call's parity; pads: n pointers to pads
// of >= 2 * g * lanes zero words.
int tdt_ag_ll(const void* const* in, const void* const* ws, const void* const* out,
              long long nbytes, int lanes, int phase, const void* const* pads, int n,
              const void* group, int silent, void* claim, void* report,
              unsigned long long budget_ns, void* stream) {
  if (n < 2 || n > kMaxPes || nbytes <= 0 || lanes < 1 || group == nullptr ||
      (phase != 0 && phase != 1))
    return (int)cudaErrorInvalidValue;
  const Group G = *static_cast<const Group*>(group);
  if (G.n < 2 || G.n > n) return (int)cudaErrorInvalidValue;
  long long per;
  if (const int e = lane_plan(ag_ll_kernel, nbytes, &lanes, n, &per)) return e;
  return launch_cooperative(ag_ll_kernel, dim3(lanes, n), dim3(kThreads), 0, stream,
                            make_table(in, n), make_table(ws, n), make_table(out, n), nbytes,
                            per, phase, make_table(pads, n), G, silent,
                            make_launch(claim, report, budget_ns, kAgLl));
}

// B12. in: n pointers to each rank's candidate block of nbytes; out: n
// pointers to each rank's copy (16-byte aligned); root: the group index
// whose block every member gets; pads: n pointers to pads of >= 2 * lanes
// zero words.
int tdt_bcast(const void* const* in, const void* const* out, long long nbytes, int lanes,
              int root, const void* const* pads, int n, const void* group, int silent,
              void* claim, void* report, unsigned long long budget_ns, void* stream) {
  if (n < 2 || n > kMaxPes || nbytes <= 0 || lanes < 1 || group == nullptr)
    return (int)cudaErrorInvalidValue;
  const Group G = *static_cast<const Group*>(group);
  if (G.n < 2 || G.n > n || root < 0 || root >= G.n) return (int)cudaErrorInvalidValue;
  long long per;
  if (const int e = lane_plan(bcast_kernel, nbytes, &lanes, n, &per)) return e;
  return launch_cooperative(bcast_kernel, dim3(lanes, n), dim3(kThreads), 0, stream,
                            make_table(in, n), make_table(out, n), nbytes, per, root,
                            make_table(pads, n), G, silent,
                            make_launch(claim, report, budget_ns, kBcast));
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
