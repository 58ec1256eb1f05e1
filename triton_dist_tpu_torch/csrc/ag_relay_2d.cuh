// The two-tier relay all-gather, as a device protocol that the kernels of
// this directory share.
//
// Counterpart of ag_overlap_protocol_2d (triton_dist_tpu/ops/allgather_gemm.py:
// 86-168), the protocol under the TPU kernel B11 (_ag_push_2d_kernel,
// triton_dist_tpu/ops/allgather.py:396) and under the 2-tier forms of
// AG-GEMM (B15) and the MoE AG-GroupGEMM (B19). The gather runs over axes
// (outer, *inner): the inner axes, flattened, are one tier of ni ranks, the
// outer axis the other of no; rank (mo, mi) holds global segment
// seg = mo * ni + mi, the P(axes) order. Each rank is the relay of its own
// inner index mi, in a ring over the outer axis:
//
//   1. an entry barrier over the whole group (Relay2d::all): slots and
//      signal words are reused from call to call;
//   2. the own shard is put into slot my_seg of every inner peer and of the
//      outer-right neighbour (ring hop 1), each 16-byte vector read once;
//   3. rows are consumed in the order mo, mo - 1, ...: row mo starts with
//      the own shard (no wait), then the inner arrivals (mo, j). For a
//      remote row r the relay waits for the outer arrival of (r, mi), puts
//      it to the outer-right neighbour until it has made no - 1 hops and to
//      its inner peers, then emits it; the segments (r, j != mi) arrive
//      from their own relays (mo, j) over the inner tier.
//
// Every rank receives each foreign segment exactly once: (r, mi) from the
// outer-left neighbour, (r, j != mi) from the relay (mo, j). A slot is
// forwarded only after its arrival has been waited for, and what arrived is
// read with ld.global.cg after the wait's acquire.
//
// Signals: a counted arrival per segment slot (shmem.cuh's count_word,
// finish_word and finish_block). The shard is cut into gridDim.x lanes; the
// block of each lane puts its chunk and adds one to the receiver's count of
// that segment, so a segment has fully arrived when its count holds the
// lane count. A relay forwards only a segment whose count is complete, and
// its emit may read the whole segment (what a GEMM tile needs). Many blocks
// wait on one count, so no wait consumes it: the last block of each rank to
// finish consumes every count and zeroes the finish word (finish_block), so
// the pad is zero after the call. Pad words: [0, lanes) the entry barrier,
// [lanes + s] the count of segment s, [lanes + N] the finish word (N the
// launch's ranks).
//
// The emit is a functor, emit(src, seg), called once for every segment in
// the consumption order, with src the segment's bytes (the own shard for
// my_seg, the rank's own workspace slot otherwise). B11 copies the own
// shard into its slot (remote segments landed in their output slots
// directly); the 2-tier B15 (tp_overlap.cu) and B19 (moe_tp.cu) plug in
// B2's and B17's tile, with their workspaces as `ws`. B19 moves only the
// used rows of each segment (`used`, a prefix of its slot).

#pragma once

#include "shmem.cuh"

namespace tdt_shmem {

// The tiers of a relay over axes (outer, *inner), each rank's groups:
// the whole group over the axes, the outer axis, the flattened inner axes.
struct Relay2d {
  Group all;
  Group outer;
  Group inner;
};

// Every thread of the block: bytes [b0, b1) of `src` (a segment) into slot
// `seg` (of seg_bytes) of ranks pes[0 .. k) through `ws`, each 16-byte
// vector read once through L2 and stored k times; then, after the block's
// stores, one count on each of those ranks' count_word(seg), unless this
// rank is `silent` (a rank that puts but never signals, for the hang check).
__device__ __forceinline__ void relay_put(const PeerTable& ws, const PeerTable& pads,
                                          const int* pes, int k, const unsigned char* src,
                                          long long seg_bytes, int seg, long long b0,
                                          long long b1, int silent) {
  if (k == 0) return;
  const size_t off = (size_t)seg * seg_bytes;
  if (seg_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    // the lanes' chunks are 16-byte multiples: [b0, b1) is whole vectors
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (long long i = b0 / 16 + threadIdx.x; i < b1 / 16; i += blockDim.x) {
      const uint4 v = __ldcg(s + i);
      for (int p = 0; p < k; ++p)
        reinterpret_cast<uint4*>(symm_at<unsigned char>(ws, pes[p]) + off)[i] = v;
    }
  } else {
    for (long long i = b0 + threadIdx.x; i < b1; i += blockDim.x) {
      const unsigned char v = __ldcg(src + i);
      for (int p = 0; p < k; ++p) symm_at<unsigned char>(ws, pes[p])[off + i] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && my_pe() != silent) {
    __threadfence();
    for (int p = 0; p < k; ++p) red_release_add(symm_at<int>(pads, pes[p]) + count_word(seg), 1);
  }
}

// The relay of one block (lane blockIdx.x, chunk [b0, b1) of every
// segment of seg_bytes), grid (lanes, N) covering every rank of the mesh.
// shard: this rank's segment; ws: every rank's slots [n][seg_bytes]; pads:
// the family's signal pads; used(seg): the bytes of segment seg that travel
// (a prefix of its slot; the lanes' chunks are cut to it, and a lane past
// it still counts its arrival). All threads call it; false on error (a
// starved wait, reported through L).
template <typename Emit, typename Used>
__device__ bool relay_2d(const Relay2d& R, const PeerTable& ws, const PeerTable& pads,
                         const unsigned char* shard, long long seg_bytes, long long b0,
                         long long b1, int silent, const Launch& L, Emit&& emit, Used&& used) {
  const int mo = group_me(R.outer), no = group_n(R.outer);
  const int mi = group_me(R.inner), ni = group_n(R.inner);
  const int lanes = gridDim.x;
  if (!barrier_group_block(pads, blockIdx.x, R.all, L)) return false;
  int* pad = symm_at<int>(pads, my_pe());
  const unsigned char* mine = symm_at<const unsigned char>(ws, my_pe());
  const int right = group_pe(R.outer, mo + 1);
  int pes[kMaxPes];
  int inner = 0;
  for (int s = 1; s < ni; ++s) pes[inner++] = group_pe(R.inner, mi + s);
  auto end = [&](int seg) {
    const long long u = used(seg);
    return b1 < u ? b1 : u;
  };

  // own shard: the inner push and outer ring hop 1
  const int my_seg = mo * ni + mi;
  pes[inner] = right;
  relay_put(ws, pads, pes, inner + (no > 1), shard, seg_bytes, my_seg, b0, end(my_seg), silent);
  emit(shard, my_seg);
  for (int s = 1; s < ni; ++s) {
    const int seg = mo * ni + (mi + s) % ni;
    if (!wait_block(pad + count_word(seg), lanes, false, L, count_word(seg))) return false;
    emit(mine + (size_t)seg * seg_bytes, seg);
  }
  // remote rows, nearest first: relay and distribute, then emit
  for (int t = 1; t < no; ++t) {
    const int r = (mo - t + no) % no;
    const int seg_r = r * ni + mi;
    if (!wait_block(pad + count_word(seg_r), lanes, false, L, count_word(seg_r))) return false;
    const unsigned char* got = mine + (size_t)seg_r * seg_bytes;
    pes[inner] = right;
    relay_put(ws, pads, pes, inner + (t < no - 1), got, seg_bytes, seg_r, b0, end(seg_r),
              silent);
    emit(got, seg_r);
    for (int s = 1; s < ni; ++s) {
      const int seg = r * ni + (mi + s) % ni;
      if (!wait_block(pad + count_word(seg), lanes, false, L, count_word(seg))) return false;
      emit(mine + (size_t)seg * seg_bytes, seg);
    }
  }
  // this block reads no count any more; the rank's last block drains them
  if (!finish_block(pad, lanes, my_seg, L, no * ni)) return false;
  quiet();
  return true;
}

// The relay of whole segments (every byte of each travels).
template <typename Emit>
__device__ bool relay_2d(const Relay2d& R, const PeerTable& ws, const PeerTable& pads,
                         const unsigned char* shard, long long seg_bytes, long long b0,
                         long long b1, int silent, const Launch& L, Emit&& emit) {
  return relay_2d(R, ws, pads, shard, seg_bytes, b0, b1, silent, L, emit,
                  [seg_bytes](int) { return seg_bytes; });
}

}  // namespace tdt_shmem
