// The MoE tensor-parallel pair across ranks that share one card, written by
// hand for Hopper (sm_90a): the token all-gather with the grouped
// up-projection, and the grouped down-projection with its reduce-scatter,
// each in one launch.
//
// Replaces the TPU kernels B19, _ag_moe_kernel
// (triton_dist_tpu/ops/moe.py:136, over ag_overlap_protocol and
// ag_overlap_protocol_2d; the pallas_call at :215), and B20, _moe_rs_kernel
// (:261, over rs_overlap_protocol and emit_slot_reduction) with its 2-tier
// stage _moe_rs_2d_kernel (:276; the pallas_call at :405). Every form runs
// over a group of the mesh (shmem.cuh's Group; an axis that spans the whole
// mesh is its one group), one launch covering every rank of every group;
// tables are indexed by flat rank, segments by group index. The rows are
// aligned by expert on the sender side before the launch (torch ops, as
// they are XLA in the reference): every row block of a segment belongs to
// one expert, be[seg * n_blocks + i], and the blocks at or past nb[seg] hold
// no row.
//
//   ag_moe: x [n, P, H], rank r's aligned segment at block r; w [E, H, F],
//           rank r's columns at r * F/n; out [n * P, F], rank r's columns
//           at r * F/n. After the entry barrier each rank's lanes put the
//           used rows (nb[me] blocks) of its segment into slot `me` of every
//           peer's workspace [n, P, H], one counted arrival per lane; then
//           each rank computes its column block segment by segment in the
//           swizzled order me, me+1, ...: its own segment straight from x,
//           each remote one from its slot once the slot's count is
//           complete.
//   ag_moe over two tiers (axes (outer, *inner)): ag_relay_2d.cuh's relay
//           with B17's tile as its emit, over each segment's used rows
//           only (nb[seg] blocks travel and are computed), the workspace
//           [n, P, H] as its slots.
//   moe_rs: x [n * P, K], the aligned rows of every segment (the ids are
//           replicated, so every rank aligns every segment alike), rank
//           r's K columns at r * K/n; w [E, K, N], rank r's rows of each
//           expert at r * K/n; out [n, P, N] f32, rank r's segment. Each
//           rank computes the f32 partial of every segment over its K
//           shard, in the order me+1, ..., me (its own last), and stores
//           each tile straight into the owner's symmetric slot `me`
//           [n, P, N], one counted arrival per tile (the NVLink peer store
//           of a card per rank; the TPU kernel's double-buffered send stage
//           has no counterpart); then each owner sums its used rows of its
//           n slots in slot order 0 .. n-1 in f32 (gemm_tile.cuh's
//           slot_sum, the same function as gemm.cu's slot reduction).
//   moe_rs's 2-tier stage (no outer, ni inner ranks): the same protocol
//           over the inner group, where inner peer j's chunk is the strided
//           segments {(r, j) : r < no}, laid out outer-major in no * P
//           aligned rows, and the K block is the rank's index over all the
//           axes; the owner's f32 slot sum of its used rows, every other
//           row of the chunk zero, is what the ring reduce-scatter over
//           the outer group (reduce_scatter.cu, B13) then takes.
//
// Each tile is group_gemm_tile.cuh's (B17's): every element sums its whole
// contraction in one fixed order, so ag_moe at n ranks is bitwise B17 of
// each gathered segment against rank r's columns, and moe_rs is bitwise the
// slot reduction of the n one-rank f32 partials, whatever the order of
// arrival. The weight shards are read in place with a leading dimension (a
// column block of [E, H, F] has row stride F; a K block of [E, K, N] is a
// row offset), so no copy is made. Row blocks at or past nb[seg] are never
// read, computed, put or stored: their output rows and slot rows stay
// unwritten, and the host gathers only routed rows. At a decode shape most
// of a segment's blocks are empty experts, and nb skips them without a read
// of be or of any weight.
//
// What bounds them on this card: the bytes of the used experts' weights at
// decode and prefill-chunk sizes, the operations (2 rows H F over the
// ranks) at long prefills, plus the protocol's bytes (ag_moe puts n - 1
// copies of each segment's used rows, moe_rs writes and reads n f32
// partials of each segment), which share the one HBM with the GEMM when
// every rank is on one card.
//
// What the design does about it: one cooperative launch a call, grid
// (lanes, n), the rank on y (shmem.cuh). A rank's blocks walk a persistent
// loop over its used tiles only (row tiles fastest within a column tile, so
// the row tiles of one expert read the same weight tile at about the same
// time), segment after segment. lanes is what the card keeps resident over
// all n ranks at the tile's shared memory (up to kBlocksPerSm blocks an
// SM); a grid that cannot be resident is refused. Signals are shmem.cuh's
// counted arrivals with its finish word, so every pad word is zero after a
// call; every spin is the layer's bounded wait. `silent` names a rank that
// puts or stores but never signals (the hang check).

#include <type_traits>

#include "ag_relay_2d.cuh"
#include "gemm_tile.cuh"
#include "group_gemm_tile.cuh"
#include "shmem.cuh"

using namespace tdt_shmem;
using namespace tdt_group;

namespace {

// blocks a rank's lanes may keep on one SM: the lanes are the compute here
constexpr int kBlocksPerSm = 4;

template <typename In, int TM>
constexpr size_t tile_smem() {
  if constexpr (std::is_same<In, bf16>::value)
    return bf16_smem_bytes<TM, false>();
  else
    return (size_t)f32_smem_floats<false>() * sizeof(float);
}

// One tile of the persistent loop: the block meets first, so the previous
// tile's stages are consumed. The columns stop at N (kEdge).
template <typename In, int TM, typename OutT>
__device__ __forceinline__ void tile(const In* A, int lda, const In* B, int ldb, OutT* C, int ldc,
                                     int K, int N, int row0, int col0, unsigned char* smem) {
  __syncthreads();
  if constexpr (std::is_same<In, bf16>::value)
    grouped_tile_bf16<TM, false, OutT, true>(A, lda, B, nullptr, ldb, C, ldc, K, N, row0, col0,
                                             smem);
  else
    grouped_tile_f32<false, true, true>(A, lda, B, nullptr, ldb, C, ldc, K, N, row0, col0,
                                        reinterpret_cast<float*>(smem));
}

// the used rows of segment seg: its used blocks (nb[seg], at most n_blocks)
__device__ __forceinline__ int used_rows(const int* nb, int seg, int n_blocks, int block_m) {
  return min(max(nb[seg], 0), n_blocks) * block_m;
}

// The used tiles of this rank's walk over `units` segments, unit u being
// segment seg_of(u): it has row_tiles[u] = (its used rows) / TM row tiles
// times col_tiles, and its tiles are [start[u], start[u + 1]) of the walk.
// Returns the walk's length.
template <int TM, typename SegOf>
__device__ __forceinline__ int walk(const int* nb, int n_blocks, int block_m, int col_tiles,
                                    int units, SegOf seg_of, int* start, int* row_tiles) {
  int total = 0;
  for (int u = 0; u < units; ++u) {
    row_tiles[u] = used_rows(nb, seg_of(u), n_blocks, block_m) / TM;
    start[u] = total;
    total += row_tiles[u] * col_tiles;
  }
  start[units] = total;
  return total;
}

// One used tile of segment seg: tile wt of its (row tiles fastest within a
// column tile) against its block's expert, A the segment's rows.
template <typename In, int TM, typename OutT>
__device__ __forceinline__ void seg_tile(const In* A, int lda, const In* w, int ldw,
                                         long long w_expert, const int* be, const int* nb,
                                         int seg, int n_blocks, int block_m, int E, int rt,
                                         int wt, OutT* C, int ldc, int K, int N,
                                         unsigned char* smem) {
  const int row0 = (wt % rt) * TM;
  const int col0 = (wt / rt) * kTN;
  int e = 0;
  block_expert(be + (size_t)seg * n_blocks, nb + seg, row0, block_m, n_blocks, E, &e);
  tile<In, TM, OutT>(A, lda, w + (size_t)e * w_expert, ldw, C, ldc, K, N, row0, col0, smem);
}

// grid (lanes, N), rank blockIdx.y, member me of its group G of n; see the
// header comment. x [n, P, H] (every group's); out: each rank's [n * P, n *
// nl] output (its group's); ws: each rank's [n, P, H] slots; pads: each
// rank's pad of >= lanes + N + 1 words.
template <typename In, int TM>
__global__ void __launch_bounds__(kThreads)
    ag_moe_kernel(const In* __restrict__ x, const In* __restrict__ w, const int* __restrict__ be,
                  const int* __restrict__ nb, PeerTable outs, PeerTable ws, PeerTable pads,
                  Group G, int P, int H, int nl, int F, int block_m, int E, int silent,
                  Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int me = group_me(G);
  const int n = group_n(G);
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  const int n_blocks = P / block_m;
  int* pad = symm_at<int>(pads, my_pe());
  if (!barrier_group_block(pads, lane, G, L)) return;

  // my lane's share of my segment's used rows into slot `me` of every
  // peer, then one arrival on each peer's count of segment `me`
  const In* mine = x + (size_t)me * P * H;
  const size_t slot_bytes = (size_t)P * H * sizeof(In);
  const long long nbytes = (long long)used_rows(nb, me, n_blocks, block_m) * H * sizeof(In);
  const long long per = ((nbytes + lanes - 1) / lanes + 15) / 16 * 16;
  const long long b0 = (long long)lane * per;
  const long long b1 = b0 + per < nbytes ? b0 + per : nbytes;
  if (b1 > b0)
    for (int p = 1; p < n; ++p)
      putmem_nbi_block(symm_at<unsigned char>(ws, group_pe(G, me + p)) + me * slot_bytes + b0,
                       reinterpret_cast<const unsigned char*>(mine) + b0, b1 - b0);
  __syncthreads();
  if (threadIdx.x == 0 && my_pe() != silent) {
    __threadfence();
    for (int p = 1; p < n; ++p)
      red_release_add(symm_at<int>(pads, group_pe(G, me + p)) + count_word(me), 1);
  }

  // my column block of every segment, from my own
  const int col_tiles = (nl + kTN - 1) / kTN;
  int start[kMaxPes + 1], row_tiles[kMaxPes];
  const int total = walk<TM>(nb, n_blocks, block_m, col_tiles, n,
                             [&](int u) { return (me + u) % n; }, start, row_tiles);
  const In* slots = symm_at<const In>(ws, my_pe());
  const In* wl = w + (size_t)me * nl;
  In* ol = symm_at<In>(outs, my_pe()) + (size_t)me * nl;
  int si = 0, waited = 0;  // the swizzled index of the last segment waited for
  for (int t = lane; t < total; t += lanes) {
    while (t >= start[si + 1]) ++si;
    const int seg = (me + si) % n;
    if (si > waited) {
      if (!wait_block(pad + count_word(seg), lanes, false, L, count_word(seg))) return;
      waited = si;
    }
    const In* A = si == 0 ? mine : slots + (size_t)seg * P * H;
    seg_tile<In, TM, In>(A, H, wl, F, (long long)H * F, be, nb, seg, n_blocks, block_m, E,
                         row_tiles[si], t - start[si], ol + (size_t)seg * P * F, F, H, nl, smem);
  }
  if (!finish_block(pad, lanes, me, L, n)) return;
  quiet();
}

// grid (lanes, N), the relay over R's tiers; me is the rank's index over
// all the axes (R.all). x, w, be, nb, outs, ws as ag_moe_kernel's with n =
// R.all.n. Lane l relays bytes [l * per, (l + 1) * per) of each segment's
// used rows and emits its share of each segment's used tiles, walked as
// ag_moe_kernel walks them: one sequence over the segments in the order
// they are emitted, every lanes-th tile.
template <typename In, int TM>
__global__ void __launch_bounds__(kThreads)
    ag_moe_2d_kernel(const In* __restrict__ x, const In* __restrict__ w,
                     const int* __restrict__ be, const int* __restrict__ nb, PeerTable outs,
                     PeerTable ws, PeerTable pads, Relay2d R, int P, int H, int nl, int F,
                     int block_m, int E, long long per, int silent, Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int me = group_me(R.all);
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  const int n_blocks = P / block_m;
  const long long slot_bytes = (long long)P * H * sizeof(In);
  long long b0 = (long long)lane * per;
  const long long b1 = b0 + per < slot_bytes ? b0 + per : slot_bytes;
  if (b0 > slot_bytes) b0 = slot_bytes;
  const int col_tiles = (nl + kTN - 1) / kTN;
  const In* wl = w + (size_t)me * nl;
  In* ol = symm_at<In>(outs, my_pe()) + (size_t)me * nl;
  const unsigned char* shard = reinterpret_cast<const unsigned char*>(x + (size_t)me * P * H);
  int done = 0;  // used tiles of the segments emitted before this one
  relay_2d(
      R, ws, pads, shard, slot_bytes, b0, b1, silent, L,
      [&](const unsigned char* src, int seg) {
        const int rt = used_rows(nb, seg, n_blocks, block_m) / TM;
        for (int wt = ((lane - done) % lanes + lanes) % lanes; wt < rt * col_tiles; wt += lanes)
          seg_tile<In, TM, In>(reinterpret_cast<const In*>(src), H, wl, F, (long long)H * F, be,
                               nb, seg, n_blocks, block_m, E, rt, wt, ol + (size_t)seg * P * F,
                               F, H, nl, smem);
        done += rt * col_tiles;
      },
      [&](int seg) {
        return (long long)used_rows(nb, seg, n_blocks, block_m) * H * (long long)sizeof(In);
      });
}

// grid (lanes, N), rank blockIdx.y, member me of its group G of ni (the
// axis; over two tiers the inner group), and member kb of A (the group
// whose index picks the K block: G itself, or over two tiers the group over
// all the axes); see the header comment. x [no * ni * P, K], segment s's
// aligned rows at s * P, the K block kb at columns kb * kl; w [E, K, N],
// the K block at rows kb * kl of each expert; outs: each rank's [no * P, N]
// f32 result; ws: each rank's [ni, no * P, N] f32 slots, slot s holding
// member s's partial of my chunk; pads: each rank's pad of >= lanes + N +
// 1 words. Member j's chunk is segments r * ni + j for r < no, at rows r *
// P of the slot.
template <typename In, int TM>
__global__ void __launch_bounds__(kThreads)
    moe_rs_kernel(const In* __restrict__ x, const In* __restrict__ w, const int* __restrict__ be,
                  const int* __restrict__ nb, PeerTable outs, PeerTable ws, PeerTable pads,
                  Group G, Group A, int no, int P, int N, int kl, int block_m, int E,
                  int silent, Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int me = group_me(G);
  const int ni = group_n(G);
  const int kb = group_me(A);
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  const int n_blocks = P / block_m;
  const int K = no * ni * kl;
  int* pad = symm_at<int>(pads, my_pe());
  if (!barrier_group_block(pads, lane, G, L)) return;

  // my partial of every chunk, my own last, each tile stored into the
  // owner's slot `me` and counted on the owner's count of my index; unit
  // u = si * no + r is block r of chunk (me + 1 + si) % ni
  const int col_tiles = (N + kTN - 1) / kTN;
  const int units = ni * no;
  auto seg_of = [&](int u) { return (u % no) * ni + (me + 1 + u / no) % ni; };
  int start[kMaxPes + 1], row_tiles[kMaxPes];
  const int total = walk<TM>(nb, n_blocks, block_m, col_tiles, units, seg_of, start, row_tiles);
  const long long chunk_elems = (long long)no * P * N;
  const In* xl = x + (size_t)kb * kl;
  const In* wl = w + (size_t)kb * kl * N;
  int u = 0;
  for (int t = lane; t < total; t += lanes) {
    while (t >= start[u + 1]) ++u;
    const int seg = seg_of(u);
    const int owner = group_pe(G, (me + 1 + u / no) % ni);
    seg_tile<In, TM, float>(xl + (size_t)seg * P * K, K, wl, N, (long long)K * N, be, nb, seg,
                            n_blocks, block_m, E, row_tiles[u], t - start[u],
                            symm_at<float>(ws, owner) + me * chunk_elems + (size_t)(u % no) * P * N,
                            N, kl, N, smem);
    if (my_pe() != silent) signal_op_block(symm_at<int>(pads, owner) + count_word(me), 1);
  }

  // my chunk (the units of si = ni - 1): wait for every member's partial,
  // then the slot sum of its used rows; over two tiers every other row of
  // the chunk is zero, so the outer ring reads no unwritten row
  int mine = 0;
  int used[kMaxPes];
  for (int r = 0; r < no; ++r) {
    used[r] = row_tiles[(ni - 1) * no + r] * TM;
    mine += row_tiles[(ni - 1) * no + r] * col_tiles;
  }
  for (int s = 0; s < ni; ++s)
    if (!wait_block(pad + count_word(s), mine, false, L, count_word(s))) return;
  const float* slots = symm_at<const float>(ws, my_pe());
  float* o = symm_at<float>(outs, my_pe());
  const long long stride = (long long)lanes * kThreads;
  const long long first = (long long)lane * kThreads + threadIdx.x;
  for (int r = 0; r < no; ++r) {
    const long long base = (long long)r * P * N;
    const long long sum_end = base + (long long)used[r] * N;
    if (N % 4 == 0) {
      for (long long i = base + first * 4; i < sum_end; i += stride * 4)
        tdt_gemm::slot_sum<float, 4, true>(slots, o, ni, chunk_elems, i);
    } else {
      for (long long i = base + first; i < sum_end; i += stride)
        tdt_gemm::slot_sum<float, 1, true>(slots, o, ni, chunk_elems, i);
    }
    if (no > 1)
      for (long long i = sum_end + first; i < base + (long long)P * N; i += stride) o[i] = 0.f;
  }
  finish_block(pad, mine, -1, L, ni);
}

// What the host hands every launch: `cols` is ag_moe's nl (its F = g * nl)
// and moe_rs's N; `depth` is ag_moe's H and moe_rs's kl; n the launch's
// ranks (grid y); G the group of the 1-tier forms; A moe_rs's K-block
// group; R the tiers of the 2-tier ag_moe; no moe_rs's strided segments a
// chunk (1 in its 1-tier form).
struct Call {
  const void* x;
  const void* w;
  const void* be;
  const void* nb;
  const void* const* out;
  const void* const* ws;
  const void* const* pads;
  const Group* G;
  const Group* A;
  const Relay2d* R;
  int n, no, P, cols, depth, block_m, E, lanes, silent;
  void* claim;
  void* report;
  unsigned long long budget_ns;
  void* stream;
};

template <typename KernelT, typename... Args>
int launch_kernel(KernelT kernel, size_t smem, const Call& q, int id, Args... args) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int lanes = resident_lanes(kernel, kThreads, q.lanes, q.n, smem, kBlocksPerSm);
  if (lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return launch_cooperative(kernel, dim3(lanes, q.n), dim3(kThreads), smem, q.stream, q.x, q.w,
                            q.be, q.nb, make_table(q.out, q.n), make_table(q.ws, q.n),
                            make_table(q.pads, q.n), args..., q.silent,
                            make_launch(q.claim, q.report, q.budget_ns, id));
}

enum Form : int { kAg = 0, kAg2d = 1, kRs = 2 };

template <Form F, typename In, int TM>
int launch(const Call& q) {
  if constexpr (F == kRs) {
    auto kernel = moe_rs_kernel<In, TM>;
    return launch_kernel(kernel, tile_smem<In, TM>(), q, kMoeRs, *q.G, *q.A, q.no, q.P, q.cols,
                         q.depth, q.block_m, q.E);
  } else if constexpr (F == kAg) {
    auto kernel = ag_moe_kernel<In, TM>;
    return launch_kernel(kernel, tile_smem<In, TM>(), q, kAgMoe, *q.G, q.P, q.depth, q.cols,
                         q.G->n * q.cols, q.block_m, q.E);
  } else {
    auto kernel = ag_moe_2d_kernel<In, TM>;
    const size_t smem = tile_smem<In, TM>();
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int lanes = resident_lanes(kernel, kThreads, q.lanes, q.n, smem, kBlocksPerSm);
    if (lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const long long slot = (long long)q.P * q.depth * sizeof(In);
    const long long per = ((slot + lanes - 1) / lanes + 15) / 16 * 16;
    return launch_cooperative(kernel, dim3(lanes, q.n), dim3(kThreads), smem, q.stream, q.x, q.w,
                              q.be, q.nb, make_table(q.out, q.n), make_table(q.ws, q.n),
                              make_table(q.pads, q.n), *q.R, q.P, q.depth, q.cols,
                              q.R->all.n * q.cols, q.block_m, q.E, per, q.silent,
                              make_launch(q.claim, q.report, q.budget_ns, kAgMoe2d));
  }
}

// kind: 0 bf16 (B19's output bf16; B20's f32), 1 f32 throughout. bf16 runs
// 64-row tiles where block_m allows them, else 16; f32 runs 16.
template <Form F>
int dispatch(const Call& q, int kind) {
  if (kind == 1) return q.block_m % 16 ? (int)cudaErrorInvalidValue : launch<F, float, 16>(q);
  if (kind != 0) return (int)cudaErrorInvalidValue;
  if (q.block_m % 64 == 0) return launch<F, bf16, 64>(q);
  if (q.block_m % 16 == 0) return launch<F, bf16, 16>(q);
  return (int)cudaErrorInvalidValue;
}

bool call_ok(const Call& q) {
  return q.n >= 2 && q.n <= kMaxPes && q.no >= 1 && q.block_m > 0 && q.P > 0 &&
         q.P % q.block_m == 0 && q.cols > 0 && q.cols % 8 == 0 && q.depth > 0 &&
         q.depth % kTK == 0 && q.E > 0 && q.lanes >= 1;
}

}  // namespace

extern "C" {

// B19 over the groups of `group` (a Group over the n ranks of the launch;
// see ag_moe_kernel): x [g, P, H], g the group's size; w [E, H, g * nl]; be
// [g, P / block_m] i32; nb [g] i32; out: n pointers, each rank's group's
// output [g * P, g * nl] in x's type; ws: n pointers to each rank's [g, P,
// H] slots (x's type); pads: n pointers to pads of >= lanes + n + 1 zero
// words. `lanes` is cut to what the card keeps resident. Returns the
// launch's cudaError_t.
int tdt_ag_moe(const void* x, const void* w, const void* be, const void* nb,
               const void* const* out, const void* const* ws, const void* const* pads,
               const void* group, int n, int P, int H, int nl, int block_m, int E, int kind,
               int lanes, int silent, void* claim, void* report, unsigned long long budget_ns,
               void* stream) {
  if (group == nullptr) return (int)cudaErrorInvalidValue;
  const Call q{x, w, be, nb, out, ws, pads, static_cast<const Group*>(group), nullptr, nullptr,
               n, 1, P, nl, H, block_m, E, lanes, silent, claim, report, budget_ns, stream};
  if (!call_ok(q)) return (int)cudaErrorInvalidValue;
  return dispatch<kAg>(q, kind);
}

// B19 over two tiers (see ag_moe_2d_kernel): relay the Relay2d over the n
// ranks; x, w, be, nb, out, ws and pads as tdt_ag_moe's, g = relay->all.n;
// each slot of P * H elements a whole number of 16-byte vectors.
int tdt_ag_moe_2d(const void* x, const void* w, const void* be, const void* nb,
                  const void* const* out, const void* const* ws, const void* const* pads,
                  const void* relay, int n, int P, int H, int nl, int block_m, int E, int kind,
                  int lanes, int silent, void* claim, void* report,
                  unsigned long long budget_ns, void* stream) {
  if (relay == nullptr) return (int)cudaErrorInvalidValue;
  const Call q{x, w, be, nb, out, ws, pads, nullptr, nullptr, static_cast<const Relay2d*>(relay),
               n, 1, P, nl, H, block_m, E, lanes, silent, claim, report, budget_ns, stream};
  if (!call_ok(q)) return (int)cudaErrorInvalidValue;
  return dispatch<kAg2d>(q, kind);
}

// B20 over the groups of `group` (see moe_rs_kernel), the K block of each
// rank its index in `kgroup`, `no` strided segments a chunk (1 for the
// 1-tier form): x [no * g * P, no * g * kl]; w [E, no * g * kl, N]; be
// [no * g, P / block_m] i32; nb [no * g] i32; out: n pointers, each rank's
// [no * P, N] f32 result; ws: n pointers to each rank's [g, no * P, N] f32
// slots (16-byte aligned); pads: n pointers to pads of >= lanes + n + 1
// zero words.
int tdt_moe_rs(const void* x, const void* w, const void* be, const void* nb,
               const void* const* out, const void* const* ws, const void* const* pads,
               const void* group, const void* kgroup, int no, int n, int P, int N, int kl,
               int block_m, int E, int kind, int lanes, int silent, void* claim, void* report,
               unsigned long long budget_ns, void* stream) {
  if (group == nullptr || kgroup == nullptr) return (int)cudaErrorInvalidValue;
  const Call q{x, w, be, nb, out, ws, pads, static_cast<const Group*>(group),
               static_cast<const Group*>(kgroup), nullptr, n, no, P, N, kl, block_m, E, lanes,
               silent, claim, report, budget_ns, stream};
  if (!call_ok(q)) return (int)cudaErrorInvalidValue;
  return dispatch<kRs>(q, kind);
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
