// AllGather-GEMM and GEMM-ReduceScatter across ranks that share one card,
// written by hand for Hopper (sm_90a): the GEMM and its puts in one launch.
//
// Replaces the TPU kernels B15, _ag_gemm_kernel
// (triton_dist_tpu/ops/allgather_gemm.py:171, over ag_overlap_protocol
// :51-83 and ag_overlap_protocol_2d :86-168; the pallas_calls at :243 and
// :255), and B16, _gemm_rs_kernel (triton_dist_tpu/ops/gemm_reduce_scatter.py
// :112, over rs_overlap_protocol :44-85 and emit_slot_reduction :88-109; the
// pallas_calls at :332 and :343) with its 2-tier stage
// _gemm_rs_2d_stage_kernel (:126; the pallas_calls at :235 and :245). Every
// form runs over a group of the mesh (shmem.cuh's Group: an axis that spans
// the whole mesh is its one group), one launch covering every rank of every
// group; tables are indexed by flat rank, segments by group index.
//
//   AG-GEMM: a [M, K] sharded on rows, b [K, N] on columns; C = all_gather(a)
//            @ b, [M, N] sharded on columns. After the entry barrier each
//            rank puts its shard into slot `me` of every peer's workspace
//            [n, M/n, K], then computes its column block segment by segment
//            in the swizzled order me, me+1, ...: its own segment straight
//            from a, each remote one from its slot once the slot's puts
//            have all arrived.
//   AG-GEMM over two tiers (axes (outer, *inner)): ag_relay_2d.cuh's relay
//            (the same-inner-index ring over the outer axis, the push over
//            the inner group) with the GEMM tile as its emit, the workspace
//            [n, M/n, K] as its slots: each block computes its share of a
//            segment's output tiles once the segment has arrived.
//   GEMM-RS: a [M, K] sharded on columns, b [K, N] on rows; the sum over
//            ranks of a_r @ b_r, its M rows scattered over the ranks. Each
//            rank computes the f32 partial of every segment over its K
//            block, in the order me+1, ..., me (its own last), and its
//            epilogue stores each tile straight into the owner's symmetric
//            slot `me` (the NVLink peer store of a card per rank); then it
//            sums its own segment's slots in slot order 0 .. n-1 in f32
//            and casts once.
//   GEMM-RS's 2-tier stage (axes (outer, *inner), no outer and ni inner
//            ranks): the same protocol over the inner group, where the
//            segment of inner peer j is the strided row set {(r, j) : r <
//            no}, laid out outer-major in a chunk of no * M/n rows, and the
//            K block is the rank's index over all the axes. The surviving
//            chunk, the f32 slot sum of the ni partials, is what the ring
//            reduce-scatter over the outer group (reduce_scatter.cu, B13)
//            then takes, with no re-permute.
//
// Every form runs the tile of the dense GEMM (gemm_tile.cuh, B2's) on
// strided blocks, every element summed over its whole K in one fixed order:
// AG-GEMM at n ranks, over a group or over two tiers, is bitwise B2 on the
// gathered A, column block by column block; GEMM-RS is bitwise the slot
// reduction (slot_sum, the same function as gemm.cu's) of the n B2
// partials, and its 2-tier stage the slot reduction of the ni partials of
// each strided chunk. GEMM-RS stores its partials without the TPU kernel's
// double-buffered send stage: the stage stays scratch, unwritten.
//
// What bounds them on this card: the operations, as B2's (2 M N K in all
// over the ranks), plus the bytes of the protocol: AG-GEMM puts n - 1
// copies of each shard (over two tiers the relayed ones once more),
// GEMM-RS writes and reads n f32 partials of M/n x N. With every rank on
// one card those bytes share its HBM with the GEMM.
//
// What the design does about it: one cooperative launch a call, grid
// (lanes, N), the rank on y (shmem.cuh). The blocks of a rank first share
// its puts (AG-GEMM), then walk a persistent loop over the rank's output
// tiles, row tiles fastest within a column tile, segment after segment.
// lanes is what the card keeps resident over all N ranks at the GEMM
// tile's shared memory (two blocks an SM at 74-80 KiB each for bf16); a
// grid that cannot be resident is refused. Over two tiers a block forwards
// a relayed segment only after emitting the segments before it, so a
// peer's wait on a relayed segment grows by a block's GEMM of those: right
// while every block is resident, and visible in the time.
//
// Signals (shmem.cuh's count_word, finish_word and finish_block): pad
// words [lane] are the entry barrier (consumed by its wait);
// [lanes + s] count arrivals for segment s: in AG-GEMM one per lane of
// member s whose share of the puts is stored, in GEMM-RS one per tile of
// member s's partial of my segment. Many blocks wait on one count, so no
// wait consumes it: each block, once it reads no count any more, adds one
// to the rank's finish word [lanes + N], and the last block of the rank
// waits for every count to be complete, consumes it and zeroes the finish
// word, so the pad is zero again after the call. Waiters acquire, meet at
// __syncthreads, and then read the peer's data through L2 (cp.async.cg,
// ld.cg); every spin is shmem.cuh's bounded wait. `silent` names a rank
// that puts or stores but never signals (the hang check).

#include <type_traits>

#include "ag_relay_2d.cuh"
#include "gemm_tile.cuh"
#include "shmem.cuh"

using namespace tdt_shmem;
using namespace tdt_gemm;

namespace {

constexpr int kMT = 4;  // bf16 tiles of 32 * kMT = 128 rows

template <typename In>
struct TileOf {  // bf16: the tensor-core tile, two blocks an SM
  static constexpr int kRows = 32 * kMT;
  static constexpr int kMinBlocks = 2;
};
template <>
struct TileOf<float> {  // f32: the CUDA-core tile
  static constexpr int kRows = kF32Tile;
  static constexpr int kMinBlocks = 1;
};

template <typename In, bool kBT>
constexpr size_t tile_smem() {
  if constexpr (std::is_same<In, bf16>::value)
    return bf16_smem_bytes<kMT, kBT>();
  else
    return kF32SmemBytes;
}

// One tile of the persistent loop, A read through L2 (a peer may have put
// it): the block meets first, so the previous tile's stages are consumed.
template <typename In, bool kBT, typename OutT>
__device__ __forceinline__ void tile(const In* A, int lda, const In* B, int ldb, OutT* C, int ldc,
                                     int M, int N, int K, int row0, int col0,
                                     unsigned char* smem) {
  __syncthreads();
  if constexpr (std::is_same<In, bf16>::value)
    gemm_tile_bf16<kMT, kBT, OutT, true>(A, lda, B, ldb, C, ldc, M, N, K, row0, col0, smem);
  else
    gemm_tile_f32<kBT, true>(A, lda, B, ldb, C, ldc, M, N, K, row0, col0,
                             reinterpret_cast<float*>(smem));
}

// The column block of b that rank index `me` multiplies: row-major [K, n *
// n_local] with row stride ldb (its columns at me * n_local), or (kBT)
// [n * n_local, K] (its rows there).
template <typename In, bool kBT>
__device__ __forceinline__ const In* column_block(const In* b, int me, int n_local, int ldb) {
  return kBT ? b + (size_t)me * n_local * ldb : b + (size_t)me * n_local;
}

// grid (lanes, N), rank blockIdx.y, member me of its group of n along the
// axis. a [n * m_local, K] (every group's), member s's shard at rows s *
// m_local; b [K, n * n_local] or (kBT) [n * n_local, K], see column_block;
// c: each rank's [n * m_local, n * n_local] output (its group's), member
// s's columns at s * n_local; ws: each rank's [n, m_local, K] slots; pads:
// each rank's signal pad. Lane l puts bytes [l * per, (l + 1) * per) of the
// shard.
template <typename In, bool kBT, typename OutT>
__global__ void __launch_bounds__(kThreads, TileOf<In>::kMinBlocks)
    ag_gemm_kernel(const In* __restrict__ a, const In* __restrict__ b, PeerTable c, PeerTable ws,
                   PeerTable pads, Group G, int m_local, int n_local, int K, int ldb,
                   long long per, int silent, Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int me = group_me(G);
  const int n = group_n(G);
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  int* pad = symm_at<int>(pads, my_pe());
  if (!barrier_group_block(pads, lane, G, L)) return;

  // my lane's share of the shard into slot `me` of every peer, then one
  // arrival on each peer's count of segment `me`
  const In* shard = a + (size_t)me * m_local * K;
  const long long nbytes = (long long)m_local * K * sizeof(In);
  const long long b0 = (long long)lane * per;
  const long long b1 = b0 + per < nbytes ? b0 + per : nbytes;
  if (b1 > b0)
    for (int p = 1; p < n; ++p)
      putmem_nbi_block(symm_at<unsigned char>(ws, group_pe(G, me + p)) + (size_t)me * nbytes + b0,
                       reinterpret_cast<const unsigned char*>(shard) + b0, b1 - b0);
  __syncthreads();
  if (threadIdx.x == 0 && my_pe() != silent) {
    __threadfence();
    for (int p = 1; p < n; ++p)
      red_release_add(symm_at<int>(pads, group_pe(G, me + p)) + count_word(me), 1);
  }

  // my column block, segment by segment from my own
  constexpr int TM = TileOf<In>::kRows;
  const int row_tiles = (m_local + TM - 1) / TM;
  const int per_seg = row_tiles * ((n_local + kTN - 1) / kTN);
  const int ldc = n * n_local;
  const In* bl = column_block<In, kBT>(b, me, n_local, ldb);
  OutT* cl = symm_at<OutT>(c, my_pe()) + (size_t)me * n_local;
  const In* slots = symm_at<const In>(ws, my_pe());
  int waited = 0;  // the swizzled index of the last segment waited for
  for (int t = lane; t < n * per_seg; t += lanes) {
    const int si = t / per_seg, w = t % per_seg;
    const int seg = (me + si) % n;
    if (si > waited) {
      if (!wait_block(pad + count_word(seg), lanes, false, L, count_word(seg))) return;
      waited = si;
    }
    const In* A = si == 0 ? shard : slots + (size_t)seg * m_local * K;
    tile<In, kBT, OutT>(A, K, bl, ldb, cl + (size_t)seg * m_local * ldc, ldc, m_local, n_local, K,
                        (w % row_tiles) * TM, (w / row_tiles) * kTN, smem);
  }
  if (!finish_block(pad, lanes, me, L, n)) return;
  quiet();
}

// grid (lanes, N), the relay over R's tiers; me is the rank's index over
// all the axes (R.all), the P(axes) order. a, b, c, ws as ag_gemm_kernel's
// with n = R.all.n. Lane l relays bytes [l * per, (l + 1) * per) of every
// segment and emits its share of each segment's tiles, walked as
// ag_gemm_kernel walks them: one sequence over the segments in the order
// they are emitted, every lanes-th tile.
template <typename In, bool kBT, typename OutT>
__global__ void __launch_bounds__(kThreads, TileOf<In>::kMinBlocks)
    ag_gemm_2d_kernel(const In* __restrict__ a, const In* __restrict__ b, PeerTable c,
                      PeerTable ws, PeerTable pads, Relay2d R, int m_local, int n_local, int K,
                      int ldb, long long per, int silent, Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int me = group_me(R.all);
  const int n = group_n(R.all);
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  const long long nbytes = (long long)m_local * K * sizeof(In);
  long long b0 = (long long)lane * per;
  const long long b1 = b0 + per < nbytes ? b0 + per : nbytes;
  if (b0 > nbytes) b0 = nbytes;
  constexpr int TM = TileOf<In>::kRows;
  const int row_tiles = (m_local + TM - 1) / TM;
  const int per_seg = row_tiles * ((n_local + kTN - 1) / kTN);
  const int ldc = n * n_local;
  const In* bl = column_block<In, kBT>(b, me, n_local, ldb);
  OutT* cl = symm_at<OutT>(c, my_pe()) + (size_t)me * n_local;
  const unsigned char* shard =
      reinterpret_cast<const unsigned char*>(a + (size_t)me * m_local * K);
  // the 1-tier kernel's tile walk: tile t of the segments in the relay's
  // order of emission goes to lane t % lanes
  int done = 0;  // tiles of the segments emitted before this one
  relay_2d(R, ws, pads, shard, nbytes, b0, b1, silent, L,
           [&](const unsigned char* src, int seg) {
             const In* A = reinterpret_cast<const In*>(src);
             for (int w = ((lane - done) % lanes + lanes) % lanes; w < per_seg; w += lanes)
               tile<In, kBT, OutT>(A, K, bl, ldb, cl + (size_t)seg * m_local * ldc, ldc, m_local,
                                   n_local, K, (w % row_tiles) * TM, (w / row_tiles) * kTN, smem);
             done += per_seg;
           });
}

// grid (lanes, N), rank blockIdx.y, member me of its group G of ni (the
// axis; over two tiers the inner group), and member kb of A (the group
// whose index picks the K block: G itself, or over two tiers the group
// over all the axes). a [(no * ni) * m_seg, lda], the K block kb at
// columns kb * k_local; b [., N] with row stride ldb, the K block at rows
// kb * k_local, or (kBT) [N, .] with it at columns kb * k_local; out: each
// rank's [no * m_seg, N] result (its group's segment me of the output, or
// over two tiers the chunk for the outer ring); ws: each rank's [ni, no *
// m_seg, N] f32 slots, slot s holding member s's partial of my chunk;
// pads: each rank's signal pad. Member j's chunk is rows (r * ni + j) *
// m_seg of a for r < no, stored at rows r * m_seg of the slot.
template <typename In, bool kBT, typename OutT>
__global__ void __launch_bounds__(kThreads, TileOf<In>::kMinBlocks)
    gemm_rs_kernel(const In* __restrict__ a, const In* __restrict__ b, PeerTable out, PeerTable ws,
                   PeerTable pads, Group G, Group A, int no, int m_seg, int N, int k_local,
                   int lda, int ldb, int silent, Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int me = group_me(G);
  const int ni = group_n(G);
  const int kb = group_me(A);
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  int* pad = symm_at<int>(pads, my_pe());
  if (!barrier_group_block(pads, lane, G, L)) return;

  // my partial of every chunk, my own last, each tile stored into the
  // owner's slot `me` and counted on the owner's count of my index
  constexpr int TM = TileOf<In>::kRows;
  const int row_tiles = (m_seg + TM - 1) / TM;
  const int blk = row_tiles * ((N + kTN - 1) / kTN);
  const int per_seg = no * blk;
  const long long chunk_elems = (long long)no * m_seg * N;
  const In* al = a + (size_t)kb * k_local;
  const In* bl = kBT ? b + (size_t)kb * k_local : b + (size_t)kb * k_local * ldb;
  for (int t = lane; t < ni * per_seg; t += lanes) {
    const int si = t / per_seg, w = t % per_seg;
    const int j = (me + 1 + si) % ni;
    const int r = w / blk, wb = w % blk;
    const int owner = group_pe(G, j);
    tile<In, kBT, float>(al + (size_t)(r * ni + j) * m_seg * lda, lda, bl, ldb,
                         symm_at<float>(ws, owner) + me * chunk_elems + (size_t)r * m_seg * N, N,
                         m_seg, N, k_local, (wb % row_tiles) * TM, (wb / row_tiles) * kTN, smem);
    if (my_pe() != silent) signal_op_block(symm_at<int>(pads, owner) + count_word(me), 1);
  }

  // my chunk: wait for every member's partial, then the slot sum
  for (int s = 0; s < ni; ++s)
    if (!wait_block(pad + count_word(s), per_seg, false, L, count_word(s))) return;
  const float* slots = symm_at<const float>(ws, my_pe());
  OutT* o = symm_at<OutT>(out, my_pe());
  const long long stride = (long long)lanes * kThreads;
  if (chunk_elems % 4 == 0) {
    for (long long i = ((long long)lane * kThreads + threadIdx.x) * 4; i < chunk_elems;
         i += stride * 4)
      slot_sum<OutT, 4, true>(slots, o, ni, chunk_elems, i);
  } else {
    for (long long i = (long long)lane * kThreads + threadIdx.x; i < chunk_elems; i += stride)
      slot_sum<OutT, 1, true>(slots, o, ni, chunk_elems, i);
  }
  finish_block(pad, per_seg, -1, L, ni);
}

// What the host hands every launch: n the launch's ranks (grid y); G the
// group of the 1-tier forms; A GEMM-RS's K-block group; R the tiers of the
// 2-tier AG-GEMM; no GEMM-RS's strided blocks a chunk (1 in its 1-tier
// form).
struct Call {
  const void* a;
  const void* b;
  const void* const* c;
  const void* const* ws;
  const void* const* pads;
  const Group* G;
  const Group* A;
  const Relay2d* R;
  int n, no, m, n_cols, k, lda, ldb, lanes, silent;
  void* claim;
  void* report;
  unsigned long long budget_ns;
  void* stream;
};

template <typename KernelT>
int prepare(KernelT kernel, size_t smem, const Call& q, int* lanes) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *lanes = resident_lanes(kernel, kThreads, q.lanes, q.n, smem);
  return *lanes < 1 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

// lane l's 16-byte-aligned share of a shard of nbytes
inline long long lane_share(long long nbytes, int lanes) {
  return ((nbytes + lanes - 1) / lanes + 15) / 16 * 16;
}

template <typename In, bool kBT, typename OutT>
int launch_ag(const Call& q) {
  auto kernel = ag_gemm_kernel<In, kBT, OutT>;
  const size_t smem = tile_smem<In, kBT>();
  int lanes = 0;
  if (const int e = prepare(kernel, smem, q, &lanes)) return e;
  const long long per = lane_share((long long)q.m * q.k * sizeof(In), lanes);
  return launch_cooperative(kernel, dim3(lanes, q.n), dim3(kThreads), smem, q.stream, q.a, q.b,
                            make_table(q.c, q.n), make_table(q.ws, q.n),
                            make_table(q.pads, q.n), *q.G, q.m, q.n_cols, q.k, q.ldb, per,
                            q.silent, make_launch(q.claim, q.report, q.budget_ns, kAgGemm));
}

template <typename In, bool kBT, typename OutT>
int launch_ag_2d(const Call& q) {
  auto kernel = ag_gemm_2d_kernel<In, kBT, OutT>;
  const size_t smem = tile_smem<In, kBT>();
  int lanes = 0;
  if (const int e = prepare(kernel, smem, q, &lanes)) return e;
  const long long per = lane_share((long long)q.m * q.k * sizeof(In), lanes);
  return launch_cooperative(kernel, dim3(lanes, q.n), dim3(kThreads), smem, q.stream, q.a, q.b,
                            make_table(q.c, q.n), make_table(q.ws, q.n),
                            make_table(q.pads, q.n), *q.R, q.m, q.n_cols, q.k, q.ldb, per,
                            q.silent, make_launch(q.claim, q.report, q.budget_ns, kAgGemm2d));
}

template <typename In, bool kBT, typename OutT>
int launch_rs(const Call& q) {
  auto kernel = gemm_rs_kernel<In, kBT, OutT>;
  const size_t smem = tile_smem<In, kBT>();
  int lanes = 0;
  if (const int e = prepare(kernel, smem, q, &lanes)) return e;
  return launch_cooperative(kernel, dim3(lanes, q.n), dim3(kThreads), smem, q.stream, q.a, q.b,
                            make_table(q.c, q.n), make_table(q.ws, q.n),
                            make_table(q.pads, q.n), *q.G, *q.A, q.no, q.m, q.n_cols, q.k,
                            q.lda, q.ldb, q.silent,
                            make_launch(q.claim, q.report, q.budget_ns, kGemmRs));
}

enum Form : int { kAg = 0, kAg2d = 1, kRs = 2 };

template <Form F, typename In, bool kBT, typename OutT>
int launch(const Call& q) {
  if constexpr (F == kAg) return launch_ag<In, kBT, OutT>(q);
  if constexpr (F == kAg2d) return launch_ag_2d<In, kBT, OutT>(q);
  return launch_rs<In, kBT, OutT>(q);
}

// kind: 0 bf16 in and out, 1 bf16 in and f32 out, 2 f32 throughout
template <Form F, bool kBT>
int dispatch(const Call& q, int kind) {
  switch (kind) {
    case 0:
      return launch<F, bf16, kBT, bf16>(q);
    case 1:
      return launch<F, bf16, kBT, float>(q);
    case 2:
      return launch<F, float, kBT, float>(q);
  }
  return (int)cudaErrorInvalidValue;
}

template <Form F>
int run(const Call& q, int b_trans, int kind) {
  if (q.n < 2 || q.n > kMaxPes || q.m <= 0 || q.n_cols <= 0 || q.k <= 0 || q.lanes < 1)
    return (int)cudaErrorInvalidValue;
  return b_trans ? dispatch<F, true>(q, kind) : dispatch<F, false>(q, kind);
}

}  // namespace

extern "C" {

// AG-GEMM over the groups of `group` (a Group over the n ranks of the
// launch; see ag_gemm_kernel): a [g * m_local, K], g the group's size; b
// [K, g * n_local] with row stride ldb, or [g * n_local, K] (b_trans); c: n
// pointers, each rank's group's output [g * m_local, g * n_local]; ws: n
// pointers to each rank's [g, m_local, K] slots (a's type); pads: n
// pointers to pads of >= lanes + n + 1 zero words. `lanes` is cut to what
// the card keeps resident (resident_lanes, shmem.cuh). Returns the
// launch's cudaError_t.
int tdt_ag_gemm(const void* a, const void* b, const void* const* c, const void* const* ws,
                const void* const* pads, const void* group, int n, int m_local, int n_local,
                int K, int ldb, int b_trans, int kind, int lanes, int silent, void* claim,
                void* report, unsigned long long budget_ns, void* stream) {
  if (group == nullptr) return (int)cudaErrorInvalidValue;
  const Call q{a, b, c, ws, pads, static_cast<const Group*>(group), nullptr, nullptr,
               n, 1, m_local, n_local, K, K, ldb, lanes, silent, claim, report, budget_ns,
               stream};
  return run<kAg>(q, b_trans, kind);
}

// AG-GEMM over two tiers (see ag_gemm_2d_kernel): relay the Relay2d over
// the n ranks; a, b, c, ws and pads as tdt_ag_gemm's, g = relay->all.n;
// each shard of m_local * K elements a whole number of 16-byte vectors.
int tdt_ag_gemm_2d(const void* a, const void* b, const void* const* c, const void* const* ws,
                   const void* const* pads, const void* relay, int n, int m_local, int n_local,
                   int K, int ldb, int b_trans, int kind, int lanes, int silent, void* claim,
                   void* report, unsigned long long budget_ns, void* stream) {
  if (relay == nullptr) return (int)cudaErrorInvalidValue;
  const Call q{a, b, c, ws, pads, nullptr, nullptr, static_cast<const Relay2d*>(relay),
               n, 1, m_local, n_local, K, K, ldb, lanes, silent, claim, report, budget_ns,
               stream};
  return run<kAg2d>(q, b_trans, kind);
}

// GEMM-RS over the groups of `group` (see gemm_rs_kernel), the K block of
// each rank its index in `kgroup`, `no` strided blocks of m_seg rows a
// chunk (1 for the 1-tier form): a [no * g * m_seg, lda]; b [., N] with row
// stride ldb, or [N, .] (b_trans); out: n pointers, each rank's [no *
// m_seg, N] result; ws: n pointers to each rank's [g, no * m_seg, N] f32
// slots (16-byte aligned); pads: n pointers to pads of >= lanes + n + 1
// zero words.
int tdt_gemm_rs(const void* a, const void* b, const void* const* out, const void* const* ws,
                const void* const* pads, const void* group, const void* kgroup, int no, int n,
                int m_seg, int N, int k_local, int lda, int ldb, int b_trans, int kind,
                int lanes, int silent, void* claim, void* report, unsigned long long budget_ns,
                void* stream) {
  if (group == nullptr || kgroup == nullptr || no < 1) return (int)cudaErrorInvalidValue;
  const Call q{a, b, out, ws, pads, static_cast<const Group*>(group),
               static_cast<const Group*>(kgroup), nullptr, n, no, m_seg, N, k_local, lda, ldb,
               lanes, silent, claim, report, budget_ns, stream};
  return run<kRs>(q, b_trans, kind);
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
