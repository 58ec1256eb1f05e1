// AllGather-GEMM and GEMM-ReduceScatter across ranks that share one card,
// written by hand for Hopper (sm_90a): the GEMM and its puts in one launch.
//
// Replaces the TPU kernels B15, _ag_gemm_kernel
// (triton_dist_tpu/ops/allgather_gemm.py:171, over ag_overlap_protocol
// :51-83; the pallas_calls at :243 and :255), and B16, _gemm_rs_kernel
// (triton_dist_tpu/ops/gemm_reduce_scatter.py:112, over rs_overlap_protocol
// :44-85 and emit_slot_reduction :88-109; the pallas_calls at :332 and
// :343), in their 1-tier forms over an axis that spans the whole mesh.
//
//   AG-GEMM: a [M, K] sharded on rows, b [K, N] on columns; C = all_gather(a)
//            @ b, [M, N] sharded on columns. After the entry barrier each
//            rank puts its shard into slot `me` of every peer's workspace
//            [n, M/n, K], then computes its column block segment by segment
//            in the swizzled order me, me+1, ...: its own segment straight
//            from a, each remote one from its slot once the slot's puts
//            have all arrived.
//   GEMM-RS: a [M, K] sharded on columns, b [K, N] on rows; the sum over
//            ranks of a_r @ b_r, its M rows scattered over the ranks. Each
//            rank computes the f32 partial of every segment over its K/n
//            columns, in the order me+1, ..., me (its own last), and its
//            epilogue stores each tile straight into the owner's symmetric
//            slot `me` (the NVLink peer store of a card per rank); then it
//            sums its own segment's n slots in slot order 0 .. n-1 in f32
//            and casts once.
//
// Both run the tile of the dense GEMM (gemm_tile.cuh, B2's) on strided
// blocks, every element summed over its whole K in one fixed order: AG-GEMM
// at n ranks is bitwise B2 on the gathered A, column block by column block,
// and GEMM-RS is bitwise the slot reduction (slot_sum, the same function as
// gemm.cu's) of the n B2 partials. GEMM-RS stores its partials without the
// TPU kernel's double-buffered send stage: the stage stays scratch,
// unwritten.
//
// What bounds them on this card: the operations, as B2's (2 M N K in all
// over the ranks), plus the bytes of the protocol: AG-GEMM puts n - 1 copies
// of each shard, GEMM-RS writes and reads n f32 partials of M/n x N. With
// every rank on one card those bytes share its HBM with the GEMM.
//
// What the design does about it: one cooperative launch a call, grid
// (lanes, n), the rank on y (shmem.cuh). The blocks of a rank first share
// its puts (AG-GEMM), then walk a persistent loop over the rank's output
// tiles, row tiles fastest within a column tile, segment after segment.
// lanes is what the card keeps resident over all n ranks (two blocks an SM
// at 74-80 KiB of shared memory each for bf16); a grid that cannot be
// resident is refused.
//
// Signals (shmem.cuh's count_word, finish_word and finish_block): pad
// words [lane] are the entry barrier (consumed by its wait);
// [lanes + s] count arrivals for segment s: in AG-GEMM one per lane of rank
// s whose share of the puts is stored, in GEMM-RS one per tile of rank s's
// partial of my segment. Many blocks wait on one count, so no wait consumes
// it: each block, once it reads no count any more, adds one to the rank's
// finish word [lanes + n], and the last block of the rank waits for every
// count to be complete, consumes it and zeroes the finish word, so the pad
// is zero again after the call. Waiters acquire, meet at __syncthreads, and
// then read the peer's data through L2 (cp.async.cg, ld.cg); every spin is
// shmem.cuh's bounded wait.

#include <type_traits>

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

// grid (lanes, n), rank me = blockIdx.y. a [n * m_local, K], rank r's shard
// at rows r * m_local; b row-major [K, n * n_local] with row stride ldb,
// rank r's columns at r * n_local, or (kBT) stored as [n * n_local, K] with
// row stride ldb, rank r's rows at r * n_local; c [n * m_local, n *
// n_local], rank r's columns at r * n_local; ws: each rank's [n, m_local, K]
// slots; pads: each rank's signal pad. Lane l puts bytes [l * per, (l + 1)
// * per) of the shard.
template <typename In, bool kBT, typename OutT>
__global__ void __launch_bounds__(kThreads, TileOf<In>::kMinBlocks)
    ag_gemm_kernel(const In* __restrict__ a, const In* __restrict__ b, OutT* __restrict__ c,
                   PeerTable ws, PeerTable pads, int m_local, int n_local, int K, int ldb,
                   long long per, Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int me = my_pe();
  const int n = n_pes();
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  int* pad = symm_at<int>(pads, me);
  if (!barrier_all_block(pads, lane, L)) return;

  // my lane's share of the shard into slot `me` of every peer, then one
  // arrival on each peer's count of segment `me`
  const In* shard = a + (size_t)me * m_local * K;
  const long long nbytes = (long long)m_local * K * sizeof(In);
  const long long b0 = (long long)lane * per;
  const long long b1 = b0 + per < nbytes ? b0 + per : nbytes;
  if (b1 > b0)
    for (int p = 1; p < n; ++p)
      putmem_nbi_block(symm_at<unsigned char>(ws, pe_at(me + p)) + (size_t)me * nbytes + b0,
                       reinterpret_cast<const unsigned char*>(shard) + b0, b1 - b0);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    for (int p = 1; p < n; ++p)
      red_release_add(symm_at<int>(pads, pe_at(me + p)) + count_word(me), 1);
  }

  // my column block, segment by segment from my own
  constexpr int TM = TileOf<In>::kRows;
  const int row_tiles = (m_local + TM - 1) / TM;
  const int per_seg = row_tiles * ((n_local + kTN - 1) / kTN);
  const int ldc = n * n_local;
  const In* bl = kBT ? b + (size_t)me * n_local * ldb : b + (size_t)me * n_local;
  OutT* cl = c + (size_t)me * n_local;
  const In* slots = symm_at<const In>(ws, me);
  int waited = 0;  // the swizzled index of the last segment waited for
  for (int t = lane; t < n * per_seg; t += lanes) {
    const int si = t / per_seg, w = t % per_seg;
    const int seg = pe_at(me + si);
    if (si > waited) {
      if (!wait_block(pad + count_word(seg), lanes, false, L, count_word(seg))) return;
      waited = si;
    }
    const In* A = si == 0 ? shard : slots + (size_t)seg * m_local * K;
    tile<In, kBT, OutT>(A, K, bl, ldb, cl + (size_t)seg * m_local * ldc, ldc, m_local, n_local, K,
                        (w % row_tiles) * TM, (w / row_tiles) * kTN, smem);
  }
  if (!finish_block(pad, lanes, me, L)) return;
  quiet();
}

// grid (lanes, n), rank me = blockIdx.y. a [n * m_seg, lda], rank r's
// columns at r * k_local; b row-major [n * k_local, N] with row stride ldb,
// rank r's rows at r * k_local, or (kBT) stored as [N, n * k_local] with
// row stride ldb, rank r's columns at r * k_local; out [n * m_seg, N],
// rank r's rows at r * m_seg; ws: each rank's [n, m_seg, N] f32 slots, slot
// s holding rank s's partial; pads: each rank's signal pad.
template <typename In, bool kBT, typename OutT>
__global__ void __launch_bounds__(kThreads, TileOf<In>::kMinBlocks)
    gemm_rs_kernel(const In* __restrict__ a, const In* __restrict__ b, OutT* __restrict__ out,
                   PeerTable ws, PeerTable pads, int m_seg, int N, int k_local, int lda, int ldb,
                   Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int me = my_pe();
  const int n = n_pes();
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  int* pad = symm_at<int>(pads, me);
  if (!barrier_all_block(pads, lane, L)) return;

  // my partial of every segment, its own last, each tile stored into the
  // owner's slot `me` and counted on the owner's count of my rank
  constexpr int TM = TileOf<In>::kRows;
  const int row_tiles = (m_seg + TM - 1) / TM;
  const int per_seg = row_tiles * ((N + kTN - 1) / kTN);
  const long long seg_elems = (long long)m_seg * N;
  const In* al = a + (size_t)me * k_local;
  const In* bl = kBT ? b + (size_t)me * k_local : b + (size_t)me * k_local * ldb;
  for (int t = lane; t < n * per_seg; t += lanes) {
    const int si = t / per_seg, w = t % per_seg;
    const int seg = pe_at(me + 1 + si);
    tile<In, kBT, float>(al + (size_t)seg * m_seg * lda, lda, bl, ldb,
                         symm_at<float>(ws, seg) + (size_t)me * seg_elems, N, m_seg, N, k_local,
                         (w % row_tiles) * TM, (w / row_tiles) * kTN, smem);
    signal_op_block(symm_at<int>(pads, seg) + count_word(me), 1);
  }

  // my segment: wait for every rank's partial, then the slot sum
  for (int s = 0; s < n; ++s)
    if (!wait_block(pad + count_word(s), per_seg, false, L, count_word(s))) return;
  const float* slots = symm_at<const float>(ws, me);
  OutT* o = out + (size_t)me * seg_elems;
  const long long stride = (long long)lanes * kThreads;
  if (seg_elems % 4 == 0) {
    for (long long i = ((long long)lane * kThreads + threadIdx.x) * 4; i < seg_elems;
         i += stride * 4)
      slot_sum<OutT, 4, true>(slots, o, n, seg_elems, i);
  } else {
    for (long long i = (long long)lane * kThreads + threadIdx.x; i < seg_elems; i += stride)
      slot_sum<OutT, 1, true>(slots, o, n, seg_elems, i);
  }
  finish_block(pad, per_seg, -1, L);
}

// What the host hands every launch.
struct Call {
  const void* a;
  const void* b;
  void* c;
  const void* const* ws;
  const void* const* pads;
  int n, m, n_cols, k, lda, ldb, lanes;
  void* claim;
  void* report;
  unsigned long long budget_ns;
  void* stream;
};

template <typename In, bool kBT, typename OutT>
int launch_ag(const Call& q) {
  auto kernel = ag_gemm_kernel<In, kBT, OutT>;
  const size_t smem = tile_smem<In, kBT>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int lanes = resident_lanes(kernel, kThreads, q.lanes, q.n, smem);
  if (lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long nbytes = (long long)q.m * q.k * sizeof(In);
  const long long per = ((nbytes + lanes - 1) / lanes + 15) / 16 * 16;
  return launch_cooperative(kernel, dim3(lanes, q.n), dim3(kThreads), smem, q.stream, q.a, q.b,
                            q.c, make_table(q.ws, q.n), make_table(q.pads, q.n), q.m, q.n_cols,
                            q.k, q.ldb, per,
                            make_launch(q.claim, q.report, q.budget_ns, kAgGemm));
}

template <typename In, bool kBT, typename OutT>
int launch_rs(const Call& q) {
  auto kernel = gemm_rs_kernel<In, kBT, OutT>;
  const size_t smem = tile_smem<In, kBT>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int lanes = resident_lanes(kernel, kThreads, q.lanes, q.n, smem);
  if (lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return launch_cooperative(kernel, dim3(lanes, q.n), dim3(kThreads), smem, q.stream, q.a, q.b,
                            q.c, make_table(q.ws, q.n), make_table(q.pads, q.n), q.m, q.n_cols,
                            q.k, q.lda, q.ldb,
                            make_launch(q.claim, q.report, q.budget_ns, kGemmRs));
}

// kind: 0 bf16 in and out, 1 bf16 in and f32 out, 2 f32 throughout
template <bool kRs, bool kBT>
int dispatch(const Call& q, int kind) {
  switch (kind) {
    case 0:
      return kRs ? launch_rs<bf16, kBT, bf16>(q) : launch_ag<bf16, kBT, bf16>(q);
    case 1:
      return kRs ? launch_rs<bf16, kBT, float>(q) : launch_ag<bf16, kBT, float>(q);
    case 2:
      return kRs ? launch_rs<float, kBT, float>(q) : launch_ag<float, kBT, float>(q);
  }
  return (int)cudaErrorInvalidValue;
}

bool call_ok(const Call& q) {
  return q.n >= 2 && q.n <= kMaxPes && q.m > 0 && q.n_cols > 0 && q.k > 0 && q.lanes >= 1;
}

}  // namespace

extern "C" {

// AG-GEMM over n ranks (see ag_gemm_kernel): a [n * m_local, K]; b [K, n *
// n_local] with row stride ldb, or [n * n_local, K] (b_trans); c [n *
// m_local, n * n_local]; ws: n pointers to each rank's [n, m_local, K]
// slots (a's type); pads: n pointers to pads of >= lanes + n + 1 zero
// words. `lanes` is cut to what the card keeps resident (resident_lanes,
// shmem.cuh). Returns the launch's cudaError_t.
int tdt_ag_gemm(const void* a, const void* b, void* c, const void* const* ws,
                const void* const* pads, int n, int m_local, int n_local, int K, int ldb,
                int b_trans, int kind, int lanes, void* claim, void* report,
                unsigned long long budget_ns, void* stream) {
  const Call q{a, b, c, ws, pads, n, m_local, n_local, K, K, ldb, lanes,
               claim, report, budget_ns, stream};
  if (!call_ok(q)) return (int)cudaErrorInvalidValue;
  return b_trans ? dispatch<false, true>(q, kind) : dispatch<false, false>(q, kind);
}

// GEMM-RS over n ranks (see gemm_rs_kernel): a [n * m_seg, lda]; b [n *
// k_local, N] with row stride ldb, or [N, n * k_local] (b_trans); out [n *
// m_seg, N]; ws: n pointers to each rank's [n, m_seg, N] f32 slots
// (16-byte aligned); pads: n pointers to pads of >= lanes + n + 1 zero
// words.
int tdt_gemm_rs(const void* a, const void* b, void* out, const void* const* ws,
                const void* const* pads, int n, int m_seg, int N, int k_local, int lda, int ldb,
                int b_trans, int kind, int lanes, void* claim, void* report,
                unsigned long long budget_ns, void* stream) {
  const Call q{a, b, out, ws, pads, n, m_seg, N, k_local, lda, ldb, lanes,
               claim, report, budget_ns, stream};
  if (!call_ok(q)) return (int)cudaErrorInvalidValue;
  return b_trans ? dispatch<true, true>(q, kind) : dispatch<true, false>(q, kind);
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
