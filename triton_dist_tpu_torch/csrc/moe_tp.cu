// The MoE tensor-parallel pair across ranks that share one card, written by
// hand for Hopper (sm_90a): the token all-gather with the grouped
// up-projection, and the grouped down-projection with its reduce-scatter,
// each in one launch.
//
// Replaces the TPU kernels B19, _ag_moe_kernel
// (triton_dist_tpu/ops/moe.py:136, over ag_overlap_protocol; the
// pallas_call at :215), and B20, _moe_rs_kernel (:261, over
// rs_overlap_protocol and emit_slot_reduction; the pallas_call at :405), in
// their 1-tier forms over an axis that spans the whole mesh. The rows are
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

// The used tiles of this rank's walk over the n segments in the order
// pe_at(me + first + si): segment si has row_tiles[si] = (its used rows) /
// TM row tiles times col_tiles, and its tiles are [start[si], start[si +
// 1]) of the walk. Returns the walk's length.
template <int TM>
__device__ __forceinline__ int walk(const int* nb, int n_blocks, int block_m, int col_tiles,
                                    int first, int* start, int* row_tiles) {
  const int me = my_pe();
  const int n = n_pes();
  int total = 0;
  for (int si = 0; si < n; ++si) {
    const int seg = pe_at(me + first + si);
    row_tiles[si] = min(max(nb[seg], 0), n_blocks) * block_m / TM;
    start[si] = total;
    total += row_tiles[si] * col_tiles;
  }
  start[n] = total;
  return total;
}

// grid (lanes, n), rank me = blockIdx.y; see the header comment. ws: each
// rank's [n, P, H] slots; pads: each rank's pad of >= lanes + n + 1 words.
template <typename In, int TM>
__global__ void __launch_bounds__(kThreads)
    ag_moe_kernel(const In* __restrict__ x, const In* __restrict__ w, const int* __restrict__ be,
                  const int* __restrict__ nb, In* __restrict__ out, PeerTable ws, PeerTable pads,
                  int P, int H, int nl, int F, int block_m, int E, int silent, Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int me = my_pe();
  const int n = n_pes();
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  const int n_blocks = P / block_m;
  int* pad = symm_at<int>(pads, me);
  if (!barrier_all_block(pads, lane, L)) return;

  // my lane's share of my segment's used rows into slot `me` of every
  // peer, then one arrival on each peer's count of segment `me`
  const In* mine = x + (size_t)me * P * H;
  const size_t slot_bytes = (size_t)P * H * sizeof(In);
  const long long nbytes =
      (long long)min(max(nb[me], 0), n_blocks) * block_m * H * (long long)sizeof(In);
  const long long per = ((nbytes + lanes - 1) / lanes + 15) / 16 * 16;
  const long long b0 = (long long)lane * per;
  const long long b1 = b0 + per < nbytes ? b0 + per : nbytes;
  if (b1 > b0)
    for (int p = 1; p < n; ++p)
      putmem_nbi_block(symm_at<unsigned char>(ws, pe_at(me + p)) + me * slot_bytes + b0,
                       reinterpret_cast<const unsigned char*>(mine) + b0, b1 - b0);
  __syncthreads();
  if (threadIdx.x == 0 && me != silent) {
    __threadfence();
    for (int p = 1; p < n; ++p)
      red_release_add(symm_at<int>(pads, pe_at(me + p)) + count_word(me), 1);
  }

  // my column block of every segment, from my own
  const int col_tiles = (nl + kTN - 1) / kTN;
  int start[kMaxPes + 1], row_tiles[kMaxPes];
  const int total = walk<TM>(nb, n_blocks, block_m, col_tiles, 0, start, row_tiles);
  const In* slots = symm_at<const In>(ws, me);
  const In* wl = w + (size_t)me * nl;
  In* ol = out + (size_t)me * nl;
  int si = 0, waited = 0;  // the swizzled index of the last segment waited for
  for (int t = lane; t < total; t += lanes) {
    while (t >= start[si + 1]) ++si;
    const int seg = pe_at(me + si);
    if (si > waited) {
      if (!wait_block(pad + count_word(seg), lanes, false, L, count_word(seg))) return;
      waited = si;
    }
    const int wt = t - start[si];
    const int row0 = (wt % row_tiles[si]) * TM;
    const int col0 = (wt / row_tiles[si]) * kTN;
    int e = 0;
    block_expert(be + (size_t)seg * n_blocks, nb + seg, row0, block_m, n_blocks, E, &e);
    const In* A = si == 0 ? mine : slots + (size_t)seg * P * H;
    tile<In, TM, In>(A, H, wl + (size_t)e * H * F, F, ol + (size_t)seg * P * F, F, H, nl, row0,
                     col0, smem);
  }
  if (!finish_block(pad, lanes, me, L)) return;
  quiet();
}

// grid (lanes, n), rank me = blockIdx.y; see the header comment. ws: each
// rank's [n, P, N] f32 slots, slot s holding rank s's partial; pads: each
// rank's pad of >= lanes + n + 1 words.
template <typename In, int TM>
__global__ void __launch_bounds__(kThreads)
    moe_rs_kernel(const In* __restrict__ x, const In* __restrict__ w, const int* __restrict__ be,
                  const int* __restrict__ nb, float* __restrict__ out, PeerTable ws,
                  PeerTable pads, int P, int N, int kl, int block_m, int E, int silent,
                  Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int me = my_pe();
  const int n = n_pes();
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  const int n_blocks = P / block_m;
  const int K = n * kl;
  int* pad = symm_at<int>(pads, me);
  if (!barrier_all_block(pads, lane, L)) return;

  // my partial of every segment, its own last, each tile stored into the
  // owner's slot `me` and counted on the owner's count of my rank
  const int col_tiles = (N + kTN - 1) / kTN;
  int start[kMaxPes + 1], row_tiles[kMaxPes];
  const int total = walk<TM>(nb, n_blocks, block_m, col_tiles, 1, start, row_tiles);
  const size_t seg_elems = (size_t)P * N;
  const In* xl = x + (size_t)me * kl;
  const In* wl = w + (size_t)me * kl * N;
  int si = 0;
  for (int t = lane; t < total; t += lanes) {
    while (t >= start[si + 1]) ++si;
    const int seg = pe_at(me + 1 + si);
    const int wt = t - start[si];
    const int row0 = (wt % row_tiles[si]) * TM;
    const int col0 = (wt / row_tiles[si]) * kTN;
    int e = 0;
    block_expert(be + (size_t)seg * n_blocks, nb + seg, row0, block_m, n_blocks, E, &e);
    tile<In, TM, float>(xl + (size_t)seg * P * K, K, wl + (size_t)e * K * N, N,
                        symm_at<float>(ws, seg) + me * seg_elems, N, kl, N, row0, col0, smem);
    if (me != silent) signal_op_block(symm_at<int>(pads, seg) + count_word(me), 1);
  }

  // my segment: wait for every rank's partial, then the slot sum of its
  // used rows
  const int mine = row_tiles[n - 1] * col_tiles;
  for (int s = 0; s < n; ++s)
    if (!wait_block(pad + count_word(s), mine, false, L, count_word(s))) return;
  const float* slots = symm_at<const float>(ws, me);
  float* o = out + me * seg_elems;
  const long long used = (long long)row_tiles[n - 1] * TM * N;
  const long long stride = (long long)lanes * kThreads;
  if (N % 4 == 0) {
    for (long long i = ((long long)lane * kThreads + threadIdx.x) * 4; i < used; i += stride * 4)
      tdt_gemm::slot_sum<float, 4, true>(slots, o, n, (long long)seg_elems, i);
  } else {
    for (long long i = (long long)lane * kThreads + threadIdx.x; i < used; i += stride)
      tdt_gemm::slot_sum<float, 1, true>(slots, o, n, (long long)seg_elems, i);
  }
  finish_block(pad, mine, -1, L);
}

// What the host hands every launch: `cols` is ag_moe's nl (its F = n * nl)
// and moe_rs's N; `depth` is ag_moe's H and moe_rs's kl.
struct Call {
  const void* x;
  const void* w;
  const void* be;
  const void* nb;
  void* out;
  const void* const* ws;
  const void* const* pads;
  int n, P, cols, depth, block_m, E, lanes, silent;
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
                            q.be, q.nb, q.out, make_table(q.ws, q.n), make_table(q.pads, q.n),
                            args..., q.block_m, q.E, q.silent,
                            make_launch(q.claim, q.report, q.budget_ns, id));
}

template <bool kRs, typename In, int TM>
int launch(const Call& q) {
  const size_t smem = tile_smem<In, TM>();
  if constexpr (kRs)
    return launch_kernel(moe_rs_kernel<In, TM>, smem, q, kMoeRs, q.P, q.cols, q.depth);
  else
    return launch_kernel(ag_moe_kernel<In, TM>, smem, q, kAgMoe, q.P, q.depth, q.cols,
                         q.n * q.cols);
}

// kind: 0 bf16 (B19's output bf16; B20's f32), 1 f32 throughout. bf16 runs
// 64-row tiles where block_m allows them, else 16; f32 runs 16.
template <bool kRs>
int dispatch(const Call& q, int kind) {
  if (kind == 1) return q.block_m % 16 ? (int)cudaErrorInvalidValue : launch<kRs, float, 16>(q);
  if (kind != 0) return (int)cudaErrorInvalidValue;
  if (q.block_m % 64 == 0) return launch<kRs, bf16, 64>(q);
  if (q.block_m % 16 == 0) return launch<kRs, bf16, 16>(q);
  return (int)cudaErrorInvalidValue;
}

bool call_ok(const Call& q) {
  return q.n >= 2 && q.n <= kMaxPes && q.block_m > 0 && q.P > 0 && q.P % q.block_m == 0 &&
         q.cols > 0 && q.cols % 8 == 0 && q.depth > 0 && q.depth % kTK == 0 && q.E > 0 &&
         q.lanes >= 1;
}

}  // namespace

extern "C" {

// B19 across ranks (see ag_moe_kernel): x [n, P, H]; w [E, H, n * nl]; be
// [n, P / block_m] i32; nb [n] i32; out [n * P, n * nl] in x's type; ws: n
// pointers to each rank's [n, P, H] slots (x's type); pads: n pointers to
// pads of >= lanes + n + 1 zero words. `lanes` is cut to what the card
// keeps resident. Returns the launch's cudaError_t.
int tdt_ag_moe(const void* x, const void* w, const void* be, const void* nb, void* out,
               const void* const* ws, const void* const* pads, int n, int P, int H, int nl,
               int block_m, int E, int kind, int lanes, int silent, void* claim, void* report,
               unsigned long long budget_ns, void* stream) {
  const Call q{x, w, be, nb, out, ws, pads, n, P, nl, H, block_m, E, lanes, silent,
               claim, report, budget_ns, stream};
  if (!call_ok(q)) return (int)cudaErrorInvalidValue;
  return dispatch<false>(q, kind);
}

// B20 across ranks (see moe_rs_kernel): x [n * P, n * kl]; w [E, n * kl,
// N]; be [n, P / block_m] i32; nb [n] i32; out [n, P, N] f32; ws: n
// pointers to each rank's [n, P, N] f32 slots (16-byte aligned); pads: n
// pointers to pads of >= lanes + n + 1 zero words.
int tdt_moe_rs(const void* x, const void* w, const void* be, const void* nb, void* out,
               const void* const* ws, const void* const* pads, int n, int P, int N, int kl,
               int block_m, int E, int kind, int lanes, int silent, void* claim, void* report,
               unsigned long long budget_ns, void* stream) {
  const Call q{x, w, be, nb, out, ws, pads, n, P, N, kl, block_m, E, lanes, silent,
               claim, report, budget_ns, stream};
  if (!call_ok(q)) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, kind);
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
