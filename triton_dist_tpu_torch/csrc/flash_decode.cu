// Contiguous-cache GQA decode, written by hand for Hopper (sm_90a): the
// split-KV partials, their combine, and the sequence-parallel lse merge,
// alone and fused with the partials' all-gather across ranks.
//
// Replaces three TPU kernels of triton_dist_tpu/ops/flash_decode.py:
//
// - gqa_decode_partial (_decode_kernel + _online_softmax_body): for every
//   row b, softmax attention of the Hq query heads over the first
//   kv_len[b] keys of the head-major cache [B, Hkv, S, D], with (m, l, acc)
//   kept in f32, p cast to v's type before the P.V product, out in q's type
//   and lse = m + log(l) (NEG_INF for an empty row). The TPU walks the whole
//   cache in one grid row; here the keys are cut into splits of a fixed
//   length (the wrapper's SPLIT_KEYS), one block per (split, kv head, row),
//   so that a batch-1 long-context decode fills the SMs. The split length
//   is a constant, so the split count depends on S alone and a row's bits
//   never depend on the rest of the batch or on the device.
// - decode_combine (_combine_kernel): the lse-weighted merge of R partials,
//   m = max lse, w = exp(lse - m), out = sum(out * w) / sum(w), summed in the
//   order r = 0..R-1. It also merges the splits above, and then writes the
//   merged lse.
// - the merge half of ll_ag_merge (_ll_ag_merge_kernel, :391-404): the
//   running (m, denom, acc) rescaling over n segments in canonical order.
//   It is kept apart from the combine because it rounds in another order.
//   Across ranks (ll_ag_merge_kernel, _ll_ag_merge_kernel :332-402 whole),
//   the transport is fused in front of it: each rank puts its f32 partial
//   (out || lse) into slot `me` of every peer's workspace and signals
//   (shmem.cuh), then merges the n segments in canonical order 0..n-1,
//   waiting for each once and reading its own directly. Both kernels run
//   one row's merge through the same device functions, so every replica
//   equals the merge kernel's result over the stacked partials bit for bit.
//
// What bounds them on this card: bytes. The partials read each live key and
// value once per (row, kv head) at about 4 * G flops per element, far below
// the ~295 flops per byte where the H100 stops being memory bound; the
// combine and the merge read R partial rows of D f32 values to write one;
// the fused merge writes n - 1 copies of a rank's partial and reads n.
//
// What the design does about it: a partial block stages tiles of K and V
// (64 keys in bf16, 32 in f32: 16 KB each) through shared memory with a
// two-stage cp.async ring, so the next tile's loads are in flight while
// the current tile is scored, and its G query heads share every byte read.
// Keys past kv_len are never read; a split that starts past kv_len exits at
// once (split 0 writes zeros and NEG_INF), and the combine merges only the
// splits that start below kv_len. Rows of shared memory are padded by 16
// bytes so that a warp reading 32 keys' rows hits no bank twice. The
// products run on the CUDA cores, not the tensor cores (a decode step has
// one query row per head). The combine and the merge give one warp to each
// (row, head) pair, each lane a few of the D columns, f32 throughout;
// their products and sums are rounded one by one (__fmul_rn, __fadd_rn),
// as the plain versions round them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 128;            // combine, merge: one warp a row
constexpr int kWarps = kThreads / 32;
constexpr int kPartialThreads = 256;     // partial: one block a (split, head, row)
constexpr int kPartialWarps = kPartialThreads / 32;
constexpr int kMaxOutPerThread = 4;  // G * D <= kPartialThreads * kMaxOutPerThread
constexpr int kMaxColsPerLane = 8;   // D <= 32 * kMaxColsPerLane (combine, merge)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the kVec elements of one 16-byte vector of shared memory, as floats
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 y = __bfloat1622float2(h[i]);
    f[2 * i] = y.x;
    f[2 * i + 1] = y.y;
  }
}

// keys per tile: 16 KB of K (and of V) at D = 128, 64 keys of bf16 or 32 of
// f32; kVec elements make one 16-byte vector
template <typename T>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kKeys = 4 * kVec * 2;  // 64 in bf16, 32 in f32
};

// Grid (n_split, Hkv, B); one block of kPartialThreads threads per (split,
// kv head, row). q [B, Hq, D]; k / v [B, Hkv, S, D]; kv_len [B] i32. With
// one split (direct) it writes out [B, Hq, D] (q's type) and lse [B, Hq]
// f32; else the f32 partials po [n_split, B, Hq, D] and pl [n_split, B, Hq]
// of the live splits (those that start below kv_len) and of split 0: the
// combine reads no other.
template <typename T>
__global__ void __launch_bounds__(kPartialThreads)
    decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ kv_len,
                          T* __restrict__ out, float* __restrict__ lse,
                          float* __restrict__ po, float* __restrict__ pl, int Hq,
                          int Hkv, int S, int D, int split, float sm_scale) {
  constexpr int kVec = Tile<T>::kVec;
  constexpr int kTile = Tile<T>::kKeys;
  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool direct = gridDim.x == 1;

  const int len = min(max(kv_len[b], 0), S);
  const int s0 = sp * split;
  const int s1 = min(s0 + split, len);  // this block's live keys: [s0, s1)
  const size_t head0 = (size_t)b * Hq + (size_t)h * G;
  const size_t part0 = (size_t)sp * B * Hq + head0;

  if (s0 >= s1) {  // nothing to read: zeros and NEG_INF, for split 0 only
    if (sp > 0) return;
    for (int i = tid; i < G * D; i += kPartialThreads) {
      if (direct)
        out[head0 * D + i] = from_float<T>(0.f);
      else
        po[part0 * D + i] = 0.f;
    }
    if (tid < G) (direct ? lse[head0 + tid] : pl[part0 + tid]) = kNegInf;
    return;
  }

  const int ld = D + kVec;  // padded shared-memory row, in elements
  extern __shared__ __align__(16) unsigned char smem[];
  T* kv_s = reinterpret_cast<T*>(smem);  // [2 stages][K, V][kTile][ld]
  float* q_s = reinterpret_cast<float*>(kv_s + 4 * kTile * ld);  // [G, D]
  float* p_s = q_s + G * D;                                      // [G, kTile]
  float* m_s = p_s + G * kTile;                                  // [G]
  float* l_s = m_s + G;                                          // [G]
  float* a_s = l_s + G;  // [G] this tile's rescale factor

  for (int i = tid; i < G * D; i += kPartialThreads) q_s[i] = to_float(q[head0 * D + i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // each thread owns the outputs (g_o, d_o) = ((tid + o * kPartialThreads) / D,
  // tid % D)
  const int d_own = tid % D;
  const int g_first = tid / D;
  const int g_step = kPartialThreads / D;
  float acc[kMaxOutPerThread];
#pragma unroll
  for (int o = 0; o < kMaxOutPerThread; ++o) acc[o] = 0.f;

  const size_t base = ((size_t)b * Hkv + h) * S * D;
  const int vecs_per_row = D / kVec;
  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;

  auto load_tile = [&](int t, int stage) {
    const int key0 = s0 + t * kTile;
    const int nv = min(kTile, s1 - key0);
    const int per = nv * vecs_per_row;
    for (int i = tid; i < 2 * per; i += kPartialThreads) {
      const int which = i / per;  // 0: K, 1: V
      const int r = (i % per) / vecs_per_row;
      const int c = (i % vecs_per_row) * kVec;
      const T* src = (which ? v : k) + base + (size_t)(key0 + r) * D + c;
      T* dst = kv_s + ((stage * 2 + which) * kTile + r) * ld + c;
      cp_async16(dst, src);
    }
  };

  load_tile(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) load_tile(t + 1, stage ^ 1);
    cp_async_commit();     // possibly empty: keeps one group per tile
    cp_async_wait<1>();    // this thread's copies of tile t have landed
    __syncthreads();       // and everyone's

    const int nv = min(kTile, s1 - (s0 + t * kTile));
    const T* k_s = kv_s + (stage * 2) * kTile * ld;
    const T* v_s = k_s + kTile * ld;

    // scores: one thread per (query head, key), f32 sums over d in two
    // interleaved halves of each vector, added at the end
    for (int pair = tid; pair < G * kTile; pair += kPartialThreads) {
      const int g = pair / kTile;
      const int j = pair % kTile;
      float s = kNegInf;
      if (j < nv) {
        const float* qg = q_s + g * D;
        const T* kr = k_s + j * ld;
        float dot0 = 0.f, dot1 = 0.f;
        for (int d = 0; d < D; d += kVec) {
          float kf[kVec], qf[kVec];
          load_vec(kr + d, kf);
#pragma unroll
          for (int e = 0; e < kVec; e += 4) load_vec(qg + d + e, qf + e);
#pragma unroll
          for (int e = 0; e < kVec; e += 2) {
            dot0 = fmaf(qf[e], kf[e], dot0);
            dot1 = fmaf(qf[e + 1], kf[e + 1], dot1);
          }
        }
        s = (dot0 + dot1) * sm_scale;
      }
      p_s[g * kTile + j] = s;
    }
    __syncthreads();

    // online-softmax update: one warp per query head
    for (int g = warp; g < G; g += kPartialWarps) {
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, p_s[g * kTile + j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = expf(p_s[g * kTile + j] - m_new);
        sum += p;
        // the P.V operand is p in v's type, as the TPU kernel casts it
        p_s[g * kTile + j] = to_float(from_float<T>(p));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V over the tile's live keys
    float pv[kMaxOutPerThread];
#pragma unroll
    for (int o = 0; o < kMaxOutPerThread; ++o) pv[o] = 0.f;
    for (int j = 0; j < nv; ++j) {
      const float vj = to_float(v_s[j * ld + d_own]);
#pragma unroll
      for (int o = 0; o < kMaxOutPerThread; ++o) {
        const int g = g_first + o * g_step;
        if (g < G) pv[o] = fmaf(p_s[g * kTile + j], vj, pv[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < kMaxOutPerThread; ++o) {
      const int g = g_first + o * g_step;
      if (g < G) acc[o] = acc[o] * a_s[g] + pv[o];
    }
    __syncthreads();  // the next tile's copies overwrite this stage and p_s
  }

#pragma unroll
  for (int o = 0; o < kMaxOutPerThread; ++o) {
    const int g = g_first + o * g_step;
    if (g < G) {
      const float l = l_s[g];
      const float val = acc[o] / (l > 0.f ? l : 1.f);
      const size_t i = (size_t)g * D + d_own;
      if (direct)
        out[head0 * D + i] = from_float<T>(val);
      else
        po[part0 * D + i] = val;
    }
  }
  if (tid < G) {
    const float l = l_s[tid];
    const float x = l > 0.f ? m_s[tid] + logf(l) : kNegInf;
    (direct ? lse[head0 + tid] : pl[part0 + tid]) = x;
  }
}

// One warp per row of [rows, D]: outs [R, rows, D], lses [R, rows] f32 ->
// out [rows, D] (TO), and lse_out [rows] f32 when it is given. Given kv_len,
// the rows are (b, head) pairs of Hq heads, and row b merges only the splits
// that start below kv_len[b] (at least one): the others hold zeros and
// NEG_INF, whose weight is exactly 0, so skipping them leaves every bit.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const TI* __restrict__ outs, const float* __restrict__ lses,
                   TO* __restrict__ out, float* __restrict__ lse_out,
                   const int* __restrict__ kv_len, int R, int rows, int D, int Hq,
                   int S, int split) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  if (kv_len != nullptr) {
    const int len = min(max(kv_len[row / Hq], 0), S);
    R = min(R, max(1, (len + split - 1) / split));
  }
  // the row's lses sit one per lane, 32 partials at a time: the max is one
  // warp reduction and each weight reaches the loop by a shuffle, so the
  // loop's loads (the partial rows) do not wait on one another; the sums
  // still run in the order r = 0..R-1
  float m = kNegInf;
  for (int r0 = 0; r0 < R; r0 += 32)
    if (r0 + lane < R) m = fmaxf(m, lses[(size_t)(r0 + lane) * rows + row]);
  m = warp_max(m);
  float acc[kMaxColsPerLane];
#pragma unroll
  for (int c = 0; c < kMaxColsPerLane; ++c) acc[c] = 0.f;
  float denom = 0.f;
  for (int r0 = 0; r0 < R; r0 += 32) {
    const float w_lane =
        r0 + lane < R ? expf(lses[(size_t)(r0 + lane) * rows + row] - m) : 0.f;
    const int nr = min(32, R - r0);
#pragma unroll 8
    for (int i = 0; i < nr; ++i) {
      const float w = __shfl_sync(0xffffffffu, w_lane, i);
      denom = __fadd_rn(denom, w);
      const TI* o = outs + ((size_t)(r0 + i) * rows + row) * D;
#pragma unroll
      for (int c = 0; c < kMaxColsPerLane; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = __fadd_rn(acc[c], __fmul_rn(to_float(o[d]), w));
      }
    }
  }
  const float safe = denom > 0.f ? denom : 1.f;
#pragma unroll
  for (int c = 0; c < kMaxColsPerLane; ++c) {
    const int d = lane + 32 * c;
    if (d < D) out[(size_t)row * D + d] = from_float<TO>(acc[c] / safe);
  }
  if (lse_out != nullptr && lane == 0)
    lse_out[row] = denom > 0.f ? m + logf(denom) : kNegInf;
}

// The running merge of one row in canonical segment order, shared by the
// merge kernel and the fused gather-and-merge, so both give the same bits:
// segment 0 initialises (acc, m, denom) = (out, lse, 1), each later segment
// rescales (_ll_ag_merge_kernel :391-404), every product and sum rounded on
// its own. Each lane holds the columns lane + 32 c. kCg reads through L2
// (a segment another block delivered).
struct MergeRow {
  float acc[kMaxColsPerLane];
  float m, denom;
};

template <bool kCg>
__device__ __forceinline__ float load_col(const float* p) {
  return kCg ? __ldcg(p) : *p;
}

template <bool kCg>
__device__ __forceinline__ void merge_first(MergeRow& r, const float* o, float lse, int D,
                                            int lane) {
#pragma unroll
  for (int c = 0; c < kMaxColsPerLane; ++c) {
    const int d = lane + 32 * c;
    r.acc[c] = d < D ? load_col<kCg>(o + d) : 0.f;
  }
  r.m = lse;
  r.denom = 1.f;
}

template <bool kCg>
__device__ __forceinline__ void merge_next(MergeRow& r, const float* o, float l, int D,
                                           int lane) {
  const float new_m = fmaxf(r.m, l);
  const float scale = expf(r.m - new_m);
  const float w = expf(l - new_m);
#pragma unroll
  for (int c = 0; c < kMaxColsPerLane; ++c) {
    const int d = lane + 32 * c;
    if (d < D) r.acc[c] = __fadd_rn(__fmul_rn(r.acc[c], scale), __fmul_rn(load_col<kCg>(o + d), w));
  }
  r.denom = __fadd_rn(__fmul_rn(r.denom, scale), w);
  r.m = new_m;
}

template <typename TO>
__device__ __forceinline__ void merge_store(const MergeRow& r, TO* out, int D, int lane) {
  const float safe = r.denom > 0.f ? r.denom : 1.f;
#pragma unroll
  for (int c = 0; c < kMaxColsPerLane; ++c) {
    const int d = lane + 32 * c;
    if (d < D) out[d] = from_float<TO>(r.acc[c] / safe);
  }
}

// One warp per row: outs [n, rows, D] f32, lses [n, rows] -> out [rows, D]
// (TO), merged in segment order with the running rescale.
template <typename TO>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ outs, const float* __restrict__ lses,
                 TO* __restrict__ out, int n, int rows, int D) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  MergeRow r;
  merge_first<false>(r, outs + (size_t)row * D, lses[row], D, lane);
  // segments 1..n-1, their lses one per lane, 32 at a time (as in the
  // combine)
  for (int s0 = 1; s0 < n; s0 += 32) {
    const float l_lane = s0 + lane < n ? lses[(size_t)(s0 + lane) * rows + row] : kNegInf;
    const int ns = min(32, n - s0);
#pragma unroll 8
    for (int i = 0; i < ns; ++i)
      merge_next<false>(r, outs + ((size_t)(s0 + i) * rows + row) * D,
                        __shfl_sync(0xffffffffu, l_lane, i), D, lane);
  }
  merge_store<TO>(r, out + (size_t)row * D, D, lane);
}

// B5 across ranks: grid (lanes, n), lane c merging rows [c per, (c + 1)
// per), per = ceil(rows / lanes), one warp a row at a time (the lanes are
// cut to what stays resident, so a lane may hold many rows). outs / lses: each rank's partial [rows, D] and
// [rows] f32; ws: each rank's arrival workspace, n slots of rows * (D + 1)
// f32 (the slot's outs, then its lses); res: each rank's merged [rows, D].
// Pad words: [0, lanes) the entry barrier, [lanes + s lanes + c] the
// delivery of segment s's rows of lane c. Each rank puts its rows into slot
// `me` of every peer, waits once for each peer's, then merges segments
// 0..n-1 in that order, reading its own directly: every rank's replica
// gets the same bits.
//
// Over an axis inside a multi-axis mesh it runs in groups (G): grid
// (lanes, N) covers every rank of the mesh, the segments are the members
// of a rank's group by their index in it, and the tables are indexed by
// flat rank. A `silent` rank (-1 for none) puts but never signals (the
// hang check).
template <typename TO>
__global__ void __launch_bounds__(kThreads)
    ll_ag_merge_kernel(tdt_shmem::PeerTable outs, tdt_shmem::PeerTable lses,
                       tdt_shmem::PeerTable ws, tdt_shmem::PeerTable res, int rows, int D,
                       tdt_shmem::PeerTable pads, tdt_shmem::Group G, int silent,
                       tdt_shmem::Launch L) {
  using namespace tdt_shmem;
  const int me = group_me(G);
  const int n = group_n(G);
  const int pe = my_pe();
  const int lanes = gridDim.x;
  const int lane_id = blockIdx.x;
  const int lane = threadIdx.x % 32;
  if (!barrier_group_block(pads, lane_id, G, L)) return;
  const int per = (rows + lanes - 1) / lanes;
  const int r0 = min(rows, lane_id * per);
  const int nr = min(per, rows - r0);
  const size_t slot_floats = (size_t)rows * (D + 1);
  const float* my_outs = symm_at<const float>(outs, pe);
  const float* my_lses = symm_at<const float>(lses, pe);
  for (int p = 0; p < n; ++p) {
    if (p == me) continue;
    float* slot = symm_at<float>(ws, group_pe(G, p)) + (size_t)me * slot_floats;
    putmem_nbi_block(slot + (size_t)r0 * D, my_outs + (size_t)r0 * D,
                     (long long)nr * D * sizeof(float));
    putmem_nbi_block(slot + (size_t)rows * D + r0, my_lses + r0, (long long)nr * sizeof(float));
  }
  __syncthreads();
  if (threadIdx.x == 0 && pe != silent) {
    __threadfence();
    for (int p = 0; p < n; ++p)
      if (p != me) signal_op(symm_at<int>(pads, group_pe(G, p)) + lanes + me * lanes + lane_id, 1);
  }
  for (int seg = 0; seg < n; ++seg) {
    const int word = lanes + seg * lanes + lane_id;
    if (seg != me && !wait_block(symm_at<int>(pads, pe) + word, 1, true, L, word)) return;
  }
  const float* arrived = symm_at<const float>(ws, pe);
  for (int row = r0 + (int)threadIdx.x / 32; row < r0 + nr; row += kWarps) {
    MergeRow r;
    for (int seg = 0; seg < n; ++seg) {
      if (seg == me) {
        const float* o = my_outs + (size_t)row * D;
        if (seg == 0)
          merge_first<false>(r, o, my_lses[row], D, lane);
        else
          merge_next<false>(r, o, my_lses[row], D, lane);
      } else {
        const float* base = arrived + (size_t)seg * slot_floats;
        const float l = __ldcg(base + (size_t)rows * D + row);
        if (seg == 0)
          merge_first<true>(r, base + (size_t)row * D, l, D, lane);
        else
          merge_next<true>(r, base + (size_t)row * D, l, D, lane);
      }
    }
    merge_store<TO>(r, symm_at<TO>(res, pe) + (size_t)row * D, D, lane);
  }
  quiet();
}

template <typename T>
int launch_partial(const void* q, const void* k, const void* v, const void* kv_len,
                   void* out, void* lse, void* po, void* pl, int B, int Hq, int Hkv,
                   int S, int D, int split, int n_split, float sm_scale, void* stream) {
  constexpr int kTile = Tile<T>::kKeys;
  if (B <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 || D <= 0 ||
      kPartialThreads % D != 0 || D % Tile<T>::kVec != 0 ||
      (Hq / Hkv) * D > kPartialThreads * kMaxOutPerThread ||
      split % kTile != 0 || n_split != (S + split - 1) / split ||
      (n_split > 1 && (po == nullptr || pl == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const int ld = D + Tile<T>::kVec;
  const size_t smem = 4 * (size_t)kTile * ld * sizeof(T) +
                      ((size_t)G * D + (size_t)G * kTile + 3 * (size_t)G) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_partial_kernel<T>
      <<<dim3(n_split, Hkv, B), kPartialThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(out), static_cast<float*>(lse),
      static_cast<float*>(po), static_cast<float*>(pl), Hq, Hkv, S, D, split, sm_scale);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int launch_combine(const void* outs, const void* lses, void* out, void* lse_out,
                   const void* kv_len, int R, int rows, int D, int Hq, int S, int split,
                   void* stream) {
  if (R <= 0 || rows <= 0 || D <= 0 || D > 32 * kMaxColsPerLane ||
      (kv_len != nullptr && (Hq <= 0 || rows % Hq != 0 || split <= 0)))
    return (int)cudaErrorInvalidValue;
  combine_kernel<TI, TO><<<(rows + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const TI*>(outs), static_cast<const float*>(lses), static_cast<TO*>(out),
      static_cast<float*>(lse_out), static_cast<const int*>(kv_len), R, rows, D, Hq, S,
      split);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_merge(const void* outs, const void* lses, void* out, int n, int rows, int D,
                 void* stream) {
  if (n <= 0 || rows <= 0 || D <= 0 || D > 32 * kMaxColsPerLane)
    return (int)cudaErrorInvalidValue;
  merge_kernel<TO><<<(rows + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(outs), static_cast<const float*>(lses),
      static_cast<TO*>(out), n, rows, D);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_ll_ag_merge(const void* const* outs, const void* const* lses, const void* const* ws,
                       const void* const* res, int rows, int D, const void* const* pads, int n,
                       const void* group, int silent, void* claim, void* report,
                       unsigned long long budget_ns, void* stream) {
  using namespace tdt_shmem;
  if (n < 2 || n > kMaxPes || rows <= 0 || D <= 0 || D > 32 * kMaxColsPerLane ||
      group == nullptr)
    return (int)cudaErrorInvalidValue;
  const Group G = *static_cast<const Group*>(group);
  if (G.n < 2 || G.n > n) return (int)cudaErrorInvalidValue;
  const int lanes =
      tdt_shmem::resident_lanes(ll_ag_merge_kernel<TO>, kThreads, (rows + kWarps - 1) / kWarps, n);
  if (lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return launch_cooperative(ll_ag_merge_kernel<TO>, dim3(lanes, n), dim3(kThreads), 0, stream,
                            make_table(outs, n), make_table(lses, n), make_table(ws, n),
                            make_table(res, n), rows, D, make_table(pads, n), G, silent,
                            make_launch(claim, report, budget_ns, kLlAgMerge));
}

}  // namespace

extern "C" {

int tdt_gqa_decode_partial_f32(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, void* lse, void* po,
                               void* pl, int B, int Hq, int Hkv, int S, int D, int split,
                               int n_split, float sm_scale, void* stream) {
  return launch_partial<float>(q, k, v, kv_len, out, lse, po, pl, B, Hq, Hkv, S, D,
                               split, n_split, sm_scale, stream);
}

int tdt_gqa_decode_partial_bf16(const void* q, const void* k, const void* v,
                                const void* kv_len, void* out, void* lse, void* po,
                                void* pl, int B, int Hq, int Hkv, int S, int D, int split,
                                int n_split, float sm_scale, void* stream) {
  return launch_partial<__nv_bfloat16>(q, k, v, kv_len, out, lse, po, pl, B, Hq, Hkv, S,
                                       D, split, n_split, sm_scale, stream);
}

int tdt_decode_combine_f32(const void* outs, const void* lses, void* out, void* lse_out,
    const void* kv_len, int R, int rows, int D, int Hq, int S, int split,
    void* stream) {
  return launch_combine<float, float>(outs, lses, out, lse_out, kv_len, R, rows,
      D, Hq, S, split, stream);
}

int tdt_decode_combine_bf16(const void* outs, const void* lses, void* out, void* lse_out,
    const void* kv_len, int R, int rows, int D, int Hq, int S, int split,
    void* stream) {
  return launch_combine<__nv_bfloat16, __nv_bfloat16>(outs, lses, out, lse_out, kv_len, R, rows,
      D, Hq, S, split, stream);
}

int tdt_decode_combine_f32_bf16(const void* outs, const void* lses, void* out, void* lse_out,
    const void* kv_len, int R, int rows, int D, int Hq, int S, int split,
    void* stream) {
  return launch_combine<float, __nv_bfloat16>(outs, lses, out, lse_out, kv_len, R, rows,
      D, Hq, S, split, stream);
}

int tdt_ll_merge_f32(const void* outs, const void* lses, void* out, int n, int rows,
                     int D, void* stream) {
  return launch_merge<float>(outs, lses, out, n, rows, D, stream);
}

int tdt_ll_merge_bf16(const void* outs, const void* lses, void* out, int n, int rows,
                      int D, void* stream) {
  return launch_merge<__nv_bfloat16>(outs, lses, out, n, rows, D, stream);
}

// outs / lses: n pointers to each rank's partial [rows, D] / [rows] f32;
// ws: n pointers to each rank's g slots of rows * (D + 1) f32 (g the group
// size); res: n pointers to each rank's merged [rows, D]; pads: n pointers
// to pads of >= (g + 1) * ceil(rows / 4) zero words; group: the merge's
// groups over the n ranks (g >= 2).
int tdt_ll_ag_merge_f32(const void* const* outs, const void* const* lses, const void* const* ws,
                        const void* const* res, int rows, int D, const void* const* pads, int n,
                        const void* group, int silent, void* claim, void* report,
                        unsigned long long budget_ns, void* stream) {
  return launch_ll_ag_merge<float>(outs, lses, ws, res, rows, D, pads, n, group, silent, claim,
                                   report, budget_ns, stream);
}

int tdt_ll_ag_merge_bf16(const void* const* outs, const void* const* lses, const void* const* ws,
                         const void* const* res, int rows, int D, const void* const* pads, int n,
                         const void* group, int silent, void* claim, void* report,
                         unsigned long long budget_ns, void* stream) {
  return launch_ll_ag_merge<__nv_bfloat16>(outs, lses, ws, res, rows, D, pads, n, group, silent,
                                           claim, report, budget_ns, stream);
}

const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
