// Per-page flash-decode partials and their fixed-order fold, written by hand
// for Hopper (sm_90a).
//
// Replaces the TPU kernel triton_dist_tpu/ops/flash_decode.py::_fd_page_partials
// (the pallas_call at :810 over _fd_partial_kernel :746), runs the n = 1
// route of flash_decode_dist (:970-976), which folds those partials with the
// XLA scan _fd_fold (:840-862), and replaces B8, flash_decode_dist's fold
// across ranks (the pallas_call at :1023 over _fd_fold_kernel :865).
//
//   fd_page_partials_kernel  one independent softmax partial per (row, page,
//                            kv head): out [B, S, Hq, D] f32 and lse [B, S, Hq]
//                            f32. A page that is not this rank's (its id
//                            outside [rank * p_local, (rank + 1) * p_local)),
//                            or that lies wholly past kv_len, writes the
//                            neutral entry (0, NEG_INF) by a select and reads
//                            no K/V.
//   fd_partials_fold_kernel  the n = 1 route: one block per (row, kv head)
//                            walks the row's block-table pages in order,
//                            computes each page's partial with the SAME device
//                            function as fd_page_partials_kernel and folds it
//                            at once with _fd_fold's formulas, each product
//                            and sum rounded on its own (__fmul_rn,
//                            __fadd_rn), so the result equals the fold of the
//                            partials' slab bit for bit, with no slab in
//                            device memory. It stops after the last live page:
//                            the pages past it are neutral entries, exact
//                            no-ops of the fold.
//   fd_fold_dist_kernel      B8, the fold across n SP ranks: one cooperative
//                            launch over every rank of the mesh. Each rank's
//                            slab (B7 over its slice of the pool) is announced
//                            to the members of its group with one counted
//                            signal; after n - 1 announcements every rank
//                            folds every member's slab in the one fold order,
//                            page-major and rank-minor, reading each peer's
//                            slab in place through the PeerTable (the one-card
//                            form of the JAX kernel's put), and an exit barrier
//                            keeps a slab alive until every reader is done. At
//                            each page one rank's entry is real; an empty entry
//                            (lse <= FD_EMPTY) leaves the carry untouched and
//                            its out is never read. The fold's arithmetic is
//                            the fused kernel's, operation for operation (expf,
//                            __fmul_rn, __fadd_rn, __fdiv_rn), and a real
//                            entry's out is B7's pv / l, so the result is the
//                            fused n = 1 kernel's bit for bit at every n.
//
// A partial: scores = q . k in f32 times sm_scale, keys at or past kv_len
// masked to NEG_INF; m = max, p = exp(scores - m), l = sum p; p is cast to v's
// type before the P.V product (f32 sums); out = pv / l, lse = m + log(l).
//
// What bounds them on this card: the K/V bytes of the live pages. The fold
// reads each live page once per (row, kv head) -- a prefill chunk's rows all
// walk one sequence's pages, so they re-read them (mostly from L2) -- and does
// about 4 * G flops per K/V element on the CUDA cores, far under the ~295 flops
// per byte where the card stops being memory bound; at long context the
// re-reads and the per-page latency of one block's walk set its pace.
//
// What the design does about it: the G query heads of a kv head share every
// K/V byte a block reads; the walk prefetches the next page's K and V into
// registers (16-byte loads) while the current page is computed, and the
// block-table entry of the page after it one step earlier still; the shapes
// (G, head dim, page size) are template parameters, so every loop unrolls
// and each thread keeps its slice of the G query rows in registers for the
// whole walk. The score pass gives each key 128 / page_size lanes, each lane
// a strided slice of D with its dot products for all G heads, reduced by
// shuffles within the key's lanes; the fold's per-head scalars are computed
// once per head, by the lane that finished the head's softmax. Sharing a
// page's K/V across a prefill chunk's rows in shared memory, and the tensor
// cores, are later work; neither changes a row's bits. Instantiated for
// head dim 128 and page size 16 with 1, 2, 4 or 8 query heads per kv head
// (the Llama and Mixtral presets).
//
// B8 is bound by the slabs' bytes: each rank reads every member's live
// entries (n x the live partials of its rows, 4 (D + 1) bytes each) and
// writes its [B, Hq, D] result. Its walk is a chain of dependent steps per
// (row, head), so its design hides the latency: each warp loads 32 steps'
// lse at once (one a lane), finds the real entries by a ballot, loads up to
// four of their D-wide outs together, then folds them in order; a block
// folds four (row, head) pairs at once, a thread one element of D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr float kFdEmpty = kNegInf / 2;  // "no entry": a real lse never gets here

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The shapes of one (kv head, page) partial, all compile-time. L lanes take
// one key in the score pass (L * PS == kThreads), each lane DL values of D; a
// K/V row of shared memory is padded to STRIDE elements so that the L lanes
// of neighbouring keys hit other banks; one page of one kv head is VECS
// 16-byte vectors of K and as many of V, NV of them per thread.
template <typename T, int G_, int D_, int PS_>
struct Shape {
  static constexpr int G = G_, D = D_, PS = PS_;
  static constexpr int L = kThreads / PS;
  static constexpr int DL = D / L;
  static constexpr int PER_VEC = 16 / sizeof(T);
  static constexpr int STRIDE = D + PER_VEC;
  static constexpr int VEC_ROW = D / PER_VEC;
  static constexpr int VECS = PS * VEC_ROW;
  static constexpr int NV = (2 * VECS + kThreads - 1) / kThreads;
  static constexpr int HW = (G + kWarps - 1) / kWarps;  // heads per warp
  static_assert(PS * L == kThreads && L <= 32 && D % L == 0, "score lanes");
  static_assert(D <= kThreads && D % PER_VEC == 0, "one P.V output per thread");
  static_assert(PS <= 32 && PS % 4 == 0, "one softmax lane per key");
  static_assert(G * D % 4 == 0, "16-byte aligned shared memory");
};

// Shared memory of a block: k_s and v_s [PS][STRIDE] T, p_s [G][PS] f32, and
// per head m_s, l_s, lse_s, and the fold's scale_s, w_s, skip_s and den_s.
template <typename S, typename T>
struct Smem {
  T k_s[S::PS * S::STRIDE];
  T v_s[S::PS * S::STRIDE];
  float p_s[S::G * S::PS];
  float m_s[S::G], l_s[S::G], lse_s[S::G];
  float scale_s[S::G], w_s[S::G], den_s[S::G];
  int skip_s[S::G];
};

// This thread's slice of the block's G query rows: qr[g][i] = q[g][c + L i]
// for the lane c = tid % L of the score pass.
template <typename S, typename T>
__device__ __forceinline__ void load_q(float (&qr)[S::G][S::DL], const T* q) {
  const int c = threadIdx.x % S::L;
#pragma unroll
  for (int g = 0; g < S::G; ++g)
#pragma unroll
    for (int i = 0; i < S::DL; ++i) qr[g][i] = to_float(q[g * S::D + c + S::L * i]);
}

// One page of one kv head, K then V, into this thread's registers.
template <typename S, typename T>
__device__ __forceinline__ void load_page(uint4 (&r)[S::NV], const T* kp, const T* vp) {
  const uint4* k4 = reinterpret_cast<const uint4*>(kp);
  const uint4* v4 = reinterpret_cast<const uint4*>(vp);
#pragma unroll
  for (int i = 0; i < S::NV; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < S::VECS)
      r[i] = k4[v];
    else if (v < 2 * S::VECS)
      r[i] = v4[v - S::VECS];
  }
}

template <typename S, typename T>
__device__ __forceinline__ void store_page(const uint4 (&r)[S::NV], Smem<S, T>& sm) {
#pragma unroll
  for (int i = 0; i < S::NV; ++i) {
    int v = threadIdx.x + i * kThreads;
    if (v >= 2 * S::VECS) break;
    T* dst = sm.k_s;
    if (v >= S::VECS) {
      v -= S::VECS;
      dst = sm.v_s;
    }
    const int row = v / S::VEC_ROW;
    const int col = (v % S::VEC_ROW) * S::PER_VEC;
    *reinterpret_cast<uint4*>(dst + row * S::STRIDE + col) = r[i];
  }
}

// The partial of one live page for the G query heads of one kv head, from the
// thread's query slice qr and the page's K/V in shared memory. Every thread
// of the block calls it (it synchronises). On return m_s, l_s and lse_s hold
// each head's max, sum and m + log(l) (NEG_INF for l == 0), and thread d < D
// holds pv[g] = sum_j p[g, j] * v[j, d]. Both kernels call this one function,
// so a page's partial has the same bits in either. With kFold, the lane that
// finished head g's softmax also takes the fold's step for the head: it
// updates the head's carry (mc, den) and leaves the skip flag, the carry's
// scale and the page's weight in shared memory.
template <typename S, typename T, bool kFold>
__device__ __forceinline__ void page_partial(const float (&qr)[S::G][S::DL],
                                             Smem<S, T>& sm, int key0, int len,
                                             float scale, float (&pv)[S::G],
                                             float (&mc)[S::HW], float (&den)[S::HW]) {
  const int tid = threadIdx.x;
  {  // scores: key j on lanes c = 0..L-1, lane c takes d = c, c + L, ...
    const int j = tid / S::L;
    const int c = tid % S::L;
    float dot[S::G];
#pragma unroll
    for (int g = 0; g < S::G; ++g) dot[g] = 0.f;
    const T* krow = sm.k_s + j * S::STRIDE + c;
#pragma unroll
    for (int i = 0; i < S::DL; ++i) {
      const float kv = to_float(krow[S::L * i]);
#pragma unroll
      for (int g = 0; g < S::G; ++g) dot[g] = fmaf(qr[g][i], kv, dot[g]);
    }
#pragma unroll
    for (int o = S::L / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < S::G; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
    if (c == 0) {
      const bool valid = key0 + j < len;
#pragma unroll
      for (int g = 0; g < S::G; ++g) sm.p_s[g * S::PS + j] = valid ? dot[g] * scale : kNegInf;
    }
  }
  __syncthreads();
  {  // softmax of the page: one warp per query head, one lane per key
    const int warp = tid / 32;
    const int lane = tid % 32;
#pragma unroll
    for (int h = 0; h < S::HW; ++h) {
      const int g = warp + h * kWarps;
      if (g >= S::G) break;
      const float s = lane < S::PS ? sm.p_s[g * S::PS + lane] : kNegInf;
      const float m = warp_max(s);
      const float p = lane < S::PS ? expf(s - m) : 0.f;
      const float l = warp_sum(p);
      // the P.V operand is p in v's type, as the TPU kernel casts it
      if (lane < S::PS) sm.p_s[g * S::PS + lane] = to_float(from_float<T>(p));
      if (lane == 0) {
        const float lse = l > 0.f ? m + logf(l) : kNegInf;
        sm.m_s[g] = m;
        sm.l_s[g] = l;
        sm.lse_s[g] = lse;
        if (kFold) {  // _fd_fold's step; an empty entry leaves the carry alone
          const bool skip = !(l > 0.f) || lse <= kFdEmpty;
          sm.skip_s[g] = skip;
          if (!skip) {
            const float new_m = fmaxf(mc[h], lse);
            const float sc = expf(mc[h] - new_m);
            const float w = expf(lse - new_m);
            den[h] = __fadd_rn(__fmul_rn(den[h], sc), w);
            mc[h] = new_m;
            sm.scale_s[g] = sc;
            sm.w_s[g] = w;
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < S::G; ++g) pv[g] = 0.f;
  if (tid < S::D) {
#pragma unroll
    for (int j0 = 0; j0 < S::PS; j0 += 4) {
      float vv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) vv[jj] = to_float(sm.v_s[(j0 + jj) * S::STRIDE + tid]);
#pragma unroll
      for (int g = 0; g < S::G; ++g) {
        const float4 p4 = *reinterpret_cast<const float4*>(&sm.p_s[g * S::PS + j0]);
        pv[g] = fmaf(p4.x, vv[0], pv[g]);
        pv[g] = fmaf(p4.y, vv[1], pv[g]);
        pv[g] = fmaf(p4.z, vv[2], pv[g]);
        pv[g] = fmaf(p4.w, vv[3], pv[g]);
      }
    }
  }
}

// Grid (Hkv, S, B). q [B, Hq, D]; k_pages / v_pages [p_local, Hkv, PS, D] (this
// rank's slice); block_table [B, S] global page ids; kv_len [B] ->
// out [B, S, Hq, D] f32, lse [B, S, Hq] f32.
template <typename S, typename T>
__global__ void __launch_bounds__(kThreads)
    fd_page_partials_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                            const T* __restrict__ v_pages, const int* __restrict__ block_table,
                            const int* __restrict__ kv_len, float* __restrict__ out,
                            float* __restrict__ lse, int Hkv, int p_local, int n_cols,
                            int rank, float sm_scale, int neutral_out) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int Hq = Hkv * S::G;
  const int len = kv_len[b];
  const int page = block_table[(size_t)b * n_cols + s];
  const int loc = page - rank * p_local;
  const bool live = loc >= 0 && loc < p_local && s * S::PS < len;

  const size_t row = (size_t)b * n_cols + s;
  float* o = out + (row * Hq + (size_t)h * S::G) * S::D;
  float* ls = lse + row * Hq + (size_t)h * S::G;
  if (!live) {  // the neutral entry, by a select: no K/V is read
    if (neutral_out)  // B8 reads no out of an entry whose lse is empty
      for (int i = tid; i < S::G * S::D; i += kThreads) o[i] = 0.f;
    if (tid < S::G) ls[tid] = kNegInf;
    return;
  }

  __shared__ __align__(16) Smem<S, T> sm;
  const size_t off = ((size_t)loc * Hkv + h) * (size_t)S::PS * S::D;
  uint4 r[S::NV];
  load_page<S>(r, k_pages + off, v_pages + off);
  float qr[S::G][S::DL];
  load_q<S>(qr, q + ((size_t)b * Hq + (size_t)h * S::G) * S::D);
  store_page<S>(r, sm);
  __syncthreads();

  float pv[S::G], mc[S::HW], den[S::HW];
  page_partial<S, T, false>(qr, sm, s * S::PS, len, sm_scale, pv, mc, den);
  if (tid < S::D) {
#pragma unroll
    for (int g = 0; g < S::G; ++g) {
      const float l = sm.l_s[g];
      o[g * S::D + tid] = l > 0.f ? pv[g] / l : 0.f;
    }
  }
  if (tid < S::G) ls[tid] = sm.lse_s[tid];
}

// Grid (Hkv, B). The n = 1 route: the pool is the whole pool (P pages), and a
// page id outside [0, P) is a neutral entry. out [B, Hq, D] in q's type.
template <typename S, typename T>
__global__ void __launch_bounds__(kThreads)
    fd_partials_fold_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                            const T* __restrict__ v_pages, const int* __restrict__ block_table,
                            const int* __restrict__ kv_len, T* __restrict__ out, int Hkv,
                            int P, int n_cols, float sm_scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int Hq = Hkv * S::G;
  const int len = kv_len[b];
  int n_live = len > 0 ? (len + S::PS - 1) / S::PS : 0;
  if (n_live > n_cols) n_live = n_cols;
  const int* bt = block_table + (size_t)b * n_cols;
  const size_t head_elems = (size_t)S::PS * S::D;
  auto mine = [P](int page) { return page >= 0 && page < P; };

  __shared__ __align__(16) Smem<S, T> sm;
  uint4 r[S::NV];
  // the first page's K/V and the second page's id are in flight while q loads
  int cur = n_live > 0 ? bt[0] : -1;
  int next = n_live > 1 ? bt[1] : -1;
  if (mine(cur)) {
    const size_t off = ((size_t)cur * Hkv + h) * head_elems;
    load_page<S>(r, k_pages + off, v_pages + off);
  }
  float qr[S::G][S::DL];
  load_q<S>(qr, q + ((size_t)b * Hq + (size_t)h * S::G) * S::D);

  float acc[S::G], mc[S::HW], den[S::HW];
#pragma unroll
  for (int g = 0; g < S::G; ++g) acc[g] = 0.f;
#pragma unroll
  for (int i = 0; i < S::HW; ++i) {
    mc[i] = kNegInf;
    den[i] = 0.f;
  }
  for (int s = 0; s < n_live; ++s) {
    const bool live = mine(cur);
    __syncthreads();  // the previous page's reads of shared memory are done
    if (live) store_page<S>(r, sm);
    // the page after next: its id is read now and used one step later
    const int after = s + 2 < n_live ? bt[s + 2] : -1;
    if (mine(next)) {  // in flight while this page is computed
      const size_t off = ((size_t)next * Hkv + h) * head_elems;
      load_page<S>(r, k_pages + off, v_pages + off);
    }
    __syncthreads();
    if (live) {  // a page outside the pool is a neutral entry: a no-op
      float pv[S::G];
      page_partial<S, T, true>(qr, sm, s * S::PS, len, sm_scale, pv, mc, den);
#pragma unroll
      for (int g = 0; g < S::G; ++g) {
        if (sm.skip_s[g]) continue;
        const float xo = pv[g] / sm.l_s[g];
        acc[g] = __fadd_rn(__fmul_rn(acc[g], sm.scale_s[g]), __fmul_rn(xo, sm.w_s[g]));
      }
    }
    cur = next;
    next = after;
  }
  // each head's denominator, from the lane that carried it
  if (tid % 32 == 0) {
#pragma unroll
    for (int i = 0; i < S::HW; ++i) {
      const int g = tid / 32 + i * kWarps;
      if (g < S::G) sm.den_s[g] = den[i];
    }
  }
  __syncthreads();
  if (tid < S::D) {
    T* o = out + ((size_t)b * Hq + (size_t)h * S::G) * S::D;
#pragma unroll
    for (int g = 0; g < S::G; ++g) {
      const float d = sm.den_s[g];
      o[g * S::D + tid] = from_float<T>(__fdiv_rn(acc[g], d > 0.f ? d : 1.f));
    }
  }
}

// B8: (row, head) pairs a block folds at once, D = 128 threads each
constexpr int kFoldD = 128;
constexpr int kFoldPairs = 4;
constexpr int kFoldThreads = kFoldD * kFoldPairs;
constexpr int kFoldAhead = 4;  // real entries whose outs are loaded together

// Grid (lanes, N): every rank of the mesh. outs / lses: each group index's
// slab, out [rows, S, Hq, D] f32 (read only where lse is real) and lse
// [rows, S, Hq] f32, the ranks of one group index sharing one buffer; res:
// each rank's [rows, Hq, D] in T. Pad words: [0, lanes) the entry barrier,
// [lanes, 2 lanes) the slabs' announcements, [2 lanes, 3 lanes) the exit
// barrier.
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
    fd_fold_dist_kernel(tdt_shmem::PeerTable outs, tdt_shmem::PeerTable lses,
                        tdt_shmem::PeerTable res, const int* __restrict__ kv_len, int rows,
                        int n_cols, int Hq, int ps, tdt_shmem::PeerTable pads,
                        tdt_shmem::Group G, tdt_shmem::Launch L) {
  using namespace tdt_shmem;
  const int lane = blockIdx.x;
  const int lanes = gridDim.x;
  const int me = group_me(G);
  const int n = group_n(G);
  if (!barrier_group_block(pads, lane, G, L)) return;
  // my slab is ready: one counted announcement to every member, then wait
  // for theirs (consumed, so the pad is zero after the call)
  __syncthreads();
  int ok = 1;
  if (threadIdx.x == 0) {
    __threadfence();
    for (int p = 0; p < n; ++p)
      if (p != me) signal_op(symm_at<int>(pads, group_pe(G, p)) + lanes + lane, 1);
    ok = signal_wait_until(symm_at<int>(pads, my_pe()) + lanes + lane, n - 1, true, L,
                           lanes + lane);
  }
  if (!__syncthreads_and(ok)) return;

  const float* o_r[kMaxPes];
  const float* l_r[kMaxPes];
#pragma unroll
  for (int r = 0; r < kMaxPes; ++r) {
    o_r[r] = r < n ? symm_at<const float>(outs, group_pe(G, r)) : nullptr;
    l_r[r] = r < n ? symm_at<const float>(lses, group_pe(G, r)) : nullptr;
  }
  T* mine = symm_at<T>(res, my_pe());
  const int d = threadIdx.x % kFoldD;
  const int wl = threadIdx.x % 32;
  for (int pair = lane * kFoldPairs + threadIdx.x / kFoldD; pair < rows * Hq;
       pair += lanes * kFoldPairs) {
    const int b = pair / Hq;
    const int h = pair - b * Hq;
    const int len = kv_len[b];
    int n_live = len > 0 ? (len + ps - 1) / ps : 0;
    if (n_live > n_cols) n_live = n_cols;
    const int steps = n_live * n;  // step t: page t / n, rank t % n
    const size_t row0 = (size_t)b * n_cols;
    float acc = 0.f, m = kNegInf, den = 0.f;
    for (int t0 = 0; t0 < steps; t0 += 32) {
      float lse = kNegInf;
      if (t0 + wl < steps) {
        const int s = (t0 + wl) / n;
        lse = __ldcg(l_r[t0 + wl - s * n] + (row0 + s) * Hq + h);
      }
      unsigned real = __ballot_sync(0xffffffffu, lse > kFdEmpty);
      while (real) {
        int k[kFoldAhead];
        float xl[kFoldAhead], xo[kFoldAhead];
#pragma unroll
        for (int i = 0; i < kFoldAhead; ++i) {
          k[i] = real ? __ffs(real) - 1 : -1;
          real &= real ? real - 1 : 0u;
          xl[i] = __shfl_sync(0xffffffffu, lse, k[i] < 0 ? 0 : k[i]);
          xo[i] = 0.f;
          if (k[i] >= 0) {
            const int t = t0 + k[i];
            const int s = t / n;
            xo[i] = __ldcg(o_r[t - s * n] + ((row0 + s) * Hq + h) * kFoldD + d);
          }
        }
#pragma unroll
        for (int i = 0; i < kFoldAhead; ++i) {
          if (k[i] < 0) break;
          // _fd_fold's step, as the fused kernel takes it
          const float new_m = fmaxf(m, xl[i]);
          const float sc = expf(m - new_m);
          const float w = expf(xl[i] - new_m);
          acc = __fadd_rn(__fmul_rn(acc, sc), __fmul_rn(xo[i], w));
          den = __fadd_rn(__fmul_rn(den, sc), w);
          m = new_m;
        }
      }
    }
    mine[((size_t)b * Hq + h) * kFoldD + d] =
        from_float<T>(__fdiv_rn(acc, den > 0.f ? den : 1.f));
  }
  // every member has read my slab before the next call may rewrite it
  barrier_group_block(pads, 2 * lanes + lane, G, L);
}

// The instantiated shapes: head dim 128, page size 16, G query heads per kv
// head. Calls fn with the Shape type, or returns false for another shape.
template <typename T, typename F>
bool with_shape(int G, int D, int PS, F&& fn) {
  if (D != 128 || PS != 16) return false;
  switch (G) {
    case 1: fn(Shape<T, 1, 128, 16>{}); return true;
    case 2: fn(Shape<T, 2, 128, 16>{}); return true;
    case 4: fn(Shape<T, 4, 128, 16>{}); return true;
    case 8: fn(Shape<T, 8, 128, 16>{}); return true;
    default: return false;
  }
}

template <typename T>
int launch_partials(const void* q, const void* kp, const void* vp, const void* bt,
                    const void* kv_len, void* out, void* lse, int B, int Hq, int Hkv, int D,
                    int ps, int p_local, int n_cols, int rank, float sm_scale, int neutral_out,
                    void* stream) {
  if (B <= 0 || n_cols <= 0 || n_cols > 65535 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const bool ok = with_shape<T>(Hq / Hkv, D, ps, [&](auto shape) {
    using S = decltype(shape);
    fd_page_partials_kernel<S, T><<<dim3(Hkv, n_cols, B), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
        static_cast<const int*>(bt), static_cast<const int*>(kv_len), static_cast<float*>(out),
        static_cast<float*>(lse), Hkv, p_local, n_cols, rank, sm_scale, neutral_out);
    err = cudaGetLastError();
  });
  return ok ? (int)err : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_fold(const void* q, const void* kp, const void* vp, const void* bt,
                const void* kv_len, void* out, int B, int Hq, int Hkv, int D, int ps, int P,
                int n_cols, float sm_scale, void* stream) {
  if (B <= 0 || n_cols <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const bool ok = with_shape<T>(Hq / Hkv, D, ps, [&](auto shape) {
    using S = decltype(shape);
    fd_partials_fold_kernel<S, T><<<dim3(Hkv, B), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
        static_cast<const int*>(bt), static_cast<const int*>(kv_len), static_cast<T*>(out), Hkv,
        P, n_cols, sm_scale);
    err = cudaGetLastError();
  });
  return ok ? (int)err : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_fold_dist(const void* const* outs, const void* const* lses, const void* const* res,
                     const void* kv_len, int rows, int n_cols, int Hq, int D, int ps, int lanes,
                     const void* const* pads, int n, const void* group, void* claim,
                     void* report, unsigned long long budget_ns, void* stream) {
  using namespace tdt_shmem;
  if (n < 2 || n > kMaxPes || rows < 1 || n_cols < 1 || Hq < 1 || D != kFoldD || ps < 1 ||
      lanes < 1 || group == nullptr)
    return (int)cudaErrorInvalidValue;
  const Group G = *static_cast<const Group*>(group);
  if (G.n < 2 || G.n > n) return (int)cudaErrorInvalidValue;
  lanes = resident_lanes(fd_fold_dist_kernel<T>, kFoldThreads, lanes, n);
  if (lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return launch_cooperative(fd_fold_dist_kernel<T>, dim3(lanes, n), dim3(kFoldThreads), 0,
                            stream, make_table(outs, n), make_table(lses, n),
                            make_table(res, n), static_cast<const int*>(kv_len), rows, n_cols,
                            Hq, ps, make_table(pads, n), G,
                            make_launch(claim, report, budget_ns, kFdFoldDist));
}

}  // namespace

extern "C" {

// q [B, Hq, D]; k/v pages [p_local, Hkv, ps, D]; block_table [B, S] i32 global
// page ids; kv_len [B] i32 -> out [B, S, Hq, D] f32, lse [B, S, Hq] f32.
int tdt_fd_page_partials_f32(const void* q, const void* kp, const void* vp, const void* bt,
                             const void* kv_len, void* out, void* lse, int B, int Hq, int Hkv,
                             int D, int ps, int p_local, int S, int rank, float sm_scale,
                             int neutral_out, void* stream) {
  return launch_partials<float>(q, kp, vp, bt, kv_len, out, lse, B, Hq, Hkv, D, ps, p_local,
                                S, rank, sm_scale, neutral_out, stream);
}

int tdt_fd_page_partials_bf16(const void* q, const void* kp, const void* vp, const void* bt,
                              const void* kv_len, void* out, void* lse, int B, int Hq, int Hkv,
                              int D, int ps, int p_local, int S, int rank, float sm_scale,
                              int neutral_out, void* stream) {
  return launch_partials<bf16>(q, kp, vp, bt, kv_len, out, lse, B, Hq, Hkv, D, ps, p_local, S,
                               rank, sm_scale, neutral_out, stream);
}

// The same inputs over the whole pool of P pages -> out [B, Hq, D] in q's
// type: the partials folded in block-table order.
int tdt_fd_partials_fold_f32(const void* q, const void* kp, const void* vp, const void* bt,
                             const void* kv_len, void* out, int B, int Hq, int Hkv, int D,
                             int ps, int P, int S, float sm_scale, void* stream) {
  return launch_fold<float>(q, kp, vp, bt, kv_len, out, B, Hq, Hkv, D, ps, P, S, sm_scale,
                            stream);
}

int tdt_fd_partials_fold_bf16(const void* q, const void* kp, const void* vp, const void* bt,
                              const void* kv_len, void* out, int B, int Hq, int Hkv, int D,
                              int ps, int P, int S, float sm_scale, void* stream) {
  return launch_fold<bf16>(q, kp, vp, bt, kv_len, out, B, Hq, Hkv, D, ps, P, S, sm_scale,
                           stream);
}

// B8 across n ranks. outs / lses: n pointers, each rank's group's slab (out
// [rows, S, Hq, D] f32, lse [rows, S, Hq] f32); res: n pointers to each
// rank's [rows, Hq, D] result; kv_len [rows]; pads: n pointers to pads of
// >= 3 * lanes zero words; group: the fold's groups (size >= 2). `lanes`
// is cut to what the card keeps resident at once.
int tdt_fd_fold_dist_f32(const void* const* outs, const void* const* lses,
                         const void* const* res, const void* kv_len, int rows, int S, int Hq,
                         int D, int ps, int lanes, const void* const* pads, int n,
                         const void* group, void* claim, void* report,
                         unsigned long long budget_ns, void* stream) {
  return launch_fold_dist<float>(outs, lses, res, kv_len, rows, S, Hq, D, ps, lanes, pads, n,
                                 group, claim, report, budget_ns, stream);
}

int tdt_fd_fold_dist_bf16(const void* const* outs, const void* const* lses,
                          const void* const* res, const void* kv_len, int rows, int S, int Hq,
                          int D, int ps, int lanes, const void* const* pads, int n,
                          const void* group, void* claim, void* report,
                          unsigned long long budget_ns, void* stream) {
  return launch_fold_dist<bf16>(outs, lses, res, kv_len, rows, S, Hq, D, ps, lanes, pads, n,
                                group, claim, report, budget_ns, stream);
}

const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
