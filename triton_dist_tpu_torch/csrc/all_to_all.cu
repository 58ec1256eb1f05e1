// The EP all-to-all of the MoE serving path, written by hand for Hopper
// (sm_90a): the wire across ranks (B21 and its segmented form B22) and the
// two row movements around it.
//
// Replaces the TPU kernels B21, all_to_all_push (the pallas_call at
// triton_dist_tpu/ops/all_to_all.py:347, _a2a_kernel :132, with its
// send-side quantise _quant_slot_pipeline :74 and per-arrival dequantise
// _dequant_slot_pipeline :108), and B22, all_to_all_push_seg (the
// pallas_call at :549, _a2a_seg_kernel :421).
//
//   a2a_push: every rank holds `arrays` wire arrays [n, slot]: slot p goes
//     to peer p's slot `me`. After the entry barrier, the local slot is
//     copied first, then the puts go out in the reference's (me + p) % n
//     order, each (peer, lane) announced by one signal; arrivals are
//     consumed in the same fixed order. With `quant`, array 0 holds
//     [n, cap, H] rows of the compute type and slot dst is quantised per
//     row just before its put (the f32 amax; scale = amax times the f32
//     reciprocal of qmax, the compiled reference's form of amax / qmax; 1
//     for a zero row; q = x / scale by an IEEE divide, rint for int8, RNE
//     for float8_e4m3fn): the wire rows land in the peer's array 0 and their
//     scales in its scale wire [n, cols] (cols = cap rounded up to 128, the
//     pad ones). With `dequant`, each arrived slot of array 0 is multiplied
//     by its scales in f32 into the compute type as it lands.
//   a2a_seg: the plain wire (no quantisation) in `segments` row chunks of
//     each slot (_seg_chunks); after its puts each (peer, segment, lane)
//     gets one counted signal, and the consumer waits segment by segment,
//     in fixed order, for the n - 1 peers. The same bytes land in the same
//     slots as a2a_push: the outputs are bitwise equal.
//
// Both run over a group inside a multi-axis mesh (a Group, shmem.cuh): one
// cooperative launch covers every rank of the mesh (grid (lanes, ranks)),
// and a rank puts to, signals and waits on the members of its group only.
// Every spin is bounded and reports kernel, rank and signal; every wait
// consumes its signal, so the pads are zero after a call.
//
// The one-rank row movements, around the wire:
//   ep_dispatch: x[r] = tokens[src[r] / topk] if valid[r], else 0
//                (x [P, H]: expert-aligned rows; src indexes the T * topk
//                 (token, k) pairs)
//   ep_combine:  out[t] = cast(sum over j = 0..topk-1, in order, of
//                              w[t, j] * y[pos[t * topk + j]])
//                (y [P, D], pos [T * topk], w [T, topk] f32, out [T, D]; the
//                 products and sums in f32 without fused multiply-adds, as
//                 the JAX combine's gather_back computes them; a pair whose
//                 pos lies outside [0, P) adds 0); ep_combine_scaled takes
//                 the expert edge's one-byte rows (fp8 e4m3fn or int8) with
//                 an f32 scale a row, w[t, j] * (y[p] * scale[p]) in f32
//
// As the serving path uses them, ep_dispatch (topk = 1) gathers the rows
// into their wire slots and ep_combine folds the returned slots back into
// the tokens (the reference's _slot_gather and combine's gather_back).
//
// What bounds them on this card: bytes. Each kernel reads and writes a few
// rows of d_model values, at most a few MB per MoE layer, with one multiply
// and add per value read: far under the ~295 operations per byte where the
// H100 stops being memory bound, and at decode it is over before the launch
// overhead is.
//
// The wire moves every rank's slots once through the one HBM when all ranks
// share a card; at decode (a few rows a slot) it is latency-bound, like
// B9's push. Its design: each slot is cut into lanes (row ranges under
// quantisation, 16-byte ranges otherwise), and the blocks of one lane
// form an independent exchange with their own barrier word and flags, so
// no block waits for another lane; a quantised row is read twice (amax,
// then the quotients) by one block, reduced by warp shuffles.
//
// What the design does about the row movements: one block per output row,
// its 128 threads moving 16-byte vectors, so each value is read and written once in whole
// sectors; the row index and its validity are read once per block. An index
// outside its range is treated as a row routed nowhere, so no value outside
// the inputs is ever read.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 128;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, bf16* o) { *o = __float2bfloat16_rn(v); }

// Grid (P): block r writes aligned row r, `vecs` 16-byte vectors.
__global__ void __launch_bounds__(kThreads)
    ep_dispatch_kernel(const uint4* __restrict__ tokens, const int* __restrict__ src,
                       const unsigned char* __restrict__ valid, uint4* __restrict__ out,
                       int pairs, int vecs, int topk) {
  const int r = blockIdx.x;
  const int s = src[r];
  const bool ok = valid[r] && s >= 0 && s < pairs;
  uint4* dst = out + (size_t)r * vecs;
  if (!ok) {
    for (int v = threadIdx.x; v < vecs; v += kThreads) dst[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* row = tokens + (size_t)(s / topk) * vecs;
  for (int v = threadIdx.x; v < vecs; v += kThreads) dst[v] = row[v];
}

// Grid (T): block t writes out[t], each thread 16-byte vectors of it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ep_combine_kernel(const T* __restrict__ y, const int* __restrict__ pos,
                      const float* __restrict__ w, T* __restrict__ out, int P, int D,
                      int topk) {
  constexpr int kV = 16 / sizeof(T);  // values per vector
  const int t = blockIdx.x;
  const int vecs = D / kV;
  for (int v = threadIdx.x; v < vecs; v += kThreads) {
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.f;
    for (int j = 0; j < topk; ++j) {
      const int p = pos[t * topk + j];
      const float wj = w[t * topk + j];
      if (p >= 0 && p < P) {
        const uint4 u = reinterpret_cast<const uint4*>(y + (size_t)p * D)[v];
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < kV; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(e[i]), wj));
      } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(0.f, wj));
      }
    }
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int i = 0; i < kV; ++i) from_f32(acc[i], &oe[i]);
    reinterpret_cast<uint4*>(out + (size_t)t * D)[v] = o;
  }
}

template <typename T>
int launch_combine(const void* y, const void* pos, const void* w, void* out, int P, int T_,
                   int D, int topk, void* stream) {
  constexpr int kV = 16 / sizeof(T);
  if (P <= 0 || T_ <= 0 || D <= 0 || D % kV || topk <= 0) return (int)cudaErrorInvalidValue;
  ep_combine_kernel<T><<<T_, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(y), static_cast<const int*>(pos), static_cast<const float*>(w),
      static_cast<T*>(out), P, D, topk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B21 and B22: the wire across ranks
// ---------------------------------------------------------------------------

using tdt_shmem::Group;
using tdt_shmem::Launch;
using tdt_shmem::PeerTable;

constexpr int kWireThreads = 256;
constexpr int kMaxArrays = 3;
constexpr int kMaxSegments = 4;

enum WireType : int { kWireNone = 0, kWireFp8 = 1, kWireInt8 = 2 };
enum XType : int { kXBf16 = 0, kXF32 = 1 };

// What one call moves (built by ops/all_to_all.py, field for field).
struct A2aArgs {
  PeerTable in[kMaxArrays];       // array a's input [n, in_slot[a]] of each rank
  PeerTable out[kMaxArrays];      // array a's output [n, slot[a]] of each rank
  long long in_slot[kMaxArrays];  // bytes of one input slot
  long long slot[kMaxArrays];     // bytes of one output slot
  int arrays;
  int quant;        // kWire*: quantise array 0's rows on the send side
  int dequant;      // 1: dequantise array 0's arrivals into deq
  int wire;         // array 0's wire type under quant or dequant
  int x_type;       // the compute type (quant's input, dequant's output)
  int cap, H, cols;
  int silent;       // a rank that puts but never signals (-1: none)
  int segments;     // B22: segments of each slot
  int scale_array;  // the array that carries array 0's scales (-1: none)
  PeerTable qscale;  // quant: the scale wire [n, cols] f32 it writes
  PeerTable dscale;  // dequant: the scale wire [n, cols] f32 it reads
  PeerTable deq;     // dequant: [n, cap, H] of the compute type
  long long seg_off[kMaxArrays][kMaxSegments];  // B22: bytes of a slot
  long long seg_len[kMaxArrays][kMaxSegments];
};

__device__ __forceinline__ long long lane_chunk(long long len, int lanes) {
  return ((len + lanes - 1) / lanes + 15) / 16 * 16;
}

// bytes [b0, b1) of src to dst by the block, 16 bytes at a time where both
// ends allow it; reads through L2 (a peer may have written the source)
__device__ __forceinline__ void copy_range(unsigned char* dst, const unsigned char* src,
                                           long long b0, long long b1) {
  if (b1 <= b0) return;
  tdt_shmem::putmem_block(dst + b0, src + b0, b1 - b0);
}

__device__ __forceinline__ float x_at(const void* row, int x_type, int j) {
  return x_type == kXF32 ? __ldcg(static_cast<const float*>(row) + j)
                         : __bfloat162float(__ldcg(static_cast<const bf16*>(row) + j));
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x / 32;
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[w] = v;
  __syncthreads();
  float m = red[0];
  for (int i = 1; i < (int)(blockDim.x / 32); ++i) m = fmaxf(m, red[i]);
  return m;
}

// rows [r0, r1) of one slot: x (compute type) quantised into q (wire type)
// and their scales into sc, as _quant does
__device__ void quant_rows(const void* x, unsigned char* q, float* sc, int x_type, int wire,
                           int H, int r0, int r1) {
  __shared__ float red[kWireThreads / 32];
  const float qmax = wire == kWireFp8 ? 448.0f : 127.0f;
  const float inv_qmax = __frcp_rn(qmax);  // XLA's rewrite of amax / qmax
  const size_t xsize = x_type == kXF32 ? 4 : 2;
  for (int r = r0; r < r1; ++r) {
    const void* xr = static_cast<const unsigned char*>(x) + (size_t)r * H * xsize;
    float amax = 0.f;
    for (int j = threadIdx.x; j < H; j += blockDim.x) amax = fmaxf(amax, fabsf(x_at(xr, x_type, j)));
    amax = block_max(amax, red);
    const float scale = amax > 0.f ? __fmul_rn(amax, inv_qmax) : 1.0f;
    unsigned char* qr = q + (size_t)r * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float v = __fdiv_rn(x_at(xr, x_type, j), scale);
      if (wire == kWireFp8)
        qr[j] = (unsigned char)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
      else
        qr[j] = (unsigned char)(signed char)(int)rintf(v);
    }
    if (threadIdx.x == 0) sc[r] = scale;
  }
}

__device__ __forceinline__ float wire_value(unsigned char b, int wire) {
  if (wire == kWireFp8) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E4M3);
    return __half2float(__half(h));
  }
  return (float)(signed char)b;
}

__device__ __forceinline__ float wire_at(const unsigned char* q, int wire, size_t i) {
  return wire_value(__ldcg(q + i), wire);
}

// ep_combine of one-byte rows (the expert edge's return trip, still
// quantised): out[t] = cast(sum over j, in order, of w[t, j] * (y[p] *
// scale[p])), p = pos[t * topk + j], the dequantise folded into the f32
// sum as the JAX combine's gather_back does it. Grid (T): block t writes
// out[t], each thread 16 values (one 16-byte vector of y) at a time.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    ep_combine_scaled_kernel(const unsigned char* __restrict__ y, const float* __restrict__ scale,
                             const int* __restrict__ pos, const float* __restrict__ w,
                             OutT* __restrict__ out, int P, int D, int topk, int wire) {
  const int t = blockIdx.x;
  const int vecs = D / 16;
  for (int v = threadIdx.x; v < vecs; v += kThreads) {
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int j = 0; j < topk; ++j) {
      const int p = pos[t * topk + j];
      const float wj = w[t * topk + j];
      if (p >= 0 && p < P) {
        const uint4 u = reinterpret_cast<const uint4*>(y + (size_t)p * D)[v];
        const unsigned char* e = reinterpret_cast<const unsigned char*>(&u);
        const float sp = scale[p];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(wire_value(e[i], wire), sp), wj));
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(0.f, wj));
      }
    }
    __align__(16) OutT o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) from_f32(acc[i], &o[i]);
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)t * D + (size_t)v * 16);
#pragma unroll
    for (int i = 0; i < (int)sizeof(o) / 16; ++i) dst[i] = reinterpret_cast<const uint4*>(o)[i];
  }
}

// rows [r0, r1) of one arrived slot: wire rows times their scales, in f32,
// into the compute type, as _dequant does
__device__ void dequant_rows(const unsigned char* q, const float* sc, void* out, int wire,
                             int x_type, int H, int r0, int r1) {
  for (int r = r0; r < r1; ++r) {
    const float s = __ldcg(sc + r);
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const size_t i = (size_t)r * H + j;
      const float v = __fmul_rn(wire_at(q, wire, i), s);
      if (x_type == kXF32)
        static_cast<float*>(out)[i] = v;
      else
        static_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
    }
  }
}

__device__ __forceinline__ int flag_word(int src, int lane) {
  return gridDim.x + src * gridDim.x + lane;
}

// grid (lanes, ranks). Pad words: [0, lanes) the entry barrier;
// flag_word(src, lane) the arrival of src's slot (lane's part).
__global__ void __launch_bounds__(kWireThreads)
    a2a_push_kernel(A2aArgs A, PeerTable pads, Group G, Launch L) {
  using namespace tdt_shmem;
  const int me = group_me(G);
  const int n = group_n(G);
  const int lane = blockIdx.x;
  const int lanes = gridDim.x;
  const int self = my_pe();
  if (!barrier_group_block(pads, lane, G, L)) return;
  const bool rows0 = A.quant != kWireNone || A.dequant;
  const int per_rows = (A.cap + lanes - 1) / lanes;
  const int r0 = lane * per_rows < A.cap ? lane * per_rows : A.cap;
  const int r1 = r0 + per_rows < A.cap ? r0 + per_rows : A.cap;
  for (int p = 0; p < n; ++p) {
    const int dst = (me + p) % n;  // the local slot first
    const int peer = group_pe(G, dst);
    for (int a = 0; a < A.arrays; ++a) {
      const unsigned char* src = symm_at<const unsigned char>(A.in[a], self) + dst * A.in_slot[a];
      unsigned char* to = symm_at<unsigned char>(A.out[a], peer) + me * A.slot[a];
      if (a == 0 && A.quant != kWireNone) {
        float* sc = symm_at<float>(A.qscale, peer) + (size_t)me * A.cols;
        quant_rows(src, to, sc, A.x_type, A.quant, A.H, r0, r1);
        if (lane == 0)
          for (int c = A.cap + threadIdx.x; c < A.cols; c += blockDim.x) sc[c] = 1.0f;
      } else if (a == 0 && rows0) {
        const long long row = A.slot[0] / A.cap;
        copy_range(to, src, r0 * row, r1 * row);
      } else if (a == A.scale_array && rows0) {
        // the scales of this lane's rows travel with them; lane 0 the pad
        copy_range(to, src, r0 * 4LL, r1 * 4LL);
        if (lane == 0) copy_range(to, src, A.cap * 4LL, A.cols * 4LL);
      } else {
        const long long per = lane_chunk(A.slot[a], lanes);
        const long long b0 = lane * per < A.slot[a] ? lane * per : A.slot[a];
        copy_range(to, src, b0, b0 + per < A.slot[a] ? b0 + per : A.slot[a]);
      }
    }
    if (self != A.silent)
      signal_op_block(symm_at<int>(pads, peer) + flag_word(me, lane), 1);
    else
      __syncthreads();
  }
  for (int p = 0; p < n; ++p) {
    const int src = (me + p) % n;  // consumed in the same fixed order
    if (!wait_block(symm_at<int>(pads, self) + flag_word(src, lane), 1, true, L,
                    flag_word(src, lane)))
      return;
    if (A.dequant) {
      const size_t cells = (size_t)A.cap * A.H;
      dequant_rows(symm_at<const unsigned char>(A.out[0], self) + src * A.slot[0],
                   symm_at<const float>(A.dscale, self) + (size_t)src * A.cols,
                   symm_at<unsigned char>(A.deq, self) +
                       src * cells * (A.x_type == kXF32 ? 4 : 2),
                   A.wire, A.x_type, A.H, r0, r1);
    }
  }
  quiet();
}

__device__ __forceinline__ int seg_word(int seg, int lane) {
  return gridDim.x + seg * gridDim.x + lane;
}

// lane's part of segment s of array a, from src's slot to dst's slot
__device__ __forceinline__ void seg_copy(const A2aArgs& A, int a, int s, unsigned char* to,
                                         const unsigned char* from) {
  const long long len = A.seg_len[a][s];
  if (len <= 0) return;
  const long long per = lane_chunk(len, gridDim.x);
  const long long b0 = (long long)blockIdx.x * per < len ? (long long)blockIdx.x * per : len;
  const long long b1 = b0 + per < len ? b0 + per : len;
  copy_range(to + A.seg_off[a][s], from + A.seg_off[a][s], b0, b1);
}

// grid (lanes, ranks). Pad words: [0, lanes) the entry barrier;
// seg_word(s, lane) the count of peers whose segment s (lane's part) landed.
__global__ void __launch_bounds__(kWireThreads)
    a2a_seg_kernel(A2aArgs A, PeerTable pads, Group G, Launch L) {
  using namespace tdt_shmem;
  const int me = group_me(G);
  const int n = group_n(G);
  const int lane = blockIdx.x;
  const int self = my_pe();
  if (!barrier_group_block(pads, lane, G, L)) return;
  for (int s = 0; s < A.segments; ++s)
    for (int a = 0; a < A.arrays; ++a)
      seg_copy(A, a, s, symm_at<unsigned char>(A.out[a], self) + me * A.slot[a],
               symm_at<const unsigned char>(A.in[a], self) + me * A.in_slot[a]);
  for (int p = 1; p < n; ++p) {
    const int dst = (me + p) % n;
    const int peer = group_pe(G, dst);
    for (int s = 0; s < A.segments; ++s) {
      for (int a = 0; a < A.arrays; ++a)
        seg_copy(A, a, s, symm_at<unsigned char>(A.out[a], peer) + me * A.slot[a],
                 symm_at<const unsigned char>(A.in[a], self) + dst * A.in_slot[a]);
      if (self != A.silent)
        signal_op_block(symm_at<int>(pads, peer) + seg_word(s, lane), 1);
      else
        __syncthreads();
    }
  }
  if (n > 1)
    for (int s = 0; s < A.segments; ++s)
      if (!wait_block(symm_at<int>(pads, self) + seg_word(s, lane), n - 1, true, L,
                      seg_word(s, lane)))
        return;
  __syncthreads();
  quiet();
}

template <typename K>
int launch_wire(K kernel, int kernel_id, const void* args, const void* const* pads, int n,
                const void* group, int lanes, void* claim, void* report,
                unsigned long long budget_ns, void* stream) {
  using namespace tdt_shmem;
  if (n < 1 || n > kMaxPes || lanes < 1 || args == nullptr || group == nullptr)
    return (int)cudaErrorInvalidValue;
  const A2aArgs A = *static_cast<const A2aArgs*>(args);
  const Group G = *static_cast<const Group*>(group);
  if (A.arrays < 1 || A.arrays > kMaxArrays || G.n < 1 || G.n > n ||
      A.segments < 1 || A.segments > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  lanes = resident_lanes(kernel, kWireThreads, lanes, n);
  if (lanes < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return launch_cooperative(kernel, dim3(lanes, n), dim3(kWireThreads), 0, stream, A,
                            make_table(pads, n), G,
                            make_launch(claim, report, budget_ns, kernel_id));
}

}  // namespace

extern "C" {

// args: an A2aArgs; pads: n pointers to each rank's pad of >= (g + 1) *
// lanes zero words (g the group size); group: the exchange's groups over
// the n ranks. `lanes` is cut to what the card keeps resident.
int tdt_a2a_push(const void* args, const void* const* pads, int n, const void* group, int lanes,
                 void* claim, void* report, unsigned long long budget_ns, void* stream) {
  return launch_wire(a2a_push_kernel, tdt_shmem::kA2aPush, args, pads, n, group, lanes, claim,
                     report, budget_ns, stream);
}

// as tdt_a2a_push, plain arrays only, pads of >= (segments + 1) * lanes
// words
int tdt_a2a_push_seg(const void* args, const void* const* pads, int n, const void* group,
                     int lanes, void* claim, void* report, unsigned long long budget_ns,
                     void* stream) {
  return launch_wire(a2a_seg_kernel, tdt_shmem::kA2aSeg, args, pads, n, group, lanes, claim,
                     report, budget_ns, stream);
}



// tokens [T, row_bytes / esize]; src [P] i32; valid [P] bool; out [P, ...]
// of the tokens' type. row_bytes % 16 == 0. Returns the launch's cudaError_t.
int tdt_ep_dispatch(const void* tokens, const void* src, const void* valid, void* out, int P,
                    int T, int row_bytes, int topk, void* stream) {
  if (P <= 0 || T <= 0 || row_bytes <= 0 || row_bytes % 16 || topk <= 0)
    return (int)cudaErrorInvalidValue;
  ep_dispatch_kernel<<<P, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(tokens), static_cast<const int*>(src),
      static_cast<const unsigned char*>(valid), static_cast<uint4*>(out), T * topk,
      row_bytes / 16, topk);
  return (int)cudaGetLastError();
}

// y [P, D]; pos [T * topk] i32; w [T, topk] f32; out [T, D] of y's type.
int tdt_ep_combine_bf16(const void* y, const void* pos, const void* w, void* out, int P, int T,
                        int D, int topk, void* stream) {
  return launch_combine<bf16>(y, pos, w, out, P, T, D, topk, stream);
}

int tdt_ep_combine_f32(const void* y, const void* pos, const void* w, void* out, int P, int T,
                       int D, int topk, void* stream) {
  return launch_combine<float>(y, pos, w, out, P, T, D, topk, stream);
}

// y [P, D] fp8 e4m3fn (wire 1) or int8 (wire 2); scale [P] f32; pos [T *
// topk] i32; w [T, topk] f32; out [T, D] bf16 (out_type 0) or f32 (1).
// D % 16 == 0.
int tdt_ep_combine_scaled(const void* y, const void* scale, const void* pos, const void* w,
                          void* out, int P, int T, int D, int topk, int wire, int out_type,
                          void* stream) {
  if (P <= 0 || T <= 0 || D <= 0 || D % 16 || topk <= 0 ||
      (wire != kWireFp8 && wire != kWireInt8) || (out_type != kXBf16 && out_type != kXF32))
    return (int)cudaErrorInvalidValue;
  const auto* yy = static_cast<const unsigned char*>(y);
  const auto* sc = static_cast<const float*>(scale);
  const auto* pp = static_cast<const int*>(pos);
  const auto* ww = static_cast<const float*>(w);
  if (out_type == kXF32)
    ep_combine_scaled_kernel<float><<<T, kThreads, 0, (cudaStream_t)stream>>>(
        yy, sc, pp, ww, static_cast<float*>(out), P, D, topk, wire);
  else
    ep_combine_scaled_kernel<bf16><<<T, kThreads, 0, (cudaStream_t)stream>>>(
        yy, sc, pp, ww, static_cast<bf16*>(out), P, D, topk, wire);
  return (int)cudaGetLastError();
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
