// Ring attention -- causal GQA flash attention, forward and backward, on one
// rank and across the ranks of a ring -- written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels of triton_dist_tpu/ops/ring_attention.py:
//   ring_attention_fwd (_ring_fwd_kernel :407, the update of _attn_step_pipeline)
//   ring_attention_bwd (_ring_bwd_kernel :900: the delta pass,
//                       _bwd_dq_pipeline, _bwd_dkv_pipeline, _p_ds_core)
// Layouts: q [B*Hq, S, D] prescaled by sm_scale*log2(e) (the wrapper rounds
// it to the input type, as the JAX wrapper does), k/v [B*Hkv, S, D]; query
// head h of batch b reads kv head b*Hkv + h/G. The softmax runs in base 2;
// lse is written in the natural-log domain: lse = (m + log2 l) * ln2, or
// -1e30 for a row with no valid key.
//
// Rounding points kept from the TPU kernels: p is cast to v's type before
// P.V; in the backward p = exp2(s - lse*log2 e), dS = p*(dp - delta), and dS
// and p are cast to the input type before their products. Sums are f32.
//
// What bounds it on this card: operations. At the training shape (S = 4096,
// Hq = 32, D = 128, causal) the forward does 2*S^2*D*Hq ~ 1.4e11 operations
// against ~84 MB of traffic, and the backward about 2.5 times the forward's
// operations: far above the ~295 operations per byte where the H100 stops
// being memory bound. Across ranks the ring adds (n - 1) K||V blocks a rank
// (and in the backward as many f32 dk||dv blocks), a few percent of the time
// the operations take.
//
// What the design does about it, for now: tiles of 64 query rows by 64 keys
// staged through shared memory as f32 (ring_attention_tile.cuh), register
// tiles of 4x4 (scores) and 4x8 (outputs) per thread, causal walks that stop
// at the diagonal, and the heaviest causal tiles launched first. The
// products run on the CUDA cores; wgmma, TMA and warp specialisation are
// later work. No atomics: each output tile is summed by one block in a
// fixed order, so a launch is bitwise reproducible.
//
// Across ranks (the *_ranks kernels): every rank of the mesh runs in one
// cooperative launch, grid (lanes, N) with the rank on y (shmem.cuh), and
// the rings run over the groups of the ring's axis (a Group). A rank's
// lanes are persistent blocks, as many as stay resident, that loop over
// the rank's work items, (query head, query tile) and (kv head, key tile).
// The protocol is the reference's: an entry barrier, then n steps; step s
// computes the local queries against the K||V block that started at group
// index me - s. Before computing, each lane puts its share of that block's
// rows into the right neighbour's relay slot (s + 1) % 2 and adds one to the
// neighbour's arrival count of step s + 1; a lane of the next step waits
// until every lane's share has arrived. A slot is refilled only after a
// credit: each lane of the right neighbour adds one to our ack count of
// step s once it has read its slots of step s, and a put at step s >= 2
// waits for every lane's ack of step s - 1. The counts are read by many
// lanes, so no wait consumes them: the last lane of a rank to finish waits
// until every count is complete, consumes it and zeroes the finish word, so
// the pad is zero after a call.
// The forward carries its (m, l, acc) state in f32 in device memory between
// steps and writes out and lse at the last step. The backward carries dq in
// f32 in device memory, and the f32 dk||dv accumulator of each block travels
// with it: each step adds the local queries' share and stores the sum into
// the right neighbour's accumulator slot, so after n steps every block's
// gradient is home, where it is scaled, cast and split. Causal masks
// compare global positions (contiguous: rank r holds rows [r S, (r+1) S);
// zigzag: chunks r and 2n-1-r). A work item with no unmasked key in a step
// skips it (the reference's whole-step skip of a later rank's block in the
// contiguous layout, and the fully masked tiles of zigzag); the backward
// still forwards such a block's accumulator unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ring_attention_tile.cuh"
#include "shmem.cuh"

using namespace tdt_ring;
using namespace tdt_shmem;

namespace {

// ---------------------------------------------------------------------------
// forward: grid (B*Hq, n_tiles), one block per (query head, query tile)
// ---------------------------------------------------------------------------

constexpr size_t kFwdSmem =
    sizeof(float) * ((size_t)kT * kLdD * 2 + (size_t)kD * kLdT + (size_t)kT * kLdT);

// Head dim kC * kD. At kC = 1 the q tile stays in shared memory across the
// key tiles; wider heads load each chunk where it is used.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, 1)
    ring_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, int Hq, int Hkv, int S, int causal) {
  constexpr int D = kC * kD;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                // [kT][kLdD] prescaled q rows (a chunk)
  float* v_s = q_s + kT * kLdD;     // [kT][kLdD] v rows (a chunk)
  float* kt_s = v_s + kT * kLdD;    // [kD][kLdT] k, transposed (a chunk)
  float* p_s = kt_s + kD * kLdT;    // [kT][kLdT] p in v's type

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest causal rows first
  const int q0 = qt * kT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t head = (size_t)bh * S * D;
  const size_t kv = (size_t)kv_head(bh, Hq, Hkv) * S * D;

  if (kC == 1) load_rows(q_s, q + head, q0, S);
  float m[4], l[4], acc[kC][4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) zero(acc[c]);

  const int n_kv = causal ? qt + 1 : (int)gridDim.y;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kT;
    float s[4][4];
    zero(s);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      __syncthreads();  // the last reads of kt_s, v_s, p_s (and q_s) are done
      if (kC > 1) load_rows<false, D>(q_s, q + head + c * kD, q0, S);
      load_cols<false, D>(kt_s, k + kv + c * kD, k0, S);
      if (kC == 1) load_rows(v_s, v + kv, k0, S);
      __syncthreads();
      tile_mma<1>(s, q_s, kLdD, kt_s, kLdT, kD, ty, tx);
    }
    softmax_update<T>(s, m, l, acc, p_s, q0, k0, S, causal, ty, tx);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (kC > 1) {
        __syncthreads();
        load_rows<false, D>(v_s, v + kv + c * kD, k0, S);
      }
      __syncthreads();
      tile_mma<2>(acc[c], p_s, kLdT, v_s, kLdD, kT, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * kD + 64 * (j / 4) + 4 * tx + j % 4;
        out[head + (size_t)row * D + col] = from_float<T>(acc[c][i][j] * inv);
      }
    if (tx == 0)
      lse[(size_t)bh * S + row] = l[i] > 0.f ? kLn2 * (m[i] + log2f(l[i])) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(do * o) in f32, one warp per row of D
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += to_float(dout[(size_t)row * D + d]) * to_float(o[(size_t)row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// backward 2: dq, grid (B*Hq, n_tiles), one block per (query head, query tile)
// over its key tiles. Per tile: s^T = k.q^T and dp^T = v.do^T (key rows x
// query columns), dS = p * (dp - delta), dq += dS.k.
// ---------------------------------------------------------------------------

constexpr size_t kDqSmem = sizeof(float) * ((size_t)kD * kLdT * 2 + (size_t)kT * kLdD * 2 +
                                            (size_t)kT * kLdT + 2 * kT);

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, 1)
    ring_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lse,
                   const T* __restrict__ dout, const float* __restrict__ delta,
                   T* __restrict__ dq, int Hq, int Hkv, int S, int causal, float scale) {
  constexpr int D = kC * kD;
  extern __shared__ __align__(16) float smem[];
  float* qt_s = smem;                 // [kD][kLdT] prescaled q, transposed (a chunk)
  float* dot_s = qt_s + kD * kLdT;    // [kD][kLdT] do, transposed (a chunk)
  float* k_s = dot_s + kD * kLdT;     // [kT][kLdD] k rows (a chunk)
  float* v_s = k_s + kT * kLdD;       // [kT][kLdD] v rows (a chunk)
  float* ds_s = v_s + kT * kLdD;      // [kT q][kLdT] dS in k's type
  float* lse_s = ds_s + kT * kLdT;    // [kT] lse * log2 e
  float* dl_s = lse_s + kT;           // [kT] delta

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t head = (size_t)bh * S * D;
  const size_t kv = (size_t)kv_head(bh, Hq, Hkv) * S * D;

  if (kC == 1) {
    load_cols(qt_s, q + head, q0, S);
    load_cols(dot_s, dout + head, q0, S);
  }
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse[(size_t)bh * S + q0 + r] * kLog2e : 0.f;
    dl_s[r] = in ? delta[(size_t)bh * S + q0 + r] : 0.f;
  }
  float acc[kC][4][8];
#pragma unroll
  for (int c = 0; c < kC; ++c) zero(acc[c]);

  const int n_kv = causal ? qt + 1 : (int)gridDim.y;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kT;
    float st[4][4], dpt[4][4];  // rows: keys 4ty + i; columns: queries 4tx + j
    zero(st);
    zero(dpt);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      __syncthreads();
      if (kC > 1) {
        load_cols<false, D>(qt_s, q + head + c * kD, q0, S);
        load_cols<false, D>(dot_s, dout + head + c * kD, q0, S);
      }
      load_rows<false, D>(k_s, k + kv + c * kD, k0, S);
      load_rows<false, D>(v_s, v + kv + c * kD, k0, S);
      __syncthreads();
      tile_mma<1>(st, k_s, kLdD, qt_s, kLdT, kD, ty, tx);
      tile_mma<1>(dpt, v_s, kLdD, dot_s, kLdT, kD, ty, tx);
    }
    dq_tile_ds<T>(st, dpt, lse_s, dl_s, ds_s, q0, k0, S, causal, ty, tx);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (kC > 1) {
        __syncthreads();
        load_rows<false, D>(k_s, k + kv + c * kD, k0, S);
      }
      __syncthreads();
      tile_mma<2>(acc[c], ds_s, kLdT, k_s, kLdD, kT, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * kD + 64 * (j / 4) + 4 * tx + j % 4;
        dq[head + (size_t)row * D + col] = from_float<T>(acc[c][i][j] * scale);
      }
  }
}

// ---------------------------------------------------------------------------
// backward 3: dk || dv, grid (B*Hkv, n_tiles), one block per (kv head, key
// tile) over the G query heads of its group and, for each, the query tiles
// from the diagonal on. Per tile: s = q.k^T and dp = do.v^T (query rows x key
// columns), dv += p^T.do, dk += dS^T.q_pre * ln2.
// ---------------------------------------------------------------------------

constexpr size_t kDkvSmem = sizeof(float) * ((size_t)kD * kLdT * 2 + (size_t)kT * kLdD * 2 +
                                             (size_t)kT * kLdT * 2 + 2 * kT);

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, 1)
    ring_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ lse,
                    const T* __restrict__ dout, const float* __restrict__ delta,
                    T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int S,
                    int causal) {
  constexpr int D = kC * kD;
  extern __shared__ __align__(16) float smem[];
  float* kt_s = smem;                 // [kD][kLdT] k, transposed (a chunk)
  float* vt_s = kt_s + kD * kLdT;     // [kD][kLdT] v, transposed (a chunk)
  float* q_s = vt_s + kD * kLdT;      // [kT][kLdD] prescaled q rows (a chunk)
  float* do_s = q_s + kT * kLdD;      // [kT][kLdD] do rows (a chunk)
  float* pt_s = do_s + kT * kLdD;     // [kT key][kLdT] p in do's type
  float* dst_s = pt_s + kT * kLdT;    // [kT key][kLdT] dS in q's type
  float* lse_s = dst_s + kT * kLdT;   // [kT] lse * log2 e
  float* dl_s = lse_s + kT;           // [kT] delta

  const int bhkv = blockIdx.x;
  const int kt = blockIdx.y;  // low key tiles have the most causal work: first
  const int k0 = kt * kT;
  const int G = Hq / Hkv;
  const int n_tiles = gridDim.y;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t kv = (size_t)bhkv * S * D;

  if (kC == 1) {
    load_cols(kt_s, k + kv, k0, S);
    load_cols(vt_s, v + kv, k0, S);
  }
  float dk_acc[kC][4][8], dv_acc[kC][4][8];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    zero(dk_acc[c]);
    zero(dv_acc[c]);
  }

  for (int g = 0; g < G; ++g) {
    const int bh = (bhkv / Hkv) * Hq + (bhkv % Hkv) * G + g;
    const size_t head = (size_t)bh * S * D;
    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kT;
      float s[4][4], dp[4][4];  // rows: queries 4ty + i; columns: keys 4tx + j
      zero(s);
      zero(dp);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        __syncthreads();
        if (kC > 1) {
          load_cols<false, D>(kt_s, k + kv + c * kD, k0, S);
          load_cols<false, D>(vt_s, v + kv + c * kD, k0, S);
        }
        load_rows<false, D>(q_s, q + head + c * kD, q0, S);
        load_rows<false, D>(do_s, dout + head + c * kD, q0, S);
        if (c == 0)
          for (int r = threadIdx.x; r < kT; r += kThreads) {
            const bool in = q0 + r < S;
            lse_s[r] = in ? lse[(size_t)bh * S + q0 + r] * kLog2e : 0.f;
            dl_s[r] = in ? delta[(size_t)bh * S + q0 + r] : 0.f;
          }
        __syncthreads();
        tile_mma<1>(s, q_s, kLdD, kt_s, kLdT, kD, ty, tx);
        tile_mma<1>(dp, do_s, kLdD, vt_s, kLdT, kD, ty, tx);
      }
      dkv_tile_p_ds<T>(s, dp, lse_s, dl_s, pt_s, dst_s, q0, k0, S, causal, ty, tx);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (kC > 1) {
          __syncthreads();
          load_rows<false, D>(q_s, q + head + c * kD, q0, S);
          load_rows<false, D>(do_s, dout + head + c * kD, q0, S);
        }
        __syncthreads();
        tile_mma<2>(dv_acc[c], pt_s, kLdT, do_s, kLdD, kT, ty, tx);
        tile_mma<2>(dk_acc[c], dst_s, kLdT, q_s, kLdD, kT, ty, tx);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * kD + 64 * (j / 4) + 4 * tx + j % 4;
        dk[kv + (size_t)row * D + col] = from_float<T>(dk_acc[c][i][j] * kLn2);
        dv[kv + (size_t)row * D + col] = from_float<T>(dv_acc[c][i][j]);
      }
  }
}

bool bad_shape(int B, int Hq, int Hkv, int S) {
  return B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0;
}

template <typename T, int kC>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B,
               int Hq, int Hkv, int S, int causal, void* stream) {
  if (bad_shape(B, Hq, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ring_fwd_kernel<T, kC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (S + kT - 1) / kT;
  ring_fwd_kernel<T, kC><<<dim3(B * Hq, n_tiles), kThreads, kFwdSmem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Hq, Hkv, S, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta(const void* o, const void* dout, void* delta, int rows, int D,
                 cudaStream_t st) {
  const int warps = kThreads / 32;
  ring_delta_kernel<T><<<(rows + warps - 1) / warps, kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta),
      rows, D);
  return (int)cudaGetLastError();
}

template <typename T, int kC>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* delta, void* dq, void* dk,
               void* dv, int B, int Hq, int Hkv, int S, int causal, float scale,
               void* stream) {
  if (bad_shape(B, Hq, Hkv, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (S + kT - 1) / kT;
  cudaError_t e = (cudaError_t)launch_delta<T>(o, dout, delta, B * Hq * S, kC * kD, st);
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(ring_dq_kernel<T, kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDqSmem);
  if (e != cudaSuccess) return (int)e;
  ring_dq_kernel<T, kC><<<dim3(B * Hq, n_tiles), kThreads, kDqSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<T*>(dq), Hq, Hkv, S, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(ring_dkv_kernel<T, kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDkvSmem);
  if (e != cudaSuccess) return (int)e;
  ring_dkv_kernel<T, kC><<<dim3(B * Hkv, n_tiles), kThreads, kDkvSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv,
      S, causal);
  return (int)cudaGetLastError();
}

// ===========================================================================
// across ranks
// ===========================================================================

// A rank's block and the rings' shapes. Each rank reads and writes its own
// shard of the global tensors in place: its table entry is the address of
// the shard's first element, and a (batch row, head) of the shard is
// b * stride_b + h * stride_h elements further, its S rows contiguous.
struct RingShape {
  int BH, BHkv;          // (batch row, head) pairs of q and of k/v a rank holds
  int Hq, Hkv;           // heads a rank holds (its GQA map)
  int S;                 // rows a rank holds
  int c;                 // rows of a zigzag chunk (S / 2); S when contiguous
  int zigzag, causal;
  long long q_b, q_h;    // strides of q, out, do, dq (elements)
  long long kv_b, kv_h;  // of k, v, dk, dv
  long long r_b, r_h;    // of lse and delta
};

__device__ __forceinline__ size_t q_at(const RingShape& sh, int bh) {
  return (size_t)(bh / sh.Hq) * sh.q_b + (size_t)(bh % sh.Hq) * sh.q_h;
}
__device__ __forceinline__ size_t kv_at(const RingShape& sh, int bhkv) {
  return (size_t)(bhkv / sh.Hkv) * sh.kv_b + (size_t)(bhkv % sh.Hkv) * sh.kv_h;
}
__device__ __forceinline__ size_t r_at(const RingShape& sh, int bh) {
  return (size_t)(bh / sh.Hq) * sh.r_b + (size_t)(bh % sh.Hq) * sh.r_h;
}
// the local kv head of local query head bh
__device__ __forceinline__ int ring_kv_head(const RingShape& sh, int bh) {
  return (bh / sh.Hq) * sh.Hkv + (bh % sh.Hq) / (sh.Hq / sh.Hkv);
}

// Global position of local row t0 minus t0, for the tile that starts at t0
// in the block of group index r of n (the reference's _layout_offs and
// _tile_off): contiguous, r * S; zigzag, chunk r's or chunk 2n-1-r's start.
__device__ __forceinline__ int tile_off(const RingShape& sh, int r, int n, int t0) {
  if (!sh.zigzag) return r * sh.S;
  return t0 < sh.c ? r * sh.c : (2 * n - 1 - r) * sh.c - sh.c;
}

// Key tiles of block `src` with an unmasked key for the query tile at q0 of
// block `me`: a prefix [0, end), positions rising with the local index.
__device__ __forceinline__ int kv_tiles_end(const RingShape& sh, int me, int src, int n,
                                            int q0) {
  const int nt = (sh.S + kT - 1) / kT;
  if (!sh.causal) return nt;
  const int q_last = min(q0 + kT, sh.S) - 1;
  const int qpos = q_last + tile_off(sh, me, n, q0);
  int end = 0;
  while (end < nt && end * kT + tile_off(sh, src, n, end * kT) <= qpos) ++end;
  return end;
}

// Query tiles of block `me` with an unmasked query for the key tile at k0
// of block `src`: a suffix [begin, nt).
__device__ __forceinline__ int q_tiles_begin(const RingShape& sh, int me, int src, int n,
                                             int k0) {
  const int nt = (sh.S + kT - 1) / kT;
  if (!sh.causal) return 0;
  const int kpos = k0 + tile_off(sh, src, n, k0);
  int begin = nt;
  while (begin > 0) {
    const int q0 = (begin - 1) * kT;
    if (min(q0 + kT, sh.S) - 1 + tile_off(sh, me, n, q0) < kpos) break;
    --begin;
  }
  return begin;
}

// Words of a rank's pad, for `lanes` lanes and a ring of n: [lane] the
// entry barrier, kv_arrival(s) the K||V shares that arrived for step s
// (1 <= s < n), g_arrival(s) the dk||dv shares for step s (1 <= s <= n;
// n is the homecoming), ack(s) the right neighbour's lanes that have read
// their slots of step s (1 <= s < n), and the finish word. The acks are
// counted a step apart: a lane without work may run steps ahead of a busy
// one, so a count summed over steps could be complete while a slot is
// still being read.
struct RingWords {
  int lanes, n;
  __device__ int kv_arrival(int s) const { return lanes + s; }
  __device__ int g_arrival(int s) const { return lanes + n + s; }
  __device__ int ack(int s) const { return lanes + 2 * n + s; }
  __device__ int finish() const { return lanes + 3 * n; }
};

// This lane's share of the K||V block to the right neighbour's relay slot:
// rows [r0, r1) of the block's 2 * BHkv * S rows (K planes, then V), read
// from the rank's own k and v (step 0) or from its relay slot.
template <typename T, int D>
__device__ void put_kv_share(const RingShape& sh, const T* k, const T* v, const T* slot,
                             T* dst, int lane, int lanes) {
  constexpr int kVecs = D * sizeof(T) / 16;  // 16-byte vectors a row
  const long long rows = 2LL * sh.BHkv * sh.S;
  const long long per = (rows + lanes - 1) / lanes;
  const long long r0 = lane * per;
  const long long r1 = r0 + per < rows ? r0 + per : rows;
  const long long plane_rows = (long long)sh.BHkv * sh.S;
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (long long i = r0 * kVecs + threadIdx.x; i < r1 * kVecs; i += kThreads) {
    const long long row = i / kVecs;
    const uint4* s;
    if (slot != nullptr) {
      s = reinterpret_cast<const uint4*>(slot) + i;
    } else {
      const int plane = (int)(row / plane_rows);
      const long long rem = row % plane_rows;
      const T* base = (plane ? v : k) + kv_at(sh, (int)(rem / sh.S)) + (rem % sh.S) * D;
      s = reinterpret_cast<const uint4*>(base) + i % kVecs;
    }
    d[i] = __ldcg(s);
  }
}

// The end of the call for one lane, which waits on no count of its rank's
// pad any more: the last lane of the rank waits until every count is
// complete (every lane's share of each arrival, every lane's acks of the
// right neighbour's n - 1 steps), consumes it and zeroes the finish word.
// All threads call it; false on error.
__device__ __noinline__ bool ring_finish(int* pad, const RingWords& w, bool backward,
                                         const Launch& L) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = arrive_last(pad + w.finish(), w.lanes);
  }
  __syncthreads();
  if (!last) return true;
  for (int s = 1; s < w.n; ++s)
    if (!wait_block(pad + w.kv_arrival(s), w.lanes, true, L, w.kv_arrival(s))) return false;
  if (backward)
    for (int s = 1; s <= w.n; ++s)
      if (!wait_block(pad + w.g_arrival(s), w.lanes, true, L, w.g_arrival(s))) return false;
  for (int s = 1; s < w.n; ++s)
    if (!wait_block(pad + w.ack(s), w.lanes, true, L, w.ack(s))) return false;
  if (threadIdx.x == 0) atomicExch(pad + w.finish(), 0);
  return true;
}

// ---------------------------------------------------------------------------
// forward across ranks
// ---------------------------------------------------------------------------

struct FwdTables {
  PeerTable q, k, v, out, lse;  // each rank's shard (q prescaled)
  PeerTable slots;              // [2 slots][K, V][BHkv][S][D] in T
  PeerTable state;              // [BH][S][D] acc, [BH][S] m, [BH][S] l in f32
  PeerTable pads;
};

// One (query head, query tile) against the K||V block of group index src
// at step s: the running state from device memory (none at step 0), the
// key tiles with an unmasked key, then the state back or, at the last
// step, out and lse.
template <typename T, int kC>
__device__ void fwd_item(float* smem, const RingShape& sh, int it, int s, int n, int me, int src,
                         const T* q, const T* k_own, const T* v_own, const T* slot, T* out,
                         float* lse, float* st) {
  constexpr int D = kC * kD;
  float* q_s = smem;
  float* v_s = q_s + kT * kLdD;
  float* kt_s = v_s + kT * kLdD;
  float* p_s = kt_s + kD * kLdT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bh = it % sh.BH;
  const int q0 = (it / sh.BH) * kT;
  const bool last = s == n - 1;
  const int t_end = kv_tiles_end(sh, me, src, n, q0);
  if (t_end == 0 && !last) return;  // no key of this block counts for these rows

  float* st_acc = st + (size_t)bh * sh.S * D;
  float* st_m = st + (size_t)sh.BH * sh.S * D + (size_t)bh * sh.S;
  float* st_l = st_m + (size_t)sh.BH * sh.S;
  float m[4], l[4], acc[kC][4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const bool carried = s > 0 && row < sh.S;
    m[i] = carried ? __ldcg(st_m + row) : kNegInf;
    l[i] = carried ? __ldcg(st_l + row) : 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[c][i][j] =
            carried ? __ldcg(st_acc + (size_t)row * D + c * kD + 64 * (j / 4) + 4 * tx + j % 4)
                    : 0.f;
  }

  if (t_end > 0) {
    const int kvh = ring_kv_head(sh, bh);
    const T* kp = slot ? slot + (size_t)kvh * sh.S * D : k_own + kv_at(sh, kvh);
    const T* vp = slot ? slot + ((size_t)sh.BHkv + kvh) * sh.S * D : v_own + kv_at(sh, kvh);
    const T* qp = q + q_at(sh, bh);
    const int q_off = tile_off(sh, me, n, q0);
    if (kC == 1) {
      __syncthreads();  // the last item's reads of q_s are done
      load_rows(q_s, qp, q0, sh.S);
    }
    for (int t = 0; t < t_end; ++t) {
      const int k0 = t * kT;
      float sc[4][4];
      zero(sc);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        __syncthreads();
        if (kC > 1) load_rows<false, D>(q_s, qp + c * kD, q0, sh.S);
        load_cols<true, D>(kt_s, kp + c * kD, k0, sh.S);
        if (kC == 1) load_rows<true>(v_s, vp, k0, sh.S);
        __syncthreads();
        tile_mma<1>(sc, q_s, kLdD, kt_s, kLdT, kD, ty, tx);
      }
      softmax_update<T, true>(sc, m, l, acc, p_s, q0, k0, sh.S, sh.causal, ty, tx, q_off,
                        tile_off(sh, src, n, k0));
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (kC > 1) {
          __syncthreads();
          load_rows<true, D>(v_s, vp + c * kD, k0, sh.S);
        }
        __syncthreads();
        tile_mma<2>(acc[c], p_s, kLdT, v_s, kLdD, kT, ty, tx);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sh.S) continue;
    if (last) {
      const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * kD + 64 * (j / 4) + 4 * tx + j % 4;
          out[q_at(sh, bh) + (size_t)row * D + col] = from_float<T>(acc[c][i][j] * inv);
        }
      if (tx == 0)
        lse[r_at(sh, bh) + row] = l[i] > 0.f ? kLn2 * (m[i] + log2f(l[i])) : kNegInf;
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st_acc[(size_t)row * D + c * kD + 64 * (j / 4) + 4 * tx + j % 4] = acc[c][i][j];
      if (tx == 0) {
        st_m[row] = m[i];
        st_l[row] = l[i];
      }
    }
  }
}

// grid (lanes, N): every rank of the mesh; the rings run over G's groups.
// A `silent` rank (-1 for none) never signals its puts (the hang check).
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, 1)
    ring_fwd_ranks_kernel(FwdTables a, RingShape sh, Group G, int silent, Launch L) {
  constexpr int D = kC * kD;
  extern __shared__ __align__(16) float smem[];
  const int pe = my_pe();
  const int me = group_me(G);
  const int n = group_n(G);
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  const RingWords w{lanes, n};
  if (!barrier_group_block(a.pads, lane, G, L)) return;
  const int right = group_pe(G, me + 1);
  const int left = group_pe(G, me - 1);
  int* pad = symm_at<int>(a.pads, pe);
  const T* q = symm_at<const T>(a.q, pe);
  const T* k = symm_at<const T>(a.k, pe);
  const T* v = symm_at<const T>(a.v, pe);
  T* slots = symm_at<T>(a.slots, pe);
  T* slots_right = symm_at<T>(a.slots, right);
  const size_t slot_elems = 2 * (size_t)sh.BHkv * sh.S * D;
  const int items = sh.BH * ((sh.S + kT - 1) / kT);

  for (int s = 0; s < n; ++s) {
    const int src = (me - s + n) % n;
    const T* slot = s == 0 ? nullptr : slots + (s % 2) * slot_elems;
    if (s >= 1 && !wait_block(pad + w.kv_arrival(s), lanes, false, L, w.kv_arrival(s))) return;
    if (s < n - 1) {
      // the right neighbour has read what we put into this slot two steps ago
      if (s >= 2 && !wait_block(pad + w.ack(s - 1), lanes, false, L, w.ack(s - 1))) return;
      put_kv_share<T, D>(sh, k, v, slot, slots_right + ((s + 1) % 2) * slot_elems, lane, lanes);
      __syncthreads();
      if (threadIdx.x == 0 && pe != silent) {
        __threadfence();
        signal_op(symm_at<int>(a.pads, right) + w.kv_arrival(s + 1), 1);
      }
    }
    for (int it = lane; it < items; it += lanes)
      fwd_item<T, kC>(smem, sh, it, s, n, me, src, q, k, v, slot, symm_at<T>(a.out, pe),
                  symm_at<float>(a.lse, pe), symm_at<float>(a.state, pe));
    if (s >= 1) signal_op_block(symm_at<int>(a.pads, left) + w.ack(s), 1);  // slot read
  }
  ring_finish(pad, w, false, L);
}

// ---------------------------------------------------------------------------
// backward across ranks
// ---------------------------------------------------------------------------

struct BwdTables {
  PeerTable q, k, v, lse, dout, delta, dq, dk, dv;  // each rank's shard
  PeerTable slots;                                   // [2][K, V][BHkv][S][D] in T
  PeerTable gslots;                                  // [2][dk, dv][BHkv][S][D] f32
  PeerTable dq_acc;                                  // [BH][S][D] f32
  PeerTable pads;
};

constexpr size_t kBwdRanksSmem = kDqSmem > kDkvSmem ? kDqSmem : kDkvSmem;

// dq of one (query head, query tile) against the block of group index src.
template <typename T, int kC>
__device__ void dq_item(float* smem, const RingShape& sh, int it, int s, int n, int me, int src,
                        const BwdTables& a, int pe, const T* slot, float scale) {
  constexpr int D = kC * kD;
  float* qt_s = smem;
  float* dot_s = qt_s + kD * kLdT;
  float* k_s = dot_s + kD * kLdT;
  float* v_s = k_s + kT * kLdD;
  float* ds_s = v_s + kT * kLdD;
  float* lse_s = ds_s + kT * kLdT;
  float* dl_s = lse_s + kT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bh = it % sh.BH;
  const int q0 = (it / sh.BH) * kT;
  const bool last = s == n - 1;
  const int t_end = kv_tiles_end(sh, me, src, n, q0);
  if (t_end == 0 && !last) return;

  float* acc_g = symm_at<float>(a.dq_acc, pe) + (size_t)bh * sh.S * D;
  float acc[kC][4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const bool carried = s > 0 && row < sh.S;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[c][i][j] =
            carried ? __ldcg(acc_g + (size_t)row * D + c * kD + 64 * (j / 4) + 4 * tx + j % 4)
                    : 0.f;
  }

  if (t_end > 0) {
    const int kvh = ring_kv_head(sh, bh);
    const T* k_own = symm_at<const T>(a.k, pe);
    const T* v_own = symm_at<const T>(a.v, pe);
    const T* kp = slot ? slot + (size_t)kvh * sh.S * D : k_own + kv_at(sh, kvh);
    const T* vp = slot ? slot + ((size_t)sh.BHkv + kvh) * sh.S * D : v_own + kv_at(sh, kvh);
    const T* qp = symm_at<const T>(a.q, pe) + q_at(sh, bh);
    const T* dop = symm_at<const T>(a.dout, pe) + q_at(sh, bh);
    const int q_off = tile_off(sh, me, n, q0);
    const float* lse = symm_at<const float>(a.lse, pe) + r_at(sh, bh);
    const float* delta = symm_at<const float>(a.delta, pe) + r_at(sh, bh);
    __syncthreads();  // the last item's reads of shared memory are done
    if (kC == 1) {
      load_cols(qt_s, qp, q0, sh.S);
      load_cols(dot_s, dop, q0, sh.S);
    }
    for (int r = threadIdx.x; r < kT; r += kThreads) {
      const bool in = q0 + r < sh.S;
      lse_s[r] = in ? lse[q0 + r] * kLog2e : 0.f;
      dl_s[r] = in ? __ldcg(delta + q0 + r) : 0.f;
    }
    for (int t = 0; t < t_end; ++t) {
      const int k0 = t * kT;
      float st[4][4], dpt[4][4];
      zero(st);
      zero(dpt);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        __syncthreads();
        if (kC > 1) {
          load_cols<false, D>(qt_s, qp + c * kD, q0, sh.S);
          load_cols<false, D>(dot_s, dop + c * kD, q0, sh.S);
        }
        load_rows<true, D>(k_s, kp + c * kD, k0, sh.S);
        load_rows<true, D>(v_s, vp + c * kD, k0, sh.S);
        __syncthreads();
        tile_mma<1>(st, k_s, kLdD, qt_s, kLdT, kD, ty, tx);
        tile_mma<1>(dpt, v_s, kLdD, dot_s, kLdT, kD, ty, tx);
      }
      dq_tile_ds<T, true>(st, dpt, lse_s, dl_s, ds_s, q0, k0, sh.S, sh.causal, ty, tx, q_off,
                    tile_off(sh, src, n, k0));
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (kC > 1) {
          __syncthreads();
          load_rows<true, D>(k_s, kp + c * kD, k0, sh.S);
        }
        __syncthreads();
        tile_mma<2>(acc[c], ds_s, kLdT, k_s, kLdD, kT, ty, tx);
      }
    }
  }

  T* dq = symm_at<T>(a.dq, pe) + q_at(sh, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sh.S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * kD + 64 * (j / 4) + 4 * tx + j % 4;
        if (last)
          dq[(size_t)row * D + col] = from_float<T>(acc[c][i][j] * scale);
        else
          acc_g[(size_t)row * D + col] = acc[c][i][j];
      }
  }
}

// dk || dv of one (kv head, key tile) of the block of group index src: the
// accumulator that arrived with the block (zeros at step 0) plus the local
// queries' share, stored into the right neighbour's accumulator slot `dst`.
template <typename T, int kC>
__device__ void dkv_item(float* smem, const RingShape& sh, int it, int s, int n, int me, int src,
                         const BwdTables& a, int pe, const T* slot, const float* g_in,
                         float* g_out) {
  constexpr int D = kC * kD;
  float* kt_s = smem;
  float* vt_s = kt_s + kD * kLdT;
  float* q_s = vt_s + kD * kLdT;
  float* do_s = q_s + kT * kLdD;
  float* pt_s = do_s + kT * kLdD;
  float* dst_s = pt_s + kT * kLdT;
  float* lse_s = dst_s + kT * kLdT;
  float* dl_s = lse_s + kT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int bhkv = it % sh.BHkv;
  const int k0 = (it / sh.BHkv) * kT;
  const int nt = (sh.S + kT - 1) / kT;
  const size_t plane = (size_t)sh.BHkv * sh.S * D;
  const size_t tile = (size_t)bhkv * sh.S * D;

  float dk_acc[kC][4][8], dv_acc[kC][4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    const bool carried = g_in != nullptr && row < sh.S;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t at = tile + (size_t)row * D + c * kD + 64 * (j / 4) + 4 * tx + j % 4;
        dk_acc[c][i][j] = carried ? __ldcg(g_in + at) : 0.f;
        dv_acc[c][i][j] = carried ? __ldcg(g_in + plane + at) : 0.f;
      }
  }

  const int qt_begin = q_tiles_begin(sh, me, src, n, k0);
  if (qt_begin < nt) {
    const T* kp = slot ? slot + tile : symm_at<const T>(a.k, pe) + kv_at(sh, bhkv);
    const T* vp = slot ? slot + plane + tile : symm_at<const T>(a.v, pe) + kv_at(sh, bhkv);
    const int kv_off = tile_off(sh, src, n, k0);
    const int G = sh.Hq / sh.Hkv;
    __syncthreads();  // the last item's reads of shared memory are done
    if (kC == 1) {
      load_cols<true>(kt_s, kp, k0, sh.S);
      load_cols<true>(vt_s, vp, k0, sh.S);
    }
    for (int g = 0; g < G; ++g) {
      const int bh = (bhkv / sh.Hkv) * sh.Hq + (bhkv % sh.Hkv) * G + g;
      const T* q = symm_at<const T>(a.q, pe) + q_at(sh, bh);
      const T* dout = symm_at<const T>(a.dout, pe) + q_at(sh, bh);
      const float* lse = symm_at<const float>(a.lse, pe) + r_at(sh, bh);
      const float* delta = symm_at<const float>(a.delta, pe) + r_at(sh, bh);
      for (int qt = qt_begin; qt < nt; ++qt) {
        const int q0 = qt * kT;
        float sc[4][4], dp[4][4];
        zero(sc);
        zero(dp);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          __syncthreads();
          if (kC > 1) {
            load_cols<true, D>(kt_s, kp + c * kD, k0, sh.S);
            load_cols<true, D>(vt_s, vp + c * kD, k0, sh.S);
          }
          load_rows<false, D>(q_s, q + c * kD, q0, sh.S);
          load_rows<false, D>(do_s, dout + c * kD, q0, sh.S);
          if (c == 0)
            for (int r = threadIdx.x; r < kT; r += kThreads) {
              const bool in = q0 + r < sh.S;
              lse_s[r] = in ? lse[q0 + r] * kLog2e : 0.f;
              dl_s[r] = in ? __ldcg(delta + q0 + r) : 0.f;
            }
          __syncthreads();
          tile_mma<1>(sc, q_s, kLdD, kt_s, kLdT, kD, ty, tx);
          tile_mma<1>(dp, do_s, kLdD, vt_s, kLdT, kD, ty, tx);
        }
        dkv_tile_p_ds<T, true>(sc, dp, lse_s, dl_s, pt_s, dst_s, q0, k0, sh.S, sh.causal, ty, tx,
                         tile_off(sh, me, n, q0), kv_off);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          if (kC > 1) {
            __syncthreads();
            load_rows<false, D>(q_s, q + c * kD, q0, sh.S);
            load_rows<false, D>(do_s, dout + c * kD, q0, sh.S);
          }
          __syncthreads();
          tile_mma<2>(dv_acc[c], pt_s, kLdT, do_s, kLdD, kT, ty, tx);
          tile_mma<2>(dk_acc[c], dst_s, kLdT, q_s, kLdD, kT, ty, tx);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= sh.S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t at = tile + (size_t)row * D + c * kD + 64 * (j / 4) + 4 * tx + j % 4;
        g_out[at] = dk_acc[c][i][j];
        g_out[plane + at] = dv_acc[c][i][j];
      }
  }
}

// grid (lanes, N), as the forward. delta is ready before the launch.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, 1)
    ring_bwd_ranks_kernel(BwdTables a, RingShape sh, float scale, Group G, int silent,
                          Launch L) {
  constexpr int D = kC * kD;
  extern __shared__ __align__(16) float smem[];
  const int pe = my_pe();
  const int me = group_me(G);
  const int n = group_n(G);
  const int lanes = gridDim.x;
  const int lane = blockIdx.x;
  const RingWords w{lanes, n};
  if (!barrier_group_block(a.pads, lane, G, L)) return;
  const int right = group_pe(G, me + 1);
  const int left = group_pe(G, me - 1);
  int* pad = symm_at<int>(a.pads, pe);
  int* pad_right = symm_at<int>(a.pads, right);
  const T* k = symm_at<const T>(a.k, pe);
  const T* v = symm_at<const T>(a.v, pe);
  T* slots = symm_at<T>(a.slots, pe);
  T* slots_right = symm_at<T>(a.slots, right);
  float* gslots = symm_at<float>(a.gslots, pe);
  float* gslots_right = symm_at<float>(a.gslots, right);
  const size_t slot_elems = 2 * (size_t)sh.BHkv * sh.S * D;
  const int nt = (sh.S + kT - 1) / kT;
  const int q_items = sh.BH * nt;
  const int kv_items = sh.BHkv * nt;

  for (int s = 0; s < n; ++s) {
    const int src = (me - s + n) % n;
    const T* slot = s == 0 ? nullptr : slots + (s % 2) * slot_elems;
    const float* g_in = s == 0 ? nullptr : gslots + (s % 2) * slot_elems;
    if (s >= 1 && (!wait_block(pad + w.kv_arrival(s), lanes, false, L, w.kv_arrival(s)) ||
                   !wait_block(pad + w.g_arrival(s), lanes, false, L, w.g_arrival(s))))
      return;
    // the right neighbour has read both slots we fill this step
    if (s >= 2 && !wait_block(pad + w.ack(s - 1), lanes, false, L, w.ack(s - 1))) return;
    if (s < n - 1) {
      put_kv_share<T, D>(sh, k, v, slot, slots_right + ((s + 1) % 2) * slot_elems, lane, lanes);
      __syncthreads();
      if (threadIdx.x == 0 && pe != silent) {
        __threadfence();
        signal_op(pad_right + w.kv_arrival(s + 1), 1);
      }
    }
    for (int it = lane; it < q_items; it += lanes)
      dq_item<T, kC>(smem, sh, it, s, n, me, src, a, pe, slot, scale);
    float* g_out = gslots_right + ((s + 1) % 2) * slot_elems;
    for (int it = lane; it < kv_items; it += lanes)
      dkv_item<T, kC>(smem, sh, it, s, n, me, src, a, pe, slot, g_in, g_out);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (pe != silent) signal_op(pad_right + w.g_arrival(s + 1), 1);
      if (s >= 1) signal_op(symm_at<int>(a.pads, left) + w.ack(s), 1);  // slots read
    }
  }

  // our own block's dk || dv, home after a full circle: scale, cast, split
  if (!wait_block(pad + w.g_arrival(n), lanes, false, L, w.g_arrival(n))) return;
  const float* g_home = gslots + (n % 2) * slot_elems;
  const size_t plane = (size_t)sh.BHkv * sh.S * D;
  T* dk = symm_at<T>(a.dk, pe);
  T* dv = symm_at<T>(a.dv, pe);
  for (int it = lane; it < kv_items; it += lanes) {
    const int bhkv = it % sh.BHkv;
    const int k0 = (it / sh.BHkv) * kT;
    const int rows = min(kT, sh.S - k0);
    const size_t tile = (size_t)bhkv * sh.S * D + (size_t)k0 * D;
    const size_t at = kv_at(sh, bhkv) + (size_t)k0 * D;
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      dk[at + e] = from_float<T>(__ldcg(g_home + tile + e) * kLn2);
      dv[at + e] = from_float<T>(__ldcg(g_home + plane + tile + e));
    }
  }
  ring_finish(pad, w, true, L);
}

template <typename K>
int ring_lanes(K kernel, size_t smem, int lanes, int n, int* out) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  *out = resident_lanes(kernel, kThreads, lanes, n, smem);
  return *out < 1 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

// shape: BH BHkv Hq Hkv S c zigzag causal; strides: q_b q_h kv_b kv_h r_b r_h
RingShape ring_shape(const int* shape, const long long* strides) {
  return RingShape{shape[0], shape[1], shape[2], shape[3], shape[4], shape[5], shape[6],
                   shape[7], strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5]};
}

bool bad_ring(const RingShape& sh, int n, const void* group) {
  if (n < 2 || n > kMaxPes || group == nullptr) return true;
  const Group& G = *static_cast<const Group*>(group);
  return G.n < 2 || G.n > n || sh.BH <= 0 || sh.BHkv <= 0 || sh.Hkv <= 0 ||
         sh.Hq % sh.Hkv != 0 || sh.S <= 0 || (sh.zigzag && (sh.c * 2 != sh.S || sh.c % kT));
}

template <typename T, int kC>
int launch_fwd_ranks(const void* const* tables, int n, const int* shape,
                     const long long* strides, int lanes, const void* group, int silent,
                     void* claim, void* report, unsigned long long budget_ns, void* stream) {
  const RingShape sh = ring_shape(shape, strides);
  if (bad_ring(sh, n, group)) return (int)cudaErrorInvalidValue;
  const void* const* t = tables;
  const FwdTables a{make_table(t, n), make_table(t + n, n), make_table(t + 2 * n, n),
                    make_table(t + 3 * n, n), make_table(t + 4 * n, n),
                    make_table(t + 5 * n, n), make_table(t + 6 * n, n),
                    make_table(t + 7 * n, n)};
  int rc = ring_lanes(ring_fwd_ranks_kernel<T, kC>, kFwdSmem, lanes, n, &lanes);
  if (rc) return rc;
  return launch_cooperative(ring_fwd_ranks_kernel<T, kC>, dim3(lanes, n), dim3(kThreads), kFwdSmem,
                            stream, a, sh, *static_cast<const Group*>(group), silent,
                            make_launch(claim, report, budget_ns, kRingAttnFwd));
}

template <typename T, int kC>
int launch_bwd_ranks(const void* const* tables, int n, const int* shape,
                     const long long* strides, float scale, const void* o, const void* dout,
                     void* delta, int rows, int lanes, const void* group, int silent,
                     void* claim, void* report, unsigned long long budget_ns, void* stream) {
  const RingShape sh = ring_shape(shape, strides);
  if (bad_ring(sh, n, group) || rows <= 0) return (int)cudaErrorInvalidValue;
  const void* const* t = tables;
  BwdTables a;
  PeerTable* dst[] = {&a.q, &a.k, &a.v, &a.lse, &a.dout, &a.delta, &a.dq, &a.dk,
                      &a.dv, &a.slots, &a.gslots, &a.dq_acc, &a.pads};
  for (int i = 0; i < 13; ++i) *dst[i] = make_table(t + i * n, n);
  int rc = launch_delta<T>(o, dout, delta, rows, kC * kD, (cudaStream_t)stream);
  if (rc) return rc;
  rc = ring_lanes(ring_bwd_ranks_kernel<T, kC>, kBwdRanksSmem, lanes, n, &lanes);
  if (rc) return rc;
  return launch_cooperative(ring_bwd_ranks_kernel<T, kC>, dim3(lanes, n), dim3(kThreads),
                            kBwdRanksSmem, stream, a, sh, scale,
                            *static_cast<const Group*>(group), silent,
                            make_launch(claim, report, budget_ns, kRingAttnBwd));
}

}  // namespace

// The head dims instantiated, D = kC * 128 for kC = 1 and 2; any other D
// is refused with cudaErrorInvalidValue (the wrapper raises first).
#define TDT_RING_BY_D(D, CALL)                             \
  ((D) == kD ? CALL(1) : (D) == 2 * kD ? CALL(2) : (int)cudaErrorInvalidValue)

extern "C" {

int tdt_ring_attention_fwd_f32(const void* q, const void* k, const void* v, void* out,
                               void* lse, int B, int Hq, int Hkv, int S, int D, int causal,
                               void* stream) {
#define CALL(C) launch_fwd<float, C>(q, k, v, out, lse, B, Hq, Hkv, S, causal, stream)
  return TDT_RING_BY_D(D, CALL);
#undef CALL
}

int tdt_ring_attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                void* lse, int B, int Hq, int Hkv, int S, int D,
                                int causal, void* stream) {
#define CALL(C) launch_fwd<__nv_bfloat16, C>(q, k, v, out, lse, B, Hq, Hkv, S, causal, stream)
  return TDT_RING_BY_D(D, CALL);
#undef CALL
}

int tdt_ring_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                               const void* lse, const void* dout, void* delta, void* dq,
                               void* dk, void* dv, int B, int Hq, int Hkv, int S, int D,
                               int causal, float scale, void* stream) {
#define CALL(C)                                                                             \
  launch_bwd<float, C>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Hq, Hkv, S, causal, scale, \
                       stream)
  return TDT_RING_BY_D(D, CALL);
#undef CALL
}

int tdt_ring_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                const void* lse, const void* dout, void* delta, void* dq,
                                void* dk, void* dv, int B, int Hq, int Hkv, int S, int D,
                                int causal, float scale, void* stream) {
#define CALL(C)                                                                            \
  launch_bwd<__nv_bfloat16, C>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Hq, Hkv, S,       \
                               causal, scale, stream)
  return TDT_RING_BY_D(D, CALL);
#undef CALL
}

// Across ranks. tables: n pointers each of q k v out lse slots state pads
// (forward) or q k v lse do delta dq dk dv slots gslots dq_acc pads
// (backward), each rank's shard or buffer; shape and strides as
// RingShape's; D the head dim; group: the rings over the n ranks of the
// mesh (shmem.cuh Group). The backward first launches the delta pass over
// `rows` rows of the global o and do. `lanes` is cut to what the card keeps
// resident.
int tdt_ring_fwd_ranks_f32(const void* const* tables, int n, const int* shape,
                           const long long* strides, int D, int lanes, const void* group,
                           int silent, void* claim, void* report,
                           unsigned long long budget_ns, void* stream) {
#define CALL(C)                                                                           \
  launch_fwd_ranks<float, C>(tables, n, shape, strides, lanes, group, silent, claim, report, \
                             budget_ns, stream)
  return TDT_RING_BY_D(D, CALL);
#undef CALL
}

int tdt_ring_fwd_ranks_bf16(const void* const* tables, int n, const int* shape,
                            const long long* strides, int D, int lanes, const void* group,
                            int silent, void* claim, void* report,
                            unsigned long long budget_ns, void* stream) {
#define CALL(C)                                                                          \
  launch_fwd_ranks<__nv_bfloat16, C>(tables, n, shape, strides, lanes, group, silent, claim, \
                                     report, budget_ns, stream)
  return TDT_RING_BY_D(D, CALL);
#undef CALL
}

int tdt_ring_bwd_ranks_f32(const void* const* tables, int n, const int* shape,
                           const long long* strides, int D, float scale, const void* o,
                           const void* dout, void* delta, int rows, int lanes,
                           const void* group, int silent, void* claim, void* report,
                           unsigned long long budget_ns, void* stream) {
#define CALL(C)                                                                          \
  launch_bwd_ranks<float, C>(tables, n, shape, strides, scale, o, dout, delta, rows, lanes, \
                             group, silent, claim, report, budget_ns, stream)
  return TDT_RING_BY_D(D, CALL);
#undef CALL
}

int tdt_ring_bwd_ranks_bf16(const void* const* tables, int n, const int* shape,
                            const long long* strides, int D, float scale, const void* o,
                            const void* dout, void* delta, int rows, int lanes,
                            const void* group, int silent, void* claim, void* report,
                            unsigned long long budget_ns, void* stream) {
#define CALL(C)                                                                             \
  launch_bwd_ranks<__nv_bfloat16, C>(tables, n, shape, strides, scale, o, dout, delta, rows, \
                                     lanes, group, silent, claim, report, budget_ns, stream)
  return TDT_RING_BY_D(D, CALL);
#undef CALL
}

const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
