// The per-tile device code of ring attention (B24, B25), shared by the
// one-rank kernels and the kernels across ranks of ring_attention.cu: tile
// loads into shared memory, the 64 x 64 score tile and the 64 x 128 output
// tile products, the online-softmax update of the forward, the recomputed
// p and dS of the backward, and the causal keep() mask.
//
// Head dims: a head of D = kC * kD columns is walked in kC chunks of kD =
// 128. Shared memory holds one chunk of a tile at a time (a 64-row f32 tile
// of D = 256 would not fit beside the others in the 227 KB of an SM): the
// score products sum the chunks' partial products in order, and each output
// chunk has its own register tile. At kC = 1 the kernels do what they did
// before, operation for operation.
//
// keep() takes a q offset and a kv offset: a tile's rows are local indices
// into a rank's block, and the mask compares global positions, local index
// plus the tile's offset (the reference's _tile_off). The shared functions
// take the offsets when instantiated with kGlobal; the one-rank kernels
// instantiate them without, and their mask is the one they always had. A zigzag block is two chunks with two offsets; a tile
// never straddles their seam (the wrapper checks that the tile height
// divides a chunk).
//
// kCg loads read through L2 (ld.global.cg): a tile that a peer rank put
// during the same launch is never read from a stale L1 line. The one-rank
// kernels read their inputs with plain loads, as they always have.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt_ring {

constexpr int kD = 128;         // head dim of one chunk
constexpr int kT = 64;          // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kLdD = kD + 4;    // row stride of a [rows][D] tile in shared memory
constexpr int kLdT = kT + 4;    // row stride of a [D][rows] or [rows][rows] tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// x rounded to T and back: the TPU kernels' `.astype(dtype)` before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// One 16-byte vector of T as floats (kCg: through L2).
template <bool kCg = false>
__device__ __forceinline__ void load_vec(float* out, const float* p) {
  const float4 t = kCg ? __ldcg(reinterpret_cast<const float4*>(p))
                       : *reinterpret_cast<const float4*>(p);
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}
template <bool kCg = false>
__device__ __forceinline__ void load_vec(float* out, const __nv_bfloat16* p) {
  const uint4 t = kCg ? __ldcg(reinterpret_cast<const uint4*>(p))
                      : *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Rows [r0, r0 + kT) of a [S, kD] matrix (rows kLd elements apart: a chunk
// of a wider head) as f32, row-major into dst[kT][kLdD]; rows at or past S
// read as zeros.
template <bool kCg = false, int kLd = kD, typename T>
__device__ void load_rows(float* dst, const T* src, int r0, int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVecs = kD / V;
  for (int idx = threadIdx.x; idx < kT * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * V;
    float vals[V];
    if (r0 + r < S) {
      load_vec<kCg>(vals, src + (size_t)(r0 + r) * kLd + c);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * kLdD + c + e] = vals[e];
  }
}

// The same rows transposed, into dst[kD][kLdT]: dst[c][r] = src[r0 + r][c].
// Neighbouring threads take neighbouring rows, so the stores hit distinct banks.
template <bool kCg = false, int kLd = kD, typename T>
__device__ void load_cols(float* dst, const T* src, int r0, int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVecs = kD / V;
  for (int idx = threadIdx.x; idx < kT * kVecs; idx += kThreads) {
    const int r = idx % kT;
    const int c = (idx / kT) * V;
    float vals[V];
    if (r0 + r < S) {
      load_vec<kCg>(vals, src + (size_t)(r0 + r) * kLd + c);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[(c + e) * kLdT + r] = vals[e];
  }
}

// c[i][4h + j] += sum_k a[4ty + i][k] * b[k][64h + 4tx + j] for k < K, with a
// row-major (stride lda) and b k-major (stride ldb), both in shared memory.
// NC = 1 gives a thread 4 x 4 outputs of a 64 x 64 tile, NC = 2 4 x 8 outputs
// of a 64 x 128 tile. Every read is a 16-byte vector; the two rows of threads
// in a warp read rows 4 apart, 16 banks apart for lda = 132 or 68.
template <int NC>
__device__ __forceinline__ void tile_mma(float (&c)[4][4 * NC], const float* a, int lda,
                                         const float* b, int ldb, int K, int ty,
                                         int tx) {
  for (int k = 0; k < K; k += 4) {
    float av[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec(av[i], a + (4 * ty + i) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < NC; ++h) {
        float bv[4];
        load_vec(bv, b + (k + kk) * ldb + 64 * h + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][4 * h + j] += av[i][kk] * bv[j];
      }
    }
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&c)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) c[i][j] = 0.f;
}

// max / sum over the 16 threads of one row of the thread grid (half a warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whether (query row qi, key row ki) counts: both inside the block of S
// rows and, when causal, the key not past the query.
__device__ __forceinline__ bool keep(int qi, int ki, int S, int causal) {
  return qi < S && ki < S && (!causal || ki <= qi);
}
// The same for local indices of a rank's block whose tiles start at global
// positions q_off + q0 and kv_off + k0: the causal test compares the key's
// global position kv_off + ki with the query's q_off + qi.
__device__ __forceinline__ bool keep(int qi, int ki, int S, int causal, int q_off,
                                     int kv_off) {
  return qi < S && ki < S && (!causal || kv_off + ki <= q_off + qi);
}

__device__ __forceinline__ int kv_head(int bh, int Hq, int Hkv) {
  return (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
}

// The online-softmax update of one score tile s (query rows q0 + 4ty + i,
// keys k0 + 4tx + j): masked scores to -inf, the running max m and sum l
// rescaled, p = exp2(s - m) rounded to T into p_s[row][key], every chunk of
// acc rescaled. The caller then adds p_s . v to acc.
template <typename T, bool kGlobal = false, int kC>
__device__ __forceinline__ void softmax_update(float (&s)[4][4], float (&m)[4], float (&l)[4],
                                               float (&acc)[kC][4][8], float* p_s, int q0, int k0,
                                               int S, int causal, int ty, int tx,
                                               int q_off = 0, int kv_off = 0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    bool kp[4];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kp[j] = kGlobal ? keep(qpos, k0 + 4 * tx + j, S, causal, q_off, kv_off)
                      : keep(qpos, k0 + 4 * tx + j, S, causal);
      if (!kp[j]) s[i][j] = kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
    const float m_new = fmaxf(m[i], row_max(mx));
    const float alpha = exp2f(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = kp[j] ? exp2f(s[i][j] - m_new) : 0.f;
      sum += p;
      p_s[(4 * ty + i) * kLdT + 4 * tx + j] = round_to<T>(p);
    }
    l[i] = l[i] * alpha + row_sum(sum);
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[c][i][j] *= alpha;
  }
}

// dS of the dq pass, transposed tiles (rows: keys k0 + 4ty + i; columns:
// queries q0 + 4tx + j): p = exp2(s - lse*log2 e), dS = p * (dp - delta),
// rounded to T into ds_s[query][key].
template <typename T, bool kGlobal = false>
__device__ __forceinline__ void dq_tile_ds(const float (&st)[4][4], const float (&dpt)[4][4],
                                           const float* lse_s, const float* dl_s, float* ds_s,
                                           int q0, int k0, int S, int causal, int ty, int tx,
                                           int q_off = 0, int kv_off = 0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = 4 * tx + j;
      const bool kp = kGlobal ? keep(q0 + qc, k0 + 4 * ty + i, S, causal, q_off, kv_off)
                              : keep(q0 + qc, k0 + 4 * ty + i, S, causal);
      const float p = kp ? exp2f(st[i][j] - lse_s[qc]) : 0.f;
      ds_s[qc * kLdT + 4 * ty + i] = round_to<T>(p * (dpt[i][j] - dl_s[qc]));
    }
  }
}

// p and dS of the dk || dv pass (rows: queries q0 + 4ty + i; columns: keys
// k0 + 4tx + j), rounded to T into pt_s[key][query] and dst_s[key][query].
template <typename T, bool kGlobal = false>
__device__ __forceinline__ void dkv_tile_p_ds(const float (&s)[4][4], const float (&dp)[4][4],
                                              const float* lse_s, const float* dl_s, float* pt_s,
                                              float* dst_s, int q0, int k0, int S, int causal,
                                              int ty, int tx, int q_off = 0, int kv_off = 0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = 4 * tx + j;
      const bool kp = kGlobal ? keep(q0 + qr, k0 + kc, S, causal, q_off, kv_off)
                              : keep(q0 + qr, k0 + kc, S, causal);
      const float p = kp ? exp2f(s[i][j] - lse_s[qr]) : 0.f;
      pt_s[kc * kLdT + qr] = round_to<T>(p);
      dst_s[kc * kLdT + qr] = round_to<T>(p * (dp[i][j] - dl_s[qr]));
    }
  }
}

}  // namespace tdt_ring
