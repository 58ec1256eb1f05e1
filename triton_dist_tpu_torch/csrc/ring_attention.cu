// Ring attention on one rank -- causal GQA flash attention, forward and
// backward -- written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels of triton_dist_tpu/ops/ring_attention.py:
//   ring_attention_fwd (_ring_fwd_kernel, the update of _attn_step_pipeline)
//   ring_attention_bwd (_ring_bwd_kernel: the delta pass,
//                       _bwd_dq_pipeline, _bwd_dkv_pipeline, _p_ds_core)
// at a ring of one rank, where they carry all of their arithmetic and none of
// their transport. Layouts: q [B*Hq, S, D] prescaled by sm_scale*log2(e) (the
// wrapper rounds it to the input type, as the JAX wrapper does), k/v
// [B*Hkv, S, D]; query head h of batch b reads kv head b*Hkv + h/G. The
// softmax runs in base 2; lse is written in the natural-log domain:
// lse = (m + log2 l) * ln2, or -1e30 for a row with no valid key.
//
// Rounding points kept from the TPU kernels: p is cast to v's type before
// P.V; in the backward p = exp2(s - lse*log2 e), dS = p*(dp - delta), and dS
// and p are cast to the input type before their products. Sums are f32.
//
// What bounds it on this card: operations. At the training shape (S = 4096,
// Hq = 32, D = 128, causal) the forward does 2*S^2*D*Hq ~ 1.4e11 operations
// against ~84 MB of traffic, and the backward about 2.5 times the forward's
// operations: far above the ~295 operations per byte where the H100 stops
// being memory bound.
//
// What the design does about it, for now: tiles of 64 query rows by 64 keys
// staged through shared memory as f32, register tiles of 4x4 (scores) and
// 4x8 (outputs) per thread, causal walks that stop at the diagonal, and the
// heaviest causal tiles launched first. The products run on the CUDA cores;
// wgmma, TMA and warp specialisation are later work. No atomics: each output
// tile is summed by one block in a fixed order, so a launch is bitwise
// reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;         // head dim
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

// One 16-byte vector of T as floats.
__device__ __forceinline__ void load_vec(float* out, const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}
__device__ __forceinline__ void load_vec(float* out, const __nv_bfloat16* p) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Rows [r0, r0 + kT) of a [S, kD] matrix as f32, row-major into dst[kT][kLdD];
// rows at or past S read as zeros.
template <typename T>
__device__ void load_rows(float* dst, const T* src, int r0, int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVecs = kD / V;
  for (int idx = threadIdx.x; idx < kT * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * V;
    float vals[V];
    if (r0 + r < S) {
      load_vec(vals, src + (size_t)(r0 + r) * kD + c);
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
template <typename T>
__device__ void load_cols(float* dst, const T* src, int r0, int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kVecs = kD / V;
  for (int idx = threadIdx.x; idx < kT * kVecs; idx += kThreads) {
    const int r = idx % kT;
    const int c = (idx / kT) * V;
    float vals[V];
    if (r0 + r < S) {
      load_vec(vals, src + (size_t)(r0 + r) * kD + c);
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

__device__ __forceinline__ bool keep(int qpos, int kpos, int S, int causal) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos);
}

__device__ __forceinline__ int kv_head(int bh, int Hq, int Hkv) {
  return (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
}

// ---------------------------------------------------------------------------
// forward: grid (B*Hq, n_tiles), one block per (query head, query tile)
// ---------------------------------------------------------------------------

constexpr size_t kFwdSmem =
    sizeof(float) * ((size_t)kT * kLdD * 2 + (size_t)kD * kLdT + (size_t)kT * kLdT);

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ring_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, int Hq, int Hkv, int S, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                // [kT][kLdD] prescaled q rows
  float* v_s = q_s + kT * kLdD;     // [kT][kLdD] v rows
  float* kt_s = v_s + kT * kLdD;    // [kD][kLdT] k, transposed
  float* p_s = kt_s + kD * kLdT;    // [kT][kLdT] p in v's type

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest causal rows first
  const int q0 = qt * kT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t head = (size_t)bh * S * kD;
  const size_t kv = (size_t)kv_head(bh, Hq, Hkv) * S * kD;

  load_rows(q_s, q + head, q0, S);
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero(acc);

  const int n_kv = causal ? qt + 1 : (int)gridDim.y;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kT;
    __syncthreads();  // the last tile's reads of kt_s, v_s, p_s are done
    load_cols(kt_s, k + kv, k0, S);
    load_rows(v_s, v + kv, k0, S);
    __syncthreads();

    float s[4][4];
    zero(s);
    tile_mma<1>(s, q_s, kLdD, kt_s, kLdT, kD, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      bool kp[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kp[j] = keep(qpos, k0 + 4 * tx + j, S, causal);
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
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_mma<2>(acc, p_s, kLdT, v_s, kLdD, kT, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * (j / 4) + 4 * tx + j % 4;
      out[head + (size_t)row * kD + col] = from_float<T>(acc[i][j] * inv);
    }
    if (tx == 0)
      lse[(size_t)bh * S + row] = l[i] > 0.f ? kLn2 * (m[i] + log2f(l[i])) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(do * o) in f32, one warp per row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < kD; d += 32)
    acc += to_float(dout[(size_t)row * kD + d]) * to_float(o[(size_t)row * kD + d]);
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ring_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lse,
                   const T* __restrict__ dout, const float* __restrict__ delta,
                   T* __restrict__ dq, int Hq, int Hkv, int S, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt_s = smem;                 // [kD][kLdT] prescaled q, transposed
  float* dot_s = qt_s + kD * kLdT;    // [kD][kLdT] do, transposed
  float* k_s = dot_s + kD * kLdT;     // [kT][kLdD] k rows
  float* v_s = k_s + kT * kLdD;       // [kT][kLdD] v rows
  float* ds_s = v_s + kT * kLdD;      // [kT q][kLdT] dS in k's type
  float* lse_s = ds_s + kT * kLdT;    // [kT] lse * log2 e
  float* dl_s = lse_s + kT;           // [kT] delta

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t head = (size_t)bh * S * kD;
  const size_t kv = (size_t)kv_head(bh, Hq, Hkv) * S * kD;

  load_cols(qt_s, q + head, q0, S);
  load_cols(dot_s, dout + head, q0, S);
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse[(size_t)bh * S + q0 + r] * kLog2e : 0.f;
    dl_s[r] = in ? delta[(size_t)bh * S + q0 + r] : 0.f;
  }
  float acc[4][8];
  zero(acc);

  const int n_kv = causal ? qt + 1 : (int)gridDim.y;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kT;
    __syncthreads();
    load_rows(k_s, k + kv, k0, S);
    load_rows(v_s, v + kv, k0, S);
    __syncthreads();

    float st[4][4], dpt[4][4];  // rows: keys 4ty + i; columns: queries 4tx + j
    zero(st);
    zero(dpt);
    tile_mma<1>(st, k_s, kLdD, qt_s, kLdT, kD, ty, tx);
    tile_mma<1>(dpt, v_s, kLdD, dot_s, kLdT, kD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = 4 * tx + j;
        const float p = keep(q0 + qc, k0 + 4 * ty + i, S, causal)
                            ? exp2f(st[i][j] - lse_s[qc])
                            : 0.f;
        ds_s[qc * kLdT + 4 * ty + i] = round_to<T>(p * (dpt[i][j] - dl_s[qc]));
      }
    }
    __syncthreads();
    tile_mma<2>(acc, ds_s, kLdT, k_s, kLdD, kT, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * (j / 4) + 4 * tx + j % 4;
      dq[head + (size_t)row * kD + col] = from_float<T>(acc[i][j] * scale);
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ring_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ lse,
                    const T* __restrict__ dout, const float* __restrict__ delta,
                    T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int S,
                    int causal) {
  extern __shared__ __align__(16) float smem[];
  float* kt_s = smem;                 // [kD][kLdT] k, transposed
  float* vt_s = kt_s + kD * kLdT;     // [kD][kLdT] v, transposed
  float* q_s = vt_s + kD * kLdT;      // [kT][kLdD] prescaled q rows
  float* do_s = q_s + kT * kLdD;      // [kT][kLdD] do rows
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
  const size_t kv = (size_t)bhkv * S * kD;

  load_cols(kt_s, k + kv, k0, S);
  load_cols(vt_s, v + kv, k0, S);
  float dk_acc[4][8], dv_acc[4][8];
  zero(dk_acc);
  zero(dv_acc);

  for (int g = 0; g < G; ++g) {
    const int bh = (bhkv / Hkv) * Hq + (bhkv % Hkv) * G + g;
    const size_t head = (size_t)bh * S * kD;
    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();
      load_rows(q_s, q + head, q0, S);
      load_rows(do_s, dout + head, q0, S);
      for (int r = threadIdx.x; r < kT; r += kThreads) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? lse[(size_t)bh * S + q0 + r] * kLog2e : 0.f;
        dl_s[r] = in ? delta[(size_t)bh * S + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];  // rows: queries 4ty + i; columns: keys 4tx + j
      zero(s);
      zero(dp);
      tile_mma<1>(s, q_s, kLdD, kt_s, kLdT, kD, ty, tx);
      tile_mma<1>(dp, do_s, kLdD, vt_s, kLdT, kD, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kc = 4 * tx + j;
          const float p = keep(q0 + qr, k0 + kc, S, causal)
                              ? exp2f(s[i][j] - lse_s[qr])
                              : 0.f;
          pt_s[kc * kLdT + qr] = round_to<T>(p);
          dst_s[kc * kLdT + qr] = round_to<T>(p * (dp[i][j] - dl_s[qr]));
        }
      }
      __syncthreads();
      tile_mma<2>(dv_acc, pt_s, kLdT, do_s, kLdD, kT, ty, tx);
      tile_mma<2>(dk_acc, dst_s, kLdT, q_s, kLdD, kT, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * (j / 4) + 4 * tx + j % 4;
      dk[kv + (size_t)row * kD + col] = from_float<T>(dk_acc[i][j] * kLn2);
      dv[kv + (size_t)row * kD + col] = from_float<T>(dv_acc[i][j]);
    }
  }
}

bool bad_shape(int B, int Hq, int Hkv, int S, int D) {
  return B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D != kD;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B,
               int Hq, int Hkv, int S, int D, int causal, void* stream) {
  if (bad_shape(B, Hq, Hkv, S, D)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ring_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (S + kT - 1) / kT;
  ring_fwd_kernel<T><<<dim3(B * Hq, n_tiles), kThreads, kFwdSmem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), Hq, Hkv, S, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* delta, void* dq, void* dk,
               void* dv, int B, int Hq, int Hkv, int S, int D, int causal, float scale,
               void* stream) {
  if (bad_shape(B, Hq, Hkv, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (S + kT - 1) / kT;
  const int rows = B * Hq * S;
  const int warps = kThreads / 32;
  ring_delta_kernel<T><<<(rows + warps - 1) / warps, kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta),
      rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(ring_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDqSmem);
  if (e != cudaSuccess) return (int)e;
  ring_dq_kernel<T><<<dim3(B * Hq, n_tiles), kThreads, kDqSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<T*>(dq), Hq, Hkv, S, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(ring_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDkvSmem);
  if (e != cudaSuccess) return (int)e;
  ring_dkv_kernel<T><<<dim3(B * Hkv, n_tiles), kThreads, kDkvSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv,
      S, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tdt_ring_attention_fwd_f32(const void* q, const void* k, const void* v, void* out,
                               void* lse, int B, int Hq, int Hkv, int S, int D, int causal,
                               void* stream) {
  return launch_fwd<float>(q, k, v, out, lse, B, Hq, Hkv, S, D, causal, stream);
}

int tdt_ring_attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                void* lse, int B, int Hq, int Hkv, int S, int D,
                                int causal, void* stream) {
  return launch_fwd<__nv_bfloat16>(q, k, v, out, lse, B, Hq, Hkv, S, D, causal, stream);
}

int tdt_ring_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                               const void* lse, const void* dout, void* delta, void* dq,
                               void* dk, void* dv, int B, int Hq, int Hkv, int S, int D,
                               int causal, float scale, void* stream) {
  return launch_bwd<float>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Hq, Hkv, S, D,
                           causal, scale, stream);
}

int tdt_ring_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                const void* lse, const void* dout, void* delta, void* dq,
                                void* dk, void* dv, int B, int Hq, int Hkv, int S, int D,
                                int causal, float scale, void* stream) {
  return launch_bwd<__nv_bfloat16>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Hq, Hkv, S,
                                   D, causal, scale, stream);
}

const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
