// Paged GQA decode attention, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel triton_dist_tpu/ops/flash_decode.py::gqa_decode_paged
// (_decode_paged_kernel + _online_softmax_body). It computes the same thing:
// for every row b, an online-softmax walk over the live pages
// block_table[b, s], s < min(ceil(kv_len[b] / page_size), pages_per_seq),
// with (m, l, acc) kept in f32, p cast to v's type before the P.V product,
// out = acc / (l > 0 ? l : 1) in q's type and lse = m + log(l) (or NEG_INF
// for an empty row). Entries of the block table past the live pages are never
// read; live entries are clamped into [0, P - 1] as the TPU index map does.
//
// What bounds it on this card: the bytes of the live K and V pages, each read
// once per (row, kv head) -- 2 * n_live * page_size * D * sizeof(T) per
// block. The arithmetic is about 4 * G flops per K/V element, far below the
// ~295 flops per byte where the H100 stops being memory bound.
//
// What the design does about it: one block per (row, kv head) reads its G
// query heads once and streams each live page of K and V exactly once,
// through shared memory with 16-byte vector loads, so the G query heads of a
// group share every byte read. There is no split over the sequence, so a
// row's result never depends on the rest of the batch. Loads are not yet
// overlapped with compute (no cp.async / TMA pipeline) and the products run
// on the CUDA cores, not the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOutPerThread = 8;  // G * D <= kThreads * kMaxOutPerThread
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

// Grid (Hkv, B); one block of kThreads threads per (kv head, row).
// q [B, Hq, D]; k_pages / v_pages [P, Hkv, ps, D]; block_table [B, pps] i32;
// kv_len [B] i32 -> out [B, Hq, D] (q's type), lse [B, Hq] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ block_table,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        float* __restrict__ lse, int Hq, int Hkv, int D,
                        int ps, int P, int pps, float sm_scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                  // [ps, D]
  T* v_s = k_s + ps * D;                                // [ps, D]
  float* q_s = reinterpret_cast<float*>(v_s + ps * D);  // [G, D]
  float* p_s = q_s + G * D;                             // [G, ps]
  float* m_s = p_s + G * ps;                            // [G] running max
  float* l_s = m_s + G;                                 // [G] running sum
  float* a_s = l_s + G;                                 // [G] this page's alpha

  const size_t head0 = (size_t)b * Hq + (size_t)h * G;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_float(q[head0 * D + i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxOutPerThread];
#pragma unroll
  for (int k = 0; k < kMaxOutPerThread; ++k) acc[k] = 0.f;

  const int len = kv_len[b];
  int n_live = len > 0 ? (len + ps - 1) / ps : 0;
  if (n_live > pps) n_live = pps;
  const size_t page_elems = (size_t)ps * D;
  const size_t page_stride = (size_t)Hkv * page_elems;
  const int vecs = (int)(page_elems * sizeof(T) / sizeof(uint4));
  __syncthreads();

  for (int s = 0; s < n_live; ++s) {
    int page = block_table[(size_t)b * pps + s];
    page = min(max(page, 0), P - 1);
    const size_t off = (size_t)page * page_stride + (size_t)h * page_elems;
    const uint4* k_src = reinterpret_cast<const uint4*>(k_pages + off);
    const uint4* v_src = reinterpret_cast<const uint4*>(v_pages + off);
    uint4* k_dst = reinterpret_cast<uint4*>(k_s);
    uint4* v_dst = reinterpret_cast<uint4*>(v_s);
    for (int i = tid; i < vecs; i += kThreads) {
      k_dst[i] = k_src[i];
      v_dst[i] = v_src[i];
    }
    __syncthreads();

    // scores: one warp per (query head, key) dot product, f32 accumulation
    for (int pair = warp; pair < G * ps; pair += kWarps) {
      const int g = pair / ps;
      const int j = pair % ps;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32)
        dot += q_s[g * D + d] * to_float(k_s[j * D + d]);
      dot = warp_sum(dot);
      if (lane == 0)
        p_s[g * ps + j] = (s * ps + j < len) ? dot * sm_scale : kNegInf;
    }
    __syncthreads();

    // online-softmax update: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < ps; j += 32) mx = fmaxf(mx, p_s[g * ps + j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < ps; j += 32) {
        const float p = expf(p_s[g * ps + j] - m_new);
        sum += p;
        // the P.V operand is p in v's type, as the TPU kernel casts it
        p_s[g * ps + j] = to_float(from_float<T>(p));
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

    // acc = acc * alpha + P.V, each thread owning fixed (head, d) outputs
#pragma unroll
    for (int k = 0; k < kMaxOutPerThread; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < G * D) {
        const int g = idx / D;
        const int d = idx % D;
        float pv = 0.f;
        for (int j = 0; j < ps; ++j) pv += p_s[g * ps + j] * to_float(v_s[j * D + d]);
        acc[k] = acc[k] * a_s[g] + pv;
      }
    }
    __syncthreads();  // the next page overwrites k_s, v_s and p_s
  }

#pragma unroll
  for (int k = 0; k < kMaxOutPerThread; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < G * D) {
      const float l = l_s[idx / D];
      out[head0 * D + idx] = from_float<T>(acc[k] / (l > 0.f ? l : 1.f));
    }
  }
  if (tid < G) {
    const float l = l_s[tid];
    lse[head0 + tid] = l > 0.f ? m_s[tid] + logf(l) : kNegInf;
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_table, const void* kv_len, void* out, void* lse,
           int B, int Hq, int Hkv, int D, int ps, int P, int pps,
           float sm_scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (Hq / Hkv) * D > kThreads * kMaxOutPerThread ||
      (ps * D * sizeof(T)) % sizeof(uint4) != 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const size_t smem = 2 * (size_t)ps * D * sizeof(T) +
                      ((size_t)G * D + (size_t)G * ps + 3 * (size_t)G) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_paged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_paged_kernel<T><<<dim3(Hkv, B), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(kv_len), static_cast<T*>(out), static_cast<float*>(lse),
      Hq, Hkv, D, ps, P, pps, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tdt_gqa_decode_paged_f32(const void* q, const void* k_pages, const void* v_pages,
                             const void* block_table, const void* kv_len, void* out,
                             void* lse, int B, int Hq, int Hkv, int D, int ps, int P,
                             int pps, float sm_scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_table, kv_len, out, lse, B, Hq, Hkv,
                       D, ps, P, pps, sm_scale, stream);
}

int tdt_gqa_decode_paged_bf16(const void* q, const void* k_pages, const void* v_pages,
                              const void* block_table, const void* kv_len, void* out,
                              void* lse, int B, int Hq, int Hkv, int D, int ps, int P,
                              int pps, float sm_scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_table, kv_len, out, lse, B,
                               Hq, Hkv, D, ps, P, pps, sm_scale, stream);
}

const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
