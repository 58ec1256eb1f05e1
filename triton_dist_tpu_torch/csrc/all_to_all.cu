// The EP all-to-all of the MoE serving path in its one-rank form, written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel B21, all_to_all_push (the pallas_call at
// triton_dist_tpu/ops/all_to_all.py:347, _a2a_kernel :132), as the MoE block
// runs it on one rank. There, the dispatch gathers each (token, k) pair's row
// into its slot of the send buffer, the kernel copies slot `me` into the
// receive buffer (the whole wire when n = 1), and the expert side gathers the
// slots into expert-aligned rows; the combine pushes the processed slots back
// the same way and sums each token's k rows, weighted, in f32. On one card
// the copies carry nothing, so each direction is one kernel that moves the
// rows straight to where the next step reads them:
//   ep_dispatch: x[r] = tokens[src[r] / topk] if valid[r], else 0
//                (x [P, H]: expert-aligned rows; src indexes the T * topk
//                 (token, k) pairs)
//   ep_combine:  out[t] = cast(sum over j = 0..topk-1, in order, of
//                              w[t, j] * y[pos[t * topk + j]])
//                (y [P, D], pos [T * topk], w [T, topk] f32, out [T, D]; the
//                 products and sums in f32 without fused multiply-adds, as
//                 the JAX combine's gather_back computes them; a pair whose
//                 pos lies outside [0, P) adds 0)
//
// What bounds it on this card: bytes. Each kernel reads and writes a few
// rows of d_model values, at most a few MB per MoE layer, with one multiply
// and add per value read: far under the ~295 operations per byte where the
// H100 stops being memory bound, and at decode it is over before the launch
// overhead is.
//
// What the design does about it: one block per output row, its 128 threads
// moving 16-byte vectors, so each value is read and written once in whole
// sectors; the row index and its validity are read once per block. An index
// outside its range is treated as a row routed nowhere, so no value outside
// the inputs is ever read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

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

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
