// Grouped GEMMs of the MoE FFN, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels of triton_dist_tpu/ops/group_gemm.py:
//   grouped_gemm        (B17: the pallas_call at :354, and at :391 through
//                        emit_grouped_gemm :182)
//   grouped_gemm_gated  (B18: the pallas_calls at :544 and :779)
// Rows are expert-aligned: row block i (block_m rows) belongs to expert
// be[i], and
//   grouped_gemm:        out[i] = x[i] @ w[be[i]]
//   grouped_gemm_gated:  out[i] = silu(x[i] @ wg[be[i]]) * (x[i] @ wu[be[i]])
// with x [P, K], w/wg/wu [E, K, N], out [P, N] in x's type (grouped_gemm
// also takes bf16 x and w into an f32 out: the f32 slot of moe_reduce_rs,
// B20, whose emit_grouped_gemm writes the f32 workspace). Products are
// summed in f32 and cast once; the gated kernel keeps both sums and applies
// silu(g) * u in f32 before its single store (the TPU's _gated_math), so no
// gate or up array reaches device memory. nb (device memory, optional)
// bounds the row blocks: a block at or past it returns before it reads
// be[i] or any weight, and its rows are left unwritten.
//
// What bounds it on this card: the bytes of the used experts' weights. At
// decode (16 rows of 8 slots x top-2) each used expert's K x N weights are
// read for 16 rows, about 8 operations per byte; at a 256-token prefill
// chunk (512 rows) about 64 rests on each expert: both well under the ~295
// operations per byte where the H100 stops being memory bound.
//
// What the design does about it: one block per (tile of TM aligned rows,
// 128 output columns; the tile of group_gemm_tile.cuh, which the MoE-TP
// kernels across ranks run too) walks K in stages of 32, staging the x tile and the
// weight tile(s) through shared memory with a ring of cp.async copies
// (4 stages in flight), so each weight byte is read from device memory once
// per row tile. Row tiles run fastest in the grid, so the row tiles of one
// expert read the same weight tile at about the same time (the second from
// L2). bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulators);
// f32 runs on the CUDA cores in full f32 (fused multiply-adds). Every output
// element sums its K products in the same order whatever TM, block_m and
// the neighbouring rows are, so a row's bits do not depend on them, and a
// launch is bitwise repeatable. wgmma, TMA and a persistent schedule are
// later work.

#include "group_gemm_tile.cuh"

namespace {

using namespace tdt_group;

// Grid (P / TM, N / kTN); TM divides block_m: one tile of
// group_gemm_tile.cuh a block, the expert of its row block read first.
template <int TM, bool kGated, typename OutT>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                             const bf16* __restrict__ wu, const int* __restrict__ be,
                             const int* __restrict__ nb, OutT* __restrict__ out, int P,
                             int K, int N, int block_m, int E) {
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * kTN;
  int e;
  if (!block_expert(be, nb, row0, block_m, P / block_m, E, &e)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t off = (size_t)e * K * N;
  grouped_tile_bf16<TM, kGated, OutT>(x, K, wg + off, kGated ? wu + off : nullptr, N, out, N, K,
                                      N, row0, col0, smem);
}

// f32 in full precision on the CUDA cores. Grid (P / 16, N / kTN).
template <bool kGated>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                            const float* __restrict__ wu, const int* __restrict__ be,
                            const int* __restrict__ nb, float* __restrict__ out, int P,
                            int K, int N, int block_m, int E) {
  const int row0 = blockIdx.x * kF32Rows;
  const int col0 = blockIdx.y * kTN;
  int e;
  if (!block_expert(be, nb, row0, block_m, P / block_m, E, &e)) return;
  __shared__ __align__(16) float smem[f32_smem_floats<kGated>()];
  const size_t off = (size_t)e * K * N;
  grouped_tile_f32<kGated>(x, K, wg + off, kGated ? wu + off : nullptr, N, out, N, K, N, row0,
                           col0, smem);
}

bool shapes_ok(int P, int K, int N, int block_m, int E, int tm) {
  return P > 0 && K > 0 && N > 0 && E > 0 && block_m > 0 && block_m % tm == 0 &&
         P % block_m == 0 && K % kTK == 0 && N % kTN == 0 && N / kTN <= 65535;
}

template <int TM, bool kGated, typename OutT>
int launch_bf16(const void* x, const void* wg, const void* wu, const void* be,
                const void* nb, void* out, int P, int K, int N, int block_m, int E,
                void* stream) {
  const size_t smem = bf16_smem_bytes<TM, kGated>();
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_bf16_kernel<TM, kGated, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  grouped_gemm_bf16_kernel<TM, kGated, OutT>
      <<<dim3(P / TM, N / kTN), kThreads, smem, (cudaStream_t)stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
          static_cast<const bf16*>(wu), static_cast<const int*>(be),
          static_cast<const int*>(nb), static_cast<OutT*>(out), P, K, N, block_m, E);
  return (int)cudaGetLastError();
}

// 64-row tiles where block_m allows them (prefill chunks), else 16 (decode).
template <bool kGated, typename OutT = bf16>
int dispatch_bf16(const void* x, const void* wg, const void* wu, const void* be,
                  const void* nb, void* out, int P, int K, int N, int block_m, int E,
                  void* stream) {
  if (shapes_ok(P, K, N, block_m, E, 64))
    return launch_bf16<64, kGated, OutT>(x, wg, wu, be, nb, out, P, K, N, block_m, E,
                                         stream);
  if (shapes_ok(P, K, N, block_m, E, 16))
    return launch_bf16<16, kGated, OutT>(x, wg, wu, be, nb, out, P, K, N, block_m, E,
                                         stream);
  return (int)cudaErrorInvalidValue;
}

template <bool kGated>
int dispatch_f32(const void* x, const void* wg, const void* wu, const void* be,
                 const void* nb, void* out, int P, int K, int N, int block_m, int E,
                 void* stream) {
  if (!shapes_ok(P, K, N, block_m, E, kF32Rows)) return (int)cudaErrorInvalidValue;
  grouped_gemm_f32_kernel<kGated><<<dim3(P / kF32Rows, N / kTN), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg),
      static_cast<const float*>(wu), static_cast<const int*>(be),
      static_cast<const int*>(nb), static_cast<float*>(out), P, K, N, block_m, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [P, K]; w [E, K, N]; be [P / block_m] i32; nb [1] i32 or null (no bound);
// out [P, N]. Returns the launch's cudaError_t.
int tdt_grouped_gemm_bf16(const void* x, const void* w, const void* be, const void* nb,
                          void* out, int P, int K, int N, int block_m, int E,
                          void* stream) {
  return dispatch_bf16<false>(x, w, nullptr, be, nb, out, P, K, N, block_m, E, stream);
}

// bf16 x and w into an f32 out (no rounding to bf16): the f32 slot of B20.
int tdt_grouped_gemm_bf16_f32(const void* x, const void* w, const void* be, const void* nb,
                              void* out, int P, int K, int N, int block_m, int E,
                              void* stream) {
  return dispatch_bf16<false, float>(x, w, nullptr, be, nb, out, P, K, N, block_m, E,
                                     stream);
}

int tdt_grouped_gemm_f32(const void* x, const void* w, const void* be, const void* nb,
                         void* out, int P, int K, int N, int block_m, int E,
                         void* stream) {
  return dispatch_f32<false>(x, w, nullptr, be, nb, out, P, K, N, block_m, E, stream);
}

// The same with wg, wu [E, K, N]: out = silu(x @ wg) * (x @ wu).
int tdt_grouped_gemm_gated_bf16(const void* x, const void* wg, const void* wu,
                                const void* be, const void* nb, void* out, int P, int K,
                                int N, int block_m, int E, void* stream) {
  return dispatch_bf16<true>(x, wg, wu, be, nb, out, P, K, N, block_m, E, stream);
}

int tdt_grouped_gemm_gated_f32(const void* x, const void* wg, const void* wu,
                               const void* be, const void* nb, void* out, int P, int K,
                               int N, int block_m, int E, void* stream) {
  return dispatch_f32<true>(x, wg, wu, be, nb, out, P, K, N, block_m, E, stream);
}

const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
