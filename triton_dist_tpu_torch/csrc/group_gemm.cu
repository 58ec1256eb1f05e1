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
//
// The options of the deployed EP block (the reference's row_scale, packed
// gate|up stream, block_k and prefetch_depth; group_gemm_tile.cuh says what
// each does in the tile): tdt_grouped_gemm_ex takes them all, with rows of
// bf16, fp8 e4m3fn or int8 (one byte a value: the expert edge of a
// quantised EP wire, whose rows the kernel reads at half the bytes and
// converts exactly to bf16 for the tensor cores), an f32 scale a row folded
// into the sums, one packed weight stream [E, K, 2N], a K split, and the
// ring depth. The packed stream, every depth and every K split give the
// bits of the two-stream, full-K, 4-deep kernel: the staged tiles and the
// order of the sums are the same.

#include "group_gemm_tile.cuh"

namespace {

using namespace tdt_group;

// What a launch computes, beside its pointers and shapes.
struct Opts {
  const float* scale;  // [P] f32 or null
  int ldw;             // weight row stride: N, or 2N packed
  int pack_bn;         // 0: two streams (gated) or one (plain)
  int block_k;         // 0: all of K in one pass
  // whether a launch takes any option: if not, the tile's option-free
  // instantiation runs (kOpts false)
  bool any() const { return scale || pack_bn || block_k; }
};

// Grid (P / TM, N / kTN); TM divides block_m: one tile of
// group_gemm_tile.cuh a block, the expert of its row block read first.
template <int TM, bool kGated, typename OutT, int kX, int kSt, bool kOpts>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_bf16_kernel(const void* __restrict__ x, const bf16* __restrict__ wg,
                             const bf16* __restrict__ wu, const int* __restrict__ be,
                             const int* __restrict__ nb, OutT* __restrict__ out, int P,
                             int K, int N, int block_m, int E, Opts o) {
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * kTN;
  int e;
  if (!block_expert(be, nb, row0, block_m, P / block_m, E, &e)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t off = (size_t)e * K * o.ldw;
  grouped_tile_bf16<TM, kGated, OutT, false, kX, kSt, kOpts>(
      x, K, wg + off, (kGated && !o.pack_bn) ? wu + off : nullptr, o.ldw, out, N, K, N, row0,
      col0, smem, o.scale, o.pack_bn, o.block_k);
}

// f32 in full precision on the CUDA cores. Grid (P / 16, N / kTN).
template <bool kGated, bool kOpts>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                            const float* __restrict__ wu, const int* __restrict__ be,
                            const int* __restrict__ nb, float* __restrict__ out, int P,
                            int K, int N, int block_m, int E, Opts o) {
  const int row0 = blockIdx.x * kF32Rows;
  const int col0 = blockIdx.y * kTN;
  int e;
  if (!block_expert(be, nb, row0, block_m, P / block_m, E, &e)) return;
  __shared__ __align__(16) float smem[f32_smem_floats<kGated>()];
  const size_t off = (size_t)e * K * o.ldw;
  grouped_tile_f32<kGated, false, false, kOpts>(x, K, wg + off, (kGated && !o.pack_bn) ? wu + off : nullptr, o.ldw,
                           out, N, K, N, row0, col0, smem, o.scale, o.pack_bn);
}

bool shapes_ok(int P, int K, int N, int block_m, int E, int tm, const Opts& o) {
  const int bk = o.block_k > 0 ? o.block_k : K;
  return P > 0 && K > 0 && N > 0 && E > 0 && block_m > 0 && block_m % tm == 0 &&
         P % block_m == 0 && K % kTK == 0 && N % kTN == 0 && N / kTN <= 65535 &&
         bk % kTK == 0 && K % bk == 0 && (o.pack_bn == 0 || (o.pack_bn % 8 == 0 &&
                                                             N % o.pack_bn == 0));
}

template <int TM, bool kGated, typename OutT, int kX, int kSt, bool kOpts>
int launch_bf16(const void* x, const void* wg, const void* wu, const void* be,
                const void* nb, void* out, int P, int K, int N, int block_m, int E,
                const Opts& o, void* stream) {
  const size_t smem = bf16_smem_bytes<TM, kGated, kX, kSt>();
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_bf16_kernel<TM, kGated, OutT, kX, kSt, kOpts>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  grouped_gemm_bf16_kernel<TM, kGated, OutT, kX, kSt, kOpts>
      <<<dim3(P / TM, N / kTN), kThreads, smem, (cudaStream_t)stream>>>(
          x, static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
          static_cast<const int*>(be), static_cast<const int*>(nb), static_cast<OutT*>(out), P,
          K, N, block_m, E, o);
  return (int)cudaGetLastError();
}

// 64-row tiles where block_m allows them (prefill chunks), else 16 (decode).
template <bool kGated, typename OutT, int kX, int kSt, bool kOpts>
int dispatch_rows(const void* x, const void* wg, const void* wu, const void* be,
                  const void* nb, void* out, int P, int K, int N, int block_m, int E,
                  const Opts& o, void* stream) {
  if (shapes_ok(P, K, N, block_m, E, 64, o))
    return launch_bf16<64, kGated, OutT, kX, kSt, kOpts>(x, wg, wu, be, nb, out, P, K, N, block_m, E,
                                                  o, stream);
  if (shapes_ok(P, K, N, block_m, E, 16, o))
    return launch_bf16<16, kGated, OutT, kX, kSt, kOpts>(x, wg, wu, be, nb, out, P, K, N, block_m, E,
                                                  o, stream);
  return (int)cudaErrorInvalidValue;
}

// The ring depth: 2, 3 or 4 stages (the gated kernel's prefetch_depth; the
// plain kernel keeps 4). bf16 rows at the full depth without an option run
// the option-free tile; every other form the tile with its options.
template <bool kGated, typename OutT, int kX>
int dispatch_depth(const void* x, const void* wg, const void* wu, const void* be,
                   const void* nb, void* out, int P, int K, int N, int block_m, int E,
                   const Opts& o, int depth, void* stream) {
  if constexpr (kGated) {
    if (depth == 2)
      return dispatch_rows<kGated, OutT, kX, 2, true>(x, wg, wu, be, nb, out, P, K, N, block_m,
                                                      E, o, stream);
    if (depth == 3)
      return dispatch_rows<kGated, OutT, kX, 3, true>(x, wg, wu, be, nb, out, P, K, N, block_m,
                                                      E, o, stream);
  }
  if (depth != kStages) return (int)cudaErrorInvalidValue;
  if constexpr (kX == kXBf16) {
    if (!o.any())
      return dispatch_rows<kGated, OutT, kX, kStages, false>(x, wg, wu, be, nb, out, P, K, N,
                                                             block_m, E, o, stream);
  }
  return dispatch_rows<kGated, OutT, kX, kStages, true>(x, wg, wu, be, nb, out, P, K, N,
                                                        block_m, E, o, stream);
}

template <bool kGated>
int dispatch_bf16(const void* x, const void* wg, const void* wu, const void* be,
                  const void* nb, void* out, int P, int K, int N, int block_m, int E,
                  const Opts& o, int depth, int x_kind, int out_f32, void* stream) {
  if (out_f32) {  // bf16 rows into an f32 out (no rounding to bf16): B20's slot
    if (kGated || x_kind != kXBf16) return (int)cudaErrorInvalidValue;
    return dispatch_depth<false, float, kXBf16>(x, wg, wu, be, nb, out, P, K, N, block_m, E, o,
                                                depth, stream);
  }
  switch (x_kind) {
    case kXBf16:
      return dispatch_depth<kGated, bf16, kXBf16>(x, wg, wu, be, nb, out, P, K, N, block_m, E,
                                                  o, depth, stream);
    case kXFp8:
      return dispatch_depth<kGated, bf16, kXFp8>(x, wg, wu, be, nb, out, P, K, N, block_m, E, o,
                                                 depth, stream);
    case kXInt8:
      return dispatch_depth<kGated, bf16, kXInt8>(x, wg, wu, be, nb, out, P, K, N, block_m, E,
                                                  o, depth, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kGated, bool kOpts>
int launch_f32(const void* x, const void* wg, const void* wu, const void* be, const void* nb,
               void* out, int P, int K, int N, int block_m, int E, const Opts& o,
               void* stream) {
  grouped_gemm_f32_kernel<kGated, kOpts>
      <<<dim3(P / kF32Rows, N / kTN), kThreads, 0, (cudaStream_t)stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(wg),
          static_cast<const float*>(wu), static_cast<const int*>(be),
          static_cast<const int*>(nb), static_cast<float*>(out), P, K, N, block_m, E, o);
  return (int)cudaGetLastError();
}

template <bool kGated>
int dispatch_f32(const void* x, const void* wg, const void* wu, const void* be,
                 const void* nb, void* out, int P, int K, int N, int block_m, int E,
                 const Opts& o, void* stream) {
  if (!shapes_ok(P, K, N, block_m, E, kF32Rows, o)) return (int)cudaErrorInvalidValue;
  return o.any() ? launch_f32<kGated, true>(x, wg, wu, be, nb, out, P, K, N, block_m, E, o, stream)
                 : launch_f32<kGated, false>(x, wg, wu, be, nb, out, P, K, N, block_m, E, o,
                                             stream);
}

constexpr int kXF32 = 3;  // the f32 tile's rows (and weights)

int grouped(const void* x, const void* wg, const void* wu, const void* be, const void* nb,
            const void* scale, void* out, int P, int K, int N, int block_m, int E,
            int pack_bn, int block_k, int depth, int gated, int x_kind, int out_f32,
            void* stream) {
  const Opts o{static_cast<const float*>(scale), pack_bn ? 2 * N : N, pack_bn, block_k};
  if ((pack_bn && !gated) || (!gated && depth != kStages) || depth < 2 || depth > kStages)
    return (int)cudaErrorInvalidValue;
  if (x_kind == kXF32) {
    if (out_f32 != 1 || depth != kStages) return (int)cudaErrorInvalidValue;
    return gated ? dispatch_f32<true>(x, wg, wu, be, nb, out, P, K, N, block_m, E, o, stream)
                 : dispatch_f32<false>(x, wg, wu, be, nb, out, P, K, N, block_m, E, o, stream);
  }
  return gated ? dispatch_bf16<true>(x, wg, wu, be, nb, out, P, K, N, block_m, E, o, depth,
                                     x_kind, out_f32, stream)
               : dispatch_bf16<false>(x, wg, wu, be, nb, out, P, K, N, block_m, E, o, depth,
                                      x_kind, out_f32, stream);
}

}  // namespace

extern "C" {

// The grouped GEMM with every option. x [P, K] of x_kind (0 bf16, 1 fp8
// e4m3fn, 2 int8: bf16 weights; 3 f32: f32 weights); wg [E, K, N] (packed:
// [E, K, 2N], pack_bn columns a group, wu null), wu [E, K, N] for the gated
// kernel; be [P / block_m] i32; nb [1] i32 or null (no bound); scale [P] f32
// or null; out [P, N] bf16, or f32 with out_f32 (f32 rows, or bf16 rows of
// the plain kernel); block_k 0 or a multiple of 32 dividing K; depth the
// ring's stages (2-4, the gated bf16 kernel; 4 otherwise). Returns the
// launch's cudaError_t.
int tdt_grouped_gemm_ex(const void* x, const void* wg, const void* wu, const void* be,
                        const void* nb, const void* scale, void* out, int P, int K, int N,
                        int block_m, int E, int pack_bn, int block_k, int depth, int gated,
                        int x_kind, int out_f32, void* stream) {
  return grouped(x, wg, wu, be, nb, scale, out, P, K, N, block_m, E, pack_bn, block_k, depth,
                 gated, x_kind, out_f32, stream);
}

const char* tdt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
