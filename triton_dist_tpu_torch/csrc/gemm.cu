// The dense GEMM and the GEMM-RS slot reduction, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel B2, triton_dist_tpu/ops/gemm.py: emit_gemm (:110),
// the pipelined MXU GEMM that matmul runs (the pallas_call at :190) and that
// the overlap kernels run per segment: AG-GEMM (B15, _ag_gemm_kernel,
// ops/allgather_gemm.py:171) and GEMM-RS (B16, _gemm_rs_kernel,
// ops/gemm_reduce_scatter.py:112). Also the second half of B16,
// emit_slot_reduction (ops/gemm_reduce_scatter.py:89): the f32 sum of the n
// partial slots of the symmetric workspace, cast to the output type.
//
//   gemm:        C[M, N] = A[M, K] @ B[K, N], every product summed over the
//                whole K in f32 and cast once (bf16 inputs give a bf16 or f32
//                C; f32 inputs an f32 C). B is row-major [K, N], or [N, K]
//                read as its transpose (b_trans), so the backward's dc @ b^T
//                needs no copy.
//   slot reduce: out[i] = sum_s ws[s][i] over s = 0 .. n-1 in that order, in
//                f32, cast once.
//
// What bounds it on this card: at the prefill shapes of Llama-3-8B (4096
// token rows against 4096 x 6144 ... 4096 x 28672 weights) the operations,
// about 2 * 4096 per weight byte read, far over the ~295 where the H100
// stops being memory bound. The slot reduction is bytes: n f32 slots read,
// one output written.
//
// What the design does about it: one block of eight warps per (128- or
// 64-row, 128-column) output tile walks K in stages of 32, staging the A and
// B tiles through shared memory with a 4-stage ring of cp.async copies, and
// multiplies on the tensor cores (mma.sync m16n8k16, fragments by ldmatrix,
// f32 accumulators); each warp owns a (TM / 2) x 32 sub-tile. Row tiles run
// fastest in the grid, so the blocks in flight share a few column tiles of
// B and all of A: B is read from device memory about once, A from L2. f32
// inputs run on the CUDA cores in full f32 (fused multiply-adds, a 128 x 128
// tile per block, 8 x 8 outputs a thread). Ragged M, N and K tails are
// masked by bounds (zeros fill the staged tiles past the edges; a chunk that
// is not 16-byte aligned is staged element by element). There is no split-K
// and no atomic: every output element sums its products in one fixed order
// whatever the tile, so a launch is bitwise repeatable and a row's bits do
// not depend on the tile height. The tile body and the slot sum live in
// gemm_tile.cuh, shared with the overlap kernels across ranks (tp_overlap.cu),
// which run the same tile on strided blocks in a persistent loop. wgmma and
// TMA are later work.

#include "gemm_tile.cuh"

namespace {

using namespace tdt_gemm;

// bf16 on the tensor cores: one tile of gemm_tile.cuh a block, grid
// (ceil(M / TM), ceil(N / kTN)) with TM = 32 * MT, contiguous A, B and C.
template <int MT, bool kBT, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    tdt_gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                         OutT* __restrict__ C, int M, int N, int K, int ldb) {
  extern __shared__ __align__(16) unsigned char smem[];
  gemm_tile_bf16<MT, kBT, OutT>(A, K, B, ldb, C, N, M, N, K, blockIdx.x * 32 * MT,
                                blockIdx.y * kTN, smem);
}

// f32 in full precision on the CUDA cores: one 128 x 128 tile a block.
template <bool kBT>
__global__ void __launch_bounds__(kThreads)
    tdt_gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                        float* __restrict__ C, int M, int N, int K, int ldb) {
  __shared__ __align__(16) float smem[kF32SmemBytes / sizeof(float)];
  gemm_tile_f32<kBT>(A, K, B, ldb, C, N, M, N, K, blockIdx.x * kF32Tile,
                     blockIdx.y * kF32Tile, smem);
}

// out[i] = sum over s of ws[s * elems + i] over s = 0 .. n-1 in that
// order, in f32, cast once (slot_sum, gemm_tile.cuh). Four elements a
// thread (16-byte loads) when elems % 4 == 0, else one. Stores go element
// by element, so out needs no alignment.
template <typename OutT, int V>
__global__ void __launch_bounds__(kThreads)
    tdt_slot_reduce_kernel(const float* __restrict__ ws, OutT* __restrict__ out, int n,
                           long long elems) {
  const long long stride = (long long)gridDim.x * kThreads * V;
  for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * V; i < elems;
       i += stride)
    slot_sum<OutT, V>(ws, out, n, elems, i);
}

template <int MT, bool kBT, typename OutT>
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K, int ldb,
                void* stream) {
  constexpr int TM = 32 * MT;
  const size_t smem = bf16_smem_bytes<MT, kBT>();
  const cudaError_t err =
      cudaFuncSetAttribute(tdt_gemm_bf16_kernel<MT, kBT, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tdt_gemm_bf16_kernel<MT, kBT, OutT>
      <<<dim3((M + TM - 1) / TM, (N + kTN - 1) / kTN), kThreads, smem,
         (cudaStream_t)stream>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                 static_cast<OutT*>(c), M, N, K, ldb);
  return (int)cudaGetLastError();
}

template <bool kBT, typename OutT>
int dispatch_tile(const void* a, const void* b, void* c, int M, int N, int K, int ldb,
                  int tile_m, void* stream) {
  if (tile_m == 128) return launch_bf16<4, kBT, OutT>(a, b, c, M, N, K, ldb, stream);
  if (tile_m == 64) return launch_bf16<2, kBT, OutT>(a, b, c, M, N, K, ldb, stream);
  return (int)cudaErrorInvalidValue;
}

bool shapes_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && (N + kTN - 1) / kTN <= 65535;
}

}  // namespace

extern "C" {

// a [M, K] bf16; b [K, N] bf16 with leading dimension ldb >= N (a column
// block of a wider matrix, read in place), or [N, K] with ldb >= K when
// b_trans; c [M, N] contiguous, in f32 when out_f32, else bf16; tile_m 128
// or 64 (rows per block). Returns the launch's cudaError_t.
int tdt_gemm_bf16_ld(const void* a, const void* b, void* c, int M, int N, int K, int ldb,
                     int b_trans, int out_f32, int tile_m, void* stream) {
  if (!shapes_ok(M, N, K) || ldb < (b_trans ? K : N)) return (int)cudaErrorInvalidValue;
  if (b_trans)
    return out_f32 ? dispatch_tile<true, float>(a, b, c, M, N, K, ldb, tile_m, stream)
                   : dispatch_tile<true, bf16>(a, b, c, M, N, K, ldb, tile_m, stream);
  return out_f32 ? dispatch_tile<false, float>(a, b, c, M, N, K, ldb, tile_m, stream)
                 : dispatch_tile<false, bf16>(a, b, c, M, N, K, ldb, tile_m, stream);
}

// The same with b contiguous (ldb = N, or K when b_trans).
int tdt_gemm_bf16(const void* a, const void* b, void* c, int M, int N, int K, int b_trans,
                  int out_f32, int tile_m, void* stream) {
  return tdt_gemm_bf16_ld(a, b, c, M, N, K, b_trans ? K : N, b_trans, out_f32, tile_m, stream);
}

// The same for f32 a, b and c (tile 128 x 128).
int tdt_gemm_f32_ld(const void* a, const void* b, void* c, int M, int N, int K, int ldb,
                    int b_trans, void* stream) {
  if (!shapes_ok(M, N, K) || ldb < (b_trans ? K : N)) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kF32Tile - 1) / kF32Tile, (N + kF32Tile - 1) / kF32Tile);
  if (b_trans)
    tdt_gemm_f32_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), M,
        N, K, ldb);
  else
    tdt_gemm_f32_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), M,
        N, K, ldb);
  return (int)cudaGetLastError();
}

int tdt_gemm_f32(const void* a, const void* b, void* c, int M, int N, int K, int b_trans,
                 void* stream) {
  return tdt_gemm_f32_ld(a, b, c, M, N, K, b_trans ? K : N, b_trans, stream);
}

// ws [n, elems] f32, 16-byte aligned; out [elems] bf16 when out_bf16, else
// f32. Returns the launch's cudaError_t.
int tdt_slot_reduce(const void* ws, void* out, int n, long long elems, int out_bf16,
                    void* stream) {
  if (n <= 0 || elems <= 0 || reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  const bool vec = elems % 4 == 0;
  const long long per_block = (long long)kThreads * (vec ? 4 : 1);
  long long blocks = (elems + per_block - 1) / per_block;
  if (blocks > 132 * 16) blocks = 132 * 16;  // a few waves of the 132 SMs
  const float* w = static_cast<const float*>(ws);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16) {
    bf16* o = static_cast<bf16*>(out);
    if (vec)
      tdt_slot_reduce_kernel<bf16, 4><<<(int)blocks, kThreads, 0, s>>>(w, o, n, elems);
    else
      tdt_slot_reduce_kernel<bf16, 1><<<(int)blocks, kThreads, 0, s>>>(w, o, n, elems);
  } else {
    float* o = static_cast<float*>(out);
    if (vec)
      tdt_slot_reduce_kernel<float, 4><<<(int)blocks, kThreads, 0, s>>>(w, o, n, elems);
    else
      tdt_slot_reduce_kernel<float, 1><<<(int)blocks, kThreads, 0, s>>>(w, o, n, elems);
  }
  return (int)cudaGetLastError();
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
