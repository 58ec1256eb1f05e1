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
// not depend on the tile height. wgmma, TMA and a persistent schedule are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // eight warps: 2 (rows) x 4 (columns)
constexpr int kTN = 128;        // output columns per block
constexpr int kTK = 32;         // contraction depth per stage
constexpr int kStages = 4;      // cp.async ring depth
constexpr int kLdK = kTK + 8;   // bf16 row stride of a k-contiguous tile: 80 bytes
constexpr int kLdN = kTN + 8;   // bf16 row stride of an n-contiguous tile: 272 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the 8 elements (row, col .. col + 7) of a row-major [rows, cols] bf16
// matrix into dst: one cp.async when they all lie inside and are 16-byte
// aligned, else element by element with zeros past the edges.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int row, int rows, int col,
                                       int cols) {
  const bf16* p = src + (size_t)row * cols + col;
  if (row < rows && col + 8 <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    cp_async16(dst, p);
    return;
  }
  __align__(16) bf16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = (row < rows && col + i < cols) ? p[i] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// Fragments of a 16 x 16 tile: four 8 x 8 matrices, lane l naming a row of
// matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// Store C[r, c] = x and C[r, c + 1] = y, each only inside [M, N); as one
// vector when both lie inside and N is even (then the pair is aligned).
__device__ __forceinline__ void store_pair(bf16* C, int r, int c, int M, int N, float x,
                                           float y) {
  if (r >= M || c >= N) return;
  bf16* p = C + (size_t)r * N + c;
  if (c + 1 < N && N % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    put(p, x);
    if (c + 1 < N) put(p + 1, y);
  }
}

__device__ __forceinline__ void store_pair(float* C, int r, int c, int M, int N, float x,
                                           float y) {
  if (r >= M || c >= N) return;
  float* p = C + (size_t)r * N + c;
  if (c + 1 < N && N % 2 == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    *p = x;
    if (c + 1 < N) p[1] = y;
  }
}

// bf16 on the tensor cores. Grid (ceil(M / TM), ceil(N / kTN)) with TM =
// 32 * MT; warp w owns rows [(w / 4) * 16 MT, +16 MT) and columns
// [(w % 4) * 32, +32) of the block's tile: MT x 4 mma tiles of 16 x 8.
// A stage holds A as [TM][kLdK] and B as [kTK][kLdN] (row-major B) or
// [kTN][kLdK] (kBT: B given as [N, K]).
template <int MT, bool kBT, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    tdt_gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                         OutT* __restrict__ C, int M, int N, int K) {
  constexpr int TM = 32 * MT;
  constexpr int kAStage = TM * kLdK;
  constexpr int kBStage = kBT ? kTN * kLdK : kTK * kLdN;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * kTN;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);  // [kStages][kAStage]
  bf16* bs = as + kStages * kAStage;          // [kStages][kBStage]

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * kTK;
    bf16* ad = as + stage * kAStage;
    for (int c = threadIdx.x; c < TM * (kTK / 8); c += kThreads) {
      const int r = c / (kTK / 8), q = (c % (kTK / 8)) * 8;
      stage8(ad + r * kLdK + q, A, row0 + r, M, k0 + q, K);
    }
    bf16* bd = bs + stage * kBStage;
    if constexpr (kBT) {
      for (int c = threadIdx.x; c < kTN * (kTK / 8); c += kThreads) {
        const int r = c / (kTK / 8), q = (c % (kTK / 8)) * 8;
        stage8(bd + r * kLdK + q, B, col0 + r, N, k0 + q, K);
      }
    } else {
      for (int c = threadIdx.x; c < kTK * (kTN / 8); c += kThreads) {
        const int r = c / (kTN / 8), q = (c % (kTN / 8)) * 8;
        stage8(bd + r * kLdN + q, B, k0 + r, K, col0 + q, N);
      }
    }
  };

  const int KT = (K + kTK - 1) / kTK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // ldmatrix row addresses. A ([m][k]) and a [k][n] B: lane l names row
  // (l % 8) + 8 ((l / 8) % 2) and 8-column half l / 16 of a 16 x 16 tile, so
  // the four matrices are (r 0-7, c 0-7), (r 8-15, c 0-7), (r 0-7, c 8-15),
  // (r 8-15, c 8-15). An [n][k] B: row (l % 8) + 8 (l / 16) and half
  // (l / 8) % 2, so the matrices come in the order (n 0-7, k 0-7),
  // (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) that the transposed
  // load of a [k][n] B gives: b0, b1 of columns 0-7, then of columns 8-15.
  const int lrow = (lane % 8) + 8 * ((lane / 8) % 2);
  const int lcol = 8 * (lane / 16);
  const int nrow = (lane % 8) + 8 * (lane / 16);
  const int ncol = 8 * ((lane / 8) % 2);

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's, and stage kt - 1 is consumed
    {
      const int nk = kt + kStages - 1;
      if (nk < KT) load_stage(nk, nk % kStages);
      cp_async_commit();
    }
    const int stage = kt % kStages;
    const bf16* ast = as + stage * kAStage + (wm * MT * 16) * kLdK;
    const bf16* bst = bs + stage * kBStage;
#pragma unroll
    for (int ks = 0; ks < kTK / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], smem_addr(ast + (mt * 16 + lrow) * kLdK + ks * 16 + lcol));
      uint32_t b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if constexpr (kBT)
          ldmatrix_x4(b[np],
                      smem_addr(bst + (wn * 32 + np * 16 + nrow) * kLdK + ks * 16 + ncol));
        else
          ldmatrix_x4_trans(
              b[np], smem_addr(bst + (ks * 16 + lrow) * kLdN + wn * 32 + np * 16 + lcol));
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt / 2][2 * (nt % 2)], b[nt / 2][2 * (nt % 2) + 1]);
    }
  }
  cp_async_wait<0>();

  // c0, c1 at (row g, columns 2t, 2t + 1) of each 16 x 8 tile; c2, c3 at row g + 8
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = row0 + wm * MT * 16 + mt * 16 + g;
      const int c = col0 + wn * 32 + nt * 8 + 2 * t;
      store_pair(C, r, c, M, N, acc[mt][nt][0], acc[mt][nt][1]);
      store_pair(C, r + 8, c, M, N, acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// f32 in full precision on the CUDA cores. Grid (ceil(M / 128), ceil(N /
// 128)); thread (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty + i and
// 64 + 4 ty + i, columns 4 tx + j and 64 + 4 tx + j (i, j < 4). Both tiles
// are staged k-major ([k][m], [k][n]) so a thread reads its 8 + 8 operands
// as four 16-byte vectors.
constexpr int kF32Tile = 128;
constexpr int kF32K = 16;
constexpr int kF32Ld = kF32Tile + 4;

template <bool kBT>
__global__ void __launch_bounds__(kThreads)
    tdt_gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                        float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float as[kF32K][kF32Ld];
  __shared__ __align__(16) float bs[kF32K][kF32Ld];
  const int row0 = blockIdx.x * kF32Tile;
  const int col0 = blockIdx.y * kF32Tile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kF32K) {
#pragma unroll
    for (int i = 0; i < kF32Tile * kF32K / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      {
        const int m = idx / kF32K, k = idx % kF32K;
        const int gr = row0 + m, gk = k0 + k;
        as[k][m] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : 0.f;
      }
      if constexpr (kBT) {
        const int n = idx / kF32K, k = idx % kF32K;
        const int gn = col0 + n, gk = k0 + k;
        bs[k][n] = (gn < N && gk < K) ? B[(size_t)gn * K + gk] : 0.f;
      } else {
        const int k = idx / kF32Tile, n = idx % kF32Tile;
        const int gn = col0 + n, gk = k0 + k;
        bs[k][n] = (gn < N && gk < K) ? B[(size_t)gk * N + gn] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32K; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int c = col0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      store_pair(C, r, c, M, N, acc[i][j], acc[i][j + 1]);
    }
  }
}

// out[i] = sum over s of ws[s * elems + i], s in order, in f32, cast once.
// Four elements a thread (16-byte loads) when elems % 4 == 0, else one.
// Stores go element by element, so out needs no alignment.
template <typename OutT, int V>
__global__ void __launch_bounds__(kThreads)
    tdt_slot_reduce_kernel(const float* __restrict__ ws, OutT* __restrict__ out, int n,
                           long long elems) {
  const long long stride = (long long)gridDim.x * kThreads * V;
  for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * V; i < elems;
       i += stride) {
    float s[V];
    if constexpr (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(ws + i);
      s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
    } else {
      s[0] = ws[i];
    }
    for (int r = 1; r < n; ++r) {
      const float* p = ws + (size_t)r * elems + i;
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = __fadd_rn(s[j], p[j]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) put(out + i + j, s[j]);
  }
}

template <int MT, bool kBT, typename OutT>
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K, void* stream) {
  constexpr int TM = 32 * MT;
  const size_t smem =
      (size_t)kStages * (TM * kLdK + (kBT ? kTN * kLdK : kTK * kLdN)) * sizeof(bf16);
  const cudaError_t err =
      cudaFuncSetAttribute(tdt_gemm_bf16_kernel<MT, kBT, OutT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tdt_gemm_bf16_kernel<MT, kBT, OutT>
      <<<dim3((M + TM - 1) / TM, (N + kTN - 1) / kTN), kThreads, smem,
         (cudaStream_t)stream>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                 static_cast<OutT*>(c), M, N, K);
  return (int)cudaGetLastError();
}

template <bool kBT, typename OutT>
int dispatch_tile(const void* a, const void* b, void* c, int M, int N, int K, int tile_m,
                  void* stream) {
  if (tile_m == 128) return launch_bf16<4, kBT, OutT>(a, b, c, M, N, K, stream);
  if (tile_m == 64) return launch_bf16<2, kBT, OutT>(a, b, c, M, N, K, stream);
  return (int)cudaErrorInvalidValue;
}

bool shapes_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && (N + kTN - 1) / kTN <= 65535;
}

}  // namespace

extern "C" {

// a [M, K] bf16; b [K, N] bf16, or [N, K] when b_trans; c [M, N] in f32 when
// out_f32, else bf16; tile_m 128 or 64 (rows per block). All row-major and
// contiguous. Returns the launch's cudaError_t.
int tdt_gemm_bf16(const void* a, const void* b, void* c, int M, int N, int K, int b_trans,
                  int out_f32, int tile_m, void* stream) {
  if (!shapes_ok(M, N, K)) return (int)cudaErrorInvalidValue;
  if (b_trans)
    return out_f32 ? dispatch_tile<true, float>(a, b, c, M, N, K, tile_m, stream)
                   : dispatch_tile<true, bf16>(a, b, c, M, N, K, tile_m, stream);
  return out_f32 ? dispatch_tile<false, float>(a, b, c, M, N, K, tile_m, stream)
                 : dispatch_tile<false, bf16>(a, b, c, M, N, K, tile_m, stream);
}

// The same for f32 a, b and c (tile 128 x 128).
int tdt_gemm_f32(const void* a, const void* b, void* c, int M, int N, int K, int b_trans,
                 void* stream) {
  if (!shapes_ok(M, N, K)) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kF32Tile - 1) / kF32Tile, (N + kF32Tile - 1) / kF32Tile);
  if (b_trans)
    tdt_gemm_f32_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), M,
        N, K);
  else
    tdt_gemm_f32_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), M,
        N, K);
  return (int)cudaGetLastError();
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
