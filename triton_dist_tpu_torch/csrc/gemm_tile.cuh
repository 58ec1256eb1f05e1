// The tile body of the dense GEMM (B2) and the slot sum of GEMM-RS, as
// `__device__` functions that every GEMM kernel of this directory runs:
// gemm.cu's one-tile-per-block kernels and the persistent tile loops of the
// overlap kernels (tp_overlap.cu).
//
// A tile is TM x 128 outputs of C = A @ B at (row0, col0), every product
// summed over the whole K in one fixed order in f32 and cast once, so an
// output element's bits depend neither on which block computes it nor on
// the tile height, nor on whether A, B and C are whole matrices or strided
// blocks of larger ones (the leading dimensions lda, ldb, ldc). bf16 runs on
// the tensor cores (mma.sync m16n8k16, a 4-stage ring of cp.async copies);
// f32 in full precision on the CUDA cores. B is row-major [K, N] with
// leading dimension ldb, or (kBT) stored as [N, K] and read as its
// transpose. With kCgA every load of A goes through L2 (cp.async.cg, ld.cg),
// so a tile may read an A that a peer rank stored during the same launch;
// without it the element-wise edge loads and the f32 loads are plain, as B2
// has always read them.
//
// The caller gives the shared memory: bf16_smem_bytes<MT, kBT>() for the
// bf16 tile, kF32SmemBytes for the f32 one. Every thread of the block calls
// a tile function; a caller that runs several tiles in one block meets the
// block (__syncthreads) before each, so the next tile's copies never
// overwrite a stage that a slow warp still reads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt_gemm {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // eight warps: 2 (rows) x 4 (columns)
constexpr int kTN = 128;        // output columns per tile
constexpr int kTK = 32;         // contraction depth per stage
constexpr int kStages = 4;      // cp.async ring depth
constexpr int kLdK = kTK + 8;   // bf16 row stride of a k-contiguous tile: 80 bytes
constexpr int kLdN = kTN + 8;   // bf16 row stride of an n-contiguous tile: 272 bytes

// f32: a 128 x 128 tile, K in steps of 16, both operands staged k-major
constexpr int kF32Tile = 128;
constexpr int kF32K = 16;
constexpr int kF32Ld = kF32Tile + 4;
constexpr size_t kF32SmemBytes = 2 * kF32K * kF32Ld * sizeof(float);

template <int MT, bool kBT>
constexpr size_t bf16_smem_bytes() {
  return (size_t)kStages * (32 * MT * kLdK + (kBT ? kTN * kLdK : kTK * kLdN)) * sizeof(bf16);
}

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

// one bf16 through L2
__device__ __forceinline__ bf16 ldcg(const bf16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// Stage the 8 elements (row, col .. col + 7) of a row-major matrix with
// leading dimension ld, bounded by [rows, cols], into dst: one cp.async
// (through L2) when they all lie inside and are 16-byte aligned, else
// element by element with zeros past the edges (through L2 with kCg).
template <bool kCg>
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int ld, int row, int rows,
                                       int col, int cols) {
  const bf16* p = src + (size_t)row * ld + col;
  if (row < rows && col + 8 <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    cp_async16(dst, p);
    return;
  }
  __align__(16) bf16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool in = row < rows && col + i < cols;
    v[i] = in ? (kCg ? ldcg(p + i) : p[i]) : __float2bfloat16(0.f);
  }
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

// Store C[r, c] = x and C[r, c + 1] = y (leading dimension ldc), each only
// inside [M, N); as one vector when both lie inside and the pair is aligned.
__device__ __forceinline__ void store_pair(bf16* C, int ldc, int r, int c, int M, int N, float x,
                                           float y) {
  if (r >= M || c >= N) return;
  bf16* p = C + (size_t)r * ldc + c;
  if (c + 1 < N && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    put(p, x);
    if (c + 1 < N) put(p + 1, y);
  }
}

__device__ __forceinline__ void store_pair(float* C, int ldc, int r, int c, int M, int N, float x,
                                           float y) {
  if (r >= M || c >= N) return;
  float* p = C + (size_t)r * ldc + c;
  if (c + 1 < N && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    *p = x;
    if (c + 1 < N) p[1] = y;
  }
}

// The bf16 tile on the tensor cores: rows [row0, row0 + TM) and columns
// [col0, col0 + kTN) of C[M, N], TM = 32 * MT. Warp w owns rows
// [(w / 4) * 16 MT, +16 MT) and columns [(w % 4) * 32, +32) of the tile: MT
// x 4 mma tiles of 16 x 8. A stage holds A as [TM][kLdK] and B as
// [kTK][kLdN] (row-major B) or [kTN][kLdK] (kBT: B stored as [N, K]).
template <int MT, bool kBT, typename OutT, bool kCgA = false>
__device__ __forceinline__ void gemm_tile_bf16(const bf16* __restrict__ A, int lda,
                                               const bf16* __restrict__ B, int ldb,
                                               OutT* __restrict__ C, int ldc, int M, int N, int K,
                                               int row0, int col0, unsigned char* smem) {
  constexpr int TM = 32 * MT;
  constexpr int kAStage = TM * kLdK;
  constexpr int kBStage = kBT ? kTN * kLdK : kTK * kLdN;
  bf16* as = reinterpret_cast<bf16*>(smem);  // [kStages][kAStage]
  bf16* bs = as + kStages * kAStage;          // [kStages][kBStage]

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * kTK;
    bf16* ad = as + stage * kAStage;
    for (int c = threadIdx.x; c < TM * (kTK / 8); c += kThreads) {
      const int r = c / (kTK / 8), q = (c % (kTK / 8)) * 8;
      stage8<kCgA>(ad + r * kLdK + q, A, lda, row0 + r, M, k0 + q, K);
    }
    bf16* bd = bs + stage * kBStage;
    if constexpr (kBT) {
      for (int c = threadIdx.x; c < kTN * (kTK / 8); c += kThreads) {
        const int r = c / (kTK / 8), q = (c % (kTK / 8)) * 8;
        stage8<false>(bd + r * kLdK + q, B, ldb, col0 + r, N, k0 + q, K);
      }
    } else {
      for (int c = threadIdx.x; c < kTK * (kTN / 8); c += kThreads) {
        const int r = c / (kTN / 8), q = (c % (kTN / 8)) * 8;
        stage8<false>(bd + r * kLdN + q, B, ldb, k0 + r, K, col0 + q, N);
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
      store_pair(C, ldc, r, c, M, N, acc[mt][nt][0], acc[mt][nt][1]);
      store_pair(C, ldc, r + 8, c, M, N, acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// The f32 tile on the CUDA cores: rows [row0, row0 + 128) and columns
// [col0, col0 + 128) of C[M, N]. Thread (ty, tx) = (tid / 16, tid % 16) owns
// rows 4 ty + i and 64 + 4 ty + i, columns 4 tx + j and 64 + 4 tx + j
// (i, j < 4). Both operands are staged k-major ([k][m], [k][n]) in smem
// (kF32SmemBytes) so a thread reads its 8 + 8 operands as four 16-byte
// vectors.
template <bool kBT, bool kCgA = false>
__device__ __forceinline__ void gemm_tile_f32(const float* __restrict__ A, int lda,
                                              const float* __restrict__ B, int ldb,
                                              float* __restrict__ C, int ldc, int M, int N, int K,
                                              int row0, int col0, float* smem) {
  float(*as)[kF32Ld] = reinterpret_cast<float(*)[kF32Ld]>(smem);
  float(*bs)[kF32Ld] = reinterpret_cast<float(*)[kF32Ld]>(smem + kF32K * kF32Ld);
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
        const float* pa = A + (size_t)gr * lda + gk;
        as[k][m] = (gr < M && gk < K) ? (kCgA ? __ldcg(pa) : *pa) : 0.f;
      }
      if constexpr (kBT) {
        const int n = idx / kF32K, k = idx % kF32K;
        const int gn = col0 + n, gk = k0 + k;
        bs[k][n] = (gn < N && gk < K) ? B[(size_t)gn * ldb + gk] : 0.f;
      } else {
        const int k = idx / kF32Tile, n = idx % kF32Tile;
        const int gn = col0 + n, gk = k0 + k;
        bs[k][n] = (gn < N && gk < K) ? B[(size_t)gk * ldb + gn] : 0.f;
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
      store_pair(C, ldc, r, c, M, N, acc[i][j], acc[i][j + 1]);
    }
  }
}

// The slot sum of GEMM-RS at element i (V elements from i; V = 4 needs ws
// 16-byte aligned and elems % 4 == 0): out[i + j] = sum over s of
// ws[s * elems + i + j], s = 0 .. n-1 in that order, in f32, cast once.
// With kCg the loads go through L2: the slots were stored by peer ranks
// during the same launch.
template <typename OutT, int V, bool kCg = false>
__device__ __forceinline__ void slot_sum(const float* __restrict__ ws, OutT* __restrict__ out,
                                         int n, long long elems, long long i) {
  float s[V];
  if constexpr (V == 4) {
    const float4* p4 = reinterpret_cast<const float4*>(ws + i);
    const float4 v = kCg ? __ldcg(p4) : *p4;
    s[0] = v.x, s[1] = v.y, s[2] = v.z, s[3] = v.w;
  } else {
    s[0] = kCg ? __ldcg(ws + i) : ws[i];
  }
  for (int r = 1; r < n; ++r) {
    const float* p = ws + (size_t)r * elems + i;
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = __fadd_rn(s[j], kCg ? __ldcg(p + j) : p[j]);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) put(out + i + j, s[j]);
}

}  // namespace tdt_gemm
