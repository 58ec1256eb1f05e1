// The tile of the grouped (expert) GEMMs, as `__device__` functions that
// every grouped kernel of this directory runs: group_gemm.cu's
// one-tile-per-block kernels (B17, B18) and the persistent tile loops of the
// MoE tensor-parallel kernels (moe_tp.cu: B19, B20 across ranks).
//
// A tile is TM expert-aligned rows x 128 output columns of
//   out = x @ w                        (plain), or
//   out = silu(x @ wg) * (x @ wu)      (gated)
// at (row0, col0), where the caller has already picked the rows' expert and
// hands its weights: wg (and wu) point at column 0 of the expert's [K, N]
// block, row stride ldw, so a weight shard may be a strided block of a
// larger tensor (a column block, or a row block of K). The sums run over
// the whole K in stages of 32 in one fixed order in f32 and are cast once,
// so an output element's bits depend neither on TM, block_m, the
// neighbouring rows, which block computes it, nor on the leading
// dimensions. bf16 runs on the tensor cores (mma.sync m16n8k16, f32
// accumulators) through a 4-stage ring of cp.async copies (x through L2,
// cp.async.cg, so a tile may read rows a peer rank put during the same
// launch); f32 runs in full f32 on the CUDA cores (fused multiply-adds),
// its x loads through L2 with kCgX. With kEdge the columns stop at N
// (N % 8 == 0: a group of 8 columns is all inside or all outside), the
// weight columns past it staged as zeros and never stored; without it N is
// a multiple of 128. K is a multiple of 32 and the rows lie inside.
//
// block_expert is the used-block bound of the aligned rows: a row block at
// or past nb returns false before be or any weight is read.
//
// Every thread of the block calls a tile function; a caller that runs
// several tiles in one block meets the block (__syncthreads) before each,
// so the next tile's copies never overwrite a stage that a slow warp still
// reads. The caller gives the shared memory: bf16_smem_bytes<TM, kGated>()
// for the bf16 tile, f32_smem_floats<kGated>() floats for the f32 one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace tdt_group {

using tdt_gemm::bf16;
using tdt_gemm::cp_async16;
using tdt_gemm::cp_async_commit;
using tdt_gemm::cp_async_wait;
using tdt_gemm::ldmatrix_x4;
using tdt_gemm::ldmatrix_x4_trans;
using tdt_gemm::mma_bf16;
using tdt_gemm::smem_addr;

constexpr int kThreads = 128;   // four warps
constexpr int kTN = 128;        // output columns per tile
constexpr int kTK = 32;         // contraction depth per stage
constexpr int kStages = 4;      // cp.async ring depth (bf16 path)
constexpr int kLdX = kTK + 8;   // bf16 row stride of an x stage: 80 bytes
constexpr int kLdW = kTN + 8;   // bf16 row stride of a weight stage: 272 bytes
constexpr int kF32Rows = 16;    // rows of the f32 tile

template <int TM, bool kGated>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return (size_t)kStages * (TM * kLdX + (kGated ? 2 : 1) * kTK * kLdW) * sizeof(bf16);
}

template <bool kGated>
__host__ __device__ constexpr int f32_smem_floats() {
  return kF32Rows * kTK + (kGated ? 2 : 1) * kTK * kTN;
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// The expert of the row block that holds row0, or false when the block lies
// at or past the bound (then nothing else is read).
__device__ __forceinline__ bool block_expert(const int* be, const int* nb, int row0,
                                             int block_m, int n_blocks, int E, int* e) {
  const int i = row0 / block_m;
  const int bound = nb ? min(*nb, n_blocks) : n_blocks;
  if (i >= bound) return false;
  *e = min(max(be[i], 0), E - 1);
  return true;
}

// Two neighbouring output values of one row, in the output's type.
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The bf16 tile: rows [row0, row0 + TM) of x (row stride ldx) and columns
// [col0, col0 + kTN) of the weights (row stride ldw) into out (row stride
// ldo). Warp w owns output columns [32w, 32w + 32) of the tile's 128, for
// all TM rows: TM/16 x 4 mma tiles.
template <int TM, bool kGated, typename OutT, bool kEdge = false>
__device__ __forceinline__ void grouped_tile_bf16(const bf16* __restrict__ x, int ldx,
                                                  const bf16* __restrict__ wg,
                                                  const bf16* __restrict__ wu, int ldw,
                                                  OutT* __restrict__ out, int ldo, int K, int N,
                                                  int row0, int col0, unsigned char* smem) {
  constexpr int kW = kGated ? 2 : 1;
  constexpr int MT = TM / 16;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kStages][TM][kLdX]
  bf16* ws = xs + kStages * TM * kLdX;        // [kStages][kW][kTK][kLdW]
  const bf16* xsrc = x + (size_t)row0 * ldx;
  const bf16* wsrc[2] = {wg + col0, kGated ? wu + col0 : nullptr};

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * kTK;
    for (int c = threadIdx.x; c < TM * (kTK / 8); c += kThreads) {
      const int r = c / (kTK / 8), q = (c % (kTK / 8)) * 8;
      cp_async16(xs + (stage * TM + r) * kLdX + q, xsrc + (size_t)r * ldx + k0 + q);
    }
#pragma unroll
    for (int w = 0; w < kW; ++w)
      for (int c = threadIdx.x; c < kTK * (kTN / 8); c += kThreads) {
        const int r = c / (kTN / 8), q = (c % (kTN / 8)) * 8;
        bf16* dst = ws + ((stage * kW + w) * kTK + r) * kLdW + q;
        if (!kEdge || col0 + q < N)
          cp_async16(dst, wsrc[w] + (size_t)(k0 + r) * ldw + q);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
  };

  const int KT = K / kTK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[kW][MT][4][4];
#pragma unroll
  for (int w = 0; w < kW; ++w)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[w][mt][nt][i] = 0.f;

  // ldmatrix row addresses: lane l names row (l % 8) + 8 * ((l / 8) % 2) and
  // 8-column half (l / 16) of a 16 x 16 tile
  const int lrow = (lane % 8) + 8 * ((lane / 8) % 2);
  const int lcol = 8 * (lane / 16);

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's, and stage kt - 1 is consumed
    {
      const int nk = kt + kStages - 1;
      if (nk < KT) load_stage(nk, nk % kStages);
      cp_async_commit();
    }
    const int stage = kt % kStages;
    const bf16* xst = xs + stage * TM * kLdX;
#pragma unroll
    for (int ks = 0; ks < kTK / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], smem_addr(xst + (mt * 16 + lrow) * kLdX + ks * 16 + lcol));
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const bf16* wst = ws + (stage * kW + w) * kTK * kLdW;
        uint32_t b[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4_trans(
              b[np], smem_addr(wst + (ks * 16 + lrow) * kLdW + warp * 32 + np * 16 + lcol));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[w][mt][nt], a[mt], b[nt / 2][2 * (nt % 2)],
                     b[nt / 2][2 * (nt % 2) + 1]);
      }
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
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = kGated ? silu_mul(acc[0][mt][nt][i], acc[kW - 1][mt][nt][i])
                      : acc[0][mt][nt][i];
      const int r = row0 + mt * 16 + g;
      const int c = col0 + warp * 32 + nt * 8 + 2 * t;
      if (kEdge && c >= N) continue;
      store2(out + (size_t)r * ldo + c, v[0], v[1]);
      store2(out + (size_t)(r + 8) * ldo + c, v[2], v[3]);
    }
}

// The f32 tile on the CUDA cores: rows [row0, row0 + 16), columns [col0,
// col0 + kTN); thread (ty = warp, tx = lane) owns rows 4ty..4ty+3 and
// columns 4tx..4tx+3. smem holds x's stage [16][kTK] and the weights'
// [kW][kTK][kTN].
template <bool kGated, bool kEdge = false, bool kCgX = false>
__device__ __forceinline__ void grouped_tile_f32(const float* __restrict__ x, int ldx,
                                                 const float* __restrict__ wg,
                                                 const float* __restrict__ wu, int ldw,
                                                 float* __restrict__ out, int ldo, int K, int N,
                                                 int row0, int col0, float* smem) {
  constexpr int TM = kF32Rows;
  constexpr int kW = kGated ? 2 : 1;
  float* xs = smem;               // [TM][kTK]
  float* ws = smem + TM * kTK;    // [kW][kTK][kTN]
  const float* wsrc[2] = {wg + col0, kGated ? wu + col0 : nullptr};
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  float acc[kW][4][4];
#pragma unroll
  for (int w = 0; w < kW; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[w][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
    {  // 16 x 32 floats: one 16-byte vector per thread
      const int r = threadIdx.x / (kTK / 4), q = (threadIdx.x % (kTK / 4)) * 4;
      const float4* p = reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * ldx + k0 + q);
      *reinterpret_cast<float4*>(xs + r * kTK + q) = kCgX ? __ldcg(p) : *p;
    }
#pragma unroll
    for (int w = 0; w < kW; ++w)
      for (int c = threadIdx.x; c < kTK * kTN / 4; c += kThreads) {
        const int r = c / (kTN / 4), q = (c % (kTN / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!kEdge || col0 + q < N)
          v = *reinterpret_cast<const float4*>(wsrc[w] + (size_t)(k0 + r) * ldw + q);
        *reinterpret_cast<float4*>(ws + (w * kTK + r) * kTN + q) = v;
      }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[(4 * ty + i) * kTK + k];
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const float4 b = *reinterpret_cast<const float4*>(ws + (w * kTK + k) * kTN + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[w][i][0] = fmaf(a[i], b.x, acc[w][i][0]);
          acc[w][i][1] = fmaf(a[i], b.y, acc[w][i][1]);
          acc[w][i][2] = fmaf(a[i], b.z, acc[w][i][2]);
          acc[w][i][3] = fmaf(a[i], b.w, acc[w][i][3]);
        }
      }
    }
    __syncthreads();
  }

  if (kEdge && col0 + 4 * tx >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = kGated ? silu_mul(acc[0][i][j], acc[kW - 1][i][j]) : acc[0][i][j];
    *reinterpret_cast<float4*>(out + (size_t)(row0 + 4 * ty + i) * ldo + col0 + 4 * tx) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace tdt_group
