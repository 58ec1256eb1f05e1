// The tile of the grouped (expert) GEMMs, as `__device__` functions that
// every grouped kernel of this directory runs: group_gemm.cu's
// one-tile-per-block kernels (B17, B18) and the persistent tile loops of the
// MoE tensor-parallel kernels (moe_tp.cu: B19, B20 across ranks).
//
// A tile is TM expert-aligned rows x 128 output columns of
//   out = s * (x @ w)                              (plain), or
//   out = silu(s * (x @ wg)) * (s * (x @ wu))      (gated)
// at (row0, col0), where the caller has already picked the rows' expert and
// hands its weights: wg (and wu) point at column 0 of the expert's [K, N]
// block, row stride ldw, so a weight shard may be a strided block of a
// larger tensor (a column block, or a row block of K). s is the row's f32
// scale (`scale[row]`, the dequantise of a quantised wire's row), or 1 when
// scale is null: it multiplies the f32 sums before the SiLU and the one
// cast. The sums run over the whole K in stages of 32 in one fixed order in
// f32 and are cast once, so an output element's bits depend neither on TM,
// block_m, the neighbouring rows, which block computes it, nor on the
// leading dimensions. bf16 weights run on the tensor cores (mma.sync
// m16n8k16, f32 accumulators) through a ring of kSt stages of cp.async
// copies (x through L2, cp.async.cg, so a tile may read rows a peer rank put
// during the same launch); f32 runs in full f32 on the CUDA cores (fused
// multiply-adds), its x loads through L2 with kCgX. With kEdge the columns
// stop at N (N % 8 == 0: a group of 8 columns is all inside or all
// outside), the weight columns past it staged as zeros and never stored;
// without it N is a multiple of 128. K is a multiple of 32 and the rows lie
// inside.
//
// The options of the bf16 tile, none of which changes a bit of the sums:
// - kX, the rows' type: bf16, or one byte (fp8 e4m3fn, int8), staged at one
//   byte an element (a 32-deep stage is 32 bytes a row) and converted
//   exactly to bf16 as the A fragments are built, so the tensor cores see
//   the values the bf16 tile would see after a cast;
// - kSt, the ring's depth (2 to 4): how many stages are in flight;
// - pack_bn, the packed gate|up stream (gated): one weight array [K, 2F]
//   whose column groups alternate pack_bn gate columns and pack_bn up
//   columns (pack_gated_weights); output column j reads gate column
//   (j / pack_bn) * 2 pack_bn + j % pack_bn and the up column pack_bn
//   further. pack_bn % 8 == 0, so a 16-byte copy stays inside one group,
//   and the staged tiles are the two-stream tile's, byte for byte;
// - block_k, the K extent of one pipeline pass (a multiple of 32 dividing
//   K; 0 is all of K): the ring is filled and drained once a pass, and the
//   f32 accumulators run on across passes in the same order.
// The row scale, the packed stream and block_k are runtime arguments that
// the tile reads only when it is instantiated with kOpts; the instantiation
// without it (every caller that takes none of them: the option-free B17 and
// B18, and B19/B20 across ranks) is the walk with no scale, two streams and
// one pass, with no test of an option left in its code.
//
// block_expert is the used-block bound of the aligned rows: a row block at
// or past nb returns false before be or any weight is read.
//
// Every thread of the block calls a tile function; a caller that runs
// several tiles in one block meets the block (__syncthreads) before each,
// so the next tile's copies never overwrite a stage that a slow warp still
// reads. The caller gives the shared memory: bf16_smem_bytes<TM, kGated,
// kX, kSt>() for the bf16 tile, f32_smem_floats<kGated>() floats for the
// f32 one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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
constexpr int kStages = 4;      // cp.async ring depth (bf16 path), the deepest
constexpr int kLdX = kTK + 8;   // bf16 row stride of an x stage: 80 bytes
constexpr int kLdX1 = 48;       // byte row stride of a one-byte x stage
constexpr int kLdW = kTN + 8;   // bf16 row stride of a weight stage: 272 bytes
constexpr int kF32Rows = 16;    // rows of the f32 tile

// the rows' types of the bf16 tile (the numbers the C entries take)
constexpr int kXBf16 = 0;
constexpr int kXFp8 = 1;
constexpr int kXInt8 = 2;

template <int kX>
__host__ __device__ constexpr int x_stage_ld() {  // bytes a row of an x stage
  return kX == kXBf16 ? kLdX * (int)sizeof(bf16) : kLdX1;
}

template <int TM, bool kGated, int kX = kXBf16, int kSt = kStages>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return (size_t)kSt *
         (TM * x_stage_ld<kX>() + (kGated ? 2 : 1) * kTK * kLdW * sizeof(bf16));
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

// The weight column that output column c of a stream reads: c itself, or
// in the packed gate|up stream (pack_bn > 0) its gate column, the up column
// lying pack_bn further.
__device__ __forceinline__ int packed_col(int c, int pack_bn) {
  return pack_bn ? (c / pack_bn) * 2 * pack_bn + c % pack_bn : c;
}

// Two neighbouring one-byte row values (fp8 e4m3fn or int8) as the bf16
// pair of an mma A fragment register (the first in the low half): both
// conversions are exact.
template <int kX>
__device__ __forceinline__ uint32_t x_pair(const unsigned char* p) {
  const unsigned short v = *reinterpret_cast<const unsigned short*>(p);
  float f0, f1;
  if constexpr (kX == kXInt8) {
    f0 = (float)(signed char)(v & 0xff);
    f1 = (float)(signed char)(v >> 8);
  } else {
    f0 = __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)(v & 0xff), __NV_E4M3)));
    f1 = __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)(v >> 8), __NV_E4M3)));
  }
  const __nv_bfloat162 b = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Two neighbouring output values of one row, in the output's type.
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The bf16 tile: rows [row0, row0 + TM) of x (row stride ldx elements)
// and columns [col0, col0 + kTN) of the weights (row stride ldw) into out
// (row stride ldo). Warp w owns output columns [32w, 32w + 32) of the
// tile's 128, for all TM rows: TM/16 x 4 mma tiles. scale, pack_bn and
// block_k are read only with kOpts (the deployed EP block's options);
// without it the tile is the option-free walk that B17, B18, B19 and B20
// run: no scale, two streams, all of K in one pass. Packed (pack_bn > 0):
// wg is the expert's [K, 2F] gate|up array and wu is unused.
template <int TM, bool kGated, typename OutT, bool kEdge = false, int kX = kXBf16,
          int kSt = kStages, bool kOpts = false>
__device__ __forceinline__ void grouped_tile_bf16(const void* __restrict__ x, int ldx,
                                                  const bf16* __restrict__ wg,
                                                  const bf16* __restrict__ wu, int ldw,
                                                  OutT* __restrict__ out, int ldo, int K, int N,
                                                  int row0, int col0, unsigned char* smem,
                                                  const float* __restrict__ scale = nullptr,
                                                  int pack_bn = 0, int block_k = 0) {
  static_assert(kSt >= 2 && kSt <= kStages, "ring depth 2 to 4");
  static_assert(kThreads % (kTN / 8) == 0, "a thread's weight columns stay fixed");
  constexpr int kW = kGated ? 2 : 1;
  constexpr int MT = TM / 16;
  constexpr int kXB = kX == kXBf16 ? 2 : 1;       // bytes a row value
  constexpr int kXLd = x_stage_ld<kX>();          // bytes a stage row
  constexpr int kXC = kTK * kXB / 16;             // 16-byte copies a stage row
  unsigned char* xs = smem;                       // [kSt][TM][kXLd] bytes
  bf16* ws = reinterpret_cast<bf16*>(smem + kSt * TM * kXLd);  // [kSt][kW][kTK][kLdW]
  const unsigned char* xsrc =
      static_cast<const unsigned char*>(x) + (size_t)row0 * ldx * kXB;

  // with kOpts a thread stages the same 8 weight columns of every row it
  // copies (kThreads is a multiple of kTN / 8): their source columns once,
  // in the packed stream too
  const int wq = (threadIdx.x % (kTN / 8)) * 8;
  const bool w_in = !kEdge || col0 + wq < N;
  const int wgc = kOpts ? packed_col(col0 + wq, pack_bn) : col0;
  const bf16* wsrc[2] = {wg + wgc, !kGated          ? nullptr
                                   : kOpts && pack_bn ? wg + wgc + pack_bn
                                                      : wu + wgc};

  auto load_stage = [&](int k0, int stage) {
    for (int c = threadIdx.x; c < TM * kXC; c += kThreads) {
      const int r = c / kXC, q = (c % kXC) * 16;
      cp_async16(xs + (stage * TM + r) * kXLd + q, xsrc + ((size_t)r * ldx + k0) * kXB + q);
    }
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      if constexpr (kOpts) {
        for (int r = threadIdx.x / (kTN / 8); r < kTK; r += kThreads / (kTN / 8)) {
          bf16* dst = ws + ((stage * kW + w) * kTK + r) * kLdW + wq;
          if (w_in)
            cp_async16(dst, wsrc[w] + (size_t)(k0 + r) * ldw);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        for (int c = threadIdx.x; c < kTK * (kTN / 8); c += kThreads) {
          const int r = c / (kTN / 8), q = (c % (kTN / 8)) * 8;
          bf16* dst = ws + ((stage * kW + w) * kTK + r) * kLdW + q;
          if (!kEdge || col0 + q < N)
            cp_async16(dst, wsrc[w] + (size_t)(k0 + r) * ldw + q);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  };

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
  // 8-column half (l / 16) of a 16 x 16 tile; a one-byte A fragment is built
  // by hand with the same layout: lane (g, t) holds rows g and g + 8,
  // columns 2t, 2t + 1 and 2t + 8, 2t + 9
  const int lrow = (lane % 8) + 8 * ((lane / 8) % 2);
  const int lcol = 8 * (lane / 16);
  const int g = lane / 4;
  const int t = lane % 4;

  // one pipeline pass over K rows [kb, kb + KT * kTK): the ring filled,
  // then drained
  auto run_pass = [&](int kb, int KT) {
#pragma unroll
    for (int s = 0; s < kSt - 1; ++s) {
      if (s < KT) load_stage(kb + s * kTK, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kSt - 2>();  // stage kt has landed (this thread's copies)
      __syncthreads();           // ... everyone's, and stage kt - 1 is consumed
      {
        const int nk = kt + kSt - 1;
        if (nk < KT) load_stage(kb + nk * kTK, nk % kSt);
        cp_async_commit();
      }
      const int stage = kt % kSt;
      const unsigned char* xst = xs + stage * TM * kXLd;
#pragma unroll
      for (int ks = 0; ks < kTK / 16; ++ks) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (kX == kXBf16) {
            ldmatrix_x4(a[mt], smem_addr(xst + (mt * 16 + lrow) * kXLd + (ks * 16 + lcol) * 2));
          } else {
            const unsigned char* p = xst + (mt * 16 + g) * kXLd + ks * 16 + 2 * t;
            a[mt][0] = x_pair<kX>(p);
            a[mt][1] = x_pair<kX>(p + 8 * kXLd);
            a[mt][2] = x_pair<kX>(p + 8);
            a[mt][3] = x_pair<kX>(p + 8 * kXLd + 8);
          }
        }
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
  };

  if constexpr (kOpts) {
    const int BK = block_k > 0 ? block_k : K;
    for (int kb = 0; kb < K; kb += BK) {
      if (kb > 0) __syncthreads();  // the last pass is consumed before this one fills the ring
      run_pass(kb, BK / kTK);
    }
  } else {
    run_pass(0, K / kTK);
  }

  // c0, c1 at (row g, columns 2t, 2t + 1) of each 16 x 8 tile; c2, c3 at row g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = row0 + mt * 16 + g;
    float s[2] = {1.f, 1.f};
    if (kOpts && scale) {
      s[0] = scale[r];
      s[1] = scale[r + 8];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float gv = acc[0][mt][nt][i], uv = acc[kW - 1][mt][nt][i];
        if (kOpts && scale) {
          gv *= s[i / 2];
          uv *= s[i / 2];
        }
        v[i] = kGated ? silu_mul(gv, uv) : gv;
      }
      const int c = col0 + warp * 32 + nt * 8 + 2 * t;
      if (kEdge && c >= N) continue;
      store2(out + (size_t)r * ldo + c, v[0], v[1]);
      store2(out + (size_t)(r + 8) * ldo + c, v[2], v[3]);
    }
  }
}

// The f32 tile on the CUDA cores: rows [row0, row0 + 16), columns [col0,
// col0 + kTN); thread (ty = warp, tx = lane) owns rows 4ty..4ty+3 and
// columns 4tx..4tx+3. smem holds x's stage [16][kTK] and the weights'
// [kW][kTK][kTN]. scale and pack_bn as in the bf16 tile, read only with
// kOpts; it has no ring, so a K split (block_k) would walk the same stages
// in the same order and is not a parameter.
template <bool kGated, bool kEdge = false, bool kCgX = false, bool kOpts = false>
__device__ __forceinline__ void grouped_tile_f32(const float* __restrict__ x, int ldx,
                                                 const float* __restrict__ wg,
                                                 const float* __restrict__ wu, int ldw,
                                                 float* __restrict__ out, int ldo, int K, int N,
                                                 int row0, int col0, float* smem,
                                                 const float* __restrict__ scale = nullptr,
                                                 int pack_bn = 0) {
  constexpr int TM = kF32Rows;
  constexpr int kW = kGated ? 2 : 1;
  float* xs = smem;               // [TM][kTK]
  float* ws = smem + TM * kTK;    // [kW][kTK][kTN]
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
        const int gc = kOpts ? packed_col(col0 + q, pack_bn) : col0 + q;
        const float* src = kOpts && pack_bn ? wg + gc + w * pack_bn : (w ? wu : wg) + gc;
        if (!kEdge || col0 + q < N)
          v = *reinterpret_cast<const float4*>(src + (size_t)(k0 + r) * ldw);
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
    const float s = kOpts && scale ? scale[row0 + 4 * ty + i] : 1.f;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float gv = acc[0][i][j], uv = acc[kW - 1][i][j];
      if (kOpts && scale) {
        gv *= s;
        uv *= s;
      }
      v[j] = kGated ? silu_mul(gv, uv) : gv;
    }
    *reinterpret_cast<float4*>(out + (size_t)(row0 + 4 * ty + i) * ldo + col0 + 4 * tx) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace tdt_group
