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
// 128 output columns) walks K in stages of 32, staging the x tile and the
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // four warps
constexpr int kTN = 128;        // output columns per block
constexpr int kTK = 32;         // contraction depth per stage
constexpr int kStages = 4;      // cp.async ring depth (bf16 path)
constexpr int kLdX = kTK + 8;   // bf16 row stride of an x stage: 80 bytes
constexpr int kLdW = kTN + 8;   // bf16 row stride of a weight stage: 272 bytes

typedef __nv_bfloat16 bf16;

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

// A fragments of one 16 x 16 tile of a row-major [m][k] bf16 tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// B fragments of two 16 x 8 tiles of a k-major [k][n] bf16 tile, transposed
// on the way in: r0, r1 for columns n0..n0+7, r2, r3 for n0+8..n0+15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring output values of one row, in the output's type.
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Grid (P / TM, N / kTN); TM divides block_m. Warp w owns output columns
// [32w, 32w + 32) of the block's 128, for all TM rows: TM/16 x 4 mma tiles.
template <int TM, bool kGated, typename OutT>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                             const bf16* __restrict__ wu, const int* __restrict__ be,
                             const int* __restrict__ nb, OutT* __restrict__ out, int P,
                             int K, int N, int block_m, int E) {
  constexpr int kW = kGated ? 2 : 1;
  constexpr int MT = TM / 16;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * kTN;
  int e;
  if (!block_expert(be, nb, row0, block_m, P / block_m, E, &e)) return;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kStages][TM][kLdX]
  bf16* ws = xs + kStages * TM * kLdX;        // [kStages][kW][kTK][kLdW]
  const bf16* xsrc = x + (size_t)row0 * K;
  const bf16* wsrc[2] = {wg + (size_t)e * K * N + col0,
                         kGated ? wu + (size_t)e * K * N + col0 : nullptr};

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * kTK;
    for (int c = threadIdx.x; c < TM * (kTK / 8); c += kThreads) {
      const int r = c / (kTK / 8), q = (c % (kTK / 8)) * 8;
      cp_async16(xs + (stage * TM + r) * kLdX + q, xsrc + (size_t)r * K + k0 + q);
    }
#pragma unroll
    for (int w = 0; w < kW; ++w)
      for (int c = threadIdx.x; c < kTK * (kTN / 8); c += kThreads) {
        const int r = c / (kTN / 8), q = (c % (kTN / 8)) * 8;
        cp_async16(ws + ((stage * kW + w) * kTK + r) * kLdW + q,
                   wsrc[w] + (size_t)(k0 + r) * N + q);
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
      store2(out + (size_t)r * N + c, v[0], v[1]);
      store2(out + (size_t)(r + 8) * N + c, v[2], v[3]);
    }
}

// f32 in full precision on the CUDA cores. Grid (P / 16, N / kTN); thread
// (ty = warp, tx = lane) owns rows 4ty..4ty+3 and columns 4tx..4tx+3.
template <bool kGated>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                            const float* __restrict__ wu, const int* __restrict__ be,
                            const int* __restrict__ nb, float* __restrict__ out, int P,
                            int K, int N, int block_m, int E) {
  constexpr int TM = 16;
  constexpr int kW = kGated ? 2 : 1;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * kTN;
  int e;
  if (!block_expert(be, nb, row0, block_m, P / block_m, E, &e)) return;

  __shared__ __align__(16) float xs[TM][kTK];
  __shared__ __align__(16) float ws[kW][kTK][kTN];
  const float* wsrc[2] = {wg + (size_t)e * K * N + col0,
                          kGated ? wu + (size_t)e * K * N + col0 : nullptr};
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
      *reinterpret_cast<float4*>(&xs[r][q]) =
          *reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * K + k0 + q);
    }
#pragma unroll
    for (int w = 0; w < kW; ++w)
      for (int c = threadIdx.x; c < kTK * kTN / 4; c += kThreads) {
        const int r = c / (kTN / 4), q = (c % (kTN / 4)) * 4;
        *reinterpret_cast<float4*>(&ws[w][r][q]) =
            *reinterpret_cast<const float4*>(wsrc[w] + (size_t)(k0 + r) * N + q);
      }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[4 * ty + i][k];
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const float4 b = *reinterpret_cast<const float4*>(&ws[w][k][4 * tx]);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = kGated ? silu_mul(acc[0][i][j], acc[kW - 1][i][j]) : acc[0][i][j];
    *reinterpret_cast<float4*>(out + (size_t)(row0 + 4 * ty + i) * N + col0 + 4 * tx) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

bool shapes_ok(int P, int K, int N, int block_m, int E, int tm) {
  return P > 0 && K > 0 && N > 0 && E > 0 && block_m > 0 && block_m % tm == 0 &&
         P % block_m == 0 && K % kTK == 0 && N % kTN == 0 && N / kTN <= 65535;
}

template <int TM, bool kGated, typename OutT>
int launch_bf16(const void* x, const void* wg, const void* wu, const void* be,
                const void* nb, void* out, int P, int K, int N, int block_m, int E,
                void* stream) {
  constexpr int kW = kGated ? 2 : 1;
  const size_t smem = (size_t)kStages * (TM * kLdX + kW * kTK * kLdW) * sizeof(bf16);
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
  if (!shapes_ok(P, K, N, block_m, E, 16)) return (int)cudaErrorInvalidValue;
  grouped_gemm_f32_kernel<kGated><<<dim3(P / 16, N / kTN), kThreads, 0, (cudaStream_t)stream>>>(
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
