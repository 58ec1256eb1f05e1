// The push/ring all-gather in its one-rank form, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel B9, _ag_call (the pallas_call at
// triton_dist_tpu/ops/allgather.py:262; _ag_push_kernel, _ag_ring_kernel),
// as the sequence-parallel decode runs it on one rank. There, each rank's
// shard [m, ...] lands in its slot of the gathered [n * m, ...]: the push
// kernel copies its own shard into slot `me` and puts it to every peer, the
// ring copies it and forwards the slots it receives. At n = 1 both are the
// copy of the shard into slot 0, which is what this kernel does:
//   out[slot * nbytes + i] = shard[i]   for i in [0, nbytes)
//
// What bounds it on this card: bytes, each read once and written once; at
// the decode step's wire (a few hundred KB) it is over before the launch
// overhead is.
//
// What the design does about it: a grid-stride loop of 16-byte vectors over
// the body, so every sector moves whole, and the last nbytes % 16 bytes one
// by one in the first block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // a few waves of the H100's 132 SMs

__global__ void __launch_bounds__(kThreads)
    ag_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long vecs,
                   const unsigned char* __restrict__ src_tail,
                   unsigned char* __restrict__ dst_tail, int tail) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < vecs; v += stride)
    dst[v] = src[v];
  if (blockIdx.x == 0 && threadIdx.x < tail) dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

}  // namespace

extern "C" {

// shard: nbytes; out: at least (slot + 1) * nbytes. The shard and the
// slot 16-byte aligned. Returns the launch's cudaError_t.
int tdt_ag_copy(const void* shard, void* out, long long nbytes, int slot, void* stream) {
  if (nbytes <= 0 || slot < 0) return (int)cudaErrorInvalidValue;
  const unsigned char* src = static_cast<const unsigned char*>(shard);
  unsigned char* dst = static_cast<unsigned char*>(out) + (size_t)slot * nbytes;
  if (((uintptr_t)src | (uintptr_t)dst) % 16) return (int)cudaErrorInvalidValue;
  const long long vecs = nbytes / 16;
  const int tail = (int)(nbytes % 16);
  long long blocks = (vecs + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  ag_copy_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst), vecs,
      src + vecs * 16, dst + vecs * 16, tail);
  return (int)cudaGetLastError();
}

const char* tdt_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
