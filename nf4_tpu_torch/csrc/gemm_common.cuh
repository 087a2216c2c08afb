// Pieces shared by the weight-streaming matmul kernels (B in matmul.cu, D in
// int8_matmul.cu, E in matmul_exact.cu): the block tiling of B's and D's
// decode kernels, the output store in fp32, bf16 or fp16, and the
// deterministic second pass that sums K-split fp32 partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

constexpr int BN = 128;      // output columns per block
constexpr int BK = 64;       // K rows per step (one scale block)
constexpr int THREADS = 128; // 4 warps
constexpr int XS_LD = BK + 8;
constexpr int WS_LD = BN + 8;
constexpr int CS_LD = BN + 4;

// A block of BM = 16 batch rows x BN columns (the decode kernels): the
// warps' tiles of WMMA 16x16 fragments, the x and decoded-weight tiles of
// one K step in shared memory, reused as the fp32 staging of the epilogue.
template <int BM>
struct Tiles {
  static_assert(BM == 16, "the decode kernels' tiling");
  static constexpr int WM = 16;  // rows per warp
  static constexpr int WN = 32;  // columns per warp
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int XV = BM * BK / 8 / THREADS;  // 16-byte x loads per thread
  static constexpr int TILE_BYTES = (BM * XS_LD + BK * WS_LD) * 2;
  static constexpr int STAGE_BYTES = BM * CS_LD * 4;
  static constexpr int SMEM = TILE_BYTES > STAGE_BYTES ? TILE_BYTES : STAGE_BYTES;
  static_assert((BM / WM) * WARPS_N == THREADS / 32, "4 warps tile the block");
  static_assert(XV >= 1, "x tile load");
};

// Store 4 fp32 sums at out + idx as out_kind 0/1/2 = fp32/bf16/fp16 (bf16
// and fp16 rounded once from the fp32 sum).
__device__ __forceinline__ void store_out(void* out, int kind, size_t idx, float4 v) {
  if (kind == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + idx) = v;
  } else if (kind == 1) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&a);
    w.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + idx) = w;
  } else {
    __half2 a = __floats2half2_rn(v.x, v.y), b = __floats2half2_rn(v.z, v.w);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&a);
    w.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__half*>(out) + idx) = w;
  }
}

// Sum the K-split fp32 partials [ksplit, n4 * 4] in split order and store
// in the out type.
__global__ void splitk_reduce_kernel(const float* __restrict__ part, void* __restrict__ out,
                                     int ksplit, size_t n4, int out_kind) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = reinterpret_cast<const float4*>(part)[i];
    for (int z = 1; z < ksplit; ++z) {
      const float4 v = reinterpret_cast<const float4*>(part + z * n4 * 4)[i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    store_out(out, out_kind, i * 4, s);
  }
}

inline void splitk_reduce(const float* part, void* out, int ksplit, size_t n, int out_kind,
                          cudaStream_t stream) {
  const size_t n4 = n / 4;
  size_t blocks = (n4 + 255) / 256;
  if (blocks > 65535u * 8u) blocks = 65535u * 8u;
  splitk_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(part, out, ksplit, n4, out_kind);
}

}  // namespace gemm
