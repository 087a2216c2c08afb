// Pieces shared by the weight-streaming matmul kernels (B in matmul.cu, D in
// int8_matmul.cu, E in matmul_exact.cu): the output columns of a block and
// the K rows of a scale block, the output store in fp32, bf16 or fp16, and
// the deterministic second pass that sums K-split fp32 partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

constexpr int BN = 128;      // output columns per block
constexpr int BK = 64;       // K rows per step (one scale block)

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
