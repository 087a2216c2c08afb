// Exact 4-bit dequantization to W^T (kernel A).
//
// Replaces: nf4_tpu/ops/dequant.py:_dequant_t_pallas (kernel body
// _make_dequant_kernel).
//
// Computes: byte (j, r) of the packed layout holds K row 2j in its low
// nibble and K row 2j+1 in its high nibble; each nibble indexes the
// 16-entry fp32 codebook (NF4 or FP4), is multiplied in fp32 by the block
// scale scales[j / 32, r], and is rounded ONCE to the output type
// (round-to-nearest-even), which makes the result bit-exact against the
// NumPy oracle.
//
// Bound: bytes.  Each packed byte is read once and 2 outputs are written
// (4 bytes of bf16/fp16, 8 of fp32), with one fp32 multiply per output,
// so the card's memory rate is the limit.  Design: one thread per 4
// neighbouring bytes of a packed row (one 32-bit load, one 16-byte load of
// the 4 scales), neighbouring threads on neighbouring columns so every
// load and store coalesces; the 16 codebook values sit in shared memory;
// offsets are size_t so tensors above 2^31 elements index correctly.
//
// Second entry point, the fast bf16 dequant (kernel F).
//
// Replaces: nf4_tpu/ops/dequant.py:_dequant_t_pallas_fast (kernel body
// _make_bytetable_dequant_kernel).
//
// Computes: kernel B's weight decode without the dot.  A 256-entry table
// maps each byte to both nibbles' bf16 code bits in one 32-bit word (low
// half K row 2j, high half K row 2j+1); the word, read as __nv_bfloat162, is
// multiplied by bf16(scale) with one __hmul2, so each value is
// bf16(bf16(code) * bf16(scale)), rounded once.  Output is always bf16.  Not
// bit-exact against the oracle (the code and the scale each round to bf16
// first); bit-exact against its plain version.
//
// Bound: bytes, the same as kernel A's bf16 output (each packed byte read
// once, 4 bytes of bf16 written).  Design: kernel A's, with the table in
// shared memory in place of the 16 codebook values and one bf16x2 multiply
// per byte in place of two fp32 multiplies and two conversions.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Out4;

template <> struct Out4<float> {
  static __device__ void store(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
};

template <> struct Out4<__nv_bfloat16> {
  static __device__ void store(__nv_bfloat16* p, float a, float b, float c, float d) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  }
};

template <> struct Out4<__half> {
  static __device__ void store(__half* p, float a, float b, float c, float d) {
    __half2 lo = __floats2half2_rn(a, b);
    __half2 hi = __floats2half2_rn(c, d);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  }
};

template <typename T>
__global__ void dequant_t_kernel(const uint8_t* __restrict__ packed,
                                 const float* __restrict__ scales,
                                 const float* __restrict__ code,
                                 T* __restrict__ out, int khalf, int m_pad) {
  __shared__ float lut[16];
  if (threadIdx.x < 16) lut[threadIdx.x] = code[threadIdx.x];
  __syncthreads();

  const size_t cols4 = (size_t)m_pad / 4;
  const size_t total = (size_t)khalf * cols4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t j = i / cols4;
    const size_t r = (i - j * cols4) * 4;
    const uint32_t b = *reinterpret_cast<const uint32_t*>(packed + j * m_pad + r);
    const float4 s = *reinterpret_cast<const float4*>(scales + (j / 32) * m_pad + r);
    T* row_lo = out + (2 * j) * (size_t)m_pad + r;
    T* row_hi = row_lo + m_pad;
    Out4<T>::store(row_lo, lut[b & 0xF] * s.x, lut[(b >> 8) & 0xF] * s.y,
                   lut[(b >> 16) & 0xF] * s.z, lut[(b >> 24) & 0xF] * s.w);
    Out4<T>::store(row_hi, lut[(b >> 4) & 0xF] * s.x, lut[(b >> 12) & 0xF] * s.y,
                   lut[(b >> 20) & 0xF] * s.z, lut[(b >> 28) & 0xF] * s.w);
  }
}

__global__ void dequant_t_fast_kernel(const uint8_t* __restrict__ packed,
                                      const float* __restrict__ scales,
                                      const uint32_t* __restrict__ table,
                                      __nv_bfloat16* __restrict__ out, int khalf, int m_pad) {
  __shared__ uint32_t lut[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = table[i];
  __syncthreads();

  const size_t cols4 = (size_t)m_pad / 4;
  const size_t total = (size_t)khalf * cols4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t j = i / cols4;
    const size_t r = (i - j * cols4) * 4;
    const uint32_t b = *reinterpret_cast<const uint32_t*>(packed + j * m_pad + r);
    const float4 s = *reinterpret_cast<const float4*>(scales + (j / 32) * m_pad + r);
    const float sf[4] = {s.x, s.y, s.z, s.w};
    __nv_bfloat162 v[4];  // v[q].x = K row 2j, v[q].y = K row 2j + 1, column r + q
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t w = lut[(b >> (8 * q)) & 0xFF];
      v[q] = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&w),
                     __bfloat162bfloat162(__float2bfloat16_rn(sf[q])));
    }
    __nv_bfloat162 row[4] = {__halves2bfloat162(v[0].x, v[1].x), __halves2bfloat162(v[2].x, v[3].x),
                             __halves2bfloat162(v[0].y, v[1].y), __halves2bfloat162(v[2].y, v[3].y)};
    const uint32_t* u = reinterpret_cast<const uint32_t*>(row);
    __nv_bfloat16* row_lo = out + (2 * j) * (size_t)m_pad + r;
    *reinterpret_cast<uint2*>(row_lo) = make_uint2(u[0], u[1]);
    *reinterpret_cast<uint2*>(row_lo + m_pad) = make_uint2(u[2], u[3]);
  }
}

size_t grid_blocks(int khalf, int m_pad, int threads) {
  const size_t total = (size_t)khalf * (m_pad / 4);
  size_t blocks = (total + threads - 1) / threads;
  return blocks > 65535u * 8u ? 65535u * 8u : blocks;  // grid-stride loop covers the rest
}

template <typename T>
void launch(const void* packed, const void* scales, const void* code, void* out,
            int khalf, int m_pad, cudaStream_t stream) {
  const int threads = 256;
  dequant_t_kernel<T><<<(unsigned)grid_blocks(khalf, m_pad, threads), threads, 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      static_cast<const float*>(code), static_cast<T*>(out), khalf, m_pad);
}

}  // namespace

// out_kind: 0 = fp32, 1 = bf16, 2 = fp16.  m_pad must be a multiple of 4
// (the layout pads it to 128); every pointer 16-byte aligned.
extern "C" int nf4_dequant_t(const void* packed, const void* scales, const void* code,
                             void* out, int khalf, int m_pad, int out_kind,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (khalf > 0 && m_pad > 0) {
    if (out_kind == 0) launch<float>(packed, scales, code, out, khalf, m_pad, s);
    else if (out_kind == 1) launch<__nv_bfloat16>(packed, scales, code, out, khalf, m_pad, s);
    else if (out_kind == 2) launch<__half>(packed, scales, code, out, khalf, m_pad, s);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Kernel F: packed u8 [khalf, m_pad], scales fp32 [khalf/32, m_pad], table
// u32 [256] (kernel B's byte table) -> out bf16 [2*khalf, m_pad].  m_pad must
// be a multiple of 4; every pointer 16-byte aligned.
extern "C" int nf4_dequant_t_fast(const void* packed, const void* scales, const void* table,
                                  void* out, int khalf, int m_pad, void* stream) {
  if (khalf > 0 && m_pad > 0) {
    const int threads = 256;
    dequant_t_fast_kernel<<<(unsigned)grid_blocks(khalf, m_pad, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
        static_cast<const uint32_t*>(table), static_cast<__nv_bfloat16*>(out), khalf, m_pad);
  }
  return (int)cudaGetLastError();
}
