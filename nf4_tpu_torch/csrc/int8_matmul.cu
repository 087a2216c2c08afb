// W8A16 matmul for int8-recoded weights (kernel D):
// y[B, m] = x[B, n] . W^T[n, m], W^T stored as int8 values [n_pad, m_pad]
// (K-major) with fp32 scales [n_pad/64, m_pad], one per 64 K rows.
//
// Replaces: nf4_tpu/ops/int8_serve.py:_int8_matmul_pallas (kernel body
// _make_int8_kernel).
//
// Computes: each weight value is bf16(float(int8) * float(bf16(scale))): the
// scale rounds to bf16 first, as the TPU kernel's does, and the product of an
// 8-bit integer and a bf16 value is exact in fp32, so the value rounds once.
// Then a bf16 product with fp32 accumulation, stored as fp32, bf16 or fp16
// (bf16 and fp16 rounded once from the fp32 sum).
//
// Bound: at decode (B <= 16) bytes: the int8 values and their scales (1.0625
// bytes per weight) are read once and each byte feeds only 2*B flops.  At
// prefill (B in the hundreds or more) operations.  Design: the tiling of
// kernel B (csrc/matmul.cu):
// * One block per (128 output columns, BM rows, K split); a loop over K
//   inside the block replaces the TPU grid's sequential K axis.  At decode K
//   is split across blocks, each writes an fp32 partial, and a second pass
//   sums them in a fixed order (deterministic, no atomics).
// * Each K step covers 64 K rows = one scale row.  A thread loads 16 bytes
//   (16 neighbouring columns) of each of 4 K rows and the 16 columns' scales,
//   converts and scales in registers, and writes bf16 to shared memory.
// * Products on the tensor cores through WMMA bf16 16x16x16 fragments; the
//   next step's values, scales and activations load into registers while the
//   current step multiplies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "gemm_common.cuh"

using namespace gemm;
using namespace nvcuda;

namespace {

constexpr int WROWS = BK / (THREADS / 8);  // K rows of the weight tile per thread

// out_kind 0/1/2 = fp32/bf16/fp16 written at out + blockIdx.z * split_stride.
template <int BM>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ values,
                   const float* __restrict__ scales, void* __restrict__ out, int n_pad, int m_pad,
                   int kb_per_split, size_t split_stride, int out_kind) {
  using T = Tiles<BM>;
  __shared__ __align__(128) unsigned char smem[T::SMEM];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + BM * XS_LD;
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int n0 = blockIdx.x * BN;  // first output column
  const int m0 = blockIdx.y * BM;  // first batch row
  const int nkb = n_pad / BK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int kb1 = min(nkb, kb0 + kb_per_split);

  // This thread's share of a K step: XV 16-byte pieces of the x tile, one
  // 16-byte piece of each of WROWS weight rows (rows wrow + 16 i; columns
  // c0..c0+15) and those columns' 16 scales.
  const int c0 = (tid % 8) * 16;
  const int wrow = tid / 8;
  uint4 xr[T::XV], wr[WROWS];
  float4 sr[4];

  auto load = [&](int kb) {
    const int k0 = kb * BK;
#pragma unroll
    for (int i = 0; i < T::XV; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / 8, c = (idx % 8) * 8;
      xr[i] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * n_pad + k0 + c);
    }
#pragma unroll
    for (int i = 0; i < WROWS; ++i)
      wr[i] = *reinterpret_cast<const uint4*>(values + (size_t)(k0 + wrow + 16 * i) * m_pad + n0 + c0);
    const float4* sp = reinterpret_cast<const float4*>(scales + (size_t)kb * m_pad + n0 + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) sr[i] = sp[i];
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (kb0 < kb1) load(kb0);

  for (int kb = kb0; kb < kb1; ++kb) {
    // Registers -> shared: the x tile as is, the weight tile decoded.
#pragma unroll
    for (int i = 0; i < T::XV; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / 8, c = (idx % 8) * 8;
      *reinterpret_cast<uint4*>(xs + r * XS_LD + c) = xr[i];
    }
    float s[16];
    const float* sf = reinterpret_cast<const float*>(sr);
#pragma unroll
    for (int q = 0; q < 16; ++q) s[q] = __bfloat162float(__float2bfloat16_rn(sf[q]));
#pragma unroll
    for (int i = 0; i < WROWS; ++i) {
      const int8_t* v = reinterpret_cast<const int8_t*>(&wr[i]);
      uint32_t w[8];
#pragma unroll
      for (int q = 0; q < 16; q += 2) {
        __nv_bfloat162 p = __floats2bfloat162_rn((float)v[q] * s[q], (float)v[q + 1] * s[q + 1]);
        w[q / 2] = *reinterpret_cast<uint32_t*>(&p);
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + (wrow + 16 * i) * WS_LD + c0);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    __syncthreads();
    if (kb + 1 < kb1) load(kb + 1);  // in flight during the products below

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[T::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[T::FN];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * T::WM + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(b[j], ws + kk * WS_LD + wn * T::WN + j * 16, WS_LD);
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: fragments -> fp32 staging in shared memory -> coalesced stores.
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(cs + (wm * T::WM + i * 16) * CS_LD + wn * T::WN + j * 16,
                              acc[i][j], CS_LD, wmma::mem_row_major);
  __syncthreads();
  void* dst = out_kind == 0 ? static_cast<void*>(static_cast<float*>(out) + blockIdx.z * split_stride) : out;
  for (int idx = tid; idx < BM * BN / 4; idx += THREADS) {
    const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(cs + r * CS_LD + c);
    gemm::store_out(dst, out_kind, (size_t)(m0 + r) * m_pad + n0 + c, v);
  }
}

template <int BM>
void launch(const void* x, const void* values, const void* scales, void* dst, int b_pad, int n_pad,
            int m_pad, int kb_per_split, int ksplit, size_t stride, int kind, cudaStream_t stream) {
  dim3 grid(m_pad / BN, b_pad / BM, ksplit);
  int8_matmul_kernel<BM><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(values),
      static_cast<const float*>(scales), dst, n_pad, m_pad, kb_per_split, stride, kind);
}

}  // namespace

// x bf16 [b_pad, n_pad]; values int8 [n_pad, m_pad]; scales fp32
// [n_pad/64, m_pad]; out [b_pad, m_pad] of out_kind (0 fp32, 1 bf16, 2
// fp16).  bm is 16 or 64 and divides b_pad; n_pad is a multiple of 64 and
// m_pad of 128.  ksplit > 1 needs workspace fp32 [ksplit, b_pad, m_pad].
extern "C" int int8_matmul_bf16(const void* x, const void* values, const void* scales, void* out,
                                void* workspace, int b_pad, int n_pad, int m_pad, int bm,
                                int ksplit, int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((bm != 16 && bm != 64) || b_pad % bm || n_pad % BK || m_pad % BN || ksplit < 1 ||
      out_kind < 0 || out_kind > 2 || (ksplit > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nkb = n_pad / BK;
  const int per = (nkb + ksplit - 1) / ksplit;
  void* dst = ksplit > 1 ? workspace : out;
  const int kind = ksplit > 1 ? 0 : out_kind;
  const size_t stride = (size_t)b_pad * m_pad;
  if (bm == 16) launch<16>(x, values, scales, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  else launch<64>(x, values, scales, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  if (ksplit > 1) gemm::splitk_reduce(static_cast<const float*>(workspace), out, ksplit, stride, out_kind, s);
  return (int)cudaGetLastError();
}
