// Fused 4-bit dequant-matmul for bf16 activations (kernel B):
// y[B, m] = x[B, n] . W^T[n, m], W kept packed in device memory.
//
// Replaces: nf4_tpu/ops/matmul.py:_matmul_pallas_bf16 (kernel body
// _make_bytetable_kernel).
//
// Computes: each weight value is bf16(bf16(code[nibble]) * bf16(scale)),
// the values the TPU kernel feeds its matrix unit, then a bf16 product with
// fp32 accumulation, stored as fp32, bf16 or fp16 (fp16 and bf16 rounded
// once from the fp32 sum).
//
// Bound: at decode (B <= 16) bytes: the packed weights and their scales
// (0.5625 bytes per weight) are read once and each byte feeds only 4*B
// flops, far below the ~295 flops per byte at which the tensor cores
// become the limit.  At prefill (B in the hundreds or more) operations.
// Design:
// * One block per (128 output columns, BM rows, K split).  A loop over K
//   inside the block replaces the TPU grid's sequential K axis; nothing is
//   carried between blocks.  When the (columns x rows) tiles alone cannot
//   fill the card (decode), K is split across blocks, each writes an fp32
//   partial, and a second small kernel sums the partials in a fixed order
//   (deterministic, no atomics).
// * Each K step covers 64 K rows = one scale block = 32 packed rows.  The
//   packed tile is decoded in shared memory through a 256-entry table that
//   maps a byte to both nibbles' bf16 code bits in one 32-bit word (low
//   half = K row 2j, high half = K row 2j+1: the layout's own order), and
//   one bf16x2 multiply by the column's bf16 scale.
// * The products run on the tensor cores through WMMA bf16 16x16x16
//   fragments.  The next step's packed bytes, scales and activations are
//   loaded into registers while the current step multiplies.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "gemm_common.cuh"

using namespace gemm;
using namespace nvcuda;

namespace {

// out_kind 0/1/2 = fp32/bf16/fp16 written at out + blockIdx.z * split_stride.
template <int BM>
__global__ void __launch_bounds__(THREADS)
nf4_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                       const float* __restrict__ scales, const uint32_t* __restrict__ table,
                       void* __restrict__ out, int n_pad, int m_pad, int kb_per_split,
                       size_t split_stride, int out_kind) {
  using T = Tiles<BM>;
  __shared__ __align__(128) unsigned char smem[T::SMEM];
  __shared__ uint32_t lut[256];
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

  for (int i = tid; i < 256; i += THREADS) lut[i] = table[i];

  // This thread's share of a K step: XV 16-byte pieces of the x tile, two
  // 16-byte pieces of the packed tile (rows prow, prow + 16; columns c0..c0+15)
  // and those columns' 16 scales.
  const int c0 = (tid % 8) * 16;
  const int prow = tid / 8;
  uint4 xr[T::XV], pr[2];
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
    for (int i = 0; i < 2; ++i)
      pr[i] = *reinterpret_cast<const uint4*>(packed + (size_t)(k0 / 2 + prow + 16 * i) * m_pad + n0 + c0);
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
  __syncthreads();  // lut ready

  for (int kb = kb0; kb < kb1; ++kb) {
    // Registers -> shared: the x tile as is, the packed tile decoded.
#pragma unroll
    for (int i = 0; i < T::XV; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / 8, c = (idx % 8) * 8;
      *reinterpret_cast<uint4*>(xs + r * XS_LD + c) = xr[i];
    }
    __nv_bfloat162 s2[16];
    const float* sf = reinterpret_cast<const float*>(sr);
#pragma unroll
    for (int q = 0; q < 16; ++q) s2[q] = __bfloat162bfloat162(__float2bfloat16_rn(sf[q]));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&pr[i]);
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int q = 0; q < 16; q += 2) {
        uint32_t w0 = lut[bytes[q]], w1 = lut[bytes[q + 1]];
        __nv_bfloat162 v0 = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&w0), s2[q]);
        __nv_bfloat162 v1 = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&w1), s2[q + 1]);
        // v.x = K row 2j (low nibble), v.y = K row 2j+1 (high nibble).
        __nv_bfloat162 l = __halves2bfloat162(v0.x, v1.x);
        __nv_bfloat162 h = __halves2bfloat162(v0.y, v1.y);
        lo[q / 2] = *reinterpret_cast<uint32_t*>(&l);
        hi[q / 2] = *reinterpret_cast<uint32_t*>(&h);
      }
      const int j = prow + 16 * i;
      uint4* dlo = reinterpret_cast<uint4*>(ws + (2 * j) * WS_LD + c0);
      uint4* dhi = reinterpret_cast<uint4*>(ws + (2 * j + 1) * WS_LD + c0);
      dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
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
void launch(const void* x, const void* packed, const void* scales, const void* table, void* dst,
            int b_pad, int n_pad, int m_pad, int kb_per_split, int ksplit, size_t stride,
            int kind, cudaStream_t stream) {
  dim3 grid(m_pad / BN, b_pad / BM, ksplit);
  nf4_matmul_bf16_kernel<BM><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const uint32_t*>(table), dst, n_pad, m_pad,
      kb_per_split, stride, kind);
}

}  // namespace

// x bf16 [b_pad, n_pad]; packed u8 [n_pad/2, m_pad]; scales fp32
// [n_pad/64, m_pad]; table u32 [256]; out [b_pad, m_pad] of out_kind
// (0 fp32, 1 bf16, 2 fp16).  bm is 16 or 64 and divides b_pad; n_pad is a
// multiple of 64 and m_pad of 128.  ksplit > 1 needs workspace fp32
// [ksplit, b_pad, m_pad].
extern "C" int nf4_matmul_bf16(const void* x, const void* packed, const void* scales,
                               const void* table, void* out, void* workspace, int b_pad,
                               int n_pad, int m_pad, int bm, int ksplit, int out_kind,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((bm != 16 && bm != 64) || b_pad % bm || n_pad % BK || m_pad % BN || ksplit < 1 ||
      out_kind < 0 || out_kind > 2 || (ksplit > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nkb = n_pad / BK;
  const int per = (nkb + ksplit - 1) / ksplit;
  void* dst = ksplit > 1 ? workspace : out;
  const int kind = ksplit > 1 ? 0 : out_kind;
  const size_t stride = (size_t)b_pad * m_pad;
  if (bm == 16) launch<16>(x, packed, scales, table, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  else launch<64>(x, packed, scales, table, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  if (ksplit > 1) gemm::splitk_reduce(static_cast<const float*>(workspace), out, ksplit, stride, out_kind, s);
  return (int)cudaGetLastError();
}
