// W8A16 matmul for int8-recoded weights (kernel D):
// y[B, m] = x[B, n] . W^T[n, m], W^T stored as int8 values [n_pad, m_pad]
// (K-major: rows are K, columns N contiguous) with fp32 scales [n_pad/64,
// m_pad], one per 64 K rows.
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
// prefill (B in the hundreds or more) operations, 989 TFLOP/s bf16,
// reachable only through wgmma.  Two kernels, with the K loop inside the
// block and, where the output tiles alone cannot fill the card, K split
// across blocks with fp32 partials summed in a fixed order by a second pass
// (deterministic, no atomics):
// * Decode (bm = 16): kernel B's WMMA tiling, 16 rows x 128 columns per
//   block of 4 warps; a thread loads 16 bytes (16 neighbouring columns) of
//   each of 4 K rows and their scales, converts and scales in registers,
//   and writes bf16 to shared memory; the next step's values load into
//   registers while the current step multiplies.
// * Prefill (bm = 256 or 128, b_pad a multiple of 64): kernel B's pipelined
//   wgmma main loop (dequant_gemm.cuh: 256 x 128 blocks of 4 consumer
//   warpgroups or 128 x 256 of 2, x by TMA, a 4-stage ring, the decode of
//   step s+1 under the products of step s) with an int8 decode.  A K step is
//   64 int8 rows (one scale row; twice the bytes of kernel B's packed
//   rows).  The decode needs no table: each byte becomes an exact fp32 by
//   putting x + 128 in the low mantissa byte of 2^23 (one byte permute) and
//   subtracting 2^23 + 128, is multiplied by the column's bf16 scale in fp32
//   and rounded once to bf16.  The int8 rows are N-contiguous while kernel
//   B's wgmma B operand is read K-major.  This kernel transposes in
//   registers: a thread reads 8 K rows x CW columns from the ring, so its
//   registers hold each column's 8 K values, which it writes as one 16-byte
//   K piece under the 128-byte swizzle, and kernel B's descriptor and
//   product helpers serve unchanged.  The other way, an MN-major tile read
//   with wgmma's transpose flag (bf16 allows it), would need a second
//   descriptor form and new product helpers, and was not built: with the
//   register transpose D takes 1.06x kernel B's time on the same shapes
//   (utils/kernel_variants.py --only layouts, NVIDIA H100 80GB HBM3, 700 W).
//   The ring's rows are XOR-swizzled by row group so that these reads miss
//   no bank.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "dequant_gemm.cuh"
#include "gemm_common.cuh"
#include "hopper.cuh"

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

// The prefill kernel's Op for the shared main loop: BN columns and WGS
// consumer warpgroups of 64 rows per block, K steps of 64 int8 rows.
template <int BN_, int WGS>
struct Int8Bf16 : dg::Bf16Op<BN_, WGS> {
  using Base = dg::Bf16Op<BN_, WGS>;
  using Base::BN, Base::THREADS, Base::CW, Base::UNITS;
  static constexpr int RAW_BYTES = BK * BN;
  static constexpr int AUX_BYTES = 0;

  static __device__ __forceinline__ void init_aux(unsigned char*, const void*, int) {}

  // Row r's 16-byte pieces are XOR-swizzled by its row group r / 8, so the
  // decode's reads (8 row groups x 4 neighbouring words per warp) miss no
  // bank.
  static __device__ __forceinline__ void load_raw(uint32_t raw, uint32_t sc, const uint8_t* values,
                                                  const float* scales, int kb, int n0, int m_pad, int tid) {
    for (int idx = tid; idx < BK * (BN / 16); idx += THREADS) {
      const int r = idx / (BN / 16), q = idx % (BN / 16);
      const uint8_t* src = values + (size_t)(kb * BK + r) * m_pad + n0 + q * 16;
      hop::cp_async16(raw + r * BN + ((q ^ ((r / 8) & 7)) << 4), src, true);
    }
    if (tid < BN / 4) hop::cp_async16(sc + tid * 16, scales + (size_t)kb * m_pad + n0 + tid * 4, true);
  }

  // A thread takes row group c (K rows 8c..8c+7) of CW neighbouring columns
  // and writes each column's 16-byte piece c: word j holds K rows 2j (low
  // half) and 2j+1.  The 8 lanes of a quarter warp take the 8 row groups of
  // the same columns, so each 16-byte store of theirs lands in another
  // chunk of the swizzle (no bank conflict); their ring reads fall in other
  // chunks too.
  static __device__ __forceinline__ void decode(const unsigned char* vs, const float* ss, unsigned char* ws,
                                                const unsigned char*, int tid) {
    const int warp = tid / 32, lane = tid % 32;
    const int c = lane % 8;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int col = ((u * (THREADS / 32) + warp) * 4 + lane / 8) * CW;  // first of the CW columns
      // Byte e of rv[r] = int8 of K row 8c + r, column col + e, plus 128.
      uint32_t rv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const unsigned char* src = vs + (8 * c + r) * BN + (((col / 16) ^ c) << 4) + (col % 16);
        rv[r] = (CW == 4 ? *reinterpret_cast<const uint32_t*>(src) : *reinterpret_cast<const uint16_t*>(src)) ^
                0x80808080u;
      }
      float sf[4];
      if constexpr (CW == 4) {
        const float4 sv = *reinterpret_cast<const float4*>(ss + col);
        sf[0] = sv.x, sf[1] = sv.y, sf[2] = sv.z, sf[3] = sv.w;
      } else {
        const float2 sv = *reinterpret_cast<const float2*>(ss + col);
        sf[0] = sv.x, sf[1] = sv.y;
      }
#pragma unroll
      for (int e = 0; e < CW; ++e) {
        const float s = __bfloat162float(__float2bfloat16_rn(sf[e]));
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          v[r] = __fmul_rn(__uint_as_float(__byte_perm(rv[r], 0x4B000000u, 0x7540 + e)) - 8388736.f, s);
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
          w[j] = *reinterpret_cast<const uint32_t*>(&p);
        }
        *reinterpret_cast<uint4*>(ws + hop::swz(col + e, c, 128)) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};

template <int BN, int WGS>
int launch_prefill(const void* x, const void* values, const void* scales, void* dst, int b_pad, int n_pad,
                   int m_pad, int kb_per_split, int ksplit, size_t stride, int kind, cudaStream_t stream) {
  using Op = Int8Bf16<BN, WGS>;
  CUtensorMap x_map;
  const int rc = dg::x_tensor_map(&x_map, x, 2, b_pad, n_pad, Op::PM);
  if (rc) return rc;
  return dg::launch<Op>(x_map, values, scales, nullptr, dst, b_pad, n_pad, m_pad, kb_per_split, ksplit, stride,
                        kind, stream);
}

}  // namespace

// x bf16 [b_pad, n_pad]; values int8 [n_pad, m_pad]; scales fp32
// [n_pad/64, m_pad]; out [b_pad, m_pad] of out_kind (0 fp32, 1 bf16, 2
// fp16).  bm is the rows of a block: 16 takes the decode kernel (b_pad a
// multiple of 16); 256 the prefill kernel's 256 x 128 blocks and 128 its
// 128 x 256 blocks (m_pad a multiple of 256), with b_pad a multiple of 64
// and the ragged last row tile masked.  The caller picks the layout and the
// K split.  n_pad is a multiple of 64 and m_pad of 128.  ksplit > 1 needs
// workspace fp32 [ksplit, b_pad, m_pad].
extern "C" int int8_matmul_bf16(const void* x, const void* values, const void* scales, void* out,
                                void* workspace, int b_pad, int n_pad, int m_pad, int bm,
                                int ksplit, int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows_ok = bm == 16 ? b_pad % 16 == 0
                                : (bm == 256 || (bm == 128 && m_pad % 256 == 0)) && b_pad % 64 == 0;
  if (!rows_ok || n_pad % BK || m_pad % BN || ksplit < 1 || out_kind < 0 || out_kind > 2 ||
      (ksplit > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nkb = n_pad / BK;
  const int per = (nkb + ksplit - 1) / ksplit;
  void* dst = ksplit > 1 ? workspace : out;
  const int kind = ksplit > 1 ? 0 : out_kind;
  const size_t stride = (size_t)b_pad * m_pad;
  int rc = 0;
  if (bm == 16) launch<16>(x, values, scales, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  else if (bm == 256)
    rc = launch_prefill<128, 4>(x, values, scales, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  else rc = launch_prefill<256, 2>(x, values, scales, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  if (rc) return rc;
  if (ksplit > 1) gemm::splitk_reduce(static_cast<const float*>(workspace), out, ksplit, stride, out_kind, s);
  return (int)cudaGetLastError();
}
