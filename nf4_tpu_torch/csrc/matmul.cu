// Fused 4-bit dequant-matmul for bf16 activations (kernel B):
// y[B, m] = x[B, n] . W^T[n, m], W kept packed in device memory.
//
// Replaces: nf4_tpu/ops/matmul.py:_matmul_pallas_bf16 (kernel body
// _make_bytetable_kernel).
//
// Computes: each weight value is bf16(bf16(code[nibble]) * bf16(scale)),
// the values the TPU kernel feeds its matrix unit, then a bf16 product with
// fp32 accumulation, stored as fp32, bf16 or fp16 (fp16 and bf16 rounded
// once from the fp32 sum).  The decode goes through a 256-entry table that
// maps a byte to both nibbles' bf16 code bits in one 32-bit word (low half
// = K row 2j, high half = K row 2j+1: the layout's own order) and one
// bf16x2 multiply by the column's bf16 scale.
//
// Bound on the H100: at decode (B <= 16) bytes: the packed weights and
// their scales (0.5625 bytes per weight) are read once and each byte feeds
// only 4*B flops, far below the ~295 flops per byte at which the tensor
// cores become the limit.  At prefill (B in the hundreds or more)
// operations, 989 TFLOP/s bf16, reachable only through wgmma.
//
// Two kernels, both with the K loop inside the block (blocks run in any
// order; nothing is carried between them) and, where the output tiles
// alone cannot fill the card, K split across blocks with fp32 partials
// summed in a fixed order by a second pass (deterministic, no atomics):
// * Decode (bm = 16): 16 rows x 128 columns per block of 4 warps, WMMA
//   bf16 16x16x16; the next step's bytes, scales and activations load into
//   registers while the current step multiplies.
// * Prefill (bm = 64: b_pad a multiple of 64): a pipelined wgmma
//   dequant-GEMM, the main loop of dequant_gemm.cuh (shared with kernels D
//   and E; its note describes the ring, the TMA load of x and the overlap
//   of decode and products) with this file's decode.  A block computes 256
//   rows x 128 columns (4 consumer warpgroups) or 128 rows x 256 columns
//   (2), each warpgroup 64 rows with wgmma.m64nBNk16; the caller picks the
//   layout (ops/matmul.py:_prefill_rows).  The decode's cost per product
//   falls with the rows that share a weight tile, so prompts of more than
//   128 rows take the 256-row blocks (registers cap a warpgroup's
//   accumulators at 128 columns when 4 share an SM); up to 128 rows, the
//   128-row blocks multiply fewer zero rows.  A K step is 64 rows = one
//   scale row = 32 packed rows, decoded through 32 bank-private copies of
//   the byte table into bf16 W^T tiles written K-major (each byte is one
//   32-bit word of K rows 2j and 2j+1 of its column), so W needs no
//   transpose flag.  Each weight tile is decoded once per 128 or 256 rows
//   (the WMMA design decoded it once per 64).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "dequant_gemm.cuh"
#include "gemm_common.cuh"
#include "hopper.cuh"

using namespace gemm;
using namespace nvcuda;

namespace {

// The decode kernel (BM = 16).  out_kind 0/1/2 = fp32/bf16/fp16 written at
// out + blockIdx.z * split_stride.
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

// The prefill kernel's Op for the shared main loop (dequant_gemm.cuh): BN
// columns and WGS consumer warpgroups of 64 rows per block, K steps of 64
// rows = one scale row = 32 packed rows.  The decode table lives in shared
// memory as 32 copies, entry e of copy l at word 32e + l, so that lane l's
// lookups never share a bank with another lane's (one table serializes
// each warp's 32 random lookups several ways: 10-13% more time at B=1024,
// utils/kernel_variants.py).
template <int BN_, int WGS>
struct Nf4Bf16 : dg::Bf16Op<BN_, WGS> {
  using Base = dg::Bf16Op<BN_, WGS>;
  using Base::BN, Base::THREADS, Base::CW, Base::UNITS;
  static constexpr int RAW_BYTES = (BK / 2) * BN;
  static constexpr int AUX_BYTES = 256 * 32 * 4;

  static __device__ __forceinline__ void init_aux(unsigned char* aux, const void* table, int tid) {
    for (int i = tid; i < 256 * 32; i += THREADS)
      reinterpret_cast<uint32_t*>(aux)[i] = static_cast<const uint32_t*>(table)[i / 32];
  }

  // Packed row r's 16-byte pieces are XOR-swizzled by r / 4, so the decode's
  // reads (8 row groups x 4 neighbouring words per warp) miss no bank.
  static __device__ __forceinline__ void load_raw(uint32_t raw, uint32_t sc, const uint8_t* packed,
                                                  const float* scales, int kb, int n0, int m_pad, int tid) {
    for (int idx = tid; idx < (BK / 2) * (BN / 16); idx += THREADS) {
      const int r = idx / (BN / 16), q = idx % (BN / 16);
      const uint8_t* src = packed + (size_t)(kb * (BK / 2) + r) * m_pad + n0 + q * 16;
      hop::cp_async16(raw + r * BN + ((q ^ ((r / 4) & 7)) << 4), src, true);
    }
    if (tid < BN / 4) hop::cp_async16(sc + tid * 16, scales + (size_t)kb * m_pad + n0 + tid * 4, true);
  }

  // A thread takes row group c (packed rows 4c..4c+3 = K rows 8c..8c+7) of
  // CW neighbouring columns and writes each column's 16-byte piece c: each
  // byte is one 32-bit word of K rows 2j and 2j+1 (low half = low nibble).
  static __device__ __forceinline__ void decode(const unsigned char* ps, const float* ss, unsigned char* ws,
                                                const unsigned char* aux, int tid) {
    const uint32_t* lut = reinterpret_cast<const uint32_t*>(aux);
    const int warp = tid / 32, lane = tid % 32;
    const int c = lane / 4;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int col = ((u * (THREADS / 32) + warp) * 4 + lane % 4) * CW;  // first of the CW columns
      uint32_t pw[4];
      float sf[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const unsigned char* src = ps + (4 * c + r) * BN + (((col / 16) ^ c) << 4) + (col % 16);
        pw[r] = CW == 4 ? *reinterpret_cast<const uint32_t*>(src) : *reinterpret_cast<const uint16_t*>(src);
      }
      if constexpr (CW == 4) {
        const float4 sv = *reinterpret_cast<const float4*>(ss + col);
        sf[0] = sv.x, sf[1] = sv.y, sf[2] = sv.z, sf[3] = sv.w;
      } else {
        const float2 sv = *reinterpret_cast<const float2*>(ss + col);
        sf[0] = sv.x, sf[1] = sv.y;
      }
#pragma unroll
      for (int e = 0; e < CW; ++e) {
        const __nv_bfloat162 s2 = __bfloat162bfloat162(__float2bfloat16_rn(sf[e]));
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t word = lut[((pw[r] >> (8 * e)) & 0xff) * 32 + lane];
          __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&word), s2);
          w[r] = *reinterpret_cast<uint32_t*>(&v);
        }
        *reinterpret_cast<uint4*>(ws + hop::swz(col + e, c, 128)) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};

template <int BN, int WGS>
int launch_prefill(const void* x, const void* packed, const void* scales, const void* table, void* dst,
                   int b_pad, int n_pad, int m_pad, int kb_per_split, int ksplit, size_t stride, int kind,
                   cudaStream_t stream) {
  using Op = Nf4Bf16<BN, WGS>;
  CUtensorMap x_map;
  const int rc = dg::x_tensor_map(&x_map, x, 2, b_pad, n_pad, Op::PM);
  if (rc) return rc;
  return dg::launch<Op>(x_map, packed, scales, table, dst, b_pad, n_pad, m_pad, kb_per_split, ksplit, stride,
                        kind, stream);
}

}  // namespace

// x bf16 [b_pad, n_pad]; packed u8 [n_pad/2, m_pad]; scales fp32
// [n_pad/64, m_pad]; table u32 [256]; out [b_pad, m_pad] of out_kind
// (0 fp32, 1 bf16, 2 fp16).  bm is the rows of a block: 16 takes the
// decode kernel (b_pad a multiple of 16); 256 the prefill kernel's 256 x
// 128 blocks and 128 its 128 x 256 blocks (m_pad a multiple of 256), with
// b_pad a multiple of 64 and the ragged last row tile masked.  The caller
// picks the layout and the K split.  n_pad is a multiple of 64 and m_pad of
// 128.  ksplit > 1 needs workspace fp32 [ksplit, b_pad, m_pad].
extern "C" int nf4_matmul_bf16(const void* x, const void* packed, const void* scales,
                               const void* table, void* out, void* workspace, int b_pad,
                               int n_pad, int m_pad, int bm, int ksplit, int out_kind,
                               void* stream) {
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
  if (bm == 16) launch<16>(x, packed, scales, table, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  else if (bm == 256)
    rc = launch_prefill<128, 4>(x, packed, scales, table, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  else rc = launch_prefill<256, 2>(x, packed, scales, table, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  if (rc) return rc;
  if (ksplit > 1) gemm::splitk_reduce(static_cast<const float*>(workspace), out, ksplit, stride, out_kind, s);
  return (int)cudaGetLastError();
}
