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
//   dequant-GEMM.  A block of consumer warpgroups computes 256 rows x 128
//   columns (4 warpgroups) or 128 rows x 256 columns (2 warpgroups), each
//   warpgroup 64 rows with wgmma.m64nBNk16 and its accumulators in
//   registers; the caller picks the layout (ops/matmul.py:_prefill_rows).
//   The decode's cost per product falls with the rows that share a weight
//   tile, so prompts of more than 128 rows take the 256-row blocks
//   (registers cap a warpgroup's accumulators at 128 columns when 4 share
//   an SM); up to 128 rows, the 128-row blocks multiply fewer zero rows.
//   A K step is 64 rows = one scale row = 32 packed rows.  A 4-stage ring
//   holds, three steps ahead, the x tile (one TMA copy per step, started by
//   one thread, K-major and 128-byte swizzled: the layout wgmma reads) and
//   the packed rows and scales (cp.async).  While the asynchronous wgmma of step s runs, the threads decode
//   step s+1's packed rows (through 32 bank-private copies of the byte
//   table) into the other of two bf16 W^T tiles, written K-major (each
//   byte is one 32-bit word of K rows 2j and 2j+1 of its column) under the
//   same swizzle, so W needs no transpose flag.  Each weight tile is
//   decoded once per 128 or 256 rows (the WMMA design decoded it once per
//   64), and the ragged last row tile is zero-filled by the copies and
//   masked at the store.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// The prefill kernel's tiling and shared memory: two bf16 W^T tiles [BN
// columns][64 K] and STAGES ring stages of the x tile [PM rows][64 K]
// (1024-byte aligned, 128-byte rows), the packed rows [32][BN] and the
// scales [BN]; then 32 copies of the byte table, entry e of copy l at word
// 32e + l, so that lane l's lookups never share a bank with another lane's
// (one table serializes each warp's 32 random lookups several ways: 10-13%
// more time at B=1024, utils/kernel_variants.py).
constexpr int STAGES = 4;

// BN columns and WGS consumer warpgroups of 64 rows per block.
template <int BN, int WGS>
struct Prefill {
  static constexpr int PM = 64 * WGS;  // rows per block
  static constexpr int THREADS = 128 * WGS;
  // Columns per decode unit: a unit is 4 packed rows of CW columns, and
  // the block's 8 x BN / CW units are spread evenly over its threads.
  static constexpr int CW = 8 * BN / THREADS >= 4 ? 4 : 2;
  static constexpr int UNITS = 8 * BN / CW / THREADS;
  static constexpr int W = 0;
  static constexpr int W_BYTES = BN * BK * 2;
  static constexpr int W_TILES = 2;
  static constexpr int X = W_TILES * W_BYTES;
  static constexpr int X_BYTES = PM * BK * 2;
  static constexpr int P = X + STAGES * X_BYTES;
  static constexpr int P_BYTES = (BK / 2) * BN;
  static constexpr int SC = P + STAGES * P_BYTES;
  static constexpr int LUT = SC + STAGES * BN * 4;
  static constexpr int MBAR = LUT + 256 * 32 * 4;  // one mbarrier per ring stage (the x tile's TMA)
  static constexpr int BYTES = MBAR + STAGES * 8 + 1024;  // + alignment slack
  static constexpr int ACC = BN / 2;  // fp32 accumulators per thread
};

template <int BN, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
nf4_matmul_bf16_wgmma(const __grid_constant__ CUtensorMap x_map, const uint8_t* __restrict__ packed,
                      const float* __restrict__ scales, const uint32_t* __restrict__ table,
                      void* __restrict__ out, int b_pad, int n_pad, int m_pad, int kb_per_split,
                      size_t split_stride, int out_kind) {
  using L = Prefill<BN, WGS>;
  constexpr int PM = L::PM, P_THREADS = L::THREADS, CW = L::CW;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // The swizzled tiles need 1024-byte alignment: round the base up (the
  // allocation has 1 KB to spare).
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = hop::smem_u32(smem);
  const uint32_t* lut = reinterpret_cast<const uint32_t*>(smem + L::LUT);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;
  // Row tiles run fastest, so the blocks that share a weight tile run
  // together and its bytes come from device memory once.
  const int m0 = blockIdx.x * PM, n0 = blockIdx.y * BN;
  const int nkb = n_pad / BK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nk = max(0, min(nkb, kb0 + kb_per_split) - kb0);

  // Start the copies of K step i (global step kb0 + i) into ring stage i %
  // STAGES: the x tile by one TMA (rows past b_pad zero-filled, written in
  // the 128-byte swizzle), completing on the stage's mbarrier; the packed
  // rows and scales by cp.async.
  const uint32_t mbar = sbase + L::MBAR;
  auto load = [&](int i) {
    const int kb = kb0 + i, st = i % STAGES;
    if (tid == 0) {
      hop::mbar_arrive_expect_tx(mbar + st * 8, L::X_BYTES);
      hop::tma_load_2d(sbase + L::X + st * L::X_BYTES, &x_map, kb * BK, m0, mbar + st * 8);
    }
    // Packed row r's 16-byte pieces are XOR-swizzled by r / 4, so the decode's
    // reads (8 row groups x 4 neighbouring words per warp) miss no bank.
    for (int idx = tid; idx < (BK / 2) * (BN / 16); idx += P_THREADS) {
      const int r = idx / (BN / 16), q = idx % (BN / 16);
      const uint8_t* src = packed + (size_t)(kb * (BK / 2) + r) * m_pad + n0 + q * 16;
      hop::cp_async16(sbase + L::P + st * L::P_BYTES + r * BN + ((q ^ ((r / 4) & 7)) << 4), src, true);
    }
    if (tid < BN / 4)
      hop::cp_async16(sbase + L::SC + st * BN * 4 + tid * 16, scales + (size_t)kb * m_pad + n0 + tid * 4, true);
  };

  // Decode step i's packed rows into W^T tile `wb`: a thread takes row group
  // c (packed rows 4c..4c+3 = K rows 8c..8c+7) of CW neighbouring columns
  // and writes each column's 16-byte piece c.
  auto decode = [&](int i, int wb) {
    const int st = i % STAGES;
    const unsigned char* ps = smem + L::P + st * L::P_BYTES;
    const float* ss = reinterpret_cast<const float*>(smem + L::SC + st * BN * 4);
    unsigned char* ws = smem + L::W + wb * L::W_BYTES;
    const int c = lane / 4;
#pragma unroll
    for (int u = 0; u < L::UNITS; ++u) {
      const int col = ((u * (P_THREADS / 32) + warp) * 4 + lane % 4) * CW;  // first of the CW columns
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
  };

  // The accumulators: no instruction but wgmma may touch them while a
  // product is in flight (ptxas would serialize the products), so they are
  // fenced only before the first and after the last.
  float acc[L::ACC];
#pragma unroll
  for (int j = 0; j < L::ACC; ++j) acc[j] = 0.f;
  hop::fence_regs(acc);

  for (int i = tid; i < 256 * 32; i += P_THREADS) reinterpret_cast<uint32_t*>(smem + L::LUT)[i] = table[i / 32];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) hop::mbar_init(mbar + s * 8, 1);
    hop::fence_mbar_init();
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    hop::cp_async_commit();
  }
  hop::cp_async_wait<STAGES - 2>();  // step 0 landed
  if (nk > 0) hop::mbar_wait(mbar, 0);
  __syncthreads();
  if (nk > 0) decode(0, 0);
  hop::fence_proxy_async();
  __syncthreads();

  for (int i = 0; i < nk; ++i) {
    // Step i's products, asynchronous: x stage i % STAGES, W^T tile i % 2.
    hop::wgmma_fence();
    const uint32_t xa = sbase + L::X + (i % STAGES) * L::X_BYTES + wg * (64 * 128);
    const uint32_t wa = sbase + L::W + (i % L::W_TILES) * L::W_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (BN == 256) hop::wgmma_m64n256k16(acc, hop::wgmma_desc(xa + kk * 32), hop::wgmma_desc(wa + kk * 32), 1);
      else hop::wgmma_m64n128k16(acc, hop::wgmma_desc(xa + kk * 32), hop::wgmma_desc(wa + kk * 32), 1);
    }
    hop::wgmma_commit();

    // While step i multiplies: step i+1 landed (every thread's copies; the
    // barrier also means every warpgroup finished step i-1's products), so
    // decode it into the W^T tile step i-1 read and refill the ring stage
    // step i-1 read with step i+3.
    if (i + 1 < nk) {
      hop::cp_async_wait<STAGES - 3>();
      hop::mbar_wait(mbar + ((i + 1) % STAGES) * 8, ((i + 1) / STAGES) & 1);
    }
    __syncthreads();
    if (i + 1 < nk) decode(i + 1, (i + 1) % L::W_TILES);
    if (i + STAGES - 1 < nk) load(i + STAGES - 1);
    hop::cp_async_commit();
    hop::wgmma_wait<0>();
    hop::fence_proxy_async();
    __syncthreads();
  }
  hop::fence_regs(acc);
  hop::cp_async_wait<0>();

  // Epilogue straight from the accumulators: fragment j holds rows g and
  // g+8 of this warp's 16, columns 8j + 2*(lane % 4) and the next.
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  void* dst = out_kind == 0 ? static_cast<void*>(static_cast<float*>(out) + blockIdx.z * split_stride) : out;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= b_pad) continue;
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      const size_t idx = (size_t)row * m_pad + col;
      if (out_kind == 0) {
        *reinterpret_cast<float2*>(static_cast<float*>(dst) + idx) = make_float2(a, b);
      } else if (out_kind == 1) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(dst) + idx) = __floats2bfloat162_rn(a, b);
      } else {
        *reinterpret_cast<__half2*>(static_cast<__half*>(dst) + idx) = __floats2half2_rn(a, b);
      }
    }
  }
}

// The TMA descriptor of x [b_pad, n_pad] bf16 for boxes of 64 K x `rows`
// rows under the 128-byte swizzle.  cuTensorMapEncodeTiled lives in
// libcuda; it is reached through the runtime's entry-point query, so the
// library links only the CUDA runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int x_tensor_map(CUtensorMap* map, const void* x, int b_pad, int n_pad, int rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return err != cudaSuccess ? (int)err : (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)n_pad, (cuuint64_t)b_pad};
  const cuuint64_t strides[1] = {(cuuint64_t)n_pad * 2};
  const cuuint32_t box[2] = {BK, (cuuint32_t)rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, int WGS>
int launch_prefill(const void* x, const void* packed, const void* scales, const void* table, void* dst,
                   int b_pad, int n_pad, int m_pad, int kb_per_split, int ksplit, size_t stride, int kind,
                   cudaStream_t stream) {
  using L = Prefill<BN, WGS>;
  CUtensorMap x_map;
  const int rc = x_tensor_map(&x_map, x, b_pad, n_pad, L::PM);
  if (rc) return rc;
  static hop::SmemOptIn opt_in;
  const cudaError_t err = opt_in(reinterpret_cast<const void*>(nf4_matmul_bf16_wgmma<BN, WGS>), L::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((b_pad + L::PM - 1) / L::PM, m_pad / BN, ksplit);
  nf4_matmul_bf16_wgmma<BN, WGS><<<grid, L::THREADS, L::BYTES, stream>>>(
      x_map, static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const uint32_t*>(table), dst, b_pad, n_pad, m_pad,
      kb_per_split, stride, kind);
  return 0;
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
