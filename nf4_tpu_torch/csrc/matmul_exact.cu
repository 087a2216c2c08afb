// Fused 4-bit dequant-matmul for fp32 and fp16 activations (kernel E):
// y[B, m] = x[B, n] . W^T[n, m] in fp32, W kept packed in device memory.
//
// Replaces: nf4_tpu/ops/matmul.py:_matmul_pallas_exact (kernel body
// _make_exact_kernel).
//
// Computes: fp16 x is upcast to fp32 (lossless).  Each weight value is the
// oracle's fp32 product code[nibble] * scale (kernel A's values, before any
// rounding); the product is fp32 with fp32 accumulation, stored as fp32, or
// rounded once to bf16 or fp16.  The TPU kernel contracts at
// Precision.HIGHEST, itself a multi-pass bf16 emulation of fp32 there; the
// port holds the contract by tolerance: within 1e-5 of the largest output
// for fp32 out (ops/matmul.py:_matmul_exact_plain, a true fp32 product, is
// the reference).
//
// Bound: at decode (B <= 16) bytes: the packed weights and their scales
// (0.5625 bytes per weight) are read once and each byte feeds 4*B flops.
// At B in the hundreds operations: 2*B*n*m fp32 flops.  The card's fp32
// FFMA rate (67 TFLOP/s) bounds any SIMT kernel at 6.667 ms per Llama-3-8B
// layer at B=1024, above cuBLAS's SGEMM (8.67 ms); only the tensor cores go
// lower, and they have no full-fp32 mode.  3xTF32 products on the tensor
// cores hold the fp32 contract in both kernels:
// * Decode (bm = 16): 3xTF32 on mma.sync m16n8k8 with the weights as the
//   A operand, on kernel B's decode design (decode_mma.cuh: the column
//   mapping, 4 warps on the same 128 columns over interleaved scale blocks,
//   the warp vote that skips all-zero batch rows 8-15, and its epilogue,
//   dm::finish, in which the split that finishes last sums the K-split
//   partials in split order: one launch per product).  It is a kernel of
//   its own (ed::decode_kernel), not a Dec of decode_mma.cuh's: its loop
//   runs the m-tiles outside the K steps (below), its scales come through
//   the ring and its x is split in registers, so B's and D's loop is left
//   as it was.  In scale block kb lane (g, t) copies packed rows 32kb + 8t
//   .. +7 at its 16 columns 16g .. 16g+15 (kernel B's pieces, by per-lane
//   cp.async into a 4-stage ring) and a quarter of its group's 16 scales,
//   and K step s = 0..7 takes packed row 8t + s: for m-tile mt the A
//   elements a0/a2 are the low/high nibble (K rows 16t + 2s, +1: the mma's
//   K slots t, t + 4) of the byte at column 16g + 2mt and a1/a3 those of
//   column 16g + 2mt + 1.  So x's B operand is a contiguous fp32 pair of
//   each batch row, and the C fragments are kernel B's.  Each A element is
//   code[nibble] * scale in fp32 (kernel A's value; the 16 code values in
//   shared memory, 16 banks) split into hi (tf32) and lo = v - hi (hi + lo
//   is the value bit for bit; the tensor cores read lo's top 11
//   significant bits, within 2^-21 of it).  A scale block is
//   taken in two halves of 4 K steps: x (fp32 or fp16, from L2 one scale
//   block ahead) is split into hi and lo once per half, and the m-tile
//   loop runs outside the K-step loop, so a half block's products sum from
//   0 in one 4-register fragment per n8 tile and are added to the running
//   sums by round-to-nearest adds (the tensor cores truncate their
//   accumulator), as the prefill's 32-row step sums.  Whole scale blocks
//   held 64 split x values and their successors' 32 in registers, and
//   spilled at 255.  Shared memory: a 4 x 4736-byte ring per warp and the
//   code table, 75,840 bytes.
// * Prefill (bm = 128, b_pad a multiple of 64): 3xTF32 on wgmma, the main
//   loop of dequant_gemm.cuh (kernel B's: x by TMA into a 4-stage ring, the
//   decode of step s+1 under the products of step s) in 128 x 128 blocks of
//   2 consumer warpgroups.  Each fp32 operand is split into two tf32 values
//   v = hi + lo, hi = rna(v), lo = rna(v - hi) (rounded explicitly: the
//   tensor cores would truncate), and three products x_lo.w_hi +
//   x_hi.w_lo + x_hi.w_hi, the small terms first, sum into an fp32
//   accumulator that starts from 0 at each K step and is added to the
//   running sum with round-to-nearest fp32 adds (the tensor cores truncate
//   their accumulator: one accumulator over all of K drifted to 1.7e-5 of
//   the largest output at K=4096); x_lo.w_lo (~2^-22 of the product) is
//   dropped.  Each
//   product's relative error is about 2^-21, far inside 1e-5.  fp16 x is
//   exact in tf32 (x_lo = 0), so it takes two products.  The bound drops to
//   3 x 2*B*n*m at 495 TFLOP/s tf32: 2.71 ms per layer at B=1024.  A
//   pre-pass in this file splits x once into fp32 x_hi and x_lo ([2, b_pad,
//   n_pad], ~0.05 ms at B=1024), so the main loop loads both by TMA.  tf32
//   has no transpose flag, so both operands are K-major: a 128-byte swizzle
//   row holds 32 fp32 K values, so a K step is 32 rows (half a scale row,
//   16 packed rows), and the decode writes w_hi and w_lo tiles (K-major,
//   swizzled) from the packed ring, each byte giving K rows 2j and 2j+1 of
//   its column.  Shared memory: x ring 4 x 32 KB (hi and lo; fp16 x 4 x 16
//   KB), W^T tiles 2 x 32 KB, packed and scale rings 10 KB.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_mma.cuh"
#include "dequant_gemm.cuh"
#include "gemm_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BK = gemm::BK;      // 64 K rows: one scale block
constexpr int BN = gemm::BN;      // 128 output columns per block

__device__ __forceinline__ float4 load_x4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The decode kernel (bm = 16): decode_mma.cuh's mapping, warps and
// epilogue (dm::finish) with 3xTF32 products on mma.sync m16n8k8.
namespace ed {

using dm::COLS, dm::MT, dm::ROWS, dm::THREADS, dm::WCOLS, dm::WK, dm::WN;

constexpr int PIECES = 8;   // packed rows (16-byte pieces) a lane copies per scale block
constexpr int STEPS = 4;    // K steps of 8 rows (one packed row of the lane's) per half scale block
constexpr int STAGES = 4;   // scale blocks in a warp's ring
constexpr bool BULK = false;  // each lane copies its own pieces (not the warp's rows by bulk copies)
constexpr int SC_LD = 80;   // per lane: bytes from one lane group's 16 scales to the next's in a slot
// A warp's slot (one scale block): its weight rows (per lane: piece r of
// lane l at 512r + 16l; bulk copies: row k at ROW_LD k + 32 (k / PIECES), as
// kernel D's), then its scales (per lane: group g's 16 at SC_LD g; bulk
// copies: the 128 columns' in a row).  After the ring: the code table and
// (bulk copies) one mbarrier per warp and stage.
constexpr int PIECE_LD = BULK ? dm::ROW_LD : 512;  // from one of a lane's pieces to the next
constexpr int SCALE_OFF = BULK ? dm::ROW_LD * 4 * PIECES + 32 * 3 : PIECES * 512;
constexpr int SLOT_BYTES = SCALE_OFF + (BULK ? 4 * WCOLS : 8 * SC_LD);
constexpr int RING_BYTES = dm::WARPS * STAGES * SLOT_BYTES;
constexpr int USED_BYTES = RING_BYTES + 64 + (BULK ? dm::WARPS * STAGES * 8 : 0);
constexpr int SMEM_BYTES = USED_BYTES > dm::STAGING_BYTES ? USED_BYTES : dm::STAGING_BYTES;

// An A element: the nibble at bit sh of word (a constant once the caller's
// loops are unrolled) through the code table at lut, times the column's
// scale (kernel A's fp32 value v), split into hi, v with its 13 low bits
// cleared (tf32), and lo = v - hi (exact: hi + lo is v bit for bit; the
// tensor cores read lo's top 11 significant bits, within 2^-21 of v).  Three
// instructions fewer per element than rounding both halves to nearest (the
// prefill's split), 14% less time (utils/kernel_variants.py).
__device__ __forceinline__ void weight(uint32_t& hi, uint32_t& lo, uint32_t word, int sh, float scale,
                                       const unsigned char* lut) {
  const uint32_t off = (sh >= 2 ? word >> (sh - 2) : word << (2 - sh)) & 0x3Cu;  // 4 x the nibble
  const float v = __fmul_rn(*reinterpret_cast<const float*>(lut + off), scale);
  hi = __float_as_uint(v) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

// K step s's products for one n8 tile of batch rows, the small terms first:
// x_lo . w_hi, x_hi . w_lo, x_hi . w_hi (fp16 x has no x_lo).  xh and xl
// hold the tile row's 8 K rows of a half scale block; slots t and t + 4 are
// its K rows 2s and 2s + 1.
template <bool XLO>
__device__ __forceinline__ void products(float (&f)[4], const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                         const uint32_t (&xh)[2 * STEPS], const uint32_t (&xl)[2 * STEPS], int s) {
  if constexpr (XLO) hop::mma_tf32_1688(f, hi, xl[2 * s], xl[2 * s + 1]);
  hop::mma_tf32_1688(f, lo, xh[2 * s], xh[2 * s + 1]);
  hop::mma_tf32_1688(f, hi, xh[2 * s], xh[2 * s + 1]);
}

// x fp32 or fp16 [b_pad, n_pad].  gridDim.z > 1: split blockIdx.z of the
// K range writes its fp32 partial to work, and the split that comes last
// sums them into out (dm::finish).
template <typename XT>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed, const float* __restrict__ scales,
              const float* __restrict__ code, void* __restrict__ out, float* __restrict__ work,
              int* __restrict__ counters, int n_pad, int m_pad, int kb_per_split, int out_kind) {
  constexpr bool XLO = sizeof(XT) == 4;  // fp16 x is exact in tf32: no low half
  constexpr int XH = sizeof(XT) / 2;     // 16-byte vectors of a batch row's 8 K values
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * COLS + (warp % WN) * WCOLS, r0 = blockIdx.y * ROWS;
  const int kb0 = blockIdx.z * kb_per_split + warp / WN;
  const int kb1 = min(n_pad / BK, (int)(blockIdx.z + 1) * kb_per_split);
  const int cnt = n0 < m_pad && kb0 < kb1 ? (kb1 - kb0 + WK - 1) / WK : 0;

  // This lane's sources in scale block kb: packed rows 32kb + 8t + r at
  // columns n0 + 16g .. +15 and the scales of columns n0 + 16g + 4t .. +3
  // (the four lanes of group g copy its 16, SC_LD bytes apart by group: no
  // bank conflict on the reads); bulk copies: packed row 32kb + lane and
  // (lane 0) the scales at columns n0 .. +127.  x rows r0 + g and r0 + 8 + g
  // at K rows 64kb + 16t .. +15.
  const uint8_t* pk = packed + (size_t)(BULK ? lane : PIECES * t) * m_pad + n0 + (BULK ? 0 : 16 * g);
  const float* sc = scales + n0 + (BULK ? 0 : 16 * g + 4 * t);
  const XT* xa = x + (size_t)(r0 + g) * n_pad + 16 * t;
  const XT* xb = xa + (size_t)8 * n_pad;
  const int warp_off = warp * STAGES * SLOT_BYTES;
  const uint32_t ring = hop::smem_u32(smem) + warp_off;
  // This lane's first piece in a slot and its group's scales.
  const unsigned char* pieces = smem + warp_off + (BULK ? dm::ROW_LD * PIECES * t + 32 * t + 16 * g : 16 * lane);
  const unsigned char* scale_row = smem + warp_off + SCALE_OFF + (BULK ? 64 * g : SC_LD * g);
  const unsigned char* lut = smem + RING_BYTES;  // the 16 fp32 code values: 16 banks
  const uint32_t bars = hop::smem_u32(smem + RING_BYTES + 64) + warp * STAGES * 8;
  if constexpr (BULK) {
    if (lane == 0) {
#pragma unroll
      for (int st = 0; st < STAGES; ++st) hop::mbar_init(bars + st * 8, 1);
      hop::fence_mbar_init();
    }
    __syncwarp();
  }

  auto issue = [&](int i) {
    if (i < cnt) {
      const int kb = kb0 + i * WK;
      const uint8_t* src = pk + (size_t)kb * (4 * PIECES) * m_pad;
      const uint32_t dst = ring + (i % STAGES) * SLOT_BYTES;
      if constexpr (BULK) {
        const uint32_t bar = bars + (i % STAGES) * 8;
        __syncwarp();  // every lane is done reading the slot
        if (lane == 0) {
          hop::mbar_arrive_expect_tx(bar, (4 * PIECES + 4) * WCOLS);
          hop::bulk_copy(dst + SCALE_OFF, sc + (size_t)kb * m_pad, 4 * WCOLS, bar);
        }
        hop::bulk_copy(dst + dm::ROW_LD * lane + 32 * (lane / PIECES), src, WCOLS, bar);
      } else {
#pragma unroll
        for (int r = 0; r < PIECES; ++r) hop::cp_async16(dst + r * 512 + 16 * lane, src + (size_t)r * m_pad, true);
        hop::cp_async16(dst + SCALE_OFF + SC_LD * g + 16 * t, sc + (size_t)kb * m_pad, true);
      }
    }
    if constexpr (!BULK) hop::cp_async_commit();
  };
  // x one scale block ahead, by halves: xn[h] = K rows 64kb + 16t + 8h ..
  // +7 of batch rows r0 + g (vectors 0 .. XH-1) and r0 + 8 + g (XH ..).
  uint4 xn[2][2 * XH];
  auto load_x = [&](int i, int h) {
    if (i < cnt) {
      const int kb = kb0 + i * WK;
      const uint4* pa = reinterpret_cast<const uint4*>(xa + kb * BK) + h * XH;
      const uint4* pb = reinterpret_cast<const uint4*>(xb + kb * BK) + h * XH;
#pragma unroll
      for (int q = 0; q < XH; ++q) xn[h][q] = __ldg(pa + q), xn[h][XH + q] = __ldg(pb + q);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  load_x(0, 0);
  load_x(0, 1);
  if (tid < 16) reinterpret_cast<float*>(smem + RING_BYTES)[tid] = __ldg(code + tid);
  __syncthreads();  // the code table is in place

  for (int i = 0; i < cnt; ++i) {
    if constexpr (BULK) {
      hop::mbar_wait(bars + (i % STAGES) * 8, (i / STAGES) & 1);  // the warp's rows of step i
    } else {
      hop::cp_async_wait<STAGES - 2>();  // this lane's copies of step i have landed
      __syncwarp();                      // and so have the other lanes' (a group's scales come from four)
    }
    // Batch rows 8-15 all zero in this scale block (decode batches of up to
    // 8 rows): their n8 tile's products would add exact zeros, so they are
    // skipped (the weights are finite).
    uint32_t any = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = XH; q < 2 * XH; ++q) any |= xn[h][q].x | xn[h][q].y | xn[h][q].z | xn[h][q].w;
    const bool rows_hi = __any_sync(0xffffffffu, any != 0);
    issue(i + STAGES - 1);  // into the slot step i - 1 read
    const int slot = (i % STAGES) * SLOT_BYTES;
    // Half h of the scale block: K steps 4h .. 4h+3.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // x as tf32 halves: xh[r][k] + xl[r][k] = batch row 8r + g, K row
      // 64kb + 16t + 8h + k.
      uint32_t xh[2][2 * STEPS], xl[2][2 * STEPS];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int k = 0; k < 2 * STEPS; ++k) {
          if constexpr (XLO) {
            const float v = reinterpret_cast<const float*>(xn[h])[2 * STEPS * r + k];
            xh[r][k] = hop::tf32_rna(v);
            xl[r][k] = hop::tf32_rna(__fsub_rn(v, __uint_as_float(xh[r][k])));
          } else {
            xh[r][k] = __float_as_uint(__half2float(reinterpret_cast<const __half*>(xn[h])[2 * STEPS * r + k]));
          }
        }
      load_x(i + 1, h);  // half a scale block's work to land
      // m-tiles 2w and 2w + 1: columns 16g + 4w .. +3, word w of each piece.
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float4 s4 = *reinterpret_cast<const float4*>(scale_row + slot + 16 * w);
        uint32_t pw[STEPS];
#pragma unroll
        for (int s = 0; s < STEPS; ++s)
          pw[s] = *reinterpret_cast<const uint32_t*>(pieces + slot + PIECE_LD * (STEPS * h + s) + 4 * w);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mt = 2 * w + e;
          const float s0 = e ? s4.z : s4.x, s1 = e ? s4.w : s4.y;  // columns 16g + 2mt (A row g), + 1 (A row g + 8)
          // The half block's products from 0, added to the sums below by
          // round-to-nearest adds: the tensor cores truncate their
          // accumulator.
          float f[2][4] = {};
#pragma unroll
          for (int s = 0; s < STEPS; ++s) {
            // Step 4h + s: packed row 8t + 4h + s, bytes 2e (A row g) and
            // 2e + 1 (A row g + 8); low nibbles in K slot t, high ones in
            // slot t + 4.
            uint32_t hi[4], lo[4];
            weight(hi[0], lo[0], pw[s], 16 * e, s0, lut);
            weight(hi[1], lo[1], pw[s], 16 * e + 8, s1, lut);
            weight(hi[2], lo[2], pw[s], 16 * e + 4, s0, lut);
            weight(hi[3], lo[3], pw[s], 16 * e + 12, s1, lut);
            products<XLO>(f[0], hi, lo, xh[0], xl[0], s);
            if (rows_hi) products<XLO>(f[1], hi, lo, xh[1], xl[1], s);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[mt][0][k] += f[0][k];
          if (rows_hi) {
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[mt][1][k] += f[1][k];
          }
        }
      }
    }
  }
  dm::finish(acc, out, work, counters, tid, blockIdx.x * COLS, r0, m_pad, out_kind);
}

template <typename XT>
cudaError_t opt_in() {
  static hop::SmemOptIn opt_in;
  return opt_in(reinterpret_cast<const void*>(&decode_kernel<XT>), SMEM_BYTES);
}

// One launch: b_pad a multiple of ROWS; ksplit > 1 needs work (fp32
// [ksplit, b_pad, m_pad]) and counters (int32, one per output tile, zero).
template <typename XT>
int launch(const void* x, const void* packed, const void* scales, const void* code, void* out, float* work,
           int* counters, int b_pad, int n_pad, int m_pad, int kb_per_split, int ksplit, int kind,
           cudaStream_t stream) {
  const cudaError_t err = opt_in<XT>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m_pad + COLS - 1) / COLS, b_pad / ROWS, ksplit);
  decode_kernel<XT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      static_cast<const float*>(code), out, work, counters, n_pad, m_pad, kb_per_split, kind);
  return 0;
}

template <typename XT>
int blocks_per_sm(int* blocks) {
  const cudaError_t err = opt_in<XT>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, decode_kernel<XT>, THREADS, SMEM_BYTES);
}

}  // namespace ed

// The pre-pass of the prefill kernel: x [n4 * 4] fp32 -> xs[0] = x_hi,
// xs[1] = x_lo, each rounded to tf32; fp16 x -> xs[0] = float(x) (exact in
// tf32).
__global__ void split_x_kernel(const float* __restrict__ x, float* __restrict__ xs, size_t n4) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    const float a[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      hi[k] = hop::tf32_rna(a[k]);
      lo[k] = hop::tf32_rna(__fsub_rn(a[k], __uint_as_float(hi[k])));
    }
    reinterpret_cast<uint4*>(xs)[i] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    reinterpret_cast<uint4*>(xs)[n4 + i] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

__global__ void split_x_kernel(const __half* __restrict__ x, float* __restrict__ xs, size_t n4) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += (size_t)gridDim.x * blockDim.x)
    reinterpret_cast<float4*>(xs)[i] = load_x4(x + 4 * i);
}

// cvt.rna.tf32.f32 by two integer instructions: add half the unit of the 13
// dropped bits to the magnitude, then clear them.  The same value for every
// finite v and for infinities (the decode's weights; 3-4% faster than the
// cvt there, utils/kernel_variants.py); the pre-pass keeps the cvt for x.
__device__ __forceinline__ uint32_t tf32_rna_int(float v) { return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u; }

// The prefill kernel's Op for the shared main loop: 128 x 128 blocks of 2
// consumer warpgroups, K steps of 32 rows.  XLO: fp32 x, whose x_lo tile
// follows x_hi's in each ring stage (rows b_pad.. of the split tensor).
template <bool XLO>
struct Nf4Tf32 {
  static constexpr int PM = 128, BN = 128, THREADS = 256, KS = 32;
  static constexpr int X_TILE = PM * 128;  // [PM rows][32 fp32]
  static constexpr int W_TILE = BN * 128;  // [BN columns][32 fp32]
  static constexpr int X_BYTES = (XLO ? 2 : 1) * X_TILE;
  static constexpr int W_BYTES = 2 * W_TILE;  // w_hi, then w_lo
  static constexpr int RAW_BYTES = (KS / 2) * BN;
  static constexpr int AUX_BYTES = 16 * 4;
  static constexpr int ACC = BN / 2;
  static constexpr bool STEP_SUMS = true;  // the tensor cores' truncation stays inside a step

  static __device__ __forceinline__ void init_aux(unsigned char* aux, const void* code, int tid) {
    if (tid < 16) reinterpret_cast<float*>(aux)[tid] = static_cast<const float*>(code)[tid];
  }

  static __device__ __forceinline__ void load_x(const CUtensorMap* map, uint32_t dst, uint32_t bar, int step,
                                                int m0, int b_pad) {
    hop::mbar_arrive_expect_tx(bar, X_BYTES);
    hop::tma_load_2d(dst, map, step * KS, m0, bar);
    if (XLO) hop::tma_load_2d(dst + X_TILE, map, step * KS, b_pad + m0, bar);
  }

  // Packed row r's 16-byte pieces are XOR-swizzled by r / 2 (a decode unit
  // reads 2 packed rows), so the decode's reads miss no bank.  The scale row
  // of K step s is s / 2.
  static __device__ __forceinline__ void load_raw(uint32_t raw, uint32_t sc, const uint8_t* packed,
                                                  const float* scales, int step, int n0, int m_pad, int tid) {
    if (tid < (KS / 2) * (BN / 16)) {
      const int r = tid / (BN / 16), q = tid % (BN / 16);
      const uint8_t* src = packed + (size_t)(step * (KS / 2) + r) * m_pad + n0 + q * 16;
      hop::cp_async16(raw + r * BN + ((q ^ ((r / 2) & 7)) << 4), src, true);
    }
    if (tid < BN / 4) hop::cp_async16(sc + tid * 16, scales + (size_t)(step / 2) * m_pad + n0 + tid * 4, true);
  }

  // A thread takes piece c (packed rows 2c, 2c+1 = K rows 4c..4c+3) of 4
  // neighbouring columns and writes each column's 16-byte piece c of w_hi
  // and of w_lo.  The 8 lanes of a quarter warp take the 8 pieces of the
  // same columns, so each 16-byte store of theirs lands in another chunk of
  // the swizzle (no bank conflict) and their ring reads in other chunks too.
  static __device__ __forceinline__ void decode(const unsigned char* ps, const float* ss, unsigned char* ws,
                                                const unsigned char* aux, int tid) {
    const float* code = reinterpret_cast<const float*>(aux);
    const int warp = tid / 32, lane = tid % 32;
    const int c = lane % 8;
    const int col = (warp * 4 + lane / 8) * 4;  // first of the 4 columns
    uint32_t pw[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      pw[r] = *reinterpret_cast<const uint32_t*>(ps + (2 * c + r) * BN + (((col / 16) ^ c) << 4) + (col % 16));
    const float4 sv = *reinterpret_cast<const float4*>(ss + col);
    const float sf[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // K row 4c + k: byte of packed row 2c + k/2, nibble k % 2
        const float v = __fmul_rn(code[(pw[k / 2] >> (8 * e + 4 * (k % 2))) & 0xF], sf[e]);
        hi[k] = tf32_rna_int(v);
        lo[k] = tf32_rna_int(__fsub_rn(v, __uint_as_float(hi[k])));
      }
      const uint32_t off = hop::swz(col + e, c, 128);
      *reinterpret_cast<uint4*>(ws + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(ws + W_TILE + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }

  // The step's products from 0 (its first has scale_d 0): the main loop adds
  // them to the running sum once they have landed.
  static __device__ __forceinline__ void mma(float (&acc)[ACC], uint32_t xs, int wg, uint32_t wt) {
    const uint32_t xh = xs + wg * (64 * 128), xl = xh + X_TILE;
#pragma unroll
    for (int kk = 0; kk < KS / 8; ++kk) {
      const uint64_t w_hi = hop::wgmma_desc(wt + kk * 32), w_lo = hop::wgmma_desc(wt + W_TILE + kk * 32);
      const uint64_t x_hi = hop::wgmma_desc(xh + kk * 32);
      if constexpr (XLO) hop::wgmma_m64n128k8_tf32(acc, hop::wgmma_desc(xl + kk * 32), w_hi, kk > 0);
      hop::wgmma_m64n128k8_tf32(acc, x_hi, w_lo, XLO || kk > 0);
      hop::wgmma_m64n128k8_tf32(acc, x_hi, w_hi, 1);
    }
  }
};

template <bool XLO, typename XT>
int launch_prefill(const void* x, const void* packed, const void* scales, const void* code, void* xsplit,
                   void* dst, int b_pad, int n_pad, int m_pad, int steps_per_split, int ksplit, size_t stride,
                   int kind, cudaStream_t stream) {
  using Op = Nf4Tf32<XLO>;
  const size_t n4 = (size_t)b_pad * n_pad / 4;
  size_t blocks = (n4 + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  split_x_kernel<<<(unsigned)blocks, 256, 0, stream>>>(static_cast<const XT*>(x), static_cast<float*>(xsplit), n4);
  CUtensorMap x_map;
  const int rc = dg::x_tensor_map(&x_map, xsplit, 4, (XLO ? 2 : 1) * b_pad, n_pad, Op::PM);
  if (rc) return rc;
  return dg::launch<Op>(x_map, packed, scales, code, dst, b_pad, n_pad, m_pad, steps_per_split, ksplit, stride,
                        kind, stream);
}

}  // namespace

// x fp32 (x_kind 0) or fp16 (x_kind 2) [b_pad, n_pad]; packed u8
// [n_pad/2, m_pad]; scales fp32 [n_pad/64, m_pad]; code fp32 [16]; out
// [b_pad, m_pad] of out_kind (0 fp32, 1 bf16, 2 fp16).  bm is the rows of a
// block: 16 takes the decode kernel (b_pad a multiple of 16, K split in
// 64-row scale blocks); 128 the prefill kernel (b_pad a multiple of 64, the
// ragged last row tile masked, K split in 32-row steps), which needs xsplit
// fp32 [2, b_pad, n_pad] (fp16 x: [1, b_pad, n_pad]).  n_pad is a multiple
// of 64 and m_pad of 128; every pointer 16-byte aligned.  ksplit > 1 needs
// workspace fp32 [ksplit, b_pad, m_pad]; the decode kernel then also needs
// counters, int32 [ceil(m_pad / cols) * (b_pad / 16)] (cols:
// nf4_matmul_exact_decode_shape), zero before the launch and zero again
// after it (the prefill kernel ignores them and sums its partials in a
// second pass).
extern "C" int nf4_matmul_exact(const void* x, const void* packed, const void* scales,
                                const void* code, void* out, void* workspace, int b_pad,
                                int n_pad, int m_pad, int bm, int x_kind, void* xsplit, void* counters,
                                int ksplit, int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows_ok = bm == 16 ? b_pad % 16 == 0 : bm == 128 && b_pad % 64 == 0 && xsplit != nullptr;
  if (!rows_ok || n_pad % BK || m_pad % BN || ksplit < 1 || (x_kind != 0 && x_kind != 2) || out_kind < 0 ||
      out_kind > 2 || (ksplit > 1 && (workspace == nullptr || (bm == 16 && counters == nullptr))))
    return (int)cudaErrorInvalidValue;
  const int steps = bm == 16 ? n_pad / BK : n_pad / Nf4Tf32<true>::KS;
  const int per = (steps + ksplit - 1) / ksplit;
  float* work = static_cast<float*>(workspace);
  int rc = 0;
  if (bm == 16) {
    int* ctr = static_cast<int*>(counters);
    if (x_kind == 0)
      rc = ed::launch<float>(x, packed, scales, code, out, work, ctr, b_pad, n_pad, m_pad, per, ksplit, out_kind, s);
    else
      rc = ed::launch<__half>(x, packed, scales, code, out, work, ctr, b_pad, n_pad, m_pad, per, ksplit, out_kind, s);
    return rc ? rc : (int)cudaGetLastError();
  }
  void* dst = ksplit > 1 ? workspace : out;
  const int kind = ksplit > 1 ? 0 : out_kind;
  const size_t stride = (size_t)b_pad * m_pad;
  if (x_kind == 0) {
    rc = launch_prefill<true, float>(x, packed, scales, code, xsplit, dst, b_pad, n_pad, m_pad, per, ksplit,
                                     stride, kind, s);
  } else {
    rc = launch_prefill<false, __half>(x, packed, scales, code, xsplit, dst, b_pad, n_pad, m_pad, per, ksplit,
                                       stride, kind, s);
  }
  if (rc) return rc;
  if (ksplit > 1) gemm::splitk_reduce(work, out, ksplit, stride, out_kind, s);
  return (int)cudaGetLastError();
}

// The decode kernel's output columns per block and its resident blocks per
// SM on the current device, the fewer of its fp32-x and fp16-x builds
// (ops/matmul.py sizes its K split by them).
extern "C" int nf4_matmul_exact_decode_shape(int* cols, int* blocks) {
  *cols = ed::COLS;
  int fp32_x = 0, fp16_x = 0;
  int rc = ed::blocks_per_sm<float>(&fp32_x);
  if (rc == 0) rc = ed::blocks_per_sm<__half>(&fp16_x);
  *blocks = fp32_x < fp16_x ? fp32_x : fp16_x;
  return rc;
}
