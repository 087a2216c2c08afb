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
// cores become the limit (Llama-3-8B's four projections of one layer: 122.7
// MB, 0.0374 ms at 3.35 TB/s).  At prefill (B in the hundreds or more)
// operations, 989 TFLOP/s bf16, reachable only through wgmma.
//
// Two kernels, both with the K loop inside the block (blocks run in any
// order; nothing is carried between them) and, where the output tiles
// alone cannot fill the card, K split across blocks with fp32 partials
// summed in a fixed order (deterministic, no float atomics):
// * Decode (bm = 16): the product is computed transposed, y^T [m, 16] =
//   W [m, n] . x^T, on mma.sync m16n8k16 with the weights as the A operand
//   (16 output columns x 16 K rows) and x as B (two n8 tiles of batch
//   rows).  An A register holds one row's K rows 2j and 2j+1: exactly the
//   two nibbles of one packed byte, so a register is one byte-table word
//   times the column's bf16x2 scale (one __hmul2), with no shared-memory
//   weight tile, no transpose and no block barrier in the K loop.  The
//   mapping (free, as long as the epilogue undoes it): lane (g, t) = (lane
//   / 4, lane % 4) of a warp owns columns 16g .. 16g+15 of the block's 128,
//   A rows g and g+8 of m-tile mt being columns 16g + 2mt and 16g + 2mt + 1;
//   in scale block kb (64 K rows = 32 packed rows) it reads packed rows
//   32kb + 8t .. 8t+7, 16 contiguous bytes each (a warp: four full
//   128-byte rows per copy), and K step s takes rows 8t + 2s (the mma's K
//   slots 2t, 2t+1) and 8t + 2s + 1 (slots 2t+8, 2t+9), so its x operand
//   is 8 contiguous bytes of each batch row.  Each lane copies its own
//   pieces by cp.async into a private slot of a STAGES-deep ring (one
//   scale block a stage: 4 KB per warp) and waits only on its own groups;
//   x and the scales come from L2 into registers one scale block ahead
//   (the scales' lines are prefetched to L2 when their packed rows are
//   copied).  The byte table lives in 32 lane-private copies (entry e of
//   copy l at byte 128e + 4l: no lookup ever conflicts, and a shift and
//   an and-or give the address), one lookup per byte.  When batch rows
//   8-15 of x are zero in a scale block (batches of up to 8 rows), a warp
//   vote skips their n8 tile's products.  A block has WN x WK warps: WN
//   side by side over 128 columns each, WK on the same columns taking
//   every WK-th scale block of the block's K range, their fp32 sums added
//   in warp order through shared memory.  Where the column tiles alone
//   cannot fill the card the blocks also split K (ops/matmul.py:
//   _decode_ksplit, one wave of resident blocks); each split writes its
//   fp32 partial, counts itself on the output tile's counter, and the
//   split that comes last sums all partials in split order (its own from
//   registers, the others' four splits to a trip to L2), stores the
//   output type and resets the counter: one launch per product, safe to
//   capture in a CUDA graph.  Chosen: WN = 1, WK = 4, STAGES = 4: 168
//   registers, no spills, 96 KB of shared memory (a 64 KB ring and the 32
//   KB table), 2 blocks (8 warps, 96 KB of weights in flight) per SM;
//   256- and 512-column blocks ran no faster, 8 warps on one column tile
//   with 2 stages within 3% either way (utils/kernel_variants.py --only
//   decode).  Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3,
//   700.00 W): one Llama-3-8B layer's four projections at B=4 in 0.107
//   ms, 35% of the byte bound, against 0.166 ms for torch.matmul on a
//   bf16 weight.  The weight copies alone (no ring reads, decode or
//   products) take 0.084 ms and everything but the copies 0.059 ms: the
//   two overlap poorly.
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
//   (the WMMA design decoded it once per 64).  K-split partials are summed
//   by a second pass (gemm_common.cuh: splitk_reduce).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant_gemm.cuh"
#include "gemm_common.cuh"
#include "hopper.cuh"

using namespace gemm;

namespace {

// The decode kernel (bm = 16); see the note above for the mapping.
namespace dk {

constexpr int WCOLS = 128;   // output columns per warp: 8 lane groups x 16
constexpr int MT = 8;        // m16 tiles per warp
constexpr int ROWS = 16;     // batch rows per block: two n8 tiles
constexpr int PIECES = 8;    // 16-byte pieces a lane copies per scale block
constexpr int WN = 1;        // warps side by side over a block's columns
constexpr int WK = 4;        // warps on the same columns, each over its own scale blocks
constexpr int STAGES = 4;    // scale blocks in a lane's ring
constexpr int WARPS = WN * WK;
constexpr int COLS = WN * WCOLS;  // output columns per block
constexpr int THREADS = WARPS * 32;
constexpr int SLOT_BYTES = PIECES * 32 * 16;  // one warp's scale block
constexpr int RING_BYTES = WARPS * STAGES * SLOT_BYTES;
constexpr int CS_LD = WCOLS + 4;              // fp32 staging row stride
constexpr int STAGING_BYTES = WARPS * ROWS * CS_LD * 4;

// The decode step: byte k of a 32-bit word of packed bytes (one column's K
// rows 2j, 2j+1) and the column's scale -> the A register of those two K
// rows, through the byte table (bf16(bf16(code) * bf16(scale)), one
// rounding, as ops/dequant.py:_bf16_weight_t).  lut is the table's first
// byte in shared memory, lane4 = 4 * lane: this lane's copy.
struct Nf4Decode {
  static constexpr int SMEM = 256 * 32 * 4;
  static constexpr int ENTRIES = 256 / WARPS;  // table entries a warp copies
  static_assert(ENTRIES % 32 == 0, "a warp copies whole rows of 32 entries");

  // Warp w loads entries w * ENTRIES .. + ENTRIES - 1 (one word a lane per
  // row of 32, all loads in flight at once) and hands each to every lane
  // by shuffle: lane l writes copy l, 32 neighbouring words per store.
  static __device__ __forceinline__ void init(uint32_t* lut, const void* table, int tid) {
    const int warp = tid / 32, lane = tid % 32;
    const uint32_t* src = static_cast<const uint32_t*>(table) + warp * ENTRIES;
    uint32_t v[ENTRIES / 32];
#pragma unroll
    for (int r = 0; r < ENTRIES / 32; ++r) v[r] = __ldg(src + 32 * r + lane);
#pragma unroll
    for (int r = 0; r < ENTRIES / 32; ++r)
#pragma unroll
      for (int j = 0; j < 32; ++j)
        lut[32 * (warp * ENTRIES + 32 * r + j) + lane] = __shfl_sync(0xffffffffu, v[r], j);
  }

  // Entry e of copy l is the word at byte 128e + 4l: one shift and one
  // and-or give its offset (k is a constant once the caller's loops are
  // unrolled).
  static __device__ __forceinline__ uint32_t reg(uint32_t word, int k, __nv_bfloat162 scale,
                                                 const unsigned char* lut, uint32_t lane4) {
    const uint32_t off = ((k == 0 ? word << 7 : word >> (8 * k - 7)) & 0x7f80u) | lane4;
    uint32_t w = *reinterpret_cast<const uint32_t*>(lut + off);
    __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&w), scale);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <class Dec>
constexpr int smem_bytes() {
  return RING_BYTES + Dec::SMEM > STAGING_BYTES ? RING_BYTES + Dec::SMEM : STAGING_BYTES;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// out_kind 0/1/2 = fp32/bf16/fp16.  gridDim.z > 1: split blockIdx.z of
// the K range writes its fp32 partial to work + blockIdx.z * b_pad * m_pad,
// and the split that comes last on its output tile's counter sums them
// into out.
template <class Dec>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
              const float* __restrict__ scales, const void* __restrict__ table, void* __restrict__ out,
              float* __restrict__ work, int* __restrict__ counters, int n_pad, int m_pad,
              int kb_per_split, int out_kind) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nb = blockIdx.x * COLS, r0 = blockIdx.y * ROWS;
  const int n0 = nb + (warp % WN) * WCOLS;                // this warp's first column
  const int kb0 = blockIdx.z * kb_per_split + warp / WN;  // and first scale block
  const int kb1 = min(n_pad / BK, (int)(blockIdx.z + 1) * kb_per_split);
  const int cnt = n0 < m_pad && kb0 < kb1 ? (kb1 - kb0 + WK - 1) / WK : 0;

  const unsigned char* lut = smem + RING_BYTES;
  const uint32_t lane4 = 4 * lane;

  // This lane's sources in scale block kb: packed rows 32kb + 8t + r at
  // columns n0 + 16g .. +15 and those columns' scales; x rows r0 + g and
  // r0 + 8 + g at K rows 64kb + 16t .. +15.
  const uint8_t* pk = packed + (size_t)(8 * t) * m_pad + n0 + 16 * g;
  const float* sc = scales + n0 + 16 * g;
  const __nv_bfloat16* xa = x + (size_t)(r0 + g) * n_pad + 16 * t;
  const __nv_bfloat16* xb = xa + (size_t)8 * n_pad;
  // Piece r of ring slot s of this lane: + s * SLOT_BYTES + r * 512.
  const int ring_off = (warp * STAGES * PIECES * 32 + lane) * 16;
  const uint32_t ring = hop::smem_u32(smem) + ring_off;
  const unsigned char* ring_ptr = smem + ring_off;

  auto issue = [&](int i) {
    if (i < cnt) {
      const int kb = kb0 + i * WK;
      const uint8_t* src = pk + (size_t)kb * (BK / 2) * m_pad;
      const uint32_t dst = ring + (i % STAGES) * SLOT_BYTES;
#pragma unroll
      for (int r = 0; r < PIECES; ++r) hop::cp_async16(dst + r * 512, src + (size_t)r * m_pad, true);
      hop::prefetch_l2(scales + (size_t)kb * m_pad + n0 + 16 * g + 4 * t);
    }
    hop::cp_async_commit();
  };
  uint4 xn[4];
  float4 sn[4];
  auto load_regs = [&](int i) {
    if (i < cnt) {
      const int kb = kb0 + i * WK;
      const uint4* pa = reinterpret_cast<const uint4*>(xa + kb * BK);
      const uint4* pb = reinterpret_cast<const uint4*>(xb + kb * BK);
      xn[0] = __ldg(pa), xn[1] = __ldg(pa + 1), xn[2] = __ldg(pb), xn[3] = __ldg(pb + 1);
      const float4* ps = reinterpret_cast<const float4*>(sc + (size_t)kb * m_pad);
#pragma unroll
      for (int q = 0; q < 4; ++q) sn[q] = __ldg(ps + q);
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
  load_regs(0);
  Dec::init(reinterpret_cast<uint32_t*>(smem + RING_BYTES), table, tid);  // while the first copies are in flight
  __syncthreads();             // the table is in place

  for (int i = 0; i < cnt; ++i) {
    hop::cp_async_wait<STAGES - 2>();  // this lane's pieces of step i have landed
    uint4 xc[4];
    __nv_bfloat162 s2[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xc[q] = xn[q];
      s2[4 * q] = __bfloat162bfloat162(__float2bfloat16_rn(sn[q].x));
      s2[4 * q + 1] = __bfloat162bfloat162(__float2bfloat16_rn(sn[q].y));
      s2[4 * q + 2] = __bfloat162bfloat162(__float2bfloat16_rn(sn[q].z));
      s2[4 * q + 3] = __bfloat162bfloat162(__float2bfloat16_rn(sn[q].w));
    }
    // Batch rows 8-15 all zero in this scale block (decode batches of up to
    // 8 rows): their n8 tile's products would add exact zeros, so they are
    // skipped (the weights are finite).
    const bool rows_hi = __any_sync(0xffffffffu, (xc[2].x | xc[2].y | xc[2].z | xc[2].w |
                                                  xc[3].x | xc[3].y | xc[3].z | xc[3].w) != 0);
    issue(i + STAGES - 1);  // into the slot step i - 1 read
    load_regs(i + 1);
    const unsigned char* slot = ring_ptr + (i % STAGES) * SLOT_BYTES;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint4 lo4 = *reinterpret_cast<const uint4*>(slot + (2 * s) * 512);
      const uint4 hi4 = *reinterpret_cast<const uint4*>(slot + (2 * s + 1) * 512);
      const uint32_t* lo = reinterpret_cast<const uint32_t*>(&lo4);
      const uint32_t* hi = reinterpret_cast<const uint32_t*>(&hi4);
      // x at K rows 64kb + 16t + 4s .. +3: K slots 2t, 2t+1 and 2t+8, 2t+9.
      const uint32_t* x0 = reinterpret_cast<const uint32_t*>(&xc[s / 2]) + 2 * (s % 2);
      const uint32_t* x1 = reinterpret_cast<const uint32_t*>(&xc[2 + s / 2]) + 2 * (s % 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int w = mt / 2, k = 2 * (mt % 2);  // bytes 2mt, 2mt + 1 of the piece
        uint32_t a[4];
        a[0] = Dec::reg(lo[w], k, s2[2 * mt], lut, lane4);
        a[1] = Dec::reg(lo[w], k + 1, s2[2 * mt + 1], lut, lane4);
        a[2] = Dec::reg(hi[w], k, s2[2 * mt], lut, lane4);
        a[3] = Dec::reg(hi[w], k + 1, s2[2 * mt + 1], lut, lane4);
        hop::mma_bf16_16816(acc[mt][0], a, x0[0], x0[1]);
        if (rows_hi) hop::mma_bf16_16816(acc[mt][1], a, x1[0], x1[1]);
      }
    }
  }
  hop::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring and the table

  // acc[mt][nt] = y at batch rows 8nt + 2t (+1) of columns 16g + 2mt (+1):
  // batch row b's 16 columns 16g .. 16g+15 as four float4s.
  float* cs = reinterpret_cast<float*>(smem) + warp * ROWS * CS_LD;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(cs + (8 * nt + 2 * t + e) * CS_LD + 16 * g + 4 * q) =
            make_float4(acc[2 * q][nt][e], acc[2 * q][nt][2 + e], acc[2 * q + 1][nt][e], acc[2 * q + 1][nt][2 + e]);
  __syncthreads();

  // The sums of the warps on the same columns added in warp order, four
  // columns a thread at a time (columns at m_pad and beyond are not stored).
  constexpr int PER = ROWS * COLS / 4 / THREADS;
  const float* cs0 = reinterpret_cast<const float*>(smem);
  float4 v[PER];
  size_t pos[PER];
  bool in[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int idx = tid + u * THREADS, r = idx / (COLS / 4), c = (idx % (COLS / 4)) * 4;
    const float* src = cs0 + ((c / WCOLS) * ROWS + r) * CS_LD + c % WCOLS;  // warp c / WCOLS
    v[u] = *reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 1; k < WK; ++k) v[u] = add4(v[u], *reinterpret_cast<const float4*>(src + k * WN * ROWS * CS_LD));
    pos[u] = (size_t)(r0 + r) * m_pad + nb + c;
    in[u] = nb + c < m_pad;
  }
  if (gridDim.z == 1) {
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (in[u]) gemm::store_out(out, out_kind, pos[u], v[u]);
    return;
  }
  const size_t stride = (size_t)gridDim.y * ROWS * m_pad;  // b_pad * m_pad
#pragma unroll
  for (int u = 0; u < PER; ++u)
    if (in[u]) *reinterpret_cast<float4*>(work + blockIdx.z * stride + pos[u]) = v[u];
  __threadfence();
  __syncthreads();
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(counter, 1) == (int)gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // the other splits' partials, read from L2
  // The partials of LOADS splits are loaded together (one trip to L2 for
  // LOADS splits) and added in split order; this split's own from registers.
  constexpr int LOADS = 4;
  const int ksplit = gridDim.z;
  float4 sum[PER];
  for (int z0 = 0; z0 < ksplit; z0 += LOADS) {
    float4 part[LOADS][PER];
#pragma unroll
    for (int j = 0; j < LOADS; ++j)
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int z = z0 + j;
        part[j][u] = z == (int)blockIdx.z || z >= ksplit || !in[u]
                         ? v[u]
                         : __ldcg(reinterpret_cast<const float4*>(work + z * stride + pos[u]));
      }
#pragma unroll
    for (int j = 0; j < LOADS; ++j)
#pragma unroll
      for (int u = 0; u < PER; ++u)
        if (z0 + j < ksplit) sum[u] = z0 + j == 0 ? part[j][u] : add4(sum[u], part[j][u]);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u)
    if (in[u]) gemm::store_out(out, out_kind, pos[u], sum[u]);
  if (tid == 0) *counter = 0;
}

template <class Dec>
cudaError_t decode_opt_in() {
  static hop::SmemOptIn opt_in;
  return opt_in(reinterpret_cast<const void*>(&decode_kernel<Dec>), smem_bytes<Dec>());
}

template <class Dec>
int launch_decode(const void* x, const void* packed, const void* scales, const void* table, void* out,
                  float* work, int* counters, int b_pad, int n_pad, int m_pad, int kb_per_split, int ksplit,
                  int kind, cudaStream_t stream) {
  const cudaError_t err = decode_opt_in<Dec>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m_pad + COLS - 1) / COLS, b_pad / ROWS, ksplit);
  decode_kernel<Dec><<<grid, THREADS, smem_bytes<Dec>(), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
      table, out, work, counters, n_pad, m_pad, kb_per_split, kind);
  return 0;
}

}  // namespace dk

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
// 128.  ksplit > 1 needs workspace fp32 [ksplit, b_pad, m_pad]; the decode
// kernel then also needs counters, int32 [ceil(m_pad / cols) * (b_pad /
// 16)] (cols: nf4_matmul_bf16_decode_shape), zero before the launch and
// zero again after it (the prefill kernel ignores them and sums its
// partials in a second pass).
extern "C" int nf4_matmul_bf16(const void* x, const void* packed, const void* scales,
                               const void* table, void* out, void* workspace, int b_pad,
                               int n_pad, int m_pad, int bm, void* counters, int ksplit,
                               int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows_ok = bm == 16 ? b_pad % 16 == 0
                                : (bm == 256 || (bm == 128 && m_pad % 256 == 0)) && b_pad % 64 == 0;
  if (!rows_ok || n_pad % BK || m_pad % BN || ksplit < 1 || out_kind < 0 || out_kind > 2 ||
      (ksplit > 1 && (workspace == nullptr || (bm == 16 && counters == nullptr))))
    return (int)cudaErrorInvalidValue;
  const int nkb = n_pad / BK;
  const int per = (nkb + ksplit - 1) / ksplit;
  const size_t stride = (size_t)b_pad * m_pad;
  float* work = static_cast<float*>(workspace);
  int rc = 0;
  if (bm == 16) {
    rc = dk::launch_decode<dk::Nf4Decode>(x, packed, scales, table, out, work, static_cast<int*>(counters), b_pad,
                                          n_pad, m_pad, per, ksplit, out_kind, s);
    return rc ? rc : (int)cudaGetLastError();
  }
  void* dst = ksplit > 1 ? workspace : out;
  const int kind = ksplit > 1 ? 0 : out_kind;
  if (bm == 256)
    rc = launch_prefill<128, 4>(x, packed, scales, table, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  else rc = launch_prefill<256, 2>(x, packed, scales, table, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  if (rc) return rc;
  if (ksplit > 1) gemm::splitk_reduce(work, out, ksplit, stride, out_kind, s);
  return (int)cudaGetLastError();
}

// The decode kernel's output columns per block and its resident blocks per
// SM on the current device (ops/matmul.py sizes its K split by them).
extern "C" int nf4_matmul_bf16_decode_shape(int* cols, int* blocks) {
  *cols = dk::COLS;
  const cudaError_t err = dk::decode_opt_in<dk::Nf4Decode>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dk::decode_kernel<dk::Nf4Decode>, dk::THREADS,
                                                            dk::smem_bytes<dk::Nf4Decode>());
}
