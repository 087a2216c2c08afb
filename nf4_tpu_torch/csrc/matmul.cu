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
// * Decode (bm = 16): the mma.sync decode kernel shared with kernel D
//   (decode_mma.cuh: its note gives the mapping, the per-lane cp.async
//   ring, the warps and the in-kernel sum of the K splits) with this
//   file's Dec, Nf4Decode.  An A register holds one column's K rows 2j and
//   2j+1: exactly the two nibbles of one packed byte, so a register is one
//   byte-table word times the column's bf16x2 scale (one __hmul2), with no
//   shared-memory weight tile, no transpose and no block barrier in the K
//   loop.  In scale block kb (32 packed rows) lane t reads packed rows
//   32kb + 8t .. 8t+7, and K step s takes rows 8t + 2s (the mma's K slots
//   2t, 2t+1) and 8t + 2s + 1 (slots 2t+8, 2t+9).  The byte table lives in
//   32 lane-private copies (entry e of copy l at byte 128e + 4l: no lookup
//   ever conflicts, and a shift and an and-or give the address), one
//   lookup per byte.  Chosen: WN = 1, WK = 4, STAGES = 4: 168 registers, no
//   spills, 96 KB of shared memory (a 64 KB ring and the 32 KB table), 2
//   blocks (8 warps, 96 KB of weights in flight) per SM; 256- and
//   512-column blocks ran no faster, 8 warps on one column tile with 2
//   stages within 3% either way (utils/kernel_variants.py --only decode).
//   Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3, 700.00 W): one
//   Llama-3-8B layer's four projections at B=4 in 0.107 ms, 35% of the
//   byte bound, against 0.166 ms for torch.matmul on a bf16 weight.  The
//   weight copies alone (no ring reads, decode or products) take 0.084 ms
//   and everything but the copies 0.059 ms: the two overlap poorly.
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

#include "decode_mma.cuh"
#include "dequant_gemm.cuh"
#include "gemm_common.cuh"
#include "hopper.cuh"

using namespace gemm;

namespace {

// Kernel B's Dec for the decode kernel (decode_mma.cuh).
namespace dk {

// The decode step: byte k of a 32-bit word of packed bytes (one column's K
// rows 2j, 2j+1) and the column's scale -> the A register of those two K
// rows, through the byte table (bf16(bf16(code) * bf16(scale)), one
// rounding, as ops/dequant.py:_bf16_weight_t).  lut is the table's first
// byte in shared memory, lane4 = 4 * lane: this lane's copy.
struct Nf4Decode {
  static constexpr int PIECES = 8;    // 16-byte pieces (packed rows) a lane copies per scale block
  static constexpr int STAGES = 4;    // scale blocks in a lane's ring
  static constexpr bool BULK = false;  // each lane copies its own pieces (cp.async)
  static constexpr int SMEM = 256 * 32 * 4;
  static constexpr int ENTRIES = 256 / dm::WARPS;  // table entries a warp copies
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

  // K step s: packed rows 8t + 2s (lo: K rows 16t + 4s, +1) and 8t + 2s + 1
  // (hi: +2, +3) of the lane's 16 columns; m-tile mt takes bytes 2mt (A
  // row g) and 2mt + 1 (A row g + 8) of each.
  struct Step {
    uint4 lo4, hi4;
    __device__ __forceinline__ Step(const unsigned char* slot, int s)
        : lo4(*reinterpret_cast<const uint4*>(slot + (2 * s) * 512)),
          hi4(*reinterpret_cast<const uint4*>(slot + (2 * s + 1) * 512)) {}
    __device__ __forceinline__ void regs(uint32_t (&a)[4], int mt, const __nv_bfloat162 (&s2)[16],
                                         const unsigned char* lut, uint32_t lane4) const {
      const uint32_t* lo = reinterpret_cast<const uint32_t*>(&lo4);
      const uint32_t* hi = reinterpret_cast<const uint32_t*>(&hi4);
      const int w = mt / 2, k = 2 * (mt % 2);  // bytes 2mt, 2mt + 1 of the piece
      a[0] = reg(lo[w], k, s2[2 * mt], lut, lane4);
      a[1] = reg(lo[w], k + 1, s2[2 * mt + 1], lut, lane4);
      a[2] = reg(hi[w], k, s2[2 * mt], lut, lane4);
      a[3] = reg(hi[w], k + 1, s2[2 * mt + 1], lut, lane4);
    }
  };
};

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
    rc = dm::launch<dk::Nf4Decode>(x, packed, scales, table, out, work, static_cast<int*>(counters), b_pad, n_pad,
                                   m_pad, per, ksplit, out_kind, s);
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
  return dm::shape<dk::Nf4Decode>(cols, blocks);
}
