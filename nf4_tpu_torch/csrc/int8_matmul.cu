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
// bytes per weight) are read once and each byte feeds only 2*B flops
// (Llama-3-8B's four projections of one layer: 231.7 MB, 0.0699 ms at 3.35
// TB/s).  At prefill (B in the hundreds or more) operations, 989 TFLOP/s
// bf16, reachable only through wgmma.  Two kernels, with the K loop inside
// the block and, where the output tiles alone cannot fill the card, K split
// across blocks with fp32 partials summed in a fixed order (deterministic,
// no float atomics):
// * Decode (bm = 16): kernel B's mma.sync decode kernel (decode_mma.cuh:
//   the weights the A operand, 4 warps on the same 128 columns over
//   interleaved scale blocks, no block barrier in the K loop, the split
//   that finishes last sums the partials) with this file's Dec,
//   Int8Decode.  An int8 row is one K row, so an A register (two K slots of
//   one column) takes the byte at that column from each of two rows: lane t
//   reads the 16 rows 64kb + 16t .. +15 of its 16 columns per scale block
//   (twice kernel B's pieces), and K step s pairs rows 16t + 4s with +1
//   and +2 with +3.  A register is two bytes made exact fp32 by the byte
//   trick below (x + 128 in the low mantissa byte of 2^23, minus 2^23 +
//   128), whose high halves are then the exact bf16 of the two values
//   (|x| <= 128 has at most 8 significant bits), packed by one byte
//   permute and multiplied by the column's bf16x2 scale with one __hmul2:
//   the product of two bf16 values is exact in fp32, so this rounds once,
//   to the bits of bf16(x * bf16(scale)) (fp32 products and one convert
//   give the same bits and time, with 221 registers).  Twice kernel B's
//   bytes per weight made the per-lane cp.async copies the larger cost
//   (231.7 MB at 2.0 TB/s alone), so the ring is filled by bulk copies:
//   each warp's 64 rows of 128 bytes per scale block, two cp.async.bulk a
//   lane, on one mbarrier per warp and stage, in 144-byte rows skewed by
//   32 bytes per lane t (no bank conflict on the reads).  No table: 3
//   stages of 9.1 KB per warp, 109 KB of shared memory, 197 registers, 2
//   blocks per SM.  Measured (chip_smoke.py phase 3, NVIDIA H100 80GB
//   HBM3, 700.00 W): one Llama-3-8B layer's four projections at B=4 in
//   0.1405 ms, 50% of the byte bound, against 0.168 ms for torch.matmul
//   on a bf16 weight; the per-lane cp.async ring 16-17% slower in the same
//   call, 2 or 4 stages no faster (utils/kernel_variants.py --only
//   decode).
// * Prefill (bm = 256 or 128, b_pad a multiple of 64): kernel B's pipelined
//   wgmma main loop (dequant_gemm.cuh: 256 x 128 blocks of 4 consumer
//   warpgroups or 128 x 256 of 2, x by TMA, a 4-stage ring, the decode of
//   step s+1 under the products of step s) with an int8 decode.  A K step is
//   64 int8 rows (one scale row; twice the bytes of kernel B's packed
//   rows).  The decode needs no table: each byte becomes an exact fp32 by
//   the byte trick, is multiplied by the column's bf16 scale in fp32 and
//   rounded once to bf16.  The int8 rows are N-contiguous while kernel
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
#include <stdint.h>

#include "decode_mma.cuh"
#include "dequant_gemm.cuh"
#include "gemm_common.cuh"
#include "hopper.cuh"

using namespace gemm;

namespace {

// Byte e of lo and of hi (two K rows of one column, each byte XOR 0x80 = x
// + 128) -> the A register of those two K rows: bf16(x * bf16(scale))
// each, low half = lo's.
__device__ __forceinline__ uint32_t int8_pair(uint32_t lo, uint32_t hi, int e, __nv_bfloat162 scale) {
  const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 + e)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 + e)) - 8388736.f;
  uint32_t w = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);  // the exact bf16 pair
  __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&w), scale);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Kernel D's Dec for the decode kernel (decode_mma.cuh).
struct Int8Decode {
  static constexpr int PIECES = 16;  // 16-byte pieces (int8 rows) a lane copies per scale block
  static constexpr int STAGES = 3;   // scale blocks in a warp's ring
  static constexpr bool BULK = true;  // the warp's rows by bulk copies, 144-byte rows in a slot
  static constexpr int PIECE_LD = BULK ? dm::ROW_LD : 512;  // from one of a lane's pieces to the next
  static constexpr int SMEM = 0;

  static __device__ __forceinline__ void init(uint32_t*, const void*, int) {}

  // K step s: rows 16t + 4s + r (r = 0..3) of the lane's 16 columns, each
  // byte XOR 0x80; m-tile mt takes bytes 2mt (A row g) and 2mt + 1 (A row
  // g + 8) of each, rows r = 0, 1 in K slots 2t, 2t+1 and r = 2, 3 in
  // slots 2t+8, 2t+9.
  struct Step {
    uint32_t v[4][4];
    __device__ __forceinline__ Step(const unsigned char* slot, int s) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint4 p = *reinterpret_cast<const uint4*>(slot + (4 * s + r) * PIECE_LD);
        v[r][0] = p.x ^ 0x80808080u, v[r][1] = p.y ^ 0x80808080u;
        v[r][2] = p.z ^ 0x80808080u, v[r][3] = p.w ^ 0x80808080u;
      }
    }
    __device__ __forceinline__ void regs(uint32_t (&a)[4], int mt, const __nv_bfloat162 (&s2)[16],
                                         const unsigned char*, uint32_t) const {
      const int w = mt / 2, e = 2 * (mt % 2);  // bytes 2mt, 2mt + 1 of the piece
      a[0] = int8_pair(v[0][w], v[1][w], e, s2[2 * mt]);
      a[1] = int8_pair(v[0][w], v[1][w], e + 1, s2[2 * mt + 1]);
      a[2] = int8_pair(v[2][w], v[3][w], e, s2[2 * mt]);
      a[3] = int8_pair(v[2][w], v[3][w], e + 1, s2[2 * mt + 1]);
    }
  };
};

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
// workspace fp32 [ksplit, b_pad, m_pad]; the decode kernel then also needs
// counters, int32 [ceil(m_pad / cols) * (b_pad / 16)] (cols:
// int8_matmul_bf16_decode_shape), zero before the launch and zero again
// after it (the prefill kernel ignores them and sums its partials in a
// second pass).
extern "C" int int8_matmul_bf16(const void* x, const void* values, const void* scales, void* out,
                                void* workspace, void* counters, int b_pad, int n_pad, int m_pad,
                                int bm, int ksplit, int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows_ok = bm == 16 ? b_pad % 16 == 0
                                : (bm == 256 || (bm == 128 && m_pad % 256 == 0)) && b_pad % 64 == 0;
  if (!rows_ok || n_pad % BK || m_pad % BN || ksplit < 1 || out_kind < 0 || out_kind > 2 ||
      (ksplit > 1 && (workspace == nullptr || (bm == 16 && counters == nullptr))))
    return (int)cudaErrorInvalidValue;
  const int nkb = n_pad / BK;
  const int per = (nkb + ksplit - 1) / ksplit;
  const size_t stride = (size_t)b_pad * m_pad;
  int rc = 0;
  if (bm == 16) {
    rc = dm::launch<Int8Decode>(x, values, scales, nullptr, out, static_cast<float*>(workspace),
                                static_cast<int*>(counters), b_pad, n_pad, m_pad, per, ksplit, out_kind, s);
    return rc ? rc : (int)cudaGetLastError();
  }
  void* dst = ksplit > 1 ? workspace : out;
  const int kind = ksplit > 1 ? 0 : out_kind;
  if (bm == 256)
    rc = launch_prefill<128, 4>(x, values, scales, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  else rc = launch_prefill<256, 2>(x, values, scales, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  if (rc) return rc;
  if (ksplit > 1) gemm::splitk_reduce(static_cast<const float*>(workspace), out, ksplit, stride, out_kind, s);
  return (int)cudaGetLastError();
}

// The decode kernel's output columns per block and its resident blocks per
// SM on the current device (ops/int8_serve.py sizes its K split by them).
extern "C" int int8_matmul_bf16_decode_shape(int* cols, int* blocks) {
  return dm::shape<Int8Decode>(cols, blocks);
}
