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
// lower, and they have no full-fp32 mode.  Two kernels:
// * Decode (bm = 16): a tiled SIMT GEMM.  One block of 256 threads per (128
//   output columns, 16 rows, K split); each thread keeps a 2 x 4 tile of
//   sums in registers and per K row reads 2 x values (one broadcast across
//   the warp) and 4 weight values from shared memory.  Each K step (one
//   64-row scale block = 32 packed rows) decodes 16 packed bytes a thread
//   into rows 2j and 2j+1 of the W^T tile; the next step's x, bytes and
//   scales load into registers while the current step multiplies.  K is
//   split across blocks at step boundaries, each split writes an fp32
//   partial, and gemm_common.cuh's second pass sums them in a fixed order.
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

#include "dequant_gemm.cuh"
#include "gemm_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BK = gemm::BK;      // 64 K rows per step: one scale block
constexpr int BN = gemm::BN;      // 128 output columns per block
constexpr int THREADS_E = 256;
constexpr int BM_E = 16;          // rows of a decode block
constexpr int TN = 4;             // columns per thread
constexpr int TX = BN / TN;       // 32 threads across the columns (one warp)
constexpr int TY = THREADS_E / TX;  // 8 warps down the rows
constexpr int TM = BM_E / TY;     // 2 rows per thread

// Shared memory of a decode block: the 16 code values, the K-major x tile
// (rows padded by 4 so the transposing stores of one warp fall in distinct
// banks) and the decoded W^T tile (37,952 bytes: no opt-in needed).
constexpr int LDX = BM_E + 4;
constexpr size_t SMEM_E = (16 + BK * LDX + BK * BN) * sizeof(float);

__device__ __forceinline__ float4 load_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_x4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The decode kernel.  out_kind 0/1/2 = fp32/bf16/fp16 written at out +
// blockIdx.z * split_stride.
template <typename XT>
__global__ void __launch_bounds__(THREADS_E)
nf4_matmul_exact_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
                        const float* __restrict__ scales, const float* __restrict__ code,
                        void* __restrict__ out, int n_pad, int m_pad, int kb_per_split,
                        size_t split_stride, int out_kind) {
  extern __shared__ __align__(16) float smem[];
  float* lut = smem;              // the 16 fp32 code values
  float* xs = smem + 16;          // x tile, K-major [BK][LDX]
  float* ws = xs + BK * LDX;      // decoded W^T tile [BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN;    // first output column
  const int m0 = blockIdx.y * BM_E;  // first batch row
  const int nkb = n_pad / BK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int kb1 = min(nkb, kb0 + kb_per_split);

  if (tid < 16) lut[tid] = code[tid];

  // This thread's share of a K step: 4 x values (batch row r, K columns
  // c..c+3; a warp's pieces run down 16 rows at two column groups), 16
  // packed bytes (packed row prow, columns c0..c0+15) and those columns' 16
  // scales.
  const int prow = tid / 8;
  const int c0 = (tid % 8) * 16;
  const int xrow = tid % BM_E, xcol = (tid / BM_E) * 4;
  float4 xr;
  uint4 pr;
  float4 sr[4];

  auto load = [&](int kb) {
    const int k0 = kb * BK;
    xr = load_x4(x + (size_t)(m0 + xrow) * n_pad + k0 + xcol);
    pr = *reinterpret_cast<const uint4*>(packed + (size_t)(k0 / 2 + prow) * m_pad + n0 + c0);
    const float4* sp = reinterpret_cast<const float4*>(scales + (size_t)kb * m_pad + n0 + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) sr[i] = sp[i];
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  if (kb0 < kb1) load(kb0);
  __syncthreads();  // lut ready

  for (int kb = kb0; kb < kb1; ++kb) {
    // Registers -> shared: x transposed to K-major, the packed bytes decoded
    // (low nibble to W^T row 2*prow, high nibble to row 2*prow + 1).
    xs[(xcol + 0) * LDX + xrow] = xr.x;
    xs[(xcol + 1) * LDX + xrow] = xr.y;
    xs[(xcol + 2) * LDX + xrow] = xr.z;
    xs[(xcol + 3) * LDX + xrow] = xr.w;
    {
      const float* sf = reinterpret_cast<const float*>(sr);
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&pr);
      float lo[16], hi[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        lo[q] = __fmul_rn(lut[bytes[q] & 0xF], sf[q]);
        hi[q] = __fmul_rn(lut[bytes[q] >> 4], sf[q]);
      }
      float4* dlo = reinterpret_cast<float4*>(ws + (2 * prow) * BN + c0);
      float4* dhi = reinterpret_cast<float4*>(ws + (2 * prow + 1) * BN + c0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dlo[q] = make_float4(lo[4 * q], lo[4 * q + 1], lo[4 * q + 2], lo[4 * q + 3]);
        dhi[q] = make_float4(hi[4 * q], hi[4 * q + 1], hi[4 * q + 2], hi[4 * q + 3]);
      }
    }
    __syncthreads();
    if (kb + 1 < kb1) load(kb + 1);  // in flight during the products below

#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(xs + k * LDX + ty * TM);
      const float4 b = *reinterpret_cast<const float4*>(ws + k * BN + tx * TN);
      const float av[TM] = {a.x, a.y};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  // Epilogue straight from registers: each thread's TM rows of 4 columns, a
  // warp's stores of one row contiguous.
  void* dst = out_kind == 0 ? static_cast<void*>(static_cast<float*>(out) + blockIdx.z * split_stride) : out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const size_t row = (size_t)(m0 + ty * TM + i);
    gemm::store_out(dst, out_kind, row * m_pad + n0 + tx * TN,
                    make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

template <typename XT>
void launch_decode(const void* x, const void* packed, const void* scales, const void* code, void* dst,
                   int b_pad, int n_pad, int m_pad, int kb_per_split, int ksplit, size_t stride, int kind,
                   cudaStream_t stream) {
  dim3 grid(m_pad / BN, b_pad / BM_E, ksplit);
  nf4_matmul_exact_kernel<XT><<<grid, THREADS_E, SMEM_E, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(code), dst, n_pad, m_pad,
      kb_per_split, stride, kind);
}

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
// 64-row steps); 128 the prefill kernel (b_pad a multiple of 64, the ragged
// last row tile masked, K split in 32-row steps), which needs xsplit fp32
// [2, b_pad, n_pad] (fp16 x: [1, b_pad, n_pad]).  n_pad is a multiple of 64
// and m_pad of 128; every pointer 16-byte aligned.  ksplit > 1 needs
// workspace fp32 [ksplit, b_pad, m_pad].
extern "C" int nf4_matmul_exact(const void* x, const void* packed, const void* scales,
                                const void* code, void* out, void* workspace, int b_pad,
                                int n_pad, int m_pad, int bm, int x_kind, void* xsplit, int ksplit,
                                int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows_ok = bm == 16 ? b_pad % 16 == 0 : bm == 128 && b_pad % 64 == 0 && xsplit != nullptr;
  if (!rows_ok || n_pad % BK || m_pad % BN || ksplit < 1 || (x_kind != 0 && x_kind != 2) || out_kind < 0 ||
      out_kind > 2 || (ksplit > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const int steps = bm == 16 ? n_pad / BK : n_pad / Nf4Tf32<true>::KS;
  const int per = (steps + ksplit - 1) / ksplit;
  void* dst = ksplit > 1 ? workspace : out;
  const int kind = ksplit > 1 ? 0 : out_kind;
  const size_t stride = (size_t)b_pad * m_pad;
  int rc = 0;
  if (bm == 16) {
    if (x_kind == 0) launch_decode<float>(x, packed, scales, code, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
    else launch_decode<__half>(x, packed, scales, code, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  } else if (x_kind == 0) {
    rc = launch_prefill<true, float>(x, packed, scales, code, xsplit, dst, b_pad, n_pad, m_pad, per, ksplit,
                                     stride, kind, s);
  } else {
    rc = launch_prefill<false, __half>(x, packed, scales, code, xsplit, dst, b_pad, n_pad, m_pad, per, ksplit,
                                       stride, kind, s);
  }
  if (rc) return rc;
  if (ksplit > 1) gemm::splitk_reduce(static_cast<const float*>(workspace), out, ksplit, stride, out_kind, s);
  return (int)cudaGetLastError();
}
