// Fused 4-bit dequant-matmul for fp32 and fp16 activations (kernel E):
// y[B, m] = x[B, n] . W^T[n, m] in fp32, W kept packed in device memory.
//
// Replaces: nf4_tpu/ops/matmul.py:_matmul_pallas_exact (kernel body
// _make_exact_kernel).
//
// Computes: fp16 x is upcast to fp32 (lossless).  Each weight value is the
// oracle's fp32 product code[nibble] * scale (kernel A's values, before any
// rounding); the product is fp32 multiplies with fp32 accumulation (FFMA,
// no TF32: the TPU kernel contracts at Precision.HIGHEST), stored as fp32,
// or rounded once to bf16 or fp16.
//
// Bound: at decode (B <= 16) bytes: the packed weights and their scales
// (0.5625 bytes per weight) are read once and each byte feeds 4*B flops.
// At B in the hundreds operations: 2*B*n*m fp32 flops, and the card's
// tensor cores have no full-fp32 mode, so the limit is its 67 TFLOP/s of
// fp32 FFMA.
// Design, a simple tiled SIMT GEMM:
// * One block of 256 threads per (128 output columns, BM rows, K split),
//   BM = 16 (decode) or 64.  Each thread keeps a (BM/8) x 4 tile of sums in
//   registers: per K row it reads BM/8 x values (one broadcast across the
//   warp) and 4 weight values from shared memory for 4*BM/8 FFMAs.
// * Each K step is one 64-row scale block = 32 packed rows.  The TPU kernel
//   splits x into even and odd K columns so each nibble plane contracts
//   contiguously; here each thread decodes 16 packed bytes into rows 2j and
//   2j+1 of the W^T tile in shared memory, and x is read in its natural
//   order (stored K-major, so the compute loop reads it as vectors).
// * The next step's x, packed bytes and scales are loaded into registers
//   while the current step multiplies.  When the tiles alone cannot fill
//   the card (decode), K is split across blocks at step boundaries, each
//   split writes an fp32 partial, and gemm_common.cuh's second pass sums
//   them in a fixed order (deterministic, no atomics).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_common.cuh"

namespace {

constexpr int BK = gemm::BK;      // 64 K rows per step: one scale block
constexpr int BN = gemm::BN;      // 128 output columns per block
constexpr int THREADS_E = 256;
constexpr int TN = 4;             // columns per thread
constexpr int TX = BN / TN;       // 32 threads across the columns (one warp)
constexpr int TY = THREADS_E / TX;  // 8 warps down the rows

// Shared memory of a block of BM rows: the 16 code values, the K-major x
// tile (rows padded by 4 so the transposing stores of one warp fall in
// distinct banks) and the decoded W^T tile.
template <int BM>
struct ExactTile {
  static constexpr int LDX = BM + 4;
  static constexpr size_t SMEM = (16 + BK * LDX + BK * BN) * sizeof(float);
};

__device__ __forceinline__ float4 load_x4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_x4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// out_kind 0/1/2 = fp32/bf16/fp16 written at out + blockIdx.z * split_stride.
template <int BM, typename XT>
__global__ void __launch_bounds__(THREADS_E)
nf4_matmul_exact_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
                        const float* __restrict__ scales, const float* __restrict__ code,
                        void* __restrict__ out, int n_pad, int m_pad, int kb_per_split,
                        size_t split_stride, int out_kind) {
  constexpr int LDX = ExactTile<BM>::LDX;
  constexpr int TM = BM / TY;                    // rows per thread: 2 or 8
  constexpr int XV = BM * BK / 4 / THREADS_E;    // 4-value x pieces per thread: 1 or 4
  static_assert(TM % 2 == 0 && XV >= 1, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* lut = smem;              // the 16 fp32 code values
  float* xs = smem + 16;          // x tile, K-major [BK][LDX]
  float* ws = xs + BK * LDX;      // decoded W^T tile [BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN;  // first output column
  const int m0 = blockIdx.y * BM;  // first batch row
  const int nkb = n_pad / BK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int kb1 = min(nkb, kb0 + kb_per_split);

  if (tid < 16) lut[tid] = code[tid];

  // This thread's share of a K step: XV pieces of 4 x values (batch row
  // r, K columns c..c+3; a warp's pieces run down 32 consecutive rows, or
  // down 16 rows at two column groups), 16 packed bytes (packed row prow,
  // columns c0..c0+15) and those columns' 16 scales.
  const int prow = tid / 8;
  const int c0 = (tid % 8) * 16;
  float4 xr[XV];
  uint4 pr;
  float4 sr[4];

  auto load = [&](int kb) {
    const int k0 = kb * BK;
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int idx = tid + i * THREADS_E;
      const int r = idx % BM, c = (idx / BM) * 4;
      xr[i] = load_x4(x + (size_t)(m0 + r) * n_pad + k0 + c);
    }
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
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int idx = tid + i * THREADS_E;
      const int r = idx % BM, c = (idx / BM) * 4;
      xs[(c + 0) * LDX + r] = xr[i].x;
      xs[(c + 1) * LDX + r] = xr[i].y;
      xs[(c + 2) * LDX + r] = xr[i].z;
      xs[(c + 3) * LDX + r] = xr[i].w;
    }
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
      float a[TM];
      const float* xk = xs + k * LDX + ty * TM;
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xk + i);
          a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; i += 2) {
          const float2 v = *reinterpret_cast<const float2*>(xk + i);
          a[i] = v.x; a[i + 1] = v.y;
        }
      }
      const float4 b = *reinterpret_cast<const float4*>(ws + k * BN + tx * TN);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
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

template <int BM, typename XT>
cudaError_t launch(const void* x, const void* packed, const void* scales, const void* code, void* dst,
                   int b_pad, int n_pad, int m_pad, int kb_per_split, int ksplit, size_t stride,
                   int kind, cudaStream_t stream) {
  constexpr size_t smem = ExactTile<BM>::SMEM;
  // Above 48 KB of shared memory only with the opt-in (BM 64: 50,240 bytes).
  cudaError_t err = cudaFuncSetAttribute(nf4_matmul_exact_kernel<BM, XT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(m_pad / BN, b_pad / BM, ksplit);
  nf4_matmul_exact_kernel<BM, XT><<<grid, THREADS_E, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(code), dst, n_pad, m_pad,
      kb_per_split, stride, kind);
  return cudaGetLastError();
}

}  // namespace

// x fp32 (x_kind 0) or fp16 (x_kind 2) [b_pad, n_pad]; packed u8
// [n_pad/2, m_pad]; scales fp32 [n_pad/64, m_pad]; code fp32 [16]; out
// [b_pad, m_pad] of out_kind (0 fp32, 1 bf16, 2 fp16).  bm is 16 or 64 and
// divides b_pad; n_pad is a multiple of 64 and m_pad of 128; every pointer
// 16-byte aligned.  ksplit > 1 needs workspace fp32 [ksplit, b_pad, m_pad].
extern "C" int nf4_matmul_exact(const void* x, const void* packed, const void* scales,
                                const void* code, void* out, void* workspace, int b_pad,
                                int n_pad, int m_pad, int bm, int x_kind, int ksplit,
                                int out_kind, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((bm != 16 && bm != 64) || b_pad % bm || n_pad % BK || m_pad % BN || ksplit < 1 ||
      (x_kind != 0 && x_kind != 2) || out_kind < 0 || out_kind > 2 ||
      (ksplit > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nkb = n_pad / BK;
  const int per = (nkb + ksplit - 1) / ksplit;
  void* dst = ksplit > 1 ? workspace : out;
  const int kind = ksplit > 1 ? 0 : out_kind;
  const size_t stride = (size_t)b_pad * m_pad;
  cudaError_t err;
  if (bm == 16) {
    err = x_kind == 0
        ? launch<16, float>(x, packed, scales, code, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s)
        : launch<16, __half>(x, packed, scales, code, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  } else {
    err = x_kind == 0
        ? launch<64, float>(x, packed, scales, code, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s)
        : launch<64, __half>(x, packed, scales, code, dst, b_pad, n_pad, m_pad, per, ksplit, stride, kind, s);
  }
  if (err != cudaSuccess) return (int)err;
  if (ksplit > 1) gemm::splitk_reduce(static_cast<const float*>(workspace), out, ksplit, stride, out_kind, s);
  return (int)cudaGetLastError();
}
