// The pipelined wgmma main loop that the prefill branches of kernels B
// (matmul.cu: 4-bit weights, bf16 x), D (int8_matmul.cu: int8 weights, bf16
// x) and E (matmul_exact.cu: 4-bit weights, fp32 x as 3xTF32) share:
// y[B, m] = x[B, n] . W^T[n, m] with W^T decoded in shared memory from the
// weight's stored form, one K step at a time.
//
// A block of WGS consumer warpgroups computes PM = 64 * WGS rows x BN
// columns, each warpgroup 64 rows with its accumulators in registers.  A K
// step is KS K rows.  A 4-stage ring holds, three steps ahead, the x tile
// (TMA, started by one thread, K-major and 128-byte swizzled: the layout
// wgmma reads; completion on one mbarrier per stage) and the weight's raw
// rows and scales (cp.async).  While the asynchronous wgmma of step s runs,
// the threads decode step s+1's raw rows into the other of two W^T tiles,
// written K-major under the same swizzle, so one descriptor form serves
// both operands.  The ragged last row tile is zero-filled by the TMA copy
// and masked at the store.  K may be split across blocks (blockIdx.z) at
// step boundaries; each split writes an fp32 partial that the caller sums.
//
// What differs between the kernels is an Op, a struct of static members:
//   PM, BN, THREADS, KS            the block's tiling
//   X_BYTES, W_BYTES, RAW_BYTES    a ring stage of x, one W^T tile, a ring
//   AUX_BYTES                      stage of raw rows; a table for the decode
//   ACC                            fp32 accumulators per thread
//   STEP_SUMS                      each step's products start from 0 and are
//                                  added to a running sum in registers
//   init_aux(aux, src, tid)        fill the table (every thread)
//   load_x(map, dst, bar, step, m0, b_pad)          TMA of the x tile(s) (one thread)
//   load_raw(raw, sc, w, scales, step, n0, m_pad, tid)  cp.async of the raw rows, scales
//   decode(raw, sc, wt, aux, tid)  raw rows -> W^T tile
//   mma(acc, xs, wg, wt)           step's products of warpgroup wg

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace dg {

constexpr int STAGES = 4;

// Shared memory: two W^T tiles, STAGES ring stages of the x tile (1024-byte
// aligned, 128-byte rows), of the raw rows and of the BN scales; the decode
// table; one mbarrier per ring stage.
template <class Op>
struct Smem {
  static constexpr int W = 0;
  static constexpr int W_TILES = 2;
  static constexpr int X = W_TILES * Op::W_BYTES;
  static constexpr int RAW = X + STAGES * Op::X_BYTES;
  static constexpr int SC = RAW + STAGES * Op::RAW_BYTES;
  static constexpr int AUX = SC + STAGES * Op::BN * 4;
  static constexpr int MBAR = AUX + Op::AUX_BYTES;
  static constexpr int BYTES = MBAR + STAGES * 8 + 1024;  // + alignment slack
  static_assert(Op::W_BYTES % 1024 == 0 && Op::X_BYTES % 1024 == 0, "swizzled tiles stay 1024-byte aligned");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// out_kind 0/1/2 = fp32/bf16/fp16 written at out + blockIdx.z * split_stride.
template <class Op>
__global__ void __launch_bounds__(Op::THREADS, 1)
dequant_gemm(const __grid_constant__ CUtensorMap x_map, const uint8_t* __restrict__ w,
             const float* __restrict__ scales, const void* __restrict__ aux, void* __restrict__ out,
             int b_pad, int n_pad, int m_pad, int steps_per_split, size_t split_stride, int out_kind) {
  using L = Smem<Op>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // The swizzled tiles need 1024-byte alignment: round the base up (the
  // allocation has 1 KB to spare).
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = hop::smem_u32(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;
  // Row tiles run fastest, so the blocks that share a weight tile run
  // together and its bytes come from device memory once.
  const int m0 = blockIdx.x * Op::PM, n0 = blockIdx.y * Op::BN;
  const int nsteps = n_pad / Op::KS;
  const int s0 = blockIdx.z * steps_per_split;
  const int nk = max(0, min(nsteps, s0 + steps_per_split) - s0);

  // Start the copies of K step i (global step s0 + i) into ring stage i %
  // STAGES: the x tile by TMA (rows past the tensor zero-filled), completing
  // on the stage's mbarrier; the raw rows and scales by cp.async.
  const uint32_t mbar = sbase + L::MBAR;
  auto load = [&](int i) {
    const int step = s0 + i, st = i % STAGES;
    if (tid == 0) Op::load_x(&x_map, sbase + L::X + st * Op::X_BYTES, mbar + st * 8, step, m0, b_pad);
    Op::load_raw(sbase + L::RAW + st * Op::RAW_BYTES, sbase + L::SC + st * Op::BN * 4, w, scales, step, n0,
                 m_pad, tid);
  };
  auto decode = [&](int i, int wb) {
    const int st = i % STAGES;
    Op::decode(smem + L::RAW + st * Op::RAW_BYTES, reinterpret_cast<const float*>(smem + L::SC + st * Op::BN * 4),
               smem + L::W + wb * Op::W_BYTES, smem + L::AUX, tid);
  };

  // The accumulators: no instruction but wgmma may touch them while a
  // product is in flight (ptxas would serialize the products), so they are
  // fenced only before the first and after the last.
  // With STEP_SUMS a step's products accumulate from 0 (the Op's first
  // product has scale_d 0) and are added to `sum` with round-to-nearest
  // fp32 adds once they have landed: the tensor cores truncate their
  // accumulator, and over thousands of products into one accumulator that
  // bias grows linearly (kernel E: 1.7e-5 of the largest output at K=4096).
  float acc[Op::ACC];
  float sum[Op::STEP_SUMS ? Op::ACC : 1];
#pragma unroll
  for (int j = 0; j < Op::ACC; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (Op::STEP_SUMS ? Op::ACC : 1); ++j) sum[j] = 0.f;
  hop::fence_regs(acc);

  Op::init_aux(smem + L::AUX, aux, tid);
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
    Op::mma(acc, sbase + L::X + (i % STAGES) * Op::X_BYTES, wg, sbase + L::W + (i % L::W_TILES) * Op::W_BYTES);
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
    if constexpr (Op::STEP_SUMS) {
      hop::fence_regs(acc);
#pragma unroll
      for (int j = 0; j < Op::ACC; ++j) sum[j] = __fadd_rn(sum[j], acc[j]);
    }
  }
  hop::fence_regs(acc);
  hop::cp_async_wait<0>();

  // Epilogue straight from the accumulators: fragment j holds rows g and
  // g+8 of this warp's 16, columns 8j + 2*(lane % 4) and the next.
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  void* dst = out_kind == 0 ? static_cast<void*>(static_cast<float*>(out) + blockIdx.z * split_stride) : out;
#pragma unroll
  for (int j = 0; j < Op::BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= b_pad) continue;
      const float a = Op::STEP_SUMS ? sum[4 * j + 2 * h] : acc[4 * j + 2 * h];
      const float b = Op::STEP_SUMS ? sum[4 * j + 2 * h + 1] : acc[4 * j + 2 * h + 1];
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

// The TMA descriptor of a row-major 2-D tensor [rows, n_pad] of `elem_bytes`
// elements (bf16 or fp32) for boxes of 128 bytes of K x `box_rows` rows
// under the 128-byte swizzle.  cuTensorMapEncodeTiled lives in libcuda; it
// is reached through the runtime's entry-point query, so the library links
// only the CUDA runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline int x_tensor_map(CUtensorMap* map, const void* x, int elem_bytes, int rows, int n_pad, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return err != cudaSuccess ? (int)err : (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)n_pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n_pad * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type = elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = encode(map, type, 2, const_cast<void*>(x), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The part of an Op that kernels B and D share: bf16 x in 128-byte rows by
// one TMA copy a step, K steps of 64 rows (one scale row), products
// wgmma.m64nBNk16 into fp32 accumulators, and the decode's work split: a
// unit is one 8-K-row piece of CW neighbouring columns, and the block's 8 x
// BN / CW units are spread evenly over its threads.  Their Ops add the
// weight ring and the decode.
template <int BN_, int WGS>
struct Bf16Op {
  static constexpr int PM = 64 * WGS;  // rows per block
  static constexpr int BN = BN_;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int KS = 64;
  static constexpr int W_BYTES = BN * KS * 2;
  static constexpr int X_BYTES = PM * KS * 2;
  static constexpr int ACC = BN / 2;  // fp32 accumulators per thread
  static constexpr bool STEP_SUMS = false;
  static constexpr int CW = 8 * BN / THREADS >= 4 ? 4 : 2;
  static constexpr int UNITS = 8 * BN / CW / THREADS;

  static __device__ __forceinline__ void load_x(const CUtensorMap* map, uint32_t dst, uint32_t bar, int step,
                                                int m0, int) {
    hop::mbar_arrive_expect_tx(bar, X_BYTES);
    hop::tma_load_2d(dst, map, step * KS, m0, bar);
  }

  static __device__ __forceinline__ void mma(float (&acc)[ACC], uint32_t xs, int wg, uint32_t wt) {
    const uint32_t xa = xs + wg * (64 * 128);
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      if constexpr (BN == 256) hop::wgmma_m64n256k16(acc, hop::wgmma_desc(xa + kk * 32), hop::wgmma_desc(wt + kk * 32), 1);
      else hop::wgmma_m64n128k16(acc, hop::wgmma_desc(xa + kk * 32), hop::wgmma_desc(wt + kk * 32), 1);
    }
  }
};

// Launch the main loop of Op over x's tensor map: a grid of row tiles
// (fastest) x column tiles x K splits of `steps_per_split` steps.
template <class Op>
int launch(const CUtensorMap& x_map, const void* w, const void* scales, const void* aux, void* dst, int b_pad,
           int n_pad, int m_pad, int steps_per_split, int ksplit, size_t stride, int kind, cudaStream_t stream) {
  using L = Smem<Op>;
  static hop::SmemOptIn opt_in;
  const cudaError_t err = opt_in(reinterpret_cast<const void*>(dequant_gemm<Op>), L::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((b_pad + Op::PM - 1) / Op::PM, m_pad / Op::BN, ksplit);
  dequant_gemm<Op><<<grid, Op::THREADS, L::BYTES, stream>>>(
      x_map, static_cast<const uint8_t*>(w), static_cast<const float*>(scales), aux, dst, b_pad, n_pad, m_pad,
      steps_per_split, stride, kind);
  return 0;
}

}  // namespace dg
