// The decode kernel (b_pad <= 16) that kernels B (matmul.cu, 4-bit packed
// weights) and D (int8_matmul.cu, int8 weights) share: y^T [m, 16] = W [m,
// n] . x^T on mma.sync m16n8k16, the weights the A operand (16 output
// columns x 16 K rows), x the B operand (two n8 tiles of batch rows).
// Kernel E's decode kernel (matmul_exact.cu: 3xTF32 on m16n8k8) has a loop
// of its own and shares this file's constants, column mapping and epilogue
// (finish).
//
// What the two share, and what a kernel's Dec policy supplies:
// * The mapping (free, as long as the epilogue undoes it): lane (g, t) =
//   (lane / 4, lane % 4) of a warp owns columns 16g .. 16g+15 of the
//   warp's 128, A rows g and g+8 of m-tile mt being columns 16g + 2mt and
//   16g + 2mt + 1.  In scale block kb (64 K rows) lane t owns K rows 64kb +
//   16t .. +15, and K step s takes rows 16t + 4s, +1 (the mma's K slots 2t,
//   2t+1) and 16t + 4s + 2, +3 (slots 2t+8, 2t+9), so its x operand is 8
//   contiguous bytes of each batch row.
// * The weight rows: a scale block is 4 * Dec::PIECES rows of the weight's
//   storage (B: 32 packed rows, each byte two K rows; D: 64 int8 rows), and
//   lane t copies rows PIECES*t .. +PIECES-1 at its 16 columns, one 16-byte
//   piece each (a warp: four full 128-byte rows per copy), in a
//   Dec::STAGES-deep ring, with no block barrier in the K loop.  Two ways
//   to fill it: per lane (Dec::BULK false), each lane copies its own
//   pieces by cp.async into a private slot (piece r at 512r + 16 lane) and
//   waits only on its own groups; by bulk copy (Dec::BULK true), the warp
//   copies its 4 * PIECES rows of 128 bytes, row by row (one
//   cp.async.bulk each, spread over the lanes), into a slot of ROW_LD-byte
//   rows skewed by 32 bytes per lane t (row k at ROW_LD k + 32 (k /
//   PIECES)), completed on one mbarrier per warp and stage: lane (g, t)
//   reads row PIECES t + r at chunk g, and the skew puts the 8 lanes of
//   each quarter warp on 8 distinct 16-byte bank groups.  Dec::Step reads
//   a K step's pieces from the slot (Dec::PIECE_LD bytes apart) and
//   Dec::Step::regs turns them into the A registers of m-tile mt
//   (Dec::SMEM bytes after the ring are the Dec's own, set up by
//   Dec::init: B's byte table).
// * x and the scales come from L2 into registers one scale block ahead (the
//   scales' lines are prefetched to L2 when their rows are copied).  When
//   batch rows 8-15 of x are zero in a scale block (batches of up to 8
//   rows), a warp vote skips their n8 tile's products.
// * A block has WN x WK warps: WN side by side over 128 columns each, WK on
//   the same columns taking every WK-th scale block of the block's K range,
//   their fp32 sums added in warp order through shared memory.
// * Where the column tiles alone cannot fill the card the blocks also split
//   K (ops/matmul.py: _decode_ksplit, one wave of resident blocks, from the
//   occupancy that shape() reports); each split writes its fp32 partial,
//   counts itself on the output tile's counter, and the split that comes
//   last sums all partials in split order (its own from registers, the
//   others' four splits to a trip to L2), stores the output type and resets
//   the counter: one launch per product, safe to capture in a CUDA graph.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_common.cuh"
#include "hopper.cuh"

namespace dm {

using gemm::BK;

constexpr int WCOLS = 128;   // output columns per warp: 8 lane groups x 16
constexpr int MT = 8;        // m16 tiles per warp
constexpr int ROWS = 16;     // batch rows per block: two n8 tiles
constexpr int WN = 1;        // warps side by side over a block's columns
constexpr int WK = 4;        // warps on the same columns, each over its own scale blocks
constexpr int WARPS = WN * WK;
constexpr int COLS = WN * WCOLS;  // output columns per block
constexpr int THREADS = WARPS * 32;
constexpr int CS_LD = WCOLS + 4;              // fp32 staging row stride
constexpr int STAGING_BYTES = WARPS * ROWS * CS_LD * 4;

constexpr int ROW_LD = WCOLS + 16;           // a bulk-copied row's stride in a slot

// Bytes of one warp's ring slot (one scale block), of the ring, and of the
// block's shared memory: the ring, the Dec's own bytes and (bulk copies)
// one mbarrier per warp and stage, or the epilogue's staging if larger.
template <class Dec>
__host__ __device__ constexpr int slot_bytes() {
  return Dec::BULK ? ROW_LD * 4 * Dec::PIECES + 32 * 3 /* lane t = 3's skew */ : Dec::PIECES * 32 * 16;
}

template <class Dec>
__host__ __device__ constexpr int ring_bytes() {
  return WARPS * Dec::STAGES * slot_bytes<Dec>();
}

template <class Dec>
__host__ __device__ constexpr int smem_bytes() {
  const int used = ring_bytes<Dec>() + Dec::SMEM + (Dec::BULK ? WARPS * Dec::STAGES * 8 : 0);
  return used > STAGING_BYTES ? used : STAGING_BYTES;
}

// Row k of a bulk-copied slot: lane t's rows are skewed by 32t bytes.
template <class Dec>
__device__ __forceinline__ int row_off(int k) {
  return ROW_LD * k + 32 * (k / Dec::PIECES);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The epilogue of the decode kernels (this file's and kernel E's,
// matmul_exact.cu): acc, a warp's sums over its scale blocks in the mma's
// C fragments, through shared memory (the kernel's dynamic shared memory,
// once every warp is done with its ring) into the warp sums, the K-split
// partials and out.  tid is the thread, nb and r0 the block's first column
// and batch row.
__device__ __forceinline__ void finish(const float (&acc)[MT][2][4], void* __restrict__ out,
                                       float* __restrict__ work, int* __restrict__ counters, int tid, int nb,
                                       int r0, int m_pad, int out_kind) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  hop::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring and the kernel's own shared memory

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

// out_kind 0/1/2 = fp32/bf16/fp16.  gridDim.z > 1: split blockIdx.z of
// the K range writes its fp32 partial to work + blockIdx.z * b_pad * m_pad,
// and the split that comes last on its output tile's counter sums them
// into out.
template <class Dec>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ weights,
              const float* __restrict__ scales, const void* __restrict__ table, void* __restrict__ out,
              float* __restrict__ work, int* __restrict__ counters, int n_pad, int m_pad,
              int kb_per_split, int out_kind) {
  constexpr int PIECES = Dec::PIECES, STAGES = Dec::STAGES;
  constexpr int SLOT_BYTES = slot_bytes<Dec>();  // one warp's scale block
  constexpr int RING_BYTES = ring_bytes<Dec>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nb = blockIdx.x * COLS, r0 = blockIdx.y * ROWS;
  const int n0 = nb + (warp % WN) * WCOLS;                // this warp's first column
  const int kb0 = blockIdx.z * kb_per_split + warp / WN;  // and first scale block
  const int kb1 = min(n_pad / BK, (int)(blockIdx.z + 1) * kb_per_split);
  const int cnt = n0 < m_pad && kb0 < kb1 ? (kb1 - kb0 + WK - 1) / WK : 0;

  const unsigned char* aux = smem + RING_BYTES;
  const uint32_t lane4 = 4 * lane;

  // This lane's sources in scale block kb: weight rows 4 * PIECES * kb +
  // PIECES * t + r at columns n0 + 16g .. +15 (bulk copies: rows 4 * PIECES
  // * kb + k at columns n0 .. +127, k = lane, lane + 32, ...) and those
  // columns' scales; x rows r0 + g and r0 + 8 + g at K rows 64kb + 16t ..
  // +15.
  const uint8_t* pk = weights + n0 + (Dec::BULK ? 0 : (size_t)(PIECES * t) * m_pad + 16 * g);
  const float* sc = scales + n0 + 16 * g;
  const __nv_bfloat16* xa = x + (size_t)(r0 + g) * n_pad + 16 * t;
  const __nv_bfloat16* xb = xa + (size_t)8 * n_pad;
  // The ring slots this lane copies into and reads: piece r of slot s at +
  // s * SLOT_BYTES + r * Dec::PIECE_LD (per lane: 512; bulk copies: the
  // warp's slot, and the lane reads from row PIECES * t, chunk g).
  const int warp_off = warp * STAGES * SLOT_BYTES;
  const int read_off = warp_off + (Dec::BULK ? row_off<Dec>(PIECES * t) + 16 * g : 16 * lane);
  const uint32_t ring = hop::smem_u32(smem) + (Dec::BULK ? warp_off : read_off);
  const unsigned char* ring_ptr = smem + read_off;
  const uint32_t bars = hop::smem_u32(smem + RING_BYTES + Dec::SMEM) + warp * STAGES * 8;
  if constexpr (Dec::BULK) {
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
      if constexpr (Dec::BULK) {
        const uint32_t bar = bars + (i % STAGES) * 8;
        __syncwarp();  // every lane is done reading the slot
        if (lane == 0) hop::mbar_arrive_expect_tx(bar, 4 * PIECES * WCOLS);
#pragma unroll
        for (int k = lane; k < 4 * PIECES; k += 32) hop::bulk_copy(dst + row_off<Dec>(k), src + (size_t)k * m_pad, WCOLS, bar);
      } else {
#pragma unroll
        for (int r = 0; r < PIECES; ++r) hop::cp_async16(dst + r * 512, src + (size_t)r * m_pad, true);
      }
      hop::prefetch_l2(scales + (size_t)kb * m_pad + n0 + 16 * g + 4 * t);
    }
    if constexpr (!Dec::BULK) hop::cp_async_commit();
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
  __syncthreads();             // the Dec's shared memory is in place

  for (int i = 0; i < cnt; ++i) {
    if constexpr (Dec::BULK) hop::mbar_wait(bars + (i % STAGES) * 8, (i / STAGES) & 1);  // the warp's rows of step i
    else hop::cp_async_wait<STAGES - 2>();  // this lane's pieces of step i have landed
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
      const typename Dec::Step step(slot, s);  // this lane's weight bytes of K step s
      // x at K rows 64kb + 16t + 4s .. +3: K slots 2t, 2t+1 and 2t+8, 2t+9.
      const uint32_t* x0 = reinterpret_cast<const uint32_t*>(&xc[s / 2]) + 2 * (s % 2);
      const uint32_t* x1 = reinterpret_cast<const uint32_t*>(&xc[2 + s / 2]) + 2 * (s % 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        step.regs(a, mt, s2, aux, lane4);
        hop::mma_bf16_16816(acc[mt][0], a, x0[0], x0[1]);
        if (rows_hi) hop::mma_bf16_16816(acc[mt][1], a, x1[0], x1[1]);
      }
    }
  }
  finish(acc, out, work, counters, tid, nb, r0, m_pad, out_kind);
}

template <class Dec>
cudaError_t opt_in() {
  static hop::SmemOptIn opt_in;
  return opt_in(reinterpret_cast<const void*>(&decode_kernel<Dec>), smem_bytes<Dec>());
}

// One launch: b_pad a multiple of ROWS; ksplit > 1 needs work (fp32
// [ksplit, b_pad, m_pad]) and counters (int32, one per output tile, zero).
template <class Dec>
int launch(const void* x, const void* weights, const void* scales, const void* table, void* out, float* work,
           int* counters, int b_pad, int n_pad, int m_pad, int kb_per_split, int ksplit, int kind,
           cudaStream_t stream) {
  const cudaError_t err = opt_in<Dec>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((m_pad + COLS - 1) / COLS, b_pad / ROWS, ksplit);
  decode_kernel<Dec><<<grid, THREADS, smem_bytes<Dec>(), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(weights), static_cast<const float*>(scales),
      table, out, work, counters, n_pad, m_pad, kb_per_split, kind);
  return 0;
}

// The output columns per block and the resident blocks per SM on the
// current device (ops/matmul.py sizes the K split by them).
template <class Dec>
int shape(int* cols, int* blocks) {
  *cols = COLS;
  const cudaError_t err = opt_in<Dec>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, decode_kernel<Dec>, THREADS, smem_bytes<Dec>());
}

}  // namespace dm
