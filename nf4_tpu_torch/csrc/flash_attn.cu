// Prefill flash attention over a bf16 or int8 KV cache (kernel C).
//
// Replaces: nf4_tpu/ops/attention.py:flash_attention (kernel body
// _make_flash_kernel), both the bf16-KV and the int8-KV branch.
//
// Computes: out[b, h, s] = softmax(scale * q . k^T) . v over the cache
// slots t visible to query position p = pos0[b] + s:
//   t <= p (causal), t < seq_len[b], t < T, and t > p - window when
//   window > 0,
// with the TPU kernel's numerics: fp32 scores times `scale`, fp32 running
// max m, normaliser l and accumulator, probabilities rounded to bf16 before
// the P.V product (bf16 in, fp32 accumulation), masked scores set to -1e30
// (finite: a row that is fully masked so far carries garbage that the
// first visible tile discards), and a final acc / max(l, 1e-30).  exp is
// the hardware's exp2 approximation (__expf: relative error ~1e-6 over the
// range a softmax meets, far below the bf16 rounding of p; expf takes 2-6%
// more time, utils/kernel_variants.py).
//
// int8 KV (INT8 = true): k and v are int8 with fp32 per-slot absmax scales
// ks, vs [B, KV, T].  Each score is multiplied by ks[t] / 127 after the
// `* scale`; l takes the unscaled probability p, and p is multiplied by
// vs[t] / 127 before its bf16 rounding and the P.V product (the TPU
// kernel's order: folding vs into l, or applying it after P.V, would be
// another function).
//
// Bound on the H100: operations at prefill lengths (each K/V tile feeds 64
// query rows; 989 TFLOP/s bf16), bytes only for short prompts over a long
// cache.  Design (the FlashAttention-2 layout on mma.sync):
// * One warpgroup per query tile of 64 rows: the GQA-packed [G, sc] rows
//   of the TPU kernel (row r = query head kv*G + r / sc at position pos0 +
//   q_tile*sc + r % sc, sc = 64 / G), so every K/V tile in shared memory
//   serves all G heads.  A block holds one query tile (bf16 KV) or two
//   neighbouring ones (int8 KV, which then converts each K/V tile once for
//   128 rows) of one (batch x KV head); a warpgroup skips the KV tiles its
//   own query tile cannot see.  Query tiles launch latest (heaviest under
//   the causal mask) first, so the long rows do not form the tail.
// * Each warp owns 16 rows.  S = Q.K^T, the online softmax and O live in
//   registers: S and O are mma.m16n8k16 accumulators, each row's max and
//   sum are reduced over the 4 lanes that hold it, and the probabilities
//   are converted to bf16 in registers as the A operand of P.V.  Only the
//   Q, K and V tiles live in shared memory (128-byte XOR swizzle, read by
//   ldmatrix without bank conflicts; V through ldmatrix.trans).
// * K/V tiles of 64 slots come through a 2-stage ring of cp.async copies:
//   tile i+1 loads while tile i multiplies.  Tiles wholly invisible to the
//   block (past its last position or seq_len, or wholly behind the window
//   of its first position) are never loaded; a tile that every row sees
//   wholly skips the mask arithmetic.
// * int8 KV: the int8 tiles and their scale slices are copied as they are
//   and converted to bf16 (exact for |v| <= 127) in shared memory.
// * Query rows past S and cache slots past T are zero-filled by the copies
//   instead of padding the tensors, so the KV cache is read in place
//   (batch and head strides are arguments; the int8 scale planes too).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BR = 64;  // query rows per query tile (one warpgroup)
constexpr int BC = 64;  // cache slots per KV tile
constexpr int STAGES = 2;
constexpr float NEG = -1e30f;

// Query tiles per block: 1 for bf16 KV; 2 for int8 KV, so that each
// converted K/V tile serves 128 rows and the conversion costs half as much
// per product.
template <bool INT8>
constexpr int QT = INT8 ? 2 : 1;

// Shared memory: the Q tiles, then two bf16 K and V tiles (the copy ring
// for bf16 KV; for int8 KV the converted tiles, while a ring of three
// stages holds the raw int8 tiles and their fp32 scale slices).
template <int D, bool INT8>
struct Smem {
  static constexpr int ROW = D * 2;    // bytes of a bf16 row
  static constexpr int TILE = BC * ROW;  // = BR * ROW
  static constexpr int Q = 0;
  static constexpr int K = Q + QT<INT8> * TILE;
  static constexpr int V = K + 2 * TILE;
  static constexpr int RAW = V + 2 * TILE;
  static constexpr int RAW_STAGES = 3;
  static constexpr int RAW_STAGE = 2 * BC * D + 2 * BC * 4;  // int8 K, V, then ks, vs
  static constexpr int BYTES = RAW + (INT8 ? RAW_STAGES * RAW_STAGE : 0);
};

// 4 int8 values -> 4 bf16 values (exact), without the slow conversion
// pipe: byte x + 128 becomes the low mantissa byte of 2^23 + x + 128 in
// fp32, a subtraction leaves x exactly, and |x| <= 128 needs no rounding
// to bf16, so the bf16 value is the fp32 value's high half.
__device__ __forceinline__ uint2 int8x4_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// 16 int8 values -> 16 bf16 values (exact), as two 16-byte pieces.
__device__ __forceinline__ void int8x16_to_bf16(uint4 src, uint4& lo, uint4& hi) {
  const uint2 a = int8x4_to_bf16(src.x), b = int8x4_to_bf16(src.y);
  const uint2 c = int8x4_to_bf16(src.z), d = int8x4_to_bf16(src.w);
  lo = make_uint4(a.x, a.y, b.x, b.y);
  hi = make_uint4(c.x, c.y, d.x, d.y);
}

template <int D, bool INT8>
__global__ void __launch_bounds__(128 * QT<INT8>)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                  const void* __restrict__ v, const float* __restrict__ ks,
                  const float* __restrict__ vs, __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ pos0s, const int* __restrict__ seq_lens, int H, int KV,
                  int S, int T, long long k_sb, long long k_sh, long long v_sb, long long v_sh,
                  long long ks_sb, long long ks_sh, long long vs_sb, long long vs_sh,
                  int sc, int window, float scale) {
  using L = Smem<D, INT8>;
  constexpr int THREADS = 128 * QT<INT8>;
  constexpr int CH = D / 8;  // 16-byte chunks per bf16 row
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = hop::smem_u32(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment row group and column pair
  const int bk = blockIdx.x;              // b * KV + kv head
  const int b = bk / KV, kvh = bk % KV;
  const int G = H / KV;
  const int qi0 = (gridDim.y - 1 - blockIdx.y) * QT<INT8>;  // latest query tiles first
  const int seq_len = seq_lens[b];
  // This warp's query tile qi and the KV tiles [tw_begin, tw_end) it sees;
  // the block loads the union over its query tiles.
  const int qi = qi0 + warp / 4;
  const int pos_first = pos0s[b] + qi * sc;  // position of the tile's row 0
  const int pos_last = pos_first + sc - 1;
  const int tw_end = min(T, min(pos_last + 1, seq_len));
  const int tw_begin = window > 0 ? max(0, (pos_first - window + 1) / BC * BC) : 0;

  // Q tiles: row r of query tile qi0 + r/64 -> head kvh*G + (r%64)/sc,
  // sequence index (qi0 + r/64)*sc + (r%64)%sc.
  for (int i = tid; i < QT<INT8> * BR * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const int h = kvh * G + (r % BR) / sc, s = (qi0 + r / BR) * sc + (r % BR) % sc;
    const bool ok = s < S;
    const __nv_bfloat16* src = ok ? q + (((size_t)b * H + h) * S + s) * D + c * 8 : q;
    hop::cp_async16(sbase + L::Q + hop::swz(r, c, L::ROW), src, ok);
  }

  const int blk_first = pos0s[b] + qi0 * sc, blk_last = blk_first + QT<INT8> * sc - 1;
  const int t_end = min(T, min(blk_last + 1, seq_len));
  const int t_begin = window > 0 ? max(0, (blk_first - window + 1) / BC * BC) : 0;
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + BC - 1) / BC : 0;
  using KV_T = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  const KV_T* kb = static_cast<const KV_T*>(k) + b * k_sb + kvh * k_sh;
  const KV_T* vb = static_cast<const KV_T*>(v) + b * v_sb + kvh * v_sh;
  const float* ksb = INT8 ? ks + b * ks_sb + kvh * ks_sh : nullptr;
  const float* vsb = INT8 ? vs + b * vs_sb + kvh * vs_sh : nullptr;

  // Start the copies of KV tile i into ring stage i % STAGES (bf16) or
  // i % RAW_STAGES (int8).
  auto fetch = [&](int i) {
    const int t0 = t_begin + i * BC, st = i % (INT8 ? L::RAW_STAGES : STAGES);
    if constexpr (INT8) {
      constexpr int CH8 = D / 16;  // 16-byte chunks per int8 row
      const uint32_t raw = sbase + L::RAW + st * L::RAW_STAGE;
      for (int j = tid; j < BC * CH8; j += THREADS) {
        const int r = j / CH8, c = j % CH8;
        const bool ok = t0 + r < T;
        const size_t off = (size_t)(ok ? t0 + r : 0) * D + c * 16;
        hop::cp_async16(raw + r * D + c * 16, kb + off, ok);
        hop::cp_async16(raw + BC * D + r * D + c * 16, vb + off, ok);
      }
      for (int j = tid; j < 2 * BC; j += THREADS) {  // ks then vs, one slot each
        const int c = j % BC, t = t0 + c;
        const bool ok = t < T;
        hop::cp_async4(raw + 2 * BC * D + j * 4, (j < BC ? ksb : vsb) + (ok ? t : 0), ok);
      }
    } else {
      for (int j = tid; j < BC * CH; j += THREADS) {
        const int r = j / CH, c = j % CH;
        const bool ok = t0 + r < T;
        const size_t off = (size_t)(ok ? t0 + r : 0) * D + c * 8;
        const uint32_t o = st * L::TILE + hop::swz(r, c, L::ROW);
        hop::cp_async16(sbase + L::K + o, kb + off, ok);
        hop::cp_async16(sbase + L::V + o, vb + off, ok);
      }
    }
  };

  // int8 KV: convert tile i (raw ring stage i % RAW_STAGES) into bf16 K/V
  // tile i % 2, and its scale slices into ks[t] / 127 and vs[t] / 127 in
  // place (each computed once per slot).
  auto convert = [&](int i) {
    unsigned char* raw = smem + L::RAW + (i % L::RAW_STAGES) * L::RAW_STAGE;
    const int kv = (i % 2) * L::TILE;
    constexpr int CH8 = D / 16;
    for (int j = tid; j < BC * CH8; j += THREADS) {
      const int r = j / CH8, c = j % CH8;
      uint4 lo, hi;
      int8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + r * D + c * 16), lo, hi);
      *reinterpret_cast<uint4*>(smem + L::K + kv + hop::swz(r, 2 * c, L::ROW)) = lo;
      *reinterpret_cast<uint4*>(smem + L::K + kv + hop::swz(r, 2 * c + 1, L::ROW)) = hi;
      int8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + BC * D + r * D + c * 16), lo, hi);
      *reinterpret_cast<uint4*>(smem + L::V + kv + hop::swz(r, 2 * c, L::ROW)) = lo;
      *reinterpret_cast<uint4*>(smem + L::V + kv + hop::swz(r, 2 * c + 1, L::ROW)) = hi;
    }
    float* fac = reinterpret_cast<float*>(raw + 2 * BC * D);
    for (int j = tid; j < 2 * BC; j += THREADS) fac[j] *= 1.f / 127.f;
  };

  if (n_tiles > 0) fetch(0);
  hop::cp_async_commit();  // group 0: Q and KV tile 0
  if constexpr (INT8) {
    if (n_tiles > 1) fetch(1);
    hop::cp_async_commit();
    hop::cp_async_wait<1>();
    __syncthreads();
    if (n_tiles > 0) convert(0);
  }

  float o[CH][4];  // O: rows g and g+8 of this warp's 16, columns n*8 + 2tq (+1)
#pragma unroll
  for (int n = 0; n < CH; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  const int ra = warp * 16 + g, rb = ra + 8;  // rows in the block's Q tiles
  const int pa = pos_first + (ra % BR) % sc, pb = pos_first + (rb % BR) % sc;
  const int q_row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;  // ldmatrix row of Q

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = t_begin + i * BC;
    const uint32_t k_tile = sbase + L::K + (i % 2) * L::TILE, v_tile = sbase + L::V + (i % 2) * L::TILE;
    const float* kfac = nullptr;
    const float* vfac = nullptr;
    if constexpr (INT8) {
      // One barrier per tile: tile i was converted during tile i-1 (or
      // before the loop), tile i+1's raw copy lands now and converts while
      // this warp's products of tile i run beside the other warps'.
      if (i + 1 < n_tiles) hop::cp_async_wait<0>();
      __syncthreads();
      if (i + 2 < n_tiles) fetch(i + 2);
      hop::cp_async_commit();
      if (i + 1 < n_tiles) convert(i + 1);
      kfac = reinterpret_cast<const float*>(smem + L::RAW + (i % L::RAW_STAGES) * L::RAW_STAGE + 2 * BC * D);
      vfac = kfac + BC;
    } else {
      if (i + 1 < n_tiles) fetch(i + 1);
      hop::cp_async_commit();
      hop::cp_async_wait<1>();  // tile i (and Q) landed for this thread's copies
      __syncthreads();          // ... and for every thread's
    }
    if (t0 < tw_begin || t0 >= tw_end) {  // wholly invisible to this warp's query tile
      if constexpr (!INT8) __syncthreads();
      continue;
    }

    // S = Q . K^T for this warp's 16 rows and the tile's 64 slots (Q's
    // fragments reloaded per 16 columns of D: registers are scarcer than
    // shared-memory reads here).
    float s[BC / 8][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4];
      hop::ldmatrix_x4(qf, sbase + L::Q + hop::swz(q_row, kk * 2 + lane / 16, L::ROW));
#pragma unroll
      for (int j2 = 0; j2 < BC / 16; ++j2) {
        const int mi = lane / 8;
        const int slot = j2 * 16 + (lane % 8) + (mi / 2) * 8;
        uint32_t kf[4];
        hop::ldmatrix_x4(kf, k_tile + hop::swz(slot, kk * 2 + (mi & 1), L::ROW));
        hop::mma_bf16_16816(s[2 * j2], qf, kf[0], kf[1]);
        hop::mma_bf16_16816(s[2 * j2 + 1], qf, kf[2], kf[3]);
      }
    }

    // Scale, int8 key factor, mask; the rows' new max.
    const bool full = t0 + BC - 1 <= pos_first && t0 + BC <= seq_len && t0 + BC <= T &&
                      (window <= 0 || t0 > pos_last - window);
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      float2 kf2 = make_float2(1.f, 1.f);
      if constexpr (INT8) kf2 = *reinterpret_cast<const float2*>(kfac + j * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * tq + e;
        float va = s[j][e] * scale, vb2 = s[j][2 + e] * scale;
        if constexpr (INT8) {
          const float f = e ? kf2.y : kf2.x;
          va *= f;
          vb2 *= f;
        }
        if (!full) {
          const int t = t0 + c;
          const bool in = t < seq_len && t < T;
          bool vis_a = in && t <= pa, vis_b = in && t <= pb;
          if (window > 0) {
            vis_a = vis_a && t > pa - window;
            vis_b = vis_b && t > pb - window;
          }
          va = vis_a ? va : NEG;
          vb2 = vis_b ? vb2 : NEG;
        }
        s[j][e] = va;
        s[j][2 + e] = vb2;
        mx_a = fmaxf(mx_a, va);
        mx_b = fmaxf(mx_b, vb2);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = __expf(m_a - mn_a), alpha_b = __expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // p = exp(s - m); l takes the unscaled p; P.V the p times vs[t] / 127
    // (int8 KV), rounded to bf16 in registers as mma's A operand.
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t pf[BC / 16][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      float p[4];
      float2 vf2 = make_float2(1.f, 1.f);
      if constexpr (INT8) vf2 = *reinterpret_cast<const float2*>(vfac + j * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = __expf(s[j][e] - mn_a);
        p[2 + e] = __expf(s[j][2 + e] - mn_b);
        sum_a += p[e];
        sum_b += p[2 + e];
        if constexpr (INT8) {
          const float f = e ? vf2.y : vf2.x;
          p[e] *= f;
          p[2 + e] *= f;
        }
      }
      // Slots 16*kk2 .. +7 are k columns 2tq of A's a0/a1, +8 .. +15 of a2/a3.
      pf[j / 2][(j % 2) * 2 + 0] = hop::pack_bf16x2(p[0], p[1]);
      pf[j / 2][(j % 2) * 2 + 1] = hop::pack_bf16x2(p[2], p[3]);
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }

    // O += P . V.
#pragma unroll
    for (int kk2 = 0; kk2 < BC / 16; ++kk2) {
#pragma unroll
      for (int nd2 = 0; nd2 < D / 16; ++nd2) {
        const int mi = lane / 8;
        const int slot = kk2 * 16 + (lane % 8) + (mi & 1) * 8;
        uint32_t vf[4];
        hop::ldmatrix_x4_trans(vf, v_tile + hop::swz(slot, nd2 * 2 + mi / 2, L::ROW));
        hop::mma_bf16_16816(o[2 * nd2], pf[kk2], vf[0], vf[1]);
        hop::mma_bf16_16816(o[2 * nd2 + 1], pf[kk2], vf[2], vf[3]);
      }
    }
    if constexpr (!INT8) __syncthreads();  // every warp is done with this stage before it is refilled
  }
  hop::cp_async_wait<0>();
  __syncthreads();

  // out = acc / max(l, 1e-30): bf16 into this warp's own rows of the Q
  // tile, then 16-byte stores of the rows inside S.
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < CH; ++n) {
    *reinterpret_cast<uint32_t*>(smem + L::Q + hop::swz(ra, n, L::ROW) + tq * 4) =
        hop::pack_bf16x2(o[n][0] * inv_a, o[n][1] * inv_a);
    *reinterpret_cast<uint32_t*>(smem + L::Q + hop::swz(rb, n, L::ROW) + tq * 4) =
        hop::pack_bf16x2(o[n][2] * inv_b, o[n][3] * inv_b);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = warp * 16 + idx / CH, c = idx % CH;
    const int h = kvh * G + (r % BR) / sc, s = qi * sc + (r % BR) % sc;
    if (s >= S) continue;
    *reinterpret_cast<uint4*>(out + (((size_t)b * H + h) * S + s) * D + c * 8) =
        *reinterpret_cast<const uint4*>(smem + L::Q + hop::swz(r, c, L::ROW));
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs;
  void* out;
  const void *pos0, *lens;
  int B, H, KV, S, T;
  long long k_sb, k_sh, v_sb, v_sh, ks_sb, ks_sh, vs_sb, vs_sh;
  int sc, window;
  float scale;
};

template <int D, bool INT8>
int launch(const Args& a, cudaStream_t stream) {
  static hop::SmemOptIn opt_in;
  const cudaError_t err = opt_in(reinterpret_cast<const void*>(flash_attn_kernel<D, INT8>), Smem<D, INT8>::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (a.S + a.sc - 1) / a.sc;
  dim3 grid(a.B * a.KV, (q_tiles + QT<INT8> - 1) / QT<INT8>);
  flash_attn_kernel<D, INT8><<<grid, 128 * QT<INT8>, Smem<D, INT8>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k, a.v, static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<__nv_bfloat16*>(a.out),
      static_cast<const int*>(a.pos0), static_cast<const int*>(a.lens), a.H, a.KV, a.S, a.T,
      a.k_sb, a.k_sh, a.v_sb, a.v_sh, a.ks_sb, a.ks_sh, a.vs_sb, a.vs_sh, a.sc, a.window, a.scale);
  return 0;
}

template <bool INT8>
int dispatch(const Args& a, int D, cudaStream_t stream) {
  if (a.KV <= 0 || a.H % a.KV || a.sc <= 0 || a.sc * (a.H / a.KV) != BR || a.B <= 0 || a.S <= 0)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (D == 128) rc = launch<128, INT8>(a, stream);
  else if (D == 64) rc = launch<64, INT8>(a, stream);
  else return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// q, out bf16 [B, H, S, D] contiguous; k, v bf16 with rows of D contiguous
// and (batch, head) strides in elements; pos0, seq_lens int32 [B].
// D is 64 or 128; sc = 64 / (H / KV); window 0 = none.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    const void* pos0, const void* seq_lens, int B, int H, int KV,
                                    int S, int T, int D, long long k_sb, long long k_sh,
                                    long long v_sb, long long v_sh, int sc, int window,
                                    float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, out, pos0, seq_lens, B, H, KV, S, T,
               k_sb, k_sh, v_sb, v_sh, 0, 0, 0, 0, sc, window, scale};
  return dispatch<false>(a, D, static_cast<cudaStream_t>(stream));
}

// As flash_attention_bf16 with int8 k, v and fp32 scale planes ks, vs
// [B, KV, T] (slots contiguous; batch and head strides in elements).
extern "C" int flash_attention_int8(const void* q, const void* k, const void* v, const void* ks,
                                    const void* vs, void* out, const void* pos0,
                                    const void* seq_lens, int B, int H, int KV, int S, int T,
                                    int D, long long k_sb, long long k_sh, long long v_sb,
                                    long long v_sh, long long ks_sb, long long ks_sh,
                                    long long vs_sb, long long vs_sh, int sc, int window,
                                    float scale, void* stream) {
  const Args a{q, k, v, ks, vs, out, pos0, seq_lens, B, H, KV, S, T,
               k_sb, k_sh, v_sb, v_sh, ks_sb, ks_sh, vs_sb, vs_sh, sc, window, scale};
  return dispatch<true>(a, D, static_cast<cudaStream_t>(stream));
}
