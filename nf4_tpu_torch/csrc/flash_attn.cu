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
// Shapes: the TPU kernel's, D = 64 or any multiple of 128 and any GQA
// group G = H / KV.  Three instantiations of one design:
// * D = 64 and 128: the register-resident kernel below with 64-slot key
//   tiles;
// * D = 256 (Gemma): the same kernel with 32-slot key tiles, so that S
//   and P take 16 + 8 registers a lane beside O's 128, and Q.K^T's column
//   loop unrolled by 2 (no spills at 247-255 registers).  Shared memory:
//   bf16 KV 96 KB (Q 32 KB, two stages of K and V, 16 KB each); int8 KV
//   keeps two query tiles per block and its three raw stages at 177 KB (at
//   64-slot tiles the raw ring alone would take 100 KB, ~290 KB in all);
// * D = 384, 512, ... (`flash_attn_wide_kernel`): one block per query
//   tile and per 128 output columns; each block computes S = Q.K^T over
//   the full D from 128-column chunks of Q and K streamed through shared
//   memory, then P.V for its own 128 columns of V.  Q.K^T is recomputed
//   D / 128 times: a simple form, not a fast one.
//
// Bound on the H100: operations at prefill lengths (each K/V tile feeds 64
// query rows; 989 TFLOP/s bf16), bytes only for short prompts over a long
// cache.  Design (the FlashAttention-2 layout on mma.sync):
// * One warpgroup per query tile of 64 rows: the GQA-packed [G, sc] rows
//   of the TPU kernel, sc = floor(64 / G) positions of all G heads (row r
//   = query head kv*G + r / sc at position pos0 + q_tile*sc + r % sc), so
//   every K/V tile in shared memory serves all G heads.  Rows G*sc .. 63
//   are idle: zero-filled on load, never stored, kept out of the tiles a
//   warp loads or multiplies.  For G > 64 a tile holds one position of 64
//   heads of the group (sc = 1), and a position's heads take ceil(G / 64)
//   tiles ("head groups", blocks of their own).  A block holds one query
//   tile (bf16 KV) or two neighbouring ones (int8 KV, which then converts
//   each K/V tile once for 128 rows) of one (batch x KV head x head
//   group); a warpgroup skips the KV tiles its own query tile cannot see.
//   Query tiles launch latest (heaviest under the causal mask) first, so
//   the long rows do not form the tail.
// * Each warp owns 16 rows.  S = Q.K^T, the online softmax and O live in
//   registers: S and O are mma.m16n8k16 accumulators, each row's max and
//   sum are reduced over the 4 lanes that hold it, and the probabilities
//   are converted to bf16 in registers as the A operand of P.V.  Only the
//   Q, K and V tiles live in shared memory (128-byte XOR swizzle, read by
//   ldmatrix without bank conflicts; V through ldmatrix.trans).
// * K/V tiles come through a 2-stage ring of cp.async copies: tile i+1
//   loads while tile i multiplies.  Tiles wholly invisible to the block
//   (past its last position or seq_len, or wholly behind the window of its
//   first position) are never loaded; a tile that every row sees wholly
//   skips the mask arithmetic.
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
constexpr int STAGES = 2;
constexpr float NEG = -1e30f;

// Cache slots per KV tile: 64, or 32 at D = 256 (registers: O alone is
// 128 a lane there).
template <int D>
constexpr int BC = D >= 256 ? 32 : 64;

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
  static constexpr int ROW = D * 2;         // bytes of a bf16 row
  static constexpr int QTILE = BR * ROW;
  static constexpr int TILE = BC<D> * ROW;  // a K or V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + QT<INT8> * QTILE;
  static constexpr int V = K + 2 * TILE;
  static constexpr int RAW = V + 2 * TILE;
  static constexpr int RAW_STAGES = 3;
  static constexpr int RAW_STAGE = 2 * BC<D> * D + 2 * BC<D> * 4;  // int8 K, V, then ks, vs
  static constexpr int BYTES = RAW + (INT8 ? RAW_STAGES * RAW_STAGE : 0);
};

// The GQA packing of a query tile (see the header): sc positions of hpt
// heads of one KV head's group, hpt = min(G, 64 / sc); a position's G heads
// take `groups` head groups.
struct Pack {
  int G, sc, hpt, groups;
  __device__ Pack(int G_, int sc_) : G(G_), sc(sc_), hpt(min(G_, BR / sc_)), groups((G_ + hpt - 1) / hpt) {}
  // Heads of head group hg in a tile: its rows r < heads * sc hold queries.
  __device__ int heads(int hg) const { return min(hpt, G - hg * hpt); }
};

// The index qi0 of this block's first query tile (latest tiles first) from
// the grid's y and z, which count the blocks of qt query tiles (the grid's
// x is (b * KV + kv head) * groups + head group, times the wide kernel's
// column chunks).  False for a block past the last one.
__device__ __forceinline__ bool block_tiles(int S, int qt, const Pack& pk, int& qi0) {
  const int q_tiles = (S + pk.sc - 1) / pk.sc;
  const int nqb = (q_tiles + qt - 1) / qt;
  const int yb = blockIdx.z * gridDim.y + blockIdx.y;
  qi0 = (nqb - 1 - yb) * qt;
  return yb < nqb;
}

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

// S += Q.K^T for one warp's 16 rows (ldmatrix row q_row of the Q tile) and
// the NS slots of the K tile, over KD columns; both tiles have rows of
// row_bytes.  Q's fragments are reloaded per 16 columns (registers are
// scarcer than shared-memory reads here).  Above 128 columns the loop is
// unrolled by 2 only: at D = 256 the full unroll spills (O alone holds 128
// registers a lane) and takes 18% longer (utils/kernel_variants.py).
template <int KD, int NS>
__device__ __forceinline__ void qk_product(float (&s)[NS / 8][4], uint32_t q_tile, int q_row, uint32_t k_tile,
                                           int row_bytes, int lane) {
#pragma unroll(KD > 128 ? 2 : KD / 16)
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t qf[4];
    hop::ldmatrix_x4(qf, q_tile + hop::swz(q_row, kk * 2 + lane / 16, row_bytes));
#pragma unroll
    for (int j2 = 0; j2 < NS / 16; ++j2) {
      const int mi = lane / 8;
      const int slot = j2 * 16 + (lane % 8) + (mi / 2) * 8;
      uint32_t kf[4];
      hop::ldmatrix_x4(kf, k_tile + hop::swz(slot, kk * 2 + (mi & 1), row_bytes));
      hop::mma_bf16_16816(s[2 * j2], qf, kf[0], kf[1]);
      hop::mma_bf16_16816(s[2 * j2 + 1], qf, kf[2], kf[3]);
    }
  }
}

// The online softmax of one warp's 16 rows over a tile of NS slots from
// t0: scale, int8 key factor (kfac), mask, the rows' new max, O *= alpha,
// p = exp(s - m) into l, and p times the int8 value factor (vfac) as bf16
// A fragments pf of P.V.  Rows a and b are the lane's two rows (positions
// pa, pb); `full`: every row sees every slot (no mask).
template <int NS, int NO, bool INT8>
__device__ __forceinline__ void softmax_step(float (&s)[NS / 8][4], float (&o)[NO][4], uint32_t (&pf)[NS / 16][4],
                                             float& m_a, float& m_b, float& l_a, float& l_b, const float* kfac,
                                             const float* vfac, int t0, int tq, int pa, int pb, bool full,
                                             int seq_len, int T, int window, float scale) {
  float mx_a = NEG, mx_b = NEG;
#pragma unroll
  for (int j = 0; j < NS / 8; ++j) {
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
#pragma unroll
  for (int j = 0; j < NS / 8; ++j) {
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
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= alpha_a;
    o[n][1] *= alpha_a;
    o[n][2] *= alpha_b;
    o[n][3] *= alpha_b;
  }
}

// O += P.V for one warp's 16 rows: NS slots of the V tile (rows of
// row_bytes), its first NO * 8 columns.
template <int NS, int NO>
__device__ __forceinline__ void pv_product(float (&o)[NO][4], const uint32_t (&pf)[NS / 16][4], uint32_t v_tile,
                                           int row_bytes, int lane) {
#pragma unroll
  for (int kk2 = 0; kk2 < NS / 16; ++kk2) {
#pragma unroll
    for (int nd2 = 0; nd2 < NO / 2; ++nd2) {
      const int mi = lane / 8;
      const int slot = kk2 * 16 + (lane % 8) + (mi & 1) * 8;
      uint32_t vf[4];
      hop::ldmatrix_x4_trans(vf, v_tile + hop::swz(slot, nd2 * 2 + mi / 2, row_bytes));
      hop::mma_bf16_16816(o[2 * nd2], pf[kk2], vf[0], vf[1]);
      hop::mma_bf16_16816(o[2 * nd2 + 1], pf[kk2], vf[2], vf[3]);
    }
  }
}

// One warp's rows and the KV tiles it sees, from the block's first query
// tile qi0: its query tile qi and first row wr0 in it; `live` when it holds
// a query; its first and last position; the KV range [tw_begin, tw_end)
// it multiplies (empty when not live).
struct WarpRows {
  int qi, pos_first, pos_last, tw_begin, tw_end;
  __device__ WarpRows(int warp, int qi0, int heads, int sc, int S, int pos0, int seq_len, int T, int window,
                      int bc) {
    qi = qi0 + warp / 4;
    const int s_first = qi * sc;
    const bool live = (warp % 4) * 16 < heads * sc && s_first < S;
    pos_first = pos0 + s_first;
    pos_last = pos0 + min(s_first + sc, S) - 1;
    tw_end = live ? min(T, min(pos_last + 1, seq_len)) : 0;
    tw_begin = live && window > 0 ? max(0, (pos_first - window + 1) / bc * bc) : 0;
  }
};

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
  constexpr int BCT = BC<D>;
  constexpr int THREADS = 128 * QT<INT8>;
  constexpr int CH = D / 8;  // 16-byte chunks per bf16 row
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = hop::smem_u32(smem);

  const Pack pk(H / KV, sc);
  int qi0;
  if (!block_tiles(S, QT<INT8>, pk, qi0)) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment row group and column pair
  const int hg = blockIdx.x % pk.groups;   // head group
  const int bk = blockIdx.x / pk.groups;   // b * KV + kv head
  const int b = bk / KV, kvh = bk % KV;
  const int head0 = kvh * pk.G + hg * pk.hpt, heads = pk.heads(hg);
  const int seq_len = seq_lens[b], pos0 = pos0s[b];
  // This warp's query tile and the KV tiles it sees; the block loads the
  // union over its query tiles.
  const WarpRows w(warp, qi0, heads, sc, S, pos0, seq_len, T, window, BCT);

  // Q tiles: row r of query tile qi0 + r/64 -> head head0 + (r%64)/sc,
  // sequence index (qi0 + r/64)*sc + (r%64)%sc; idle rows zero-filled.
  for (int i = tid; i < QT<INT8> * BR * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const int hl = (r % BR) / sc, s = (qi0 + r / BR) * sc + (r % BR) % sc;
    const bool ok = hl < heads && s < S;
    const __nv_bfloat16* src = ok ? q + (((size_t)b * H + head0 + hl) * S + s) * D + c * 8 : q;
    hop::cp_async16(sbase + L::Q + hop::swz(r, c, L::ROW), src, ok);
  }

  const int blk_first = pos0 + qi0 * sc, blk_last = pos0 + min((qi0 + QT<INT8>) * sc, S) - 1;
  const int t_end = min(T, min(blk_last + 1, seq_len));
  const int t_begin = window > 0 ? max(0, (blk_first - window + 1) / BCT * BCT) : 0;
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + BCT - 1) / BCT : 0;
  using KV_T = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  const KV_T* kb = static_cast<const KV_T*>(k) + b * k_sb + kvh * k_sh;
  const KV_T* vb = static_cast<const KV_T*>(v) + b * v_sb + kvh * v_sh;
  const float* ksb = INT8 ? ks + b * ks_sb + kvh * ks_sh : nullptr;
  const float* vsb = INT8 ? vs + b * vs_sb + kvh * vs_sh : nullptr;

  // Start the copies of KV tile i into ring stage i % STAGES (bf16) or
  // i % RAW_STAGES (int8).
  auto fetch = [&](int i) {
    const int t0 = t_begin + i * BCT, st = i % (INT8 ? L::RAW_STAGES : STAGES);
    if constexpr (INT8) {
      constexpr int CH8 = D / 16;  // 16-byte chunks per int8 row
      const uint32_t raw = sbase + L::RAW + st * L::RAW_STAGE;
      for (int j = tid; j < BCT * CH8; j += THREADS) {
        const int r = j / CH8, c = j % CH8;
        const bool ok = t0 + r < T;
        const size_t off = (size_t)(ok ? t0 + r : 0) * D + c * 16;
        hop::cp_async16(raw + r * D + c * 16, kb + off, ok);
        hop::cp_async16(raw + BCT * D + r * D + c * 16, vb + off, ok);
      }
      for (int j = tid; j < 2 * BCT; j += THREADS) {  // ks then vs, one slot each
        const int c = j % BCT, t = t0 + c;
        const bool ok = t < T;
        hop::cp_async4(raw + 2 * BCT * D + j * 4, (j < BCT ? ksb : vsb) + (ok ? t : 0), ok);
      }
    } else {
      for (int j = tid; j < BCT * CH; j += THREADS) {
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
    for (int j = tid; j < BCT * CH8; j += THREADS) {
      const int r = j / CH8, c = j % CH8;
      uint4 lo, hi;
      int8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + r * D + c * 16), lo, hi);
      *reinterpret_cast<uint4*>(smem + L::K + kv + hop::swz(r, 2 * c, L::ROW)) = lo;
      *reinterpret_cast<uint4*>(smem + L::K + kv + hop::swz(r, 2 * c + 1, L::ROW)) = hi;
      int8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + BCT * D + r * D + c * 16), lo, hi);
      *reinterpret_cast<uint4*>(smem + L::V + kv + hop::swz(r, 2 * c, L::ROW)) = lo;
      *reinterpret_cast<uint4*>(smem + L::V + kv + hop::swz(r, 2 * c + 1, L::ROW)) = hi;
    }
    float* fac = reinterpret_cast<float*>(raw + 2 * BCT * D);
    for (int j = tid; j < 2 * BCT; j += THREADS) fac[j] *= 1.f / 127.f;
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
  const int pa = w.pos_first + (ra % BR) % sc, pb = w.pos_first + (rb % BR) % sc;
  const int q_row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;  // ldmatrix row of Q

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = t_begin + i * BCT;
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
      kfac = reinterpret_cast<const float*>(smem + L::RAW + (i % L::RAW_STAGES) * L::RAW_STAGE + 2 * BCT * D);
      vfac = kfac + BCT;
    } else {
      if (i + 1 < n_tiles) fetch(i + 1);
      hop::cp_async_commit();
      hop::cp_async_wait<1>();  // tile i (and Q) landed for this thread's copies
      __syncthreads();          // ... and for every thread's
    }
    if (t0 < w.tw_begin || t0 >= w.tw_end) {  // wholly invisible to this warp's rows
      if constexpr (!INT8) __syncthreads();
      continue;
    }

    float s[BCT / 8][4];
#pragma unroll
    for (int j = 0; j < BCT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    qk_product<D, BCT>(s, sbase + L::Q, q_row, k_tile, L::ROW, lane);
    const bool full = t0 + BCT - 1 <= w.pos_first && t0 + BCT <= seq_len && t0 + BCT <= T &&
                      (window <= 0 || t0 > w.pos_last - window);
    uint32_t pf[BCT / 16][4];
    softmax_step<BCT, CH, INT8>(s, o, pf, m_a, m_b, l_a, l_b, kfac, vfac, t0, tq, pa, pb, full, seq_len, T,
                                window, scale);
    pv_product<BCT, CH>(o, pf, v_tile, L::ROW, lane);
    if constexpr (!INT8) __syncthreads();  // every warp is done with this stage before it is refilled
  }
  hop::cp_async_wait<0>();
  __syncthreads();

  // out = acc / max(l, 1e-30): bf16 into this warp's own rows of the Q
  // tile, then 16-byte stores of the rows that hold a query.
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
    const int hl = (r % BR) / sc, s = w.qi * sc + (r % BR) % sc;
    if (hl >= heads || s >= S) continue;
    *reinterpret_cast<uint4*>(out + (((size_t)b * H + head0 + hl) * S + s) * D + c * 8) =
        *reinterpret_cast<const uint4*>(smem + L::Q + hop::swz(r, c, L::ROW));
  }
}

// D = 384, 512, ...: one warpgroup per query tile and per WC output
// columns (see the header).  Per KV tile of 64 slots the block walks D / WC
// + 1 steps through a 2-stage ring: step j < D / WC brings columns
// [j*WC, (j+1)*WC) of the Q tile and of the K tile and adds their product
// to S; the last step brings the block's WC columns of the V tile (and, int8
// KV, the tile's scale slices), runs the online softmax and adds P.V.
constexpr int WC = 128;
constexpr int WROW = WC * 2;        // bytes of a bf16 chunk row
constexpr int WTILE = 64 * WROW;    // a 64-row chunk
constexpr int WRAW = 64 * WC + 2 * 64 * 4;  // int8 chunk, then ks, vs
constexpr int WIDE_BYTES = 2 * 2 * WTILE;
constexpr int WIDE_INT8_BYTES = WIDE_BYTES + 2 * WRAW;

template <bool INT8>
__global__ void __launch_bounds__(128)
flash_attn_wide_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                       const void* __restrict__ v, const float* __restrict__ ks,
                       const float* __restrict__ vs, __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ pos0s, const int* __restrict__ seq_lens, int H, int KV,
                       int S, int T, int D, long long k_sb, long long k_sh, long long v_sb, long long v_sh,
                       long long ks_sb, long long ks_sh, long long vs_sb, long long vs_sh,
                       int sc, int window, float scale) {
  constexpr int BCT = 64;
  constexpr int CHC = WC / 8;  // 16-byte chunks per bf16 chunk row
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = hop::smem_u32(smem);

  const Pack pk(H / KV, sc);
  int qi0;
  if (!block_tiles(S, 1, pk, qi0)) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int nc = D / WC;               // column chunks
  const int dc = blockIdx.x % nc;      // this block's output chunk
  const int hg = (blockIdx.x / nc) % pk.groups;
  const int bk = blockIdx.x / nc / pk.groups;
  const int b = bk / KV, kvh = bk % KV;
  const int head0 = kvh * pk.G + hg * pk.hpt, heads = pk.heads(hg);
  const int seq_len = seq_lens[b], pos0 = pos0s[b];
  const WarpRows w(warp, qi0, heads, sc, S, pos0, seq_len, T, window, BCT);

  const int blk_first = pos0 + qi0 * sc, blk_last = pos0 + min((qi0 + 1) * sc, S) - 1;
  const int t_end = min(T, min(blk_last + 1, seq_len));
  const int t_begin = window > 0 ? max(0, (blk_first - window + 1) / BCT * BCT) : 0;
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + BCT - 1) / BCT : 0;
  const int n_steps = n_tiles * (nc + 1);
  using KV_T = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  const KV_T* kb = static_cast<const KV_T*>(k) + b * k_sb + kvh * k_sh;
  const KV_T* vb = static_cast<const KV_T*>(v) + b * v_sb + kvh * v_sh;
  const float* ksb = INT8 ? ks + b * ks_sb + kvh * ks_sh : nullptr;
  const float* vsb = INT8 ? vs + b * vs_sb + kvh * vs_sh : nullptr;

  // Stage st: the Q chunk at st * 2 * WTILE, the K or V chunk (bf16) after
  // it; int8 KV copies its K or V chunk raw to WIDE_BYTES + st * WRAW.
  auto fetch = [&](int it) {
    const int i = it / (nc + 1), j = it % (nc + 1), st = it % 2;
    const int t0 = t_begin + i * BCT;
    const uint32_t qa = sbase + st * 2 * WTILE, kva = qa + WTILE;
    const uint32_t raw = sbase + WIDE_BYTES + st * WRAW;
    const int col = (j < nc ? j : dc) * WC;
    const KV_T* src = j < nc ? kb : vb;
    if (j < nc) {
      for (int x = tid; x < BR * CHC; x += 128) {
        const int r = x / CHC, c = x % CHC;
        const int hl = r / sc, s = qi0 * sc + r % sc;
        const bool ok = hl < heads && s < S;
        const __nv_bfloat16* p = ok ? q + (((size_t)b * H + head0 + hl) * S + s) * D + col + c * 8 : q;
        hop::cp_async16(qa + hop::swz(r, c, WROW), p, ok);
      }
    }
    if constexpr (INT8) {
      for (int x = tid; x < BCT * (WC / 16); x += 128) {
        const int r = x / (WC / 16), c = x % (WC / 16);
        const bool ok = t0 + r < T;
        hop::cp_async16(raw + r * WC + c * 16, src + (size_t)(ok ? t0 + r : 0) * D + col + c * 16, ok);
      }
      if (j == nc) {
        for (int x = tid; x < 2 * BCT; x += 128) {  // ks then vs, one slot each
          const int c = x % BCT, t = t0 + c;
          const bool ok = t < T;
          hop::cp_async4(raw + BCT * WC + x * 4, (x < BCT ? ksb : vsb) + (ok ? t : 0), ok);
        }
      }
    } else {
      for (int x = tid; x < BCT * CHC; x += 128) {
        const int r = x / CHC, c = x % CHC;
        const bool ok = t0 + r < T;
        hop::cp_async16(kva + hop::swz(r, c, WROW), src + (size_t)(ok ? t0 + r : 0) * D + col + c * 8, ok);
      }
    }
  };

  float o[CHC][4];  // O: this block's WC columns
#pragma unroll
  for (int n = 0; n < CHC; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float s[BCT / 8][4];
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  const int ra = warp * 16 + g, rb = ra + 8;
  const int pa = w.pos_first + ra % sc, pb = w.pos_first + rb % sc;
  const int q_row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;

  if (n_steps > 0) fetch(0);
  hop::cp_async_commit();
  for (int it = 0; it < n_steps; ++it) {
    const int i = it / (nc + 1), j = it % (nc + 1), st = it % 2;
    const int t0 = t_begin + i * BCT;
    const uint32_t qa = sbase + st * 2 * WTILE, kva = qa + WTILE;
    if (it + 1 < n_steps) fetch(it + 1);
    hop::cp_async_commit();
    hop::cp_async_wait<1>();
    __syncthreads();
    const float* kfac = nullptr;
    const float* vfac = nullptr;
    if constexpr (INT8) {
      // Convert the raw chunk into the stage's bf16 K/V chunk (and, at the
      // V step, the scale slices into ks / 127 and vs / 127).
      unsigned char* raw = smem + WIDE_BYTES + st * WRAW;
      for (int x = tid; x < BCT * (WC / 16); x += 128) {
        const int r = x / (WC / 16), c = x % (WC / 16);
        uint4 lo, hi;
        int8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + r * WC + c * 16), lo, hi);
        *reinterpret_cast<uint4*>(smem + st * 2 * WTILE + WTILE + hop::swz(r, 2 * c, WROW)) = lo;
        *reinterpret_cast<uint4*>(smem + st * 2 * WTILE + WTILE + hop::swz(r, 2 * c + 1, WROW)) = hi;
      }
      float* fac = reinterpret_cast<float*>(raw + BCT * WC);
      if (j == nc)
        for (int x = tid; x < 2 * BCT; x += 128) fac[x] *= 1.f / 127.f;
      __syncthreads();
      kfac = fac;
      vfac = fac + BCT;
    }
    if (t0 >= w.tw_begin && t0 < w.tw_end) {
      if (j == 0) {
#pragma unroll
        for (int x = 0; x < BCT / 8; ++x) s[x][0] = s[x][1] = s[x][2] = s[x][3] = 0.f;
      }
      if (j < nc) {
        qk_product<WC, BCT>(s, qa, q_row, kva, WROW, lane);
      } else {
        const bool full = t0 + BCT - 1 <= w.pos_first && t0 + BCT <= seq_len && t0 + BCT <= T &&
                          (window <= 0 || t0 > w.pos_last - window);
        uint32_t pf[BCT / 16][4];
        softmax_step<BCT, CHC, INT8>(s, o, pf, m_a, m_b, l_a, l_b, kfac, vfac, t0, tq, pa, pb, full, seq_len, T,
                                     window, scale);
        pv_product<BCT, CHC>(o, pf, kva, WROW, lane);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  hop::cp_async_wait<0>();

  // out = acc / max(l, 1e-30), straight from the fragments (4-byte stores).
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    const int hl = r / sc, s_idx = qi0 * sc + r % sc;
    if (hl >= heads || s_idx >= S) continue;
    __nv_bfloat16* dst = out + (((size_t)b * H + head0 + hl) * S + s_idx) * D + dc * WC + 2 * tq;
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int n = 0; n < CHC; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = hop::pack_bf16x2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
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

// The grid: x = (B * KV * head groups) [* column chunks], y * z >= the
// query-tile blocks (y at most 65535).
bool grid_for(const Args& a, int qt, int split, dim3& grid) {
  const int G = a.H / a.KV;
  const int hpt = G < BR / a.sc ? G : BR / a.sc;
  const long long x = (long long)a.B * a.KV * ((G + hpt - 1) / hpt) * split;
  const int q_tiles = (a.S + a.sc - 1) / a.sc, nqb = (q_tiles + qt - 1) / qt;
  const int y = nqb < 65535 ? nqb : 65535, z = (nqb + y - 1) / y;
  if (x > 0x7fffffffLL || z > 65535) return false;
  grid = dim3((unsigned)x, y, z);
  return true;
}

template <int D, bool INT8>
int launch(const Args& a, cudaStream_t stream) {
  static hop::SmemOptIn opt_in;
  const cudaError_t err = opt_in(reinterpret_cast<const void*>(flash_attn_kernel<D, INT8>), Smem<D, INT8>::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid;
  if (!grid_for(a, QT<INT8>, 1, grid)) return (int)cudaErrorInvalidValue;
  flash_attn_kernel<D, INT8><<<grid, 128 * QT<INT8>, Smem<D, INT8>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k, a.v, static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<__nv_bfloat16*>(a.out),
      static_cast<const int*>(a.pos0), static_cast<const int*>(a.lens), a.H, a.KV, a.S, a.T,
      a.k_sb, a.k_sh, a.v_sb, a.v_sh, a.ks_sb, a.ks_sh, a.vs_sb, a.vs_sh, a.sc, a.window, a.scale);
  return 0;
}

template <bool INT8>
int launch_wide(const Args& a, int D, cudaStream_t stream) {
  static hop::SmemOptIn opt_in;
  const int bytes = INT8 ? WIDE_INT8_BYTES : WIDE_BYTES;
  const cudaError_t err = opt_in(reinterpret_cast<const void*>(flash_attn_wide_kernel<INT8>), bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid;
  if (!grid_for(a, 1, D / WC, grid)) return (int)cudaErrorInvalidValue;
  flash_attn_wide_kernel<INT8><<<grid, 128, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k, a.v, static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<__nv_bfloat16*>(a.out),
      static_cast<const int*>(a.pos0), static_cast<const int*>(a.lens), a.H, a.KV, a.S, a.T, D,
      a.k_sb, a.k_sh, a.v_sb, a.v_sh, a.ks_sb, a.ks_sh, a.vs_sb, a.vs_sh, a.sc, a.window, a.scale);
  return 0;
}

template <bool INT8>
int dispatch(const Args& a, int D, cudaStream_t stream) {
  if (a.KV <= 0 || a.H % a.KV || a.B <= 0 || a.S <= 0) return (int)cudaErrorInvalidValue;
  const int G = a.H / a.KV;
  if (a.sc != (G >= BR ? 1 : BR / G)) return (int)cudaErrorInvalidValue;
  int rc;
  if (D == 128) rc = launch<128, INT8>(a, stream);
  else if (D == 64) rc = launch<64, INT8>(a, stream);
  else if (D == 256) rc = launch<256, INT8>(a, stream);
  else if (D > 256 && D % WC == 0) rc = launch_wide<INT8>(a, D, stream);
  else return (int)cudaErrorInvalidValue;
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// q, out bf16 [B, H, S, D] contiguous; k, v bf16 with rows of D contiguous
// and (batch, head) strides in elements; pos0, seq_lens int32 [B].
// D is 64 or a multiple of 128; sc = floor(64 / (H / KV)), at least 1;
// window 0 = none.
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
