// Prefill flash attention over a bf16 or int8 KV cache (kernel C).
//
// Replaces: nf4_tpu/ops/attention.py:flash_attention (kernel body
// _make_flash_kernel), both the bf16-KV and the int8-KV branch.
//
// Computes: out[b, h, s] = softmax(scale * q . k^T) . v over the cache
// slots t visible to query position p = pos0[b] + s:
//   t <= p (causal), t < seq_len[b], and t > p - window when window > 0,
// with the TPU kernel's numerics: fp32 scores, fp32 running max m,
// normaliser l and accumulator, probabilities rounded to bf16 before the
// P.V product, masked scores set to -1e30 (finite: a row that is fully
// masked so far carries garbage that the first visible tile discards), and
// a final acc / max(l, 1e-30).
//
// int8 KV (INT8 = true): k and v are int8 with fp32 per-slot absmax scales
// ks, vs [B, KV, T].  The int8 tiles convert to bf16 (exact for |v| <= 127)
// into the same shared-memory K/V buffers; after the `* scale` each score
// is multiplied by ks[t] / 127; l is updated with the unscaled
// probability p, and p is multiplied by vs[t] / 127 before its bf16
// rounding and the P.V product (the TPU kernel's order: folding vs into l,
// or applying it after P.V, would be another function).
//
// Bound: operations at prefill lengths (each K/V tile feeds 64 query rows),
// bytes only for short prompts over a long cache.  Design:
// * One block per (batch x KV head, query tile).  The block's 64 rows are
//   the GQA-packed [G, sc] rows of the TPU kernel (row r = query head
//   kv*G + r / sc at position pos0 + q_tile*sc + r % sc, sc = 64 / G), so
//   every K/V tile loaded into shared memory serves all G heads.
// * A loop over KV tiles of 64 slots replaces the TPU grid's sequential
//   KV axis.  Tiles wholly invisible to the block (past its last position
//   or seq_len, or wholly behind the window of its first position) are
//   never loaded.
// * Q.K^T and P.V run on the tensor cores through WMMA bf16 16x16x16.
//   Each of the 4 warps owns 16 rows: their scores, probabilities and
//   fp32 accumulator live in shared memory, where the online-softmax
//   rescale of a row is a plain loop (WMMA hides the fragment layout).
// * Query rows past S and cache slots past T are zero-filled in shared
//   memory instead of padding the tensors, so the KV cache is read in
//   place (batch and head strides are arguments; the int8 scale planes
//   too).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BR = 64;  // query rows per block
constexpr int BC = 64;  // cache slots per KV tile
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <int D>
struct Smem {
  static constexpr int QLD = D + 8, KLD = D + 8, SLD = BC + 4, PLD = BC + 8, OLD = D + 4;
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(BR * QLD * 2);
  static constexpr int V = K + align128(BC * KLD * 2);
  static constexpr int S = V + align128(BC * KLD * 2);
  static constexpr int P = S + align128(BR * SLD * 4);
  static constexpr int O = P + align128(BR * PLD * 2);
  static constexpr int M = O + align128(BR * OLD * 4);
  static constexpr int L = M + align128(BR * 4);
  static constexpr int BYTES = L + align128(BR * 4);
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Convert 16 int8 values to 16 bf16 values (exact) at dst.
__device__ __forceinline__ void int8x16_to_bf16(uint4 src, __nv_bfloat16* dst) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&src);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat162 p = __floats2bfloat162_rn((float)b[2 * i], (float)b[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&p);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// KV is bf16 (INT8 false) or int8 with scale planes ks/vs (INT8 true).
template <int D, bool INT8>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                  const void* __restrict__ v, const float* __restrict__ ks,
                  const float* __restrict__ vs, __nv_bfloat16* __restrict__ out,
                  const int* __restrict__ pos0s, const int* __restrict__ seq_lens, int H, int KV,
                  int S, int T, long long k_sb, long long k_sh, long long v_sb, long long v_sh,
                  long long ks_sb, long long ks_sh, long long vs_sb, long long vs_sh,
                  int sc, int window, float scale) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);
  float* ms = reinterpret_cast<float*>(smem + L::M);
  float* ls = reinterpret_cast<float*>(smem + L::L);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bk = blockIdx.x;  // b * KV + kv head
  const int b = bk / KV, kvh = bk % KV;
  const int G = H / KV;
  const int qi = blockIdx.y;
  const int pos_first = pos0s[b] + qi * sc;  // position of the tile's row 0
  const int pos_last = pos_first + sc - 1;
  const int seq_len = seq_lens[b];
  constexpr int DV = D / 8;  // 16-byte pieces per row

  // Q tile: row r -> head kvh*G + r/sc, sequence index qi*sc + r%sc.
  for (int i = tid; i < BR * DV; i += THREADS) {
    const int r = i / DV, c = (i % DV) * 8;
    const int h = kvh * G + r / sc, s = qi * sc + r % sc;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r / sc < G && s < S)
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * H + h) * S + s) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * L::QLD + c) = val;
  }
  for (int i = tid; i < BR * D; i += THREADS) Os[(i / D) * L::OLD + i % D] = 0.f;
  if (tid < BR) {
    ms[tid] = NEG;
    ls[tid] = 0.f;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + (warp * 16) * L::QLD + kk * 16, L::QLD);

  int t_end = min(T, min(pos_last + 1, seq_len));
  int t_begin = 0;
  if (window > 0) t_begin = max(0, (pos_first - window + 1) / BC * BC);
  using KV_T = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  const KV_T* kb = static_cast<const KV_T*>(k) + b * k_sb + kvh * k_sh;
  const KV_T* vb = static_cast<const KV_T*>(v) + b * v_sb + kvh * v_sh;
  const float* ksb = INT8 ? ks + b * ks_sb + kvh * ks_sh : nullptr;
  const float* vsb = INT8 ? vs + b * vs_sb + kvh * vs_sh : nullptr;

  for (int t0 = t_begin; t0 < t_end; t0 += BC) {
    __syncthreads();  // every warp is done with the previous K/V tile
    if constexpr (INT8) {
      constexpr int DV8 = D / 16;  // 16-byte pieces per int8 row
      for (int i = tid; i < BC * DV8; i += THREADS) {
        const int r = i / DV8, c = (i % DV8) * 16;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
        if (t0 + r < T) {
          kv = *reinterpret_cast<const uint4*>(kb + (size_t)(t0 + r) * D + c);
          vv = *reinterpret_cast<const uint4*>(vb + (size_t)(t0 + r) * D + c);
        }
        int8x16_to_bf16(kv, Ks + r * L::KLD + c);
        int8x16_to_bf16(vv, Vs + r * L::KLD + c);
      }
    } else {
      for (int i = tid; i < BC * DV; i += THREADS) {
        const int r = i / DV, c = (i % DV) * 8;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
        if (t0 + r < T) {
          kv = *reinterpret_cast<const uint4*>(kb + (size_t)(t0 + r) * D + c);
          vv = *reinterpret_cast<const uint4*>(vb + (size_t)(t0 + r) * D + c);
        }
        *reinterpret_cast<uint4*>(Ks + r * L::KLD + c) = kv;
        *reinterpret_cast<uint4*>(Vs + r * L::KLD + c) = vv;
      }
    }
    __syncthreads();

    // Scores for this warp's 16 rows: S = Q . K^T.
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + (j * 16) * L::KLD + kk * 16, L::KLD);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(Ss + (warp * 16) * L::SLD + j * 16, acc, L::SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // This lane's two slots' int8 scale factors, ks[t] / 127 and vs[t] / 127.
    float kfac[2] = {1.f, 1.f}, vfac[2] = {1.f, 1.f};
    if constexpr (INT8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + lane + 32 * e;
        kfac[e] = t < T ? ksb[t] * (1.f / 127.f) : 0.f;
        vfac[e] = t < T ? vsb[t] * (1.f / 127.f) : 0.f;
      }
    }

    // Online softmax, one row at a time across the warp (2 slots per lane).
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int p = pos_first + r % sc;
      float s2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e, t = t0 + c;
        bool vis = t <= p && t < seq_len;
        if (window > 0) vis = vis && t > p - window;
        float sv = Ss[r * L::SLD + c] * scale;
        if constexpr (INT8) sv *= kfac[e];
        s2[e] = vis ? sv : NEG;
      }
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s2[0], s2[1])));
      const float alpha = expf(m_old - m_new);
      const float p0 = expf(s2[0] - m_new), p1 = expf(s2[1] - m_new);
      const float psum = warp_sum(p0 + p1);
      // l takes the unscaled p; P.V the p scaled by vs[t] / 127 (int8 KV).
      Ps[r * L::PLD + lane] = __float2bfloat16_rn(INT8 ? p0 * vfac[0] : p0);
      Ps[r * L::PLD + lane + 32] = __float2bfloat16_rn(INT8 ? p1 * vfac[1] : p1);
#pragma unroll
      for (int d = lane; d < D; d += 32) Os[r * L::OLD + d] *= alpha;
      if (lane == 0) {
        ls[r] = ls[r] * alpha + psum;
        ms[r] = m_new;
      }
    }
    __syncwarp();

    // O += P . V for this warp's 16 rows.
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf[BC / 16];
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], Ps + (warp * 16) * L::PLD + kk * 16, L::PLD);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o = Os + (warp * 16) * L::OLD + j * 16;
      wmma::load_matrix_sync(acc, o, L::OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + (kk * 16) * L::KLD + j * 16, L::KLD);
        wmma::mma_sync(acc, pf[kk], vf, acc);
      }
      wmma::store_matrix_sync(o, acc, L::OLD, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // out = acc / max(l, 1e-30), this warp's rows.
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int h = kvh * G + r / sc, s = qi * sc + r % sc;
    if (r / sc >= G || s >= S) continue;
    const float inv = 1.f / fmaxf(ls[r], 1e-30f);
    __nv_bfloat16* dst = out + (((size_t)b * H + h) * S + s) * D;
    for (int d = lane; d < D; d += 32) dst[d] = __float2bfloat16_rn(Os[r * L::OLD + d] * inv);
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
  // Shared memory above 48 KB needs the opt-in attribute, set once per
  // process (the first launch), so a later launch can be captured in a graph.
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<D, INT8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  dim3 grid(a.B * a.KV, (a.S + a.sc - 1) / a.sc);
  flash_attn_kernel<D, INT8><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
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
