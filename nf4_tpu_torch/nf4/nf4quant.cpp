// Native host-side 4-bit quantizer: the two host-bound hot loops of
// quantization, built with g++ at first use by nf4/native.py.
//   1. per-64-block absmax + nearest-code assignment (the oracle's
//      np.searchsorted bottleneck, nf4/reference.py:quantize_to_code), and
//   2. the pair-layout K-major transpose pack (nf4/format.py's layout).
//
// Bit-exactness contract: byte-identical to the NumPy oracle.  That holds
// because every floating-point operation here is the same IEEE-754 single
// operation NumPy performs -- |x| (sign clear), max (abs values are >= 0, so
// fmaxf's NaN asymmetry only differs on NaN weights), x / scale (correctly
// rounded on every SSE2+ host), and ordered > comparisons against the SAME
// fp32 midpoint array the Python side passes in (thresholds are computed
// once in Python, never re-derived here).  Compile WITHOUT -ffast-math;
// nf4/native.py builds it so.
//
// The statistics (the fp64 absmax mean and the dynamic 8-bit compression
// of the absmax stream) stay in Python, with the oracle's own functions.

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

// Branchless lower_bound over a sorted array of exactly (1 << levels) - 1
// midpoints: returns #{mids < x}, the oracle's searchsorted(side="left").
// Ties (x == mids[k]) stay left because the walk moves right only on x >.
inline int64_t lb_tree(const float* mids, int levels, float x) {
  int64_t i = 0;
  for (int64_t h = int64_t(1) << (levels - 1); h >= 1; h >>= 1) {
    i += (x > mids[i + h - 1]) ? h : 0;
  }
  return i;
}

inline int pow2_levels(int64_t nmids) {
  // nmids == 2^k - 1 -> k, else 0 (generic fallback).
  for (int k = 1; k <= 16; ++k) {
    if (((int64_t(1) << k) - 1) == nmids) return k;
  }
  return 0;
}

}  // namespace

extern "C" {

// Per-block absmax + code assignment over a flat fp32 stream.
//   codes[i]  = #{mids < w[i] / scale(block(i))}   (uint8)
//   absmax[b] = max |w| over block b               (fp32, exact)
// scale(b) = absmax[b] if > 0 else 1.0f — the oracle's zero-block rule.
// The tail block (n % blocksize != 0) processes only real elements; its
// absmax equals the oracle's zero-padded max because |x| >= 0.
void nf4_quantize_codes(const float* w, int64_t n, int64_t blocksize,
                        const float* mids, int64_t nmids,
                        uint8_t* codes, float* absmax) {
  const int levels = pow2_levels(nmids);
  const int64_t nblocks = (n + blocksize - 1) / blocksize;
  // Small tables (the 15-midpoint NF4 case) take a linear count of ordered
  // compares: data-independent, so the compiler vectorizes both the divide
  // and the compare-accumulate (the binary tree's dependent loads serialize
  // at ~60M elements/s; this path measures ~4x that on one core).
  const bool linear = nmids <= 63;
  constexpr int64_t CHUNK = 256;
  float norm[CHUNK];
  int32_t cnt[CHUNK];
  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t lo = b * blocksize;
    const int64_t hi = std::min(lo + blocksize, n);
    float a = 0.0f;
    for (int64_t i = lo; i < hi; ++i) {
      const float v = w[i] < 0.0f ? -w[i] : w[i];
      a = v > a ? v : a;
    }
    absmax[b] = a;
    const float scale = a > 0.0f ? a : 1.0f;
    if (linear) {
      for (int64_t c = lo; c < hi; c += CHUNK) {
        const int64_t len = std::min(CHUNK, hi - c);
        for (int64_t i = 0; i < len; ++i) norm[i] = w[c + i] / scale;
        for (int64_t i = 0; i < len; ++i) cnt[i] = 0;
        for (int64_t k = 0; k < nmids; ++k) {
          const float mk = mids[k];
          for (int64_t i = 0; i < len; ++i) cnt[i] += norm[i] > mk ? 1 : 0;
        }
        for (int64_t i = 0; i < len; ++i) {
          codes[c + i] = static_cast<uint8_t>(cnt[i]);
        }
      }
    } else if (levels) {
      for (int64_t i = lo; i < hi; ++i) {
        codes[i] = static_cast<uint8_t>(lb_tree(mids, levels, w[i] / scale));
      }
    } else {
      for (int64_t i = lo; i < hi; ++i) {
        codes[i] = static_cast<uint8_t>(
            std::lower_bound(mids, mids + nmids, w[i] / scale) - mids);
      }
    }
  }
}

// Flat bitsandbytes nibble pack: element 2i in the HIGH nibble
// (nf4/reference.py:pack_nibbles; odd tails pad a zero low nibble).
void nf4_pack_flat(const uint8_t* codes, int64_t n, uint8_t* out) {
  const int64_t pairs = n / 2;
  for (int64_t i = 0; i < pairs; ++i) {
    out[i] = static_cast<uint8_t>((codes[2 * i] << 4) | (codes[2 * i + 1] & 0xF));
  }
  if (n % 2) {
    out[pairs] = static_cast<uint8_t>(codes[n - 1] << 4);
  }
}

// Adjacent-pair K-major pack with per-chunk padding: codes is [m, n]
// row-major; out is [shards * n_chunk_pad / 2, m_pad] row-major with
//   out[s * n_chunk_pad/2 + j, r] = codes[r, s*n_chunk + 2j]   (LOW nibble)
//                                 | codes[r, s*n_chunk + 2j+1] << 4
// and zeros in every padding position (nf4/format.py layout contract:
// byte (j, r) = W^T[2j, r] lo | W^T[2j+1, r] hi, per chunk).
// 64x64 tiles keep both the strided reads and writes cache-resident.
void nf4_pack_kmajor(const uint8_t* codes, int64_t m, int64_t n,
                     int64_t m_pad, int64_t n_chunk_pad, int64_t shards,
                     uint8_t* out) {
  const int64_t half_pad = n_chunk_pad / 2;
  const int64_t n_chunk = n / shards;
  const int64_t half_real = n_chunk / 2;
  std::memset(out, 0, static_cast<size_t>(shards * half_pad * m_pad));
  const int64_t T = 64;
  for (int64_t s = 0; s < shards; ++s) {
    uint8_t* outs = out + s * half_pad * m_pad;
    for (int64_t r0 = 0; r0 < m; r0 += T) {
      const int64_t r1 = std::min(r0 + T, m);
      for (int64_t j0 = 0; j0 < half_real; j0 += T) {
        const int64_t j1 = std::min(j0 + T, half_real);
        for (int64_t r = r0; r < r1; ++r) {
          const uint8_t* src = codes + r * n + s * n_chunk;
          for (int64_t j = j0; j < j1; ++j) {
            outs[j * m_pad + r] = static_cast<uint8_t>(
                (src[2 * j + 1] << 4) | (src[2 * j] & 0xF));
          }
        }
      }
    }
  }
}

}  // extern "C"
