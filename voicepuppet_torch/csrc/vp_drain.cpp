// The serving drain's host unpack: packed planar YUV 4:2:0 -> RGB uint8.
//
// Byte for byte the numpy routine _unpack_yuv420 of
// voicepuppet_torch/pipeline/synthesize.py (BT.601 full range, nearest
// chroma upsample, chroma terms in 1/64 fixed point):
//
//   u = U - 128, v = V - 128
//   rq = (90 v) >> 6,  gq = (-22 u - 46 v) >> 6,  bq = (113 u) >> 6
//   R, G, B = clamp(Y + rq | gq | bq, 0, 255)
//
// The shifts are arithmetic (floor), as numpy's >> on int16, and every
// term fits int16 (|90 v| <= 11520), so int arithmetic gives the same
// bytes.  One pass: each 2x2 block's chroma terms are computed once, each
// packed byte is read once and each output byte written once.  No threads
// and no allocation; the caller (ctypes.CDLL) drops the GIL for the call.
// On x86 an SSSE3 body does 8 blocks (16 columns of 2 rows) a step; the
// plain loop does the rest and every block where SSSE3 is missing.
//
// Build: g++ -O3 -shared -fPIC -std=c++17, into build/ at the first call
// of voicepuppet_torch/pipeline/drain_native.py.

#include <cstddef>
#include <cstdint>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define VP_DRAIN_SSSE3 1
#endif

namespace {

inline uint8_t clamp8(int x) {
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// Blocks [i, h) of one chroma row: luma rows y0 and y0 + s, RGB rows o0
// and o0 + 3 s.
void blocks_plain(const uint8_t* y0, const uint8_t* ur, const uint8_t* vr,
                  int i, int h, int s, uint8_t* o0) {
  for (; i < h; ++i) {
    const int u = int(ur[i]) - 128, v = int(vr[i]) - 128;
    const int q[3] = {(90 * v) >> 6, (-22 * u - 46 * v) >> 6,
                      (113 * u) >> 6};
    for (int r = 0; r < 2; ++r) {
      const uint8_t* y = y0 + size_t(r) * s + 2 * i;
      uint8_t* o = o0 + size_t(r) * s * 3 + 6 * i;
      for (int c = 0; c < 3; ++c) {
        o[c] = clamp8(y[0] + q[c]);
        o[3 + c] = clamp8(y[1] + q[c]);
      }
    }
  }
}

#ifdef VP_DRAIN_SSSE3

// 16 pixels of three byte planes -> 48 interleaved RGB bytes: output byte
// 16 p + k takes byte k' of plane c where 16 p + k = 3 k' + c.
__attribute__((target("ssse3")))
inline void store_rgb(uint8_t* o, __m128i r, __m128i g, __m128i b) {
  alignas(16) static const int8_t kMask[3][3][16] = {
      {{0, -1, -1, 1, -1, -1, 2, -1, -1, 3, -1, -1, 4, -1, -1, 5},
       {-1, 0, -1, -1, 1, -1, -1, 2, -1, -1, 3, -1, -1, 4, -1, -1},
       {-1, -1, 0, -1, -1, 1, -1, -1, 2, -1, -1, 3, -1, -1, 4, -1}},
      {{-1, -1, 6, -1, -1, 7, -1, -1, 8, -1, -1, 9, -1, -1, 10, -1},
       {5, -1, -1, 6, -1, -1, 7, -1, -1, 8, -1, -1, 9, -1, -1, 10},
       {-1, 5, -1, -1, 6, -1, -1, 7, -1, -1, 8, -1, -1, 9, -1, -1}},
      {{-1, 11, -1, -1, 12, -1, -1, 13, -1, -1, 14, -1, -1, 15, -1, -1},
       {-1, -1, 11, -1, -1, 12, -1, -1, 13, -1, -1, 14, -1, -1, 15, -1},
       {10, -1, -1, 11, -1, -1, 12, -1, -1, 13, -1, -1, 14, -1, -1, 15}}};
  for (int p = 0; p < 3; ++p) {
    const __m128i* m = reinterpret_cast<const __m128i*>(kMask[p]);
    const __m128i x = _mm_or_si128(
        _mm_or_si128(_mm_shuffle_epi8(r, _mm_load_si128(m)),
                     _mm_shuffle_epi8(g, _mm_load_si128(m + 1))),
        _mm_shuffle_epi8(b, _mm_load_si128(m + 2)));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(o + 16 * p), x);
  }
}

// As blocks_plain from block 0, 8 blocks a step in int16 lanes (packus
// is the clamp); returns the first block left to do.
__attribute__((target("ssse3")))
int blocks_ssse3(const uint8_t* y0, const uint8_t* ur, const uint8_t* vr,
                 int h, int s, uint8_t* o0) {
  const __m128i zero = _mm_setzero_si128(), c128 = _mm_set1_epi16(128);
  int i = 0;
  for (; i + 8 <= h; i += 8) {
    const __m128i u = _mm_sub_epi16(_mm_unpacklo_epi8(
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(ur + i)), zero),
        c128);
    const __m128i v = _mm_sub_epi16(_mm_unpacklo_epi8(
        _mm_loadl_epi64(reinterpret_cast<const __m128i*>(vr + i)), zero),
        c128);
    const __m128i q[3] = {
        _mm_srai_epi16(_mm_mullo_epi16(v, _mm_set1_epi16(90)), 6),
        _mm_srai_epi16(
            _mm_add_epi16(_mm_mullo_epi16(u, _mm_set1_epi16(-22)),
                          _mm_mullo_epi16(v, _mm_set1_epi16(-46))), 6),
        _mm_srai_epi16(_mm_mullo_epi16(u, _mm_set1_epi16(113)), 6)};
    // each block's term for its two columns: pixels 0-7 and 8-15
    __m128i lo[3], hi[3];
    for (int c = 0; c < 3; ++c) {
      lo[c] = _mm_unpacklo_epi16(q[c], q[c]);
      hi[c] = _mm_unpackhi_epi16(q[c], q[c]);
    }
    for (int r = 0; r < 2; ++r) {
      const __m128i y = _mm_loadu_si128(
          reinterpret_cast<const __m128i*>(y0 + size_t(r) * s + 2 * i));
      const __m128i yl = _mm_unpacklo_epi8(y, zero);
      const __m128i yh = _mm_unpackhi_epi8(y, zero);
      __m128i rgb[3];
      for (int c = 0; c < 3; ++c)
        rgb[c] = _mm_packus_epi16(_mm_add_epi16(yl, lo[c]),
                                  _mm_add_epi16(yh, hi[c]));
      store_rgb(o0 + size_t(r) * s * 3 + 6 * i, rgb[0], rgb[1], rgb[2]);
    }
  }
  return i;
}

#endif

}  // namespace

extern "C" {

// packed: [n, s*s*3/2] (Y plane, then U and V at (s/2)^2 each), s even;
// out: [n, s, s, 3].  Both C-contiguous.
void vp_unpack_yuv420(const uint8_t* packed, int n, int s, uint8_t* out) {
  const int h = s / 2;
  const size_t luma = size_t(s) * s, chroma = size_t(h) * h;
#ifdef VP_DRAIN_SSSE3
  const bool ssse3 = __builtin_cpu_supports("ssse3");
#endif
  for (int f = 0; f < n; ++f) {
    const uint8_t* y = packed + f * (luma + 2 * chroma);
    const uint8_t* u = y + luma;
    const uint8_t* v = u + chroma;
    uint8_t* o = out + f * luma * 3;
    for (int j = 0; j < h; ++j) {
      const uint8_t* y0 = y + size_t(2 * j) * s;
      uint8_t* o0 = o + size_t(2 * j) * s * 3;
      int i = 0;
#ifdef VP_DRAIN_SSSE3
      if (ssse3) i = blocks_ssse3(y0, u + size_t(j) * h, v + size_t(j) * h,
                                  h, s, o0);
#endif
      blocks_plain(y0, u + size_t(j) * h, v + size_t(j) * h, i, h, s, o0);
    }
  }
}

}  // extern "C"
