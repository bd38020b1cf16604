// Host-side wire-codec kernels for the streaming mesher.
//
// The "packed" value codec v2 (see msd_tpu/mesh.py:_encode_compact_body)
// ships each crossing block as a 16-byte sign bitmap (corner c negative iff
// bit c set, little-endian bit order) plus one dense u8 magnitude stream
// covering the block's NEEDED corners — corners incident to a sign change
// within their clipped 3^3 lattice window — in row-major (block, corner)
// order.  The needed set is NOT shipped: the decoder re-derives it from the
// sign bitmap as needed = dilate(neg) & dilate(pos) (separable clipped
// dilation on the 125-bit field, ~30 u64 ops/row), bit-exact with the
// encoder's window-adjacency matmul.  v1 shipped an explicit 16-byte
// present bitmap per row; on trained fields it is identical to the derived
// needed set, so round 5 dropped it (19% of the wire bytes).  Decoding
// expands to the [K, pts] float32 corner grid the marching-tets builder
// consumes: corners outside the needed set decode to the codec cap
// (q*255), whose magnitude is never read by crossing-edge interpolation;
// saturated needed corners ship the byte 255 and decode to the same cap.
//
// numpy decodes this with unpackbits + dilations + a boolean scatter --
// 130-290 ms across runs for the 28 625 crossing rows of the converged
// N=513 bench field (a ~72.8k-ACTIVE-block shell) on a 1-core host, which
// is why the packed codec lost its round-4 A/B there (PERF.md).  The
// AVX-512 path below maps the codec directly onto hardware: each 16-bit
// derived-needed word is a __mmask16 driving VEXPANDPS (dense magnitudes
// -> sparse corner lanes), and the sign bitmap is a mask XOR on the float
// sign bit.  ~8 vector ops per 16 corners plus the dilation scalar ops.

#include <cstdint>
#include <cstring>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

// Both decode paths reinterpret the little-endian wire bytes as u64/u16
// words (memcpy); on a big-endian host that would scramble the sign bits
// SILENTLY, so refuse to build there instead (the numpy fallback in
// mesh.py is endian-correct via unpackbits).
#if defined(__BYTE_ORDER__) && (__BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__)
#error "codec.cpp assumes a little-endian host; build without it to use the numpy decode path"
#endif

namespace {

// 125-bit field in a (lo, hi) u64 pair; corner index i = 25*a + 5*b + c
// (c fastest).  Boundary masks keep the separable dilation CLIPPED at the
// lattice faces (a shift by 1 must not leak across c-rows, by 5 not across
// b-rows; the stride-25 shift can only fall off the 125-bit end).
struct Bits125 {
  uint64_t lo, hi;
};

constexpr uint64_t M_ALL_LO = 0xFFFFFFFFFFFFFFFFull, M_ALL_HI = 0x1FFFFFFFFFFFFFFFull;
constexpr uint64_t M_C_NE0_LO = 0xEF7BDEF7BDEF7BDEull, M_C_NE0_HI = 0x1EF7BDEF7BDEF7BDull;
constexpr uint64_t M_C_NE4_LO = 0xF7BDEF7BDEF7BDEFull, M_C_NE4_HI = 0x0F7BDEF7BDEF7BDEull;
constexpr uint64_t M_B_NE0_LO = 0xFF83FFFFC1FFFFE0ull, M_B_NE0_HI = 0x1FFFFE0FFFFF07FFull;
constexpr uint64_t M_B_NE4_LO = 0xFFFC1FFFFE0FFFFFull, M_B_NE4_HI = 0x00FFFFF07FFFF83Full;

template <int k>
inline Bits125 shl(Bits125 v) {
  return {v.lo << k, (v.hi << k) | (v.lo >> (64 - k))};
}
template <int k>
inline Bits125 shr(Bits125 v) {
  return {(v.lo >> k) | (v.hi << (64 - k)), v.hi >> k};
}

// clipped 3^3 (Chebyshev-1) dilation, separable per axis
inline Bits125 dilate(Bits125 v) {
  Bits125 c1 = shl<1>(v), c2 = shr<1>(v);
  v.lo |= (c1.lo & M_C_NE0_LO) | (c2.lo & M_C_NE4_LO);
  v.hi |= (c1.hi & M_C_NE0_HI) | (c2.hi & M_C_NE4_HI);
  Bits125 b1 = shl<5>(v), b2 = shr<5>(v);
  v.lo |= (b1.lo & M_B_NE0_LO) | (b2.lo & M_B_NE4_LO);
  v.hi |= (b1.hi & M_B_NE0_HI) | (b2.hi & M_B_NE4_HI);
  Bits125 a1 = shl<25>(v), a2 = shr<25>(v);
  v.lo |= a1.lo | a2.lo;
  v.hi = (v.hi | a1.hi | a2.hi) & M_ALL_HI;
  return v;
}

// needed = corners whose clipped 3^3 window holds BOTH signs
inline Bits125 needed_mask(Bits125 sign) {
  Bits125 pos{~sign.lo & M_ALL_LO, ~sign.hi & M_ALL_HI};
  Bits125 dn = dilate(sign), dp = dilate(pos);
  return {dn.lo & dp.lo, dn.hi & dp.hi};
}

// Portable scalar row decode over the derived needed words; also the tail
// path when the SIMD row would overread the magnitude stream.  A short
// magnitude stream (corrupt transfer) never reads out of bounds: demand
// past n_mags decodes to the cap, and the returned consumed count still
// reflects the true demand so the caller's consistency check fires.
inline int64_t decode_row_scalar(const uint16_t* sw, const uint16_t* nw,
                                 const uint8_t* mags, int64_t m,
                                 int64_t n_mags, float q, float cap, float* o,
                                 int32_t pts) {
  for (int c = 0; c < pts; ++c) {
    int word = c >> 4, bit = c & 15;
    int p = (nw[word] >> bit) & 1;
    float v = (p && m < n_mags) ? q * (float)mags[m] : cap;
    m += p;
    o[c] = (sw[word] >> bit) & 1 ? -v : v;
  }
  return m;
}

}  // namespace

extern "C" {

// bitmaps: [K, 16] u8 sign-bitmap rows as described above.
// mags:    [n_mags] u8 dense magnitude stream (row-major needed corners).
// out:     [K, pts] float32, fully overwritten.
// Returns the number of magnitudes consumed (== expected n_mags), so the
// caller can assert stream consistency.  pts must be 125 (the needed-set
// derivation is specific to the 5^3 corner lattice).
int64_t msd_decode_packed(const uint8_t* bitmaps, const uint8_t* mags,
                          int64_t K, int64_t n_mags, int32_t pts, float q,
                          float* out) {
  if (pts != 125) return -1;
  const float cap = q * 255.0f;
  int64_t m = 0;
#if defined(__AVX512F__)
  {
    const __m512 qv = _mm512_set1_ps(q);
    const __m512 capv = _mm512_set1_ps(cap);
    const __m512i signbit = _mm512_set1_epi32((int32_t)0x80000000u);
    for (int64_t k = 0; k < K; ++k) {
      const uint8_t* b = bitmaps + k * 16;
      float* o = out + k * 125;
      Bits125 sign;
      std::memcpy(&sign.lo, b, 8);
      std::memcpy(&sign.hi, b + 8, 8);
      sign.hi &= M_ALL_HI;  // encoder pads bits 125..127 with zeros
      Bits125 need = needed_mask(sign);
      uint16_t sw[8], nw[8];
      std::memcpy(sw, b, 16);
      // chunks 0..3 = lo bits, 4..7 = hi bits (corner 64 = hi bit 0)
      for (int j = 0; j < 4; ++j) nw[j] = (uint16_t)(need.lo >> (16 * j));
      for (int j = 0; j < 4; ++j) nw[4 + j] = (uint16_t)(need.hi >> (16 * j));
      // a full row consumes <= 125 magnitudes; each chunk's 16-byte
      // magnitude load reads at most 15 bytes past the consumed
      // prefix, so m + 125 + 15 <= n_mags keeps every load in bounds
      if (m + 140 > n_mags) {
        m = decode_row_scalar(sw, nw, mags, m, n_mags, q, cap, o, 125);
        continue;
      }
      for (int j = 0; j < 8; ++j) {
        __mmask16 pm = (__mmask16)nw[j];
        __m128i m8 = _mm_loadu_si128((const __m128i*)(mags + m));
        __m512 mf =
            _mm512_mul_ps(_mm512_cvtepi32_ps(_mm512_cvtepu8_epi32(m8)), qv);
        __m512 v = _mm512_mask_expand_ps(capv, pm, mf);
        __m512i vi = _mm512_castps_si512(v);
        vi = _mm512_mask_xor_epi32(vi, (__mmask16)sw[j], vi, signbit);
        if (j < 7) {
          _mm512_storeu_ps(o + 16 * j, _mm512_castsi512_ps(vi));
        } else {
          // corners 112..124 (13 lanes)
          _mm512_mask_storeu_ps(o + 112, (__mmask16)0x1FFF,
                                _mm512_castsi512_ps(vi));
        }
        m += _mm_popcnt_u32((unsigned)pm);
      }
    }
    return m;
  }
#else
  for (int64_t k = 0; k < K; ++k) {
    const uint8_t* b = bitmaps + k * 16;
    Bits125 sign;
    std::memcpy(&sign.lo, b, 8);
    std::memcpy(&sign.hi, b + 8, 8);
    sign.hi &= M_ALL_HI;
    Bits125 need = needed_mask(sign);
    uint16_t sw[8], nw[8];
    std::memcpy(sw, b, 16);
    for (int j = 0; j < 4; ++j) nw[j] = (uint16_t)(need.lo >> (16 * j));
    for (int j = 0; j < 4; ++j) nw[4 + j] = (uint16_t)(need.hi >> (16 * j));
    m = decode_row_scalar(sw, nw, mags, m, n_mags, q, cap,
                          out + (int64_t)k * 125, 125);
  }
  return m;
#endif
}

// 1 when the AVX-512 (VEXPANDPS) row decoder compiled in, 0 when
// msd_decode_packed is the portable scalar loop.  The host-aware codec
// default (msd_tpu/stream_knobs.py) keys on this: the 1-core packed
// preference is only benchmarked on the SIMD path.
int32_t msd_codec_simd(void) {
#if defined(__AVX512F__)
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"
