// One 4-pixel word of a packed half-pel prediction, shared by the SWAR
// kernels K7/K8 (csrc/mc_swar.cu, csrc/mc_recon.cu); the 8-pixel row
// segment of the segment kernels K2-K4, K8 (csrc/mc_recon.cu), K7
// (csrc/mc_swar.cu), K5, K6 (csrc/mc_roll.cu) and K9, K10
// (csrc/mc_rows.cu), with their grouping of segments into warps and their
// residual epilogue.
//
// A word holds pixels 4x .. 4x+3 of a row, the first at the least
// significant byte.  Word k of a prediction whose first pixel column is sx
// reads the two aligned words lo, hi at word column (sx >> 2) + k:
//   a = __funnelshift_rc(lo, hi, 8 * (sx & 3))       pixels sx+4k ..
//   b = __funnelshift_rc(lo, hi, 8 * (sx & 3) + 8)   pixels sx+4k+1 ..
// (5 bytes from an offset of at most 3 always lie in the 2 words, and _rc
// clamps the shift of 32 to hi, so sx & 3 == 0 needs no branch).  c and d
// come the same way from the row `vs` below.  The shifts are unsigned: no
// sign bit is ever copied into a byte.  __vavgu4 is the per-byte
// (x + y + 1) >> 1 of MPEG-2's rounding, so the phase select stays packed:
// avg(avg(a, b), avg(c, d)) is the exact 2-D chain.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mp2v {

// Word (y, x) of an (Hr, nw) word plane; 0 at or past either edge.
__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ ref,
                                            int Hr, int nw, int y, int x) {
  return (y < Hr && x < nw) ? ref[(long long)y * nw + x] : 0u;
}

// Word k of a unidirectional packed prediction whose a/b taps are on row y
// and c/d taps `vs` rows below, with phase ph (bit 0 horizontal, bit 1
// vertical); (y, sx) >= 0.
__device__ __forceinline__ uint32_t halfpel_word(
    const uint32_t* __restrict__ ref, int Hr, int nw, int y, int sx, int k,
    int ph, int vs) {
  const int x = (sx >> 2) + k;
  const unsigned s = (unsigned)(sx & 3) << 3;
  const uint32_t lo = word_at(ref, Hr, nw, y, x);
  const uint32_t hi = word_at(ref, Hr, nw, y, x + 1);
  const uint32_t a = __funnelshift_rc(lo, hi, s);
  if ((ph & 3) == 0) return a;
  if ((ph & 3) == 1) return __vavgu4(a, __funnelshift_rc(lo, hi, s + 8));
  const uint32_t lo2 = word_at(ref, Hr, nw, y + vs, x);
  const uint32_t hi2 = word_at(ref, Hr, nw, y + vs, x + 1);
  const uint32_t c = __funnelshift_rc(lo2, hi2, s);
  if ((ph & 3) == 2) return __vavgu4(a, c);
  const uint32_t b = __funnelshift_rc(lo, hi, s + 8);
  const uint32_t d = __funnelshift_rc(lo2, hi2, s + 8);
  return __vavgu4(__vavgu4(a, b), __vavgu4(c, d));
}

// Words k and k + 1 of the same prediction (8 pixels from sx + 4k): the
// two words halfpel_word gives, from three aligned words per tap row, the
// middle one shared by both.  (tap_row2's arithmetic written out: the
// segment kernels' machine code is held fixed against this text.)
__device__ __forceinline__ uint2 halfpel_word2(
    const uint32_t* __restrict__ ref, int Hr, int nw, int y, int sx, int k,
    int ph, int vs) {
  const int x = (sx >> 2) + k;
  const unsigned s = (unsigned)(sx & 3) << 3;
  const uint32_t w0 = word_at(ref, Hr, nw, y, x);
  const uint32_t w1 = word_at(ref, Hr, nw, y, x + 1);
  const uint32_t w2 = word_at(ref, Hr, nw, y, x + 2);
  uint32_t p0 = __funnelshift_rc(w0, w1, s);
  uint32_t p1 = __funnelshift_rc(w1, w2, s);
  if (ph & 1) {
    p0 = __vavgu4(p0, __funnelshift_rc(w0, w1, s + 8));
    p1 = __vavgu4(p1, __funnelshift_rc(w1, w2, s + 8));
  }
  if (ph & 2) {
    const uint32_t v0 = word_at(ref, Hr, nw, y + vs, x);
    const uint32_t v1 = word_at(ref, Hr, nw, y + vs, x + 1);
    const uint32_t v2 = word_at(ref, Hr, nw, y + vs, x + 2);
    uint32_t q0 = __funnelshift_rc(v0, v1, s);
    uint32_t q1 = __funnelshift_rc(v1, v2, s);
    if (ph & 1) {
      q0 = __vavgu4(q0, __funnelshift_rc(v0, v1, s + 8));
      q1 = __vavgu4(q1, __funnelshift_rc(v1, v2, s + 8));
    }
    p0 = __vavgu4(p0, q0);
    p1 = __vavgu4(p1, q1);
  }
  return make_uint2(p0, p1);
}

// One tap row of halfpel_word2 for a caller that holds the row's three
// aligned words w0..w2 already (K5, K6, csrc/mc_roll.cu): its two words at bit
// offset s = 8 * (sx & 3), the a taps, averaged with the b taps one pixel to
// the right under a horizontal half-pel phase (ph bit 0).
__device__ __forceinline__ uint2 tap_row2(uint32_t w0, uint32_t w1,
                                          uint32_t w2, unsigned s, int ph) {
  uint32_t p0 = __funnelshift_rc(w0, w1, s);
  uint32_t p1 = __funnelshift_rc(w1, w2, s);
  if (ph & 1) {
    p0 = __vavgu4(p0, __funnelshift_rc(w0, w1, s + 8));
    p1 = __vavgu4(p1, __funnelshift_rc(w1, w2, s + 8));
  }
  return make_uint2(p0, p1);
}

// Residual add and clip of one 4-pixel word: prediction bytes + the two
// int16 pairs r01, r23 (pixel 0 in the low half of r01), in 32-bit
// arithmetic, clipped to [0, 255] and packed back into a word.
__device__ __forceinline__ uint32_t add_clip4(uint32_t pred, int r01,
                                              int r23) {
  const int v0 = min(max((int)(pred & 0xFF) + (int)(int16_t)r01, 0), 255);
  const int v1 = min(max((int)((pred >> 8) & 0xFF) + (r01 >> 16), 0), 255);
  const int v2 = min(max((int)((pred >> 16) & 0xFF) + (int)(int16_t)r23, 0),
                     255);
  const int v3 = min(max((int)(pred >> 24) + (r23 >> 16), 0), 255);
  return __byte_perm(__byte_perm(v0, v1, 0x0040), __byte_perm(v2, v3, 0x0040),
                     0x5410);
}

// The segment kernels give one thread to each 8-pixel row segment and pack
// whole MBs into blocks of 256 threads.  MBs side by side in one thread
// group: tiles 8 wide go in pairs of horizontally adjacent MBs, so that the
// threads of a plane's row cover 16 pixels and a warp's rows fill whole
// 32-byte sectors.
__host__ __device__ constexpr int mbs_per_group(int tw) {
  return tw == 8 ? 2 : 1;
}

}  // namespace mp2v
