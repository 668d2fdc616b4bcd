// The 8x8 fixed-point inverse DCT of K1 as device code, shared by K1
// (csrc/idct.cu) and the chunk transport (csrc/transport.cu).
//
// The arithmetic is golden/idct.py butterfly8 op for op: mulhi(x, k) =
// (x * k) >> 16, int16-saturating adds/subs, int16-wrapping left shifts,
// final >> 6.  idct8x8_row runs one block on its 8 lanes, one stored row a
// lane, through two shared-memory slots of the block; the design and why it
// is chosen are in csrc/idct.cu.
//
// Integer semantics relied on: int is 32 bits; >> of a negative int is an
// arithmetic shift (implementation-defined in C++17, arithmetic on nvcc),
// which matches numpy's floor shift; converting an int to int16_t keeps its
// low 16 bits (implementation-defined before C++20, modular on nvcc).  Left
// shifts are written as multiplications so that no negative value is
// shifted left.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mp2v_idct {

constexpr int K_TMP0 = 27145, K_TMP1 = 30068, K_TMP3 = 20090, K_TMP4 = 25079;
constexpr int K0 = 27145, K1 = -5037, K2 = -19954, K3 = -22089;
constexpr int K5 = 14567, K6 = 17391, K7 = 25570;
constexpr int IDCT_SCALE_SHIFT = 6;

__device__ __forceinline__ int sat16(int x) {
  return min(max(x, -32768), 32767);
}
// the int16 wraparound as a conversion (nvcc keeps the low 16 bits): one
// sign extension, fewer instructions than ((x + 32768) & 65535) - 32768
__device__ __forceinline__ int wrap16(int x) { return (int)(int16_t)x; }
__device__ __forceinline__ int mulhi(int x, int k) { return (x * k) >> 16; }
__device__ __forceinline__ int adds(int a, int b) { return sat16(a + b); }
__device__ __forceinline__ int subs(int a, int b) { return sat16(a - b); }

// golden/idct.py butterfly8 (idct_sse2.hpp:23-65): s and o hold int16-range
// values in int32.
__device__ __forceinline__ void butterfly8(const int s[8], int o[8]) {
  // step 0
  const int v15 = adds(wrap16(mulhi(s[0], K0) * 2), wrap16(s[0] * 2));
  const int v26 = adds(mulhi(s[1], K1), wrap16(s[1] * 4));
  const int v21 = adds(mulhi(s[2], K2), wrap16(s[2] * 4));
  const int v28 = adds(wrap16(mulhi(s[3], K3) * 2), wrap16(s[3] * 4));
  const int v16 = adds(wrap16(mulhi(s[4], K0) * 2), wrap16(s[4] * 2));
  const int v25 = adds(mulhi(s[5], K5), wrap16(s[5] * 2));
  const int v22 = adds(wrap16(mulhi(s[6], K6) * 2), s[6]);
  const int v27 = wrap16(mulhi(s[7], K7) * 2);
  // step 1
  const int v19 = subs(v25, v28);
  const int v20 = subs(v26, v27);
  const int v23 = adds(v26, v27);
  const int v24 = adds(v25, v28);
  const int v7 = adds(v23, v24);
  const int v11 = adds(v21, v22);
  const int v13 = subs(v23, v24);
  const int v17 = subs(v21, v22);
  const int v8 = adds(v15, v16);
  const int v9 = subs(v15, v16);
  // step 2 (op0: x + mulhi(x, K_TMP0), op1: x - mulhi(x, K_TMP1),
  //         op3: x + mulhi(x, K_TMP3), op4: mulhi(x, K_TMP4))
  const int v18 = mulhi(subs(v19, v20), K_TMP4);
  const int v12 = subs(v18, adds(v19, mulhi(v19, K_TMP3)));
  const int v14 = subs(subs(v20, mulhi(v20, K_TMP1)), v18);
  const int v6 = subs(wrap16(v14 * 2), v7);
  const int v5 = subs(adds(v13, mulhi(v13, K_TMP0)), v6);
  const int v4 = adds(v5, wrap16(v12 * 2));
  const int v10 = subs(adds(v17, mulhi(v17, K_TMP0)), v11);
  const int v0 = adds(v8, v11);
  const int v1 = adds(v9, v10);
  const int v2 = subs(v9, v10);
  const int v3 = subs(v8, v11);
  // step 3
  o[0] = adds(v0, v7);
  o[1] = adds(v1, v6);
  o[2] = adds(v2, v5);
  o[3] = subs(v3, v4);
  o[4] = adds(v3, v4);
  o[5] = subs(v2, v5);
  o[6] = subs(v1, v6);
  o[7] = subs(v0, v7);
}

// Two int16-range values into one word, lo in the low half.
__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ int4 pack8(const int v[8]) {
  return make_int4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                   pack2(v[6], v[7]));
}

// One block's IDCT on its 8 lanes, lane l the stored row l.  On entry slot
// a (rows 0-7 of a 9-row slot, row 8 the pad) holds the block's stored
// matrix, written by the block's lanes and ordered by a __syncwarp(); slot
// b is free.  Returns row l of the raster residual.  Three transposes go
// through the two slots, each ordered by __syncwarp(), so every lane of
// the warp calls this together (the full-warp mask).  (1) pass 1 on column
// l of the stored matrix; (2) its result stored as row l of slot b, pass 2
// on column l of that (column l of the output); (3) that column stored as
// row l of slot a, which pass 1 has finished reading (ordered by (2)'s
// __syncwarp()), and output row l read back out of the columns.
__device__ __forceinline__ int4 idct8x8_row(int4* a, int4* b, int l) {
  const int16_t* t0 = reinterpret_cast<const int16_t*>(a);
  const int16_t* t1 = reinterpret_cast<const int16_t*>(b);
  int s[8], o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = t0[k * 8 + l];
  butterfly8(s, o);
  b[l] = pack8(o);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = t1[k * 8 + l];
  butterfly8(s, o);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] >>= IDCT_SCALE_SHIFT;
  a[l] = pack8(o);
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 8; ++c) s[c] = t0[c * 8 + l];
  return pack8(s);
}

}  // namespace mp2v_idct
