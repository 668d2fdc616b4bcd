// K1: SSE2-exact 8x8 fixed-point inverse DCT.
//
// Replaces: tiny_mp2v_dec_tpu/ops/idct.py idct_blocks_pallas / _idct_kernel
// (the Pallas TPU kernel, pallas_call at ops/idct.py:56).  The arithmetic is
// golden/idct.py butterfly8 op for op: mulhi(x, k) = (x * k) >> 16,
// int16-saturating adds/subs, int16-wrapping left shifts, final >> 6.
//
// What bounds it on an H100: memory.  Each 8x8 block reads 128 bytes and
// writes 128 bytes for about 2 x 8 x 60 integer operations, far below the
// card's operations-per-byte balance, so the kernel is a streaming pass and
// its design only has to keep global accesses coalesced.
//
// Design: one thread per column (pass 1) and then per row (pass 2) of a
// block; 8 threads per block, 32 blocks per CTA (256 threads).  Pass 1
// loads element k*8+lane of each block — the 8 lanes of a block read 16
// contiguous bytes per k — and runs the butterfly in registers.  The
// transpose goes through shared memory (rows padded to 9 words against
// bank conflicts).  Pass 2 runs the butterfly along the other axis and
// stores row i*8+lane, again contiguous across the 8 lanes.  The Pallas
// kernel's (8, 8, TB) batch-along-lanes layout was a TPU vreg workaround and
// is not carried over.
//
// Integer semantics relied on: int is 32 bits; >> of a negative int is an
// arithmetic shift (implementation-defined in C++17, arithmetic on nvcc),
// which matches numpy's floor shift.  Left shifts are written as
// multiplications so that no negative value is shifted left.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_TMP0 = 27145, K_TMP1 = 30068, K_TMP3 = 20090, K_TMP4 = 25079;
constexpr int K0 = 27145, K1 = -5037, K2 = -19954, K3 = -22089;
constexpr int K5 = 14567, K6 = 17391, K7 = 25570;
constexpr int IDCT_SCALE_SHIFT = 6;
constexpr int BLOCKS_PER_CTA = 32;

__device__ __forceinline__ int sat16(int x) {
  return min(max(x, -32768), 32767);
}
__device__ __forceinline__ int wrap16(int x) {
  return ((x + 32768) & 65535) - 32768;
}
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

// in: (n, 64) int16 in transposed-raster storage; out: (n, 8, 8) int16
// raster residual.  blockDim = (8, BLOCKS_PER_CTA).
__global__ void idct8x8_kernel(const int16_t* __restrict__ in,
                               int16_t* __restrict__ out, int n) {
  __shared__ int t[BLOCKS_PER_CTA][8][9];
  const int lane = threadIdx.x;
  const int b = threadIdx.y;
  const long long blk = (long long)blockIdx.x * BLOCKS_PER_CTA + b;
  const bool live = blk < n;
  int s[8], o[8];
  // pass 1: column `lane` of the stored matrix
  const int16_t* src = in + blk * 64;
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = live ? src[k * 8 + lane] : 0;
  butterfly8(s, o);
#pragma unroll
  for (int j = 0; j < 8; ++j) t[b][j][lane] = o[j];
  __syncthreads();
  // pass 2: row `lane` of the pass-1 result; output row i, column lane
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = t[b][lane][k];
  butterfly8(s, o);
  if (live) {
    int16_t* dst = out + blk * 64;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i * 8 + lane] = (int16_t)(o[i] >> IDCT_SCALE_SHIFT);
  }
}

}  // namespace

extern "C" int mp2v_idct8x8(const void* in, void* out, int n, void* stream) {
  if (n > 0) {
    const dim3 block(8, BLOCKS_PER_CTA);
    const int grid = (n + BLOCKS_PER_CTA - 1) / BLOCKS_PER_CTA;
    idct8x8_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int16_t*)in, (int16_t*)out, n);
  }
  return (int)cudaGetLastError();
}
