// K1: SSE2-exact 8x8 fixed-point inverse DCT.
//
// Replaces: tiny_mp2v_dec_tpu/ops/idct.py idct_blocks_pallas / _idct_kernel
// (the Pallas TPU kernel, pallas_call at ops/idct.py:56).  The arithmetic is
// golden/idct.py butterfly8 op for op: mulhi(x, k) = (x * k) >> 16,
// int16-saturating adds/subs, int16-wrapping left shifts, final >> 6.
//
// What bounds it on an H100: integer instructions, not bytes.  Each 8x8
// block reads and writes 128 bytes each (33.5 MB for a 1080p chunk's
// 131,072 blocks, 10 us at 3.35 TB/s), but takes 16 butterflies of 40
// saturating adds and subtracts each: ptxas makes each one a fused
// add-and-clamp (VIADDMNMX) and a second clamp (VIMNMX), nearly half a
// thread's instructions, and the kernel reads within 10% of the same time
// with its data in L2 as from HBM.  So the layout is chosen for
// whole-sector accesses and no CTA barrier, and the instruction count is
// what the helpers below keep down; the butterfly's arithmetic stays the
// golden model's.
//
// Design: one thread per stored row.  8 threads per block, 4 blocks per
// warp, 32 per CTA (256 threads).  Thread l loads row l of its block's
// stored matrix as one 16-byte load, so a warp's load instruction reads 512
// contiguous bytes, and stores row l of the result as one 16-byte store.
// The butterfly runs along columns, so three 8x8 transposes of int16 go
// through shared memory, each within a block's 8 lanes, which lie in one
// warp: __syncwarp() orders them, no CTA barrier.  (1) the loaded rows are
// stored as they came and thread l reads column l (pass 1); (2) thread l
// stores its pass-1 column as a row and reads column l of those (pass 2,
// which gives column l of the result); (3) thread l stores that column as a
// row and reads row l of the result back out of the columns.  Every value
// crossing is in int16 range (the butterfly saturates), so the rows are
// packed int16, 16 bytes a row, and a block's slot holds 9 rows: the pad
// row puts the four blocks of a warp 4 banks apart, so neither the 16-byte
// row stores nor the 2-byte column reads conflict.  The Pallas kernel's
// (8, 8, TB) batch-along-lanes layout was a TPU vreg workaround and is not
// carried over.
//
// Integer semantics relied on: int is 32 bits; >> of a negative int is an
// arithmetic shift (implementation-defined in C++17, arithmetic on nvcc),
// which matches numpy's floor shift; converting an int to int16_t keeps its
// low 16 bits (implementation-defined before C++20, modular on nvcc).  Left
// shifts are written as multiplications so that no negative value is
// shifted left.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_TMP0 = 27145, K_TMP1 = 30068, K_TMP3 = 20090, K_TMP4 = 25079;
constexpr int K0 = 27145, K1 = -5037, K2 = -19954, K3 = -22089;
constexpr int K5 = 14567, K6 = 17391, K7 = 25570;
constexpr int IDCT_SCALE_SHIFT = 6;
constexpr int kThreads = 256;
constexpr int kBlocksPerCta = kThreads / 8;

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

// in: (n, 64) int16 in transposed-raster storage; out: (n, 8, 8) int16
// raster residual; both 16-byte aligned, read and written as 16-byte rows.
// blockDim = kThreads; thread 8b + l is row l of block b of the CTA.
__global__ void __launch_bounds__(kThreads)
    idct8x8_kernel(const int4* __restrict__ in, int4* __restrict__ out,
                   int n) {
  // two slots per block (each transpose writes the one the previous did
  // not read from); rows 0-7 of a slot, row 8 the pad
  __shared__ int4 slot[2][kBlocksPerCta][9];
  const int l = threadIdx.x & 7;
  const int b = threadIdx.x >> 3;
  const long long blk = (long long)blockIdx.x * kBlocksPerCta + b;
  const bool live = blk < n;
  const int16_t* t0 = reinterpret_cast<const int16_t*>(slot[0][b]);
  const int16_t* t1 = reinterpret_cast<const int16_t*>(slot[1][b]);
  int s[8], o[8];
  // (1) row l in; pass 1 on column l of the stored matrix
  slot[0][b][l] = live ? in[blk * 8 + l] : make_int4(0, 0, 0, 0);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = t0[k * 8 + l];
  butterfly8(s, o);
  // (2) pass 2 on row l of the pass-1 result: column l of the output
  slot[1][b][l] = pack8(o);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = t1[k * 8 + l];
  butterfly8(s, o);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] >>= IDCT_SCALE_SHIFT;
  // (3) output column l in, output row l out
  slot[0][b][l] = pack8(o);
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 8; ++c) s[c] = t0[c * 8 + l];
  if (live) out[blk * 8 + l] = pack8(s);
}

}  // namespace

extern "C" int mp2v_idct8x8(const void* in, void* out, int n, void* stream) {
  if (n > 0) {
    const int grid = (n + kBlocksPerCta - 1) / kBlocksPerCta;
    idct8x8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)in, (int4*)out, n);
  }
  return (int)cudaGetLastError();
}
