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
// what the helpers of csrc/idct8x8.cuh keep down; the butterfly's
// arithmetic stays the golden model's.
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
// The device code (the butterfly, its helpers and the three transposes) is
// in csrc/idct8x8.cuh, which the chunk transport (csrc/transport.cu)
// shares: there the same transform runs on rows that the kernel gathers
// from the chunk's nonzero pairs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct8x8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = kThreads / 8;

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
  // row l in, then the transform (mp2v_idct::idct8x8_row), row l out
  slot[0][b][l] = live ? in[blk * 8 + l] : make_int4(0, 0, 0, 0);
  __syncwarp();
  const int4 row = mp2v_idct::idct8x8_row(slot[0][b], slot[1][b], l);
  if (live) out[blk * 8 + l] = row;
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
