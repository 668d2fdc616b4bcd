// The chunk transport: a chunk blob's nonzero (column, value) pairs ->
// coefficient rows -> 8x8 IDCT -> the chunk's dense residual block grid, in
// three launches.
//
// Replaces: tiny_mp2v_dec_tpu/ops/recon.py GopRecon._decode_blob, the XLA
// ops that rebuild each pair's row and each row's grid block with
// scatter-adds and cumsums, expand the pairs into a zeroed coefficient
// buffer and scatter the IDCT's rows into a zeroed grid, together with the
// one idct_blocks_pallas call it makes (ops/idct.py:49, K1 in the port).
// In the port it takes the place of ops/recon.py's plain version (38
// PyTorch kernels and one K1 launch a chunk) on every decoder path.
//
// Input: the blob's sections as GopRecon._layout places them, each read in
// its own width: pair_pos uint8 [cap_pairs] (the column in the block's
// stored 64-vector; 255 pads), pair_val int16 [cap_pairs], row_nnz uint8
// [cap_k] (nonzeros of each coded row, in the rows' order), scat [cap_k]
// (the row's block: uint16 within its picture, 0xFFFF pads, or int32
// within the chunk, >= span pads), pic_k int32 [chunk] (coded rows of each
// picture, in order).  Output: the grid (span = chunk * n_rows, 64) int16,
// each block written once, by this code: a coded row's residual, zeros
// everywhere else (uncoded blocks, padding pictures of a short chunk).
//
// What bounds it on an H100: the grid's bytes for the uncoded blocks, and
// K1's saturating adds for the coded rows.  A 16-picture 1080p 4:2:0 chunk
// writes 100 MB of grid (30 us at 3.35 TB/s) of which about a sixth are
// coded blocks; those take K1's 16 butterflies each, which bound K1 by its
// instructions at about twice its bytes (csrc/idct.cu).  The design lets
// the two overlap: one launch holds both kinds of CTA, interleaved in
// blockIdx order in proportion to their counts, so that every SM runs
// instruction-bound transform CTAs beside store-bound zero CTAs.  The zeros
// are stored evict-first (below), so that they do not push out of the L2
// the coded rows that the MC kernels then read.
//
// Launches:
//   1. transport_index_kernel, a thread a row: the row's grid block g (or
//      -1 for padding), from its uint16 position and its picture, which is
//      the number of pictures whose rows all come before it (a binary
//      search over pic_k's running sum), or from the int32 position; g into
//      rowblk[row], row into blkrow[g]; and the nonzeros of each 32-row tile
//      (a warp's sum) into tiles[].
//   2. transport_scan_kernel, one CTA: tiles[] -> its exclusive running
//      sum, the first pair of each tile.
//   3. transport_kernel: transform CTAs, each 32 rows as K1 takes them (8
//      lanes a row, 4 rows a warp), each warp scanning its tile's 32 counts
//      by shuffles for its rows' first pairs; a row's pairs are scattered
//      into its zeroed shared-memory slot and K1's transform
//      (csrc/idct8x8.cuh) runs on it, the result stored at the row's block.
//      Zero CTAs, each 256 blocks, store zeros at every block that no row
//      of this chunk points to.
//
// blkrow is never cleared: it is read as a sparse set (Briggs and
// Torczon), block g being coded iff r = blkrow[g] is a row of this chunk
// (0 <= r < cap_k) and rowblk[r] == g.  A stale or uninitialized entry can
// only name a row that points elsewhere, so no launch zeroes the scratch
// and no state carries from one call to the next.
//
// No int64 vector, no coefficient buffer and no scatter index is made: the
// scratch is rowblk, blkrow and tiles, 4 bytes a row, a block and a tile.
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct8x8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 8;   // transform CTA: 32 rows
constexpr int kTile = 32;                   // rows whose pairs tiles[] sums
constexpr int kZeroBlocks = 256;            // zero CTA: blocks
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRowsPerCta == kTile, "a transform CTA is one tile");

// Launch 1.  blockDim = kThreads, a thread a row; dynamic shared memory
// chunk ints under U16 (the pictures' running row counts).
template <bool U16>
__global__ void __launch_bounds__(kThreads) transport_index_kernel(
    const uint8_t* __restrict__ row_nnz, const void* __restrict__ scat,
    const int* __restrict__ pic_k, int cap_k, int chunk, int n_rows,
    int span, int* __restrict__ rowblk, int* __restrict__ blkrow,
    int* __restrict__ tiles) {
  extern __shared__ int ends[];  // ends[i]: rows of pictures 0..i
  if (U16) {
    for (int i = threadIdx.x; i < chunk; i += kThreads) ends[i] = pic_k[i];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 1; i < chunk; ++i) ends[i] += ends[i - 1];
    __syncthreads();
  }
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in = r < cap_k;
  const int nnz = in ? row_nnz[r] : 0;
  if (in) {
    int g = -1;
    if (U16) {
      const int s = reinterpret_cast<const uint16_t*>(scat)[r];
      if (s != 0xFFFF && s < n_rows) {
        // the row's picture: the pictures whose rows all precede row r
        int lo = 0, hi = chunk;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ends[mid] <= r) lo = mid + 1; else hi = mid;
        }
        if (lo < chunk) g = lo * n_rows + s;
      }
    } else {
      const int s = reinterpret_cast<const int*>(scat)[r];
      if (s >= 0 && s < span) g = s;
    }
    rowblk[r] = g;
    if (g >= 0) blkrow[g] = r;
  }
  int sum = nnz;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(kFull, sum, d);
  if ((threadIdx.x & 31) == 0 && in) tiles[r / kTile] = sum;
}

// Launch 2.  One CTA of kScanThreads: tiles[0..n) -> exclusive running sum,
// in place; each thread a contiguous run of the tiles.
__global__ void __launch_bounds__(kScanThreads)
    transport_scan_kernel(int* __restrict__ tiles, int n) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += tiles[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += t;
    }
    warp_sums[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int run = (warp ? warp_sums[warp - 1] : 0) + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = tiles[i];
    tiles[i] = run;
    run += v;
  }
}

// Launch 3, a transform CTA: rows c * 32 .. c * 32 + 31; thread 8b + l is
// lane l of row c * 32 + b.
__device__ __forceinline__ void transform_rows(
    int c, const uint8_t* __restrict__ pair_pos,
    const int16_t* __restrict__ pair_val, const uint8_t* __restrict__ row_nnz,
    const int* __restrict__ rowblk, const int* __restrict__ tiles,
    int cap_pairs, int cap_k, int4* __restrict__ out,
    int4 (*slot)[kRowsPerCta][9]) {
  const int lane = threadIdx.x & 31;
  const int l = threadIdx.x & 7;
  const int b = threadIdx.x >> 3;
  const int row0 = c * kRowsPerCta;
  // the tile's counts, lane i row row0 + i, scanned across the warp: row b's
  // pairs start after those of rows row0 .. row0 + b - 1
  const int cnt_lane = row0 + lane < cap_k ? row_nnz[row0 + lane] : 0;
  int incl = cnt_lane;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  const int cnt = __shfl_sync(kFull, cnt_lane, b);
  const int first = tiles[c] + __shfl_sync(kFull, incl, b) - cnt;
  const int r = row0 + b;
  const int g = r < cap_k ? rowblk[r] : -1;
  // a warp of padding rows has nothing to write (warp-uniform; no CTA
  // barrier follows)
  if (!__any_sync(kFull, g >= 0)) return;
  int4* a = slot[0][b];
  a[l] = make_int4(0, 0, 0, 0);
  __syncwarp();
  int16_t* coef = reinterpret_cast<int16_t*>(a);
  for (int k = l; k < cnt; k += 8) {
    const int p = first + k;
    if (p < cap_pairs) {
      const int pos = pair_pos[p];
      if (pos < 64) coef[pos] = pair_val[p];
    }
  }
  __syncwarp();
  const int4 row = mp2v_idct::idct8x8_row(a, slot[1][b], l);
  if (g >= 0) out[(long long)g * 8 + l] = row;
}

// Launch 3, a zero CTA: blocks z * 256 .. z * 256 + 255 of the grid, a warp
// 4 blocks (512 contiguous bytes) a pass; zeros where no row points, stored
// evict-first (st.global.cs): the grid is twice the L2, and the coded rows,
// which the MC kernels read next, are the bytes worth keeping there.
__device__ __forceinline__ void zero_blocks(
    int z, const int* __restrict__ rowblk, const int* __restrict__ blkrow,
    int cap_k, int span, int4* __restrict__ out) {
  constexpr int kPasses = kZeroBlocks / kRowsPerCta;
  const int l = threadIdx.x & 7;
  const long long g0 = (long long)z * kZeroBlocks + (threadIdx.x >> 3);
  int r[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const long long g = g0 + p * kRowsPerCta;
    r[p] = g < span ? blkrow[g] : -1;
  }
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const long long g = g0 + p * kRowsPerCta;
    if (g >= span) continue;
    const bool coded = (unsigned)r[p] < (unsigned)cap_k && rowblk[r[p]] == g;
    if (!coded) __stcs(&out[g * 8 + l], make_int4(0, 0, 0, 0));
  }
}

// Launch 3: n_ctas = n_rows_ctas + n_zero_ctas CTAs of kThreads, CTA i a
// transform CTA iff floor((i + 1) * n_rows_ctas / n_ctas) exceeds
// c = floor(i * n_rows_ctas / n_ctas), which is then its tile; else zero CTA
// i - c.  Both kinds are spread evenly over the launch.
__global__ void __launch_bounds__(kThreads) transport_kernel(
    const uint8_t* __restrict__ pair_pos, const int16_t* __restrict__ pair_val,
    const uint8_t* __restrict__ row_nnz, const int* __restrict__ rowblk,
    const int* __restrict__ blkrow, const int* __restrict__ tiles,
    int cap_pairs, int cap_k, int span, int n_rows_ctas, int n_ctas,
    int4* __restrict__ out) {
  // a transform CTA's two slots a row (csrc/idct.cu's layout)
  __shared__ int4 slot[2][kRowsPerCta][9];
  const long long i = blockIdx.x;
  const int c = (int)(i * n_rows_ctas / n_ctas);
  if ((int)((i + 1) * n_rows_ctas / n_ctas) > c)
    transform_rows(c, pair_pos, pair_val, row_nnz, rowblk, tiles, cap_pairs,
                   cap_k, out, slot);
  else
    zero_blocks((int)i - c, rowblk, blkrow, cap_k, span, out);
}

}  // namespace

// The chunk transport on `stream`: three launches, each checked.  scratch:
// int32 [cap_k + span + ceil(cap_k / 32)] (rowblk, blkrow, tiles), its
// contents ignored; out: (span, 64) int16, 16-byte aligned.
extern "C" int mp2v_transport(const void* pair_pos, const void* pair_val,
                              const void* row_nnz, const void* scat,
                              const void* pic_k, int cap_pairs, int cap_k,
                              int chunk, int n_rows, int scat_u16,
                              void* scratch, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int span = chunk * n_rows;
  const int n_tiles = (cap_k + kTile - 1) / kTile;
  int* rowblk = (int*)scratch;
  int* blkrow = rowblk + cap_k;
  int* tiles = blkrow + span;
  if (span <= 0 || cap_k <= 0) return (int)cudaErrorInvalidValue;
  const int grid1 = (cap_k + kThreads - 1) / kThreads;
  if (scat_u16)
    transport_index_kernel<true><<<grid1, kThreads, chunk * sizeof(int), s>>>(
        (const uint8_t*)row_nnz, scat, (const int*)pic_k, cap_k, chunk,
        n_rows, span, rowblk, blkrow, tiles);
  else
    transport_index_kernel<false><<<grid1, kThreads, 0, s>>>(
        (const uint8_t*)row_nnz, scat, (const int*)pic_k, cap_k, chunk,
        n_rows, span, rowblk, blkrow, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  transport_scan_kernel<<<1, kScanThreads, 0, s>>>(tiles, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_zero = (span + kZeroBlocks - 1) / kZeroBlocks;
  const int n_ctas = n_tiles + n_zero;
  transport_kernel<<<n_ctas, kThreads, 0, s>>>(
      (const uint8_t*)pair_pos, (const int16_t*)pair_val,
      (const uint8_t*)row_nnz, rowblk, blkrow, tiles, cap_pairs, cap_k, span,
      n_tiles, n_ctas, (int4*)out);
  return (int)cudaGetLastError();
}
