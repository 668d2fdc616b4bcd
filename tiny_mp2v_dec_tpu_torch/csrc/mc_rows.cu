// K9 / K10: unidirectional half-pel prediction of a whole luma plane, the
// two Pallas formulations of the JAX package's MC profiling script.
//
// Replaces:
//   K9   tools/profile_mc_variants.py variant_c (_mc_row_kernel; pallas_call
//        at :97): the plane in bytes, out (H, W) uint8;
//   K10  tools/profile_mc_variants.py variant_d (_mc_row_kernel_packed;
//        pallas_call at :215): the plane as 4-pixel words, out (H, W/4)
//        words.
//
// For each of the (H/16) * (W/16) MBs in raster order: the 17x17 window of
// the zero-padded plane at the start (sy, sx), clamped to [0, H-16] x
// [0, W-16] (the +1 tap row and column read the padding), and the phase ph
// (bit 0 horizontal, bit 1 vertical) selecting a, (a+b+1)>>1, (a+c+1)>>1 or
// ((a+b+1)>>1 + (c+d+1)>>1 + 1)>>1, written at the MB's place.  K10 takes
// the start column as sxq = sx >> 2 and rb = sx & 3 and computes the same
// pixels as K9.  The JAX K10 does not: it shifts the word right by the
// int32 rb * 8 (profile_mc_variants.py:190), which makes the shift
// arithmetic and fills the top rb bytes of a word whose top pixel is >= 128
// with ones.  Here every shift is unsigned (__funnelshift_rc).
//
// The JAX kernels fixed the geometry at 1080p through module globals and
// walked one MB row per grid step, loading 128-lane aligned windows and
// rotating them in registers (Mosaic rules).  Here H and W are arguments,
// blocks run in parallel, and each thread reads its taps at their address.
//
// What bounds them on an H100: memory.  At 1080p K9 must read the 2.3 MB
// padded plane and write 2 MB; its taps (up to four per pixel, at MB
// windows the MVs scatter) hit in L1 and L2 after the first read, and the
// arithmetic is a few integer adds per pixel.  K10 moves the same bytes as
// words, from a quarter of the threads.
//
// Design: K9, one thread per output pixel and one block per two MBs of an
// MB row (32 x 16 threads): a warp writes 32 neighbouring bytes of one row.
// K10, one thread per output word (the word helper of csrc/swar_word.cuh,
// shared with K7/K8) and one block per eight MBs (32 x 16 threads).
#include <cuda_runtime.h>
#include <stdint.h>

#include "swar_word.cuh"

namespace {

constexpr int BX = 32, BY = 16;

__device__ __forceinline__ int clamp_to(long long v, int hi) {
  return (int)min(max(v, 0LL), (long long)hi);
}

__global__ void mc_row_kernel(const uint8_t* __restrict__ plane, int Wp,
                              const int32_t* __restrict__ sy,
                              const int32_t* __restrict__ sx,
                              const int32_t* __restrict__ ph,
                              uint8_t* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int i = (y >> 4) * (W >> 4) + (x >> 4);
  const int ty = clamp_to(sy[i], H - 16) + (y & 15);
  const int tx = clamp_to(sx[i], W - 16) + (x & 15);
  const uint8_t* p = plane + (long long)ty * Wp + tx;
  const int a = p[0];
  int v;
  switch (ph[i] & 3) {
    case 0:
      v = a;
      break;
    case 1:
      v = (a + p[1] + 1) >> 1;
      break;
    case 2:
      v = (a + p[Wp] + 1) >> 1;
      break;
    default:
      v = (((a + p[1] + 1) >> 1) + ((p[Wp] + p[Wp + 1] + 1) >> 1) + 1) >> 1;
  }
  out[(long long)y * W + x] = (uint8_t)v;
}

__global__ void mc_row_packed_kernel(const uint32_t* __restrict__ plane,
                                     int Hp, int nw,
                                     const int32_t* __restrict__ sy,
                                     const int32_t* __restrict__ sxq,
                                     const int32_t* __restrict__ rb,
                                     const int32_t* __restrict__ ph,
                                     uint32_t* __restrict__ out, int H,
                                     int W) {
  const int nout = W >> 2;
  const int wx = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (wx >= nout || y >= H) return;
  const int i = (y >> 4) * (W >> 4) + (wx >> 2);
  const int sx = clamp_to(4LL * sxq[i] + rb[i], W - 16);
  const int row = clamp_to(sy[i], H - 16) + (y & 15);
  out[(long long)y * nout + wx] =
      mp2v::halfpel_word(plane, Hp, nw, row, sx, wx & 3, ph[i], 1);
}

}  // namespace

// plane: (Hp, Wp) uint8, zero beyond the (H, W) picture, Hp > H, Wp > W;
// sy, sx, ph: (H/16 * W/16) int32; out: (H, W) uint8.
extern "C" int mp2v_mc_row(const void* plane, int Hp, int Wp,
                           const void* sy, const void* sx, const void* ph,
                           void* out, int H, int W, void* stream) {
  if (H < 16 || W < 16 || H % 16 || W % 16 || Hp <= H || Wp <= W)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY);
  mc_row_kernel<<<grid, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      (const uint8_t*)plane, Wp, (const int32_t*)sy, (const int32_t*)sx,
      (const int32_t*)ph, (uint8_t*)out, H, W);
  return (int)cudaGetLastError();
}

// plane: (Hp, nw) words, zero beyond the picture, Hp > H, nw > W / 4;
// sy, sxq, rb, ph: (H/16 * W/16) int32; out: (H, W/4) words.
extern "C" int mp2v_mc_row_packed(const void* plane, int Hp, int nw,
                                  const void* sy, const void* sxq,
                                  const void* rb, const void* ph, void* out,
                                  int H, int W, void* stream) {
  if (H < 16 || W < 16 || H % 16 || W % 16 || Hp <= H || nw <= W / 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W / 4 + BX - 1) / BX, (H + BY - 1) / BY);
  mc_row_packed_kernel<<<grid, dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)plane, Hp, nw, (const int32_t*)sy,
      (const int32_t*)sxq, (const int32_t*)rb, (const int32_t*)ph,
      (uint32_t*)out, H, W);
  return (int)cudaGetLastError();
}
