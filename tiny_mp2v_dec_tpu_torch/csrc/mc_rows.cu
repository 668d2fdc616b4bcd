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
// rotating them in registers (Mosaic rules).  Here H and W are arguments and
// the MBs run in parallel.
//
// What bounds them on an H100: bytes, under a launch floor.  At 1080p the
// windows need about 1.4 MB of the padded plane and the output is 2 MB;
// the arithmetic is a few integer operations per 4-pixel word.
//
// Design: one kernel template for both layouts (mc_row_warp_kernel), one
// warp per MB, 8 MBs per 256-thread block, K5's lanes: lane = 2 * ty + seg
// holds the 8-pixel segment seg of tile row ty.  The MB's start and phase
// are loaded by every lane from one address each, so the phase is uniform
// and nothing diverges.  Both read the plane as 16-byte quads, so its rows
// must be whole quads and its pointer 16-byte aligned (K9: Wp % 16 == 0;
// K10: nw % 4 == 0); the entry points refuse other planes, as the wrappers
// do on every device.  K9's (H, W) bytes and K10's (H, W/4) words out are
// the same bytes in memory.  Above the launch, the time tracks the L1
// wavefronts, one per cache line a warp instruction touches (read from the
// designs' times in PERF.md; no profiler counters on the card's host), and
// each row of a window or of an MB is a line of its own.  So fewer
// instructions touch those rows:
//   - loads: each lane makes one 16-byte load (its row's quad (sx >> 4) +
//     seg; the pair swaps two words), so a window costs one load
//     instruction, two under a vertical phase.  K5's scheme (roll_pred,
//     csrc/mc_roll.cu: every aligned window word loaded by one lane, 3-5
//     load instructions) read slower here in 10 of 10 pairs;
//   - stores: the block's 8 MBs go through 2 KB of shared memory, and a
//     warp's store writes two 128-byte rows of 8 neighbouring MBs, where
//     one MB's 16 rows of 16 bytes (half sectors) took 16 lines.
#include <cuda_runtime.h>
#include <stdint.h>

#include "swar_word.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // MBs per block
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

__device__ __forceinline__ int clamp_to(long long v, int hi) {
  return (int)min(max(v, 0LL), (long long)hi);
}

// The three window words (w0, w1, w2) of the lane's segment seg, whose quad
// v is quad q + seg of its row (q = sx >> 4, the quad of the window's first
// word): the pair swaps two words, and both pick three from offset
// r = (sx >> 2) & 3, uniform across the warp.  Segment 0 sees words q*4 + 0
// .. + 5 (its quad, then its partner's words 0-1), segment 1 words q*4 + 2
// .. + 7 (its partner's words 2-3, then its quad).  Every lane of the warp
// calls it together.
__device__ __forceinline__ void pick3(uint4 v, int seg, int r, uint32_t& w0,
                                      uint32_t& w1, uint32_t& w2) {
  const uint32_t o0 = __shfl_xor_sync(kFullWarp, seg ? v.x : v.z, 1);
  const uint32_t o1 = __shfl_xor_sync(kFullWarp, seg ? v.y : v.w, 1);
  const uint32_t a0 = seg ? o0 : v.x, a1 = seg ? o1 : v.y;
  const uint32_t a2 = seg ? v.x : v.z, a3 = seg ? v.y : v.w;
  const uint32_t a4 = seg ? v.z : o0, a5 = seg ? v.w : o1;
  switch (r) {
    case 0: w0 = a0; w1 = a1; w2 = a2; break;
    case 1: w0 = a1; w1 = a2; w2 = a3; break;
    case 2: w0 = a2; w1 = a3; w2 = a4; break;
    default: w0 = a3; w1 = a4; w2 = a5;
  }
}

// One direction's prediction of lane's segment (two words) of the 16x16
// tile whose window starts at (sy, sx) with phase ph, all uniform across
// the warp, from one 16-byte load per lane: the (Hp, nq) quad plane, whose
// every window quad lies in the plane (nq > W / 16, Hp > H).  The row below
// comes from lane + 2; the lanes of tile row 15 load row sy + 16 in a
// second load.  Every lane of the warp calls it together.
__device__ __forceinline__ uint2 quad_pred(const uint4* __restrict__ ref,
                                           int sy, int sx, int ph, int lane,
                                           int nq) {
  const int ty = lane >> 1, seg = lane & 1;
  const int r = (sx >> 2) & 3;
  const long long at = (long long)(sy + ty) * nq + (sx >> 4) + seg;
  const unsigned s = (unsigned)(sx & 3) << 3;
  uint32_t w0, w1, w2;
  pick3(ref[at], seg, r, w0, w1, w2);
  uint2 p = mp2v::tap_row2(w0, w1, w2, s, ph);
  if (ph & 2) {
    uint32_t v0 = __shfl_down_sync(kFullWarp, w0, 2);
    uint32_t v1 = __shfl_down_sync(kFullWarp, w1, 2);
    uint32_t v2 = __shfl_down_sync(kFullWarp, w2, 2);
    uint4 below = make_uint4(0u, 0u, 0u, 0u);
    if (ty == 15) below = ref[at + nq];
    uint32_t e0, e1, e2;
    pick3(below, seg, r, e0, e1, e2);
    if (ty == 15) {
      v0 = e0;
      v1 = e1;
      v2 = e2;
    }
    const uint2 q = mp2v::tap_row2(v0, v1, v2, s, ph);
    p = make_uint2(__vavgu4(p.x, q.x), __vavgu4(p.y, q.y));
  }
  return p;
}

// One warp per MB of the (H, W) output, one 8-pixel row segment per lane,
// from the (Hp, nq) quad plane (quad_pred); the start column is sx, or
// 4 * sx + rb when PACKED (4 * sxq can overflow an int: the clamp is in 64
// bits).  The block's 8 MBs go through shared memory, so that its stores
// cover whole rows of neighbouring MBs: slot [c][ty ^ c] holds segment
// c % 2 of tile row ty of the block's MB c / 2 (the XOR keeps both the
// warps' writes and the rows' reads free of bank conflicts).
template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
    mc_row_warp_kernel(const uint4* __restrict__ plane, int nq,
                       const int32_t* __restrict__ sy,
                       const int32_t* __restrict__ sx,
                       const int32_t* __restrict__ rb,
                       const int32_t* __restrict__ ph,
                       uint8_t* __restrict__ out, int H, int W) {
  __shared__ uint2 seg_of[2 * kWarps][16];
  const int mbw = W >> 4, n_mb = mbw * (H >> 4);
  const int i0 = blockIdx.x * kWarps, lane = threadIdx.x & 31;
  const int i = i0 + (threadIdx.x >> 5);
  if (i < n_mb) {  // whole warps
    const long long x = PACKED ? 4LL * sx[i] + rb[i] : (long long)sx[i];
    const int y0 = clamp_to(sy[i], H - 16), x0 = clamp_to(x, W - 16);
    const uint2 p = quad_pred(plane, y0, x0, ph[i], lane, nq);
    const int c = 2 * (threadIdx.x >> 5) + (lane & 1), ty = lane >> 1;
    seg_of[c][ty ^ c] = p;
  }
  __syncthreads();
  const int ty = threadIdx.x >> 4, c = threadIdx.x & 15;
  const int j = i0 + (c >> 1);
  if (j < n_mb) {
    uint8_t* at = out + (long long)((j / mbw) * 16 + ty) * W +
                  (j % mbw) * 16 + (c & 1) * 8;
    *reinterpret_cast<uint2*>(at) = seg_of[c][ty ^ c];
  }
}

template <bool PACKED>
int launch(const void* plane, int nq, const void* sy, const void* sx,
           const void* rb, const void* ph, void* out, int H, int W,
           void* stream) {
  const long long n_mb = (long long)(H / 16) * (W / 16);
  const int blocks = (int)((n_mb + kWarps - 1) / kWarps);
  mc_row_warp_kernel<PACKED><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)plane, nq, (const int32_t*)sy, (const int32_t*)sx,
      (const int32_t*)rb, (const int32_t*)ph, (uint8_t*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// K9.  plane: (Hp, Wp) uint8, 16-byte aligned, zero beyond the (H, W)
// picture, Hp > H, Wp > W, Wp % 16 == 0; sy, sx, ph: (H/16 * W/16) int32;
// out: (H, W) uint8.
extern "C" int mp2v_mc_row(const void* plane, int Hp, int Wp,
                           const void* sy, const void* sx, const void* ph,
                           void* out, int H, int W, void* stream) {
  if (H < 16 || W < 16 || H % 16 || W % 16 || Hp <= H || Wp <= W ||
      Wp % 16 || (uintptr_t)plane % 16)
    return (int)cudaErrorInvalidValue;
  return launch<false>(plane, Wp / 16, sy, sx, nullptr, ph, out, H, W,
                       stream);
}

// K10.  plane: (Hp, nw) words, 16-byte aligned, zero beyond the picture,
// Hp > H, nw > W / 4, nw % 4 == 0; sy, sxq, rb, ph: (H/16 * W/16) int32;
// out: (H, W/4) words.
extern "C" int mp2v_mc_row_packed(const void* plane, int Hp, int nw,
                                  const void* sy, const void* sxq,
                                  const void* rb, const void* ph, void* out,
                                  int H, int W, void* stream) {
  if (H < 16 || W < 16 || H % 16 || W % 16 || Hp <= H || nw <= W / 4 ||
      nw % 4 || (uintptr_t)plane % 16)
    return (int)cudaErrorInvalidValue;
  return launch<true>(plane, nw / 4, sy, sxq, rb, ph, out, H, W, stream);
}
