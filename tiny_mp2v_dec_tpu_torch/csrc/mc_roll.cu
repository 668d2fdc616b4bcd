// K5 / K6: fused motion compensation + residual add + saturation through
// an aligned window rotated into place (MP2V_MC_IMPL=roll).
//
// Replaces (bidir and forward-only forms, frame prediction only):
//   K5  tiny_mp2v_dec_tpu/ops/mc_pallas.py fused_mc_recon
//       (_make_kernel + _gather_pred; pallas_call at :156), luma 16x16;
//   K6  tiny_mp2v_dec_tpu/ops/mc_pallas.py fused_mc_recon_uv
//       (_make_kernel_uv + _gather_pred_uv; pallas_call at :275), U and V,
//       at the chroma tile of every format: 8x8, 16x8 and 16x16.
//
// Same function as K2/K3 (csrc/mc_recon.cu): per MB, the forward and
// backward half-pel predictions at the clamped window starts (sy, sx) with
// MPEG-2 rounding, selected by the 2-bit phase; mode bit 1 = forward,
// 2 = backward (bidir form only), both = (pf+pb+1)>>1; + int16 residual,
// clip to [0, 255], 0 for an MB whose mode bit 4 (coded) is clear.
//
// The TPU kernel loads an aligned window of the VMEM-resident reference
// once and rotates the misalignment away in registers (pltpu.roll), then
// takes all four taps from the rotated copy.  Both Hopper forms keep that
// idea: each aligned 32-bit word of a direction's (h+1)-row window, from the
// word column sx >> 2, is loaded from global memory once per MB.  Words at
// or past Wr / 4 and rows at or past Hr read 0, the zero pad of pad_for_mc.
// A direction the MB does not use, and every direction of an uncoded MB, is
// not read.
//
// K5 (mc_roll_luma_kernel): the register rotation is a funnel shift within
// a lane and a warp shuffle across lanes.  One warp per luma MB, 8 MBs per
// 256-thread block; lane = 2 * ty + seg holds the 8-pixel segment seg of
// tile row ty, and the MB's mode, window start and phase are uniform across
// the warp.  Of the five window words of row sy + ty, the lane of segment 0
// loads words 0-2 and the lane of segment 1 words 3-4, and takes word 2
// from its neighbour (__shfl_xor_sync).  Under a vertical half-pel phase the
// row below comes from lane + 2 (three __shfl_down_sync); only the two lanes
// of tile row 15 load row sy + 16 themselves, and lane 31 hands its word 2
// to lane 30 in the same exchange that brings it row 15's.  So a direction
// costs a lane at most 3 loads (5 on the lanes of row 15) and the warp 85,
// where K2's three words per tap row make up to 6 per lane and 192 per warp
// (its repeats hit L1).  The shuffles run with the warp converged: whether
// a direction is used and its phase are uniform, and the loads that differ
// by lane sit outside them.  Then the taps of tap_row2 (funnel shifts and
// __vavgu4, csrc/swar_word.cuh), the packed bidir average, the residual as
// one 16-byte load, add_clip4 and one 8-byte store, as K2; an uncoded MB
// reads nothing and stores zeros.
//
// K6 (mc_roll_kernel): one thread block per MB, U and V as the two z-slices,
// stages each direction's window into shared memory with 32-bit loads,
// neighbouring threads on neighbouring words; after __syncthreads() each
// thread reads its four taps from shared memory at byte offset sx & 3.
//
// What bounds them on an H100: bytes, under a launch floor, as K2/K3: an MB
// reads at most 2 x (h+1) x ceil((w+4)/4) words of reference and h x w
// residual pixels, and writes h x w bytes; the work per pixel is a few
// integer operations.  K6 pays a block-wide barrier and byte-wide taps, a
// byte-wide store and an int16 load per pixel on top.  No wgmma, TMA or
// asynchronous bulk copy: the tiles are a few hundred bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_ptrs.cuh"
#include "swar_word.cuh"

namespace {

using mp2v::DirMeta;
using mp2v::Planes;

// words of one staged window row: w + 1 pixels from a byte offset <= 3
template <int TW>
__host__ __device__ constexpr int win_words() {
  return (TW + 3) / 4 + 1;
}

// One pixel of a unidirectional prediction from a staged window: the tap
// a sits at row ty, byte x of the window.
template <int TW>
__device__ __forceinline__ int halfpel_staged(const uint32_t* win, int ty,
                                              int x, int ph) {
  constexpr int RB = 4 * win_words<TW>();  // bytes per staged row
  const uint8_t* px = reinterpret_cast<const uint8_t*>(win) + ty * RB + x;
  const int a = px[0];
  switch (ph & 3) {
    case 0:
      return a;
    case 1:
      return (a + px[1] + 1) >> 1;
    case 2:
      return (a + px[RB] + 1) >> 1;
    default: {
      const int ab = (a + px[1] + 1) >> 1;
      const int cd = (px[RB] + px[RB + 1] + 1) >> 1;
      return (ab + cd + 1) >> 1;
    }
  }
}

// Stage one direction's window of MB i: (TH + 1) rows of win_words words
// from word column sx >> 2, by the NT threads of this plane's slice.
template <int TH, int TW, int NT>
__device__ __forceinline__ void stage(uint32_t* win,
                                      const uint8_t* __restrict__ ref,
                                      int sy, int sx, int t, int Hr, int Wr) {
  constexpr int WW = win_words<TW>();
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(ref);
  const int nw = Wr >> 2, x0 = sx >> 2;
  for (int k = t; k < (TH + 1) * WW; k += NT) {
    const int y = sy + k / WW, x = x0 + k % WW;
    win[k] = (y < Hr && x < nw) ? rw[(long long)y * nw + x] : 0u;
  }
}

// K6: blockDim = (TW, TH, NP); blockIdx.x = macroblock (row-major).
template <int TH, int TW, int NP, bool BIDIR>
__global__ void mc_roll_kernel(Planes p, DirMeta fm, DirMeta bm,
                               const int32_t* __restrict__ modes, int mbw,
                               int Hr, int Wr) {
  constexpr int N = (TH + 1) * win_words<TW>();
  __shared__ uint32_t win[NP][2][N];
  const int i = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y, pl = threadIdx.z;
  const int mode = modes[i];
  const bool coded = (mode & 4) != 0;
  const bool f = coded && (mode & 1) != 0;
  const bool b = coded && BIDIR && (mode & 2) != 0;
  const int t = ty * TW + tx;
  const int sxf = fm.sx[i], sxb = bm.sx[i];
  if (f)
    stage<TH, TW, TH * TW>(win[pl][0], pl ? p.ref0[1] : p.ref0[0], fm.sy[i],
                           sxf, t, Hr, Wr);
  if (b)
    stage<TH, TW, TH * TW>(win[pl][1], pl ? p.ref1[1] : p.ref1[0], bm.sy[i],
                           sxb, t, Hr, Wr);
  __syncthreads();
  const int W = mbw * TW;
  const long long o =
      (long long)((i / mbw) * TH + ty) * W + (i % mbw) * TW + tx;
  int val = 0;
  if (coded) {
    const int pf = f ? halfpel_staged<TW>(win[pl][0], ty, tx + (sxf & 3),
                                          fm.ph[i])
                     : 0;
    const int pb = b ? halfpel_staged<TW>(win[pl][1], ty, tx + (sxb & 3),
                                          bm.ph[i])
                     : 0;
    const int pred = (f && b) ? (pf + pb + 1) >> 1 : (f ? pf : pb);
    val = min(max(pred + (int)(pl ? p.res[1] : p.res[0])[o], 0), 255);
  }
  (pl ? p.out[1] : p.out[0])[o] = (uint8_t)val;
}

template <int TH, int TW, int NP>
int launch(const void* const* ptrs, int n_mb, int mbw, int Hr, int Wr,
           int bidir, void* stream) {
  const Planes p = mp2v::planes_of(ptrs);
  const DirMeta fm = mp2v::dir_meta(ptrs, 0), bm = mp2v::dir_meta(ptrs, 1);
  const int32_t* modes = mp2v::modes_of(ptrs);
  if (n_mb > 0) {
    const dim3 block(TW, TH, NP);
    cudaStream_t s = (cudaStream_t)stream;
    if (bidir)
      mc_roll_kernel<TH, TW, NP, true>
          <<<n_mb, block, 0, s>>>(p, fm, bm, modes, mbw, Hr, Wr);
    else
      mc_roll_kernel<TH, TW, NP, false>
          <<<n_mb, block, 0, s>>>(p, fm, bm, modes, mbw, Hr, Wr);
  }
  return (int)cudaGetLastError();
}

constexpr int kThreads = 256;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// One direction's prediction of lane's segment (two words) of the luma MB
// whose window starts at (sy, sx) with phase ph, all uniform across the
// warp; every lane of the warp calls it together (see the note at the top).
__device__ __forceinline__ uint2 roll_pred(const uint32_t* __restrict__ ref,
                                           int sy, int sx, int ph, int lane,
                                           int Hr, int nw) {
  const int ty = lane >> 1, seg = lane & 1;
  const int y = sy + ty, x = (sx >> 2) + 3 * seg;
  const unsigned s = (unsigned)(sx & 3) << 3;
  const bool vert = (ph & 2) != 0;
  const uint32_t a = mp2v::word_at(ref, Hr, nw, y, x);
  const uint32_t b = mp2v::word_at(ref, Hr, nw, y, x + 1);
  // word 2 of this row on segment 0; on lane 31 word 2 of row sy + 16
  uint32_t c = 0u;
  if (!seg)
    c = mp2v::word_at(ref, Hr, nw, y, x + 2);
  else if (vert && lane == 31)
    c = mp2v::word_at(ref, Hr, nw, y + 1, x - 1);
  const uint32_t o = __shfl_xor_sync(kFullWarp, c, 1);
  const uint32_t w0 = seg ? o : a, w1 = seg ? a : b, w2 = seg ? b : c;
  uint2 p = mp2v::tap_row2(w0, w1, w2, s, ph);
  if (vert) {
    uint32_t v0 = __shfl_down_sync(kFullWarp, w0, 2);
    uint32_t v1 = __shfl_down_sync(kFullWarp, w1, 2);
    uint32_t v2 = __shfl_down_sync(kFullWarp, w2, 2);
    if (ty == 15) {
      const uint32_t e = mp2v::word_at(ref, Hr, nw, y + 1, x);
      const uint32_t f = mp2v::word_at(ref, Hr, nw, y + 1, x + 1);
      v0 = seg ? c : e;
      v1 = seg ? e : f;
      v2 = seg ? f : o;
    }
    const uint2 q = mp2v::tap_row2(v0, v1, v2, s, ph);
    p = make_uint2(__vavgu4(p.x, q.x), __vavgu4(p.y, q.y));
  }
  return p;
}

// K5: one warp per luma MB (16x16), one 8-pixel row segment per lane.
template <bool BIDIR>
__global__ void __launch_bounds__(kThreads)
    mc_roll_luma_kernel(const uint32_t* __restrict__ ref0,
                        const uint32_t* __restrict__ ref1,
                        const int16_t* __restrict__ res,
                        uint8_t* __restrict__ out, DirMeta fm, DirMeta bm,
                        const int32_t* __restrict__ modes, int n_mb, int mbw,
                        int Hr, int nw) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int i = t >> 5, lane = t & 31;
  if (i >= n_mb) return;
  const long long o = (long long)((i / mbw) * 16 + (lane >> 1)) * (mbw * 16) +
                      (i % mbw) * 16 + (lane & 1) * 8;
  const int mode = modes[i];
  if (!(mode & 4)) {
    *reinterpret_cast<uint2*>(out + o) = make_uint2(0u, 0u);
    return;
  }
  const int4 r = *reinterpret_cast<const int4*>(res + o);
  const bool f = (mode & 1) != 0;
  const bool b = BIDIR && (mode & 2) != 0;
  uint2 pred = make_uint2(0u, 0u);
  if (f) pred = roll_pred(ref0, fm.sy[i], fm.sx[i], fm.ph[i], lane, Hr, nw);
  if (b) {
    const uint2 pb =
        roll_pred(ref1, bm.sy[i], bm.sx[i], bm.ph[i], lane, Hr, nw);
    pred = f ? make_uint2(__vavgu4(pred.x, pb.x), __vavgu4(pred.y, pb.y))
             : pb;
  }
  pred = make_uint2(mp2v::add_clip4(pred.x, r.x, r.y),
                    mp2v::add_clip4(pred.y, r.z, r.w));
  *reinterpret_cast<uint2*>(out + o) = pred;
}

int launch_luma(const void* const* ptrs, int n_mb, int mbw, int Hr, int Wr,
                int bidir, void* stream) {
  if (n_mb > 0) {
    const Planes p = mp2v::planes_of(ptrs);
    const DirMeta fm = mp2v::dir_meta(ptrs, 0), bm = mp2v::dir_meta(ptrs, 1);
    const int32_t* modes = mp2v::modes_of(ptrs);
    const uint32_t* ref0 = (const uint32_t*)p.ref0[0];
    const uint32_t* ref1 = (const uint32_t*)p.ref1[0];
    const int blocks = (int)(((long long)n_mb * 32 + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (bidir)
      mc_roll_luma_kernel<true><<<blocks, kThreads, 0, s>>>(
          ref0, ref1, p.res[0], p.out[0], fm, bm, modes, n_mb, mbw, Hr,
          Wr >> 2);
    else
      mc_roll_luma_kernel<false><<<blocks, kThreads, 0, s>>>(
          ref0, ref1, p.res[0], p.out[0], fm, bm, modes, n_mb, mbw, Hr,
          Wr >> 2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K5: luma, 16x16 tiles only.  Any other tile is refused before a launch.
extern "C" int mp2v_mc_roll_luma(MP2V_MC_ARGS) {
  if (th == 16 && tw == 16)
    return launch_luma(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  return (int)cudaErrorInvalidValue;
}

// K6: U and V, at the chroma tile of each format.
extern "C" int mp2v_mc_roll_uv(MP2V_MC_ARGS) {
  if (th == 8 && tw == 8)
    return launch<8, 8, 2>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 16 && tw == 8)
    return launch<16, 8, 2>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 16 && tw == 16)
    return launch<16, 16, 2>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  return (int)cudaErrorInvalidValue;
}
