// K7: packed motion-compensated frame prediction, four pixels per 32-bit
// word (MP2V_MC_IMPL=swar).
//
// Replaces (bidir and forward-only forms):
//   K7  tiny_mp2v_dec_tpu/ops/mc_pallas.py fused_mc_pred_swar
//       (_make_kernel_swar + _gather_pred_swar, _avg_up; pallas_call at
//       :794), frame prediction.
// Two entry points: mp2v_mc_swar_yuv, the three components of one picture
// in one launch (luma 16x16 with the luma vectors; U and V at the chroma
// tile 8x8, 16x8 or 16x16, sharing the chroma vectors; one mode vector for
// all three), which is what the decode path calls; and mp2v_mc_swar, one
// component per call (luma 16x16, or one chroma plane at its tile), the
// shape of the JAX kernel.  The field form K8 (fused_mc_pred_swar_field) is
// a form of the segment kernel of csrc/mc_recon.cu.
//
// Output word (y, wx) of an (H, W/4) plane holds pixels 4wx .. 4wx+3, the
// first at the least significant byte: the funnel-shift taps and per-byte
// averages of csrc/swar_word.cuh, with c and d from the row below.  The
// bidir average stays packed too (__vavgu4).
// Mode bit 1 = forward, 2 = backward (bidir form only); neither gives 0.
// No residual and no coded bit: the caller adds the residual and masks
// uncoded MBs (ops/recon.py), as the JAX package's XLA epilogue does.
//
// Reference planes are read unpadded as (Hr, Wr/4) words: a word at or
// past Wr/4, or a row at or past Hr, reads 0 (the zero pad of
// pad_ref_words).  JAX's 512-pixel load granules were a Mosaic rule.
//
// What bounds it on an H100: bytes, under a launch floor.  A 1080p 4:2:0
// picture is 3.1 MB of words out and, per direction a mode uses, one window
// of up to 17x17 (luma) or 9x9 (chroma) reference bytes per MB: with modes
// drawn evenly about 6 MB, 1.8 us at 3.35 TB/s (chip_smoke.py's bound),
// while a launch of one MB costs 3 us on an H100 80GB HBM3 at 700 W.  A
// chroma plane's whole bound is a ninth of its launch, so a launch per
// component paid the floor three times a picture; the picture form pays it
// once.  A tile is a few hundred bytes and the arithmetic integer averages:
// TMA, wgmma and asynchronous bulk copies have nothing to do here.
//
// Design of the picture form: one thread per 8-pixel row segment, grouped
// as the segment kernel of csrc/mc_recon.cu groups them: a luma MB is one
// warp (its mode, phases and window starts uniform across it), 8 MBs per
// 256-thread block; 8-wide chroma tiles pair neighbouring MBs so that a
// warp's output rows fill 32-byte sectors; U and V of an MB sit in one group
// and load the chroma vectors once for both planes.  A segment's two words
// come from three aligned 32-bit loads per tap row (halfpel_word2) and go
// back in one 8-byte store.  One grid: the first blocks take luma, the rest
// U and V, so the branch between them is uniform per block.
//
// The one-component form keeps one thread per 4-pixel word on a 2-D grid
// over the word plane (two aligned words per tap row, neighbouring threads
// on neighbouring words).  The segment form of one component measured lower
// on bidir luma only (H100 80GB HBM3, 700 W; PERF.md): no lower on an 8x8
// plane and higher forward-only at both, so the word form stays.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_ptrs.cuh"
#include "swar_word.cuh"

namespace {

using mp2v::DirMeta;
using mp2v::FrameMeta;
using mp2v::halfpel_word;
using mp2v::mbs_per_group;
using mp2v::YuvPlanes;

// ---- the one-component form: one thread per output word ----

// One thread per output word; 2-D grid over the (H, W/4) word plane.
template <int TH, int TW, bool BIDIR>
__global__ void mc_swar_kernel(const uint32_t* __restrict__ ref0,
                               const uint32_t* __restrict__ ref1,
                               uint32_t* __restrict__ out, DirMeta fm,
                               DirMeta bm, const int32_t* __restrict__ modes,
                               int mbw, int H, int Hr, int nw) {
  constexpr int WPM = TW / 4;  // words per MB row
  const int wx = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int nout = mbw * WPM;
  if (wx >= nout || y >= H) return;
  const int i = (y / TH) * mbw + wx / WPM;
  const int ty = y % TH, k = wx % WPM;
  const int mode = modes[i];
  const bool f = (mode & 1) != 0;
  const bool b = BIDIR && (mode & 2) != 0;
  const uint32_t pf =
      f ? halfpel_word(ref0, Hr, nw, fm.sy[i] + ty, fm.sx[i], k, fm.ph[i], 1)
        : 0u;
  const uint32_t pb =
      b ? halfpel_word(ref1, Hr, nw, bm.sy[i] + ty, bm.sx[i], k, bm.ph[i], 1)
        : 0u;
  out[(long long)y * nout + wx] = (f && b) ? __vavgu4(pf, pb) : (f ? pf : pb);
}

constexpr int BX = 32, BY = 8;

template <int TH, int TW>
int launch(const void* const* ptrs, int n_mb, int mbw, int Hr, int Wr,
           int bidir, void* stream) {
  const uint32_t* ref0 = (const uint32_t*)ptrs[0];
  const uint32_t* ref1 = (const uint32_t*)ptrs[2];
  uint32_t* out = (uint32_t*)ptrs[6];
  const DirMeta fm = mp2v::dir_meta(ptrs, 0), bm = mp2v::dir_meta(ptrs, 1);
  const int32_t* modes = mp2v::modes_of(ptrs);
  if (n_mb > 0) {
    const int H = (n_mb / mbw) * TH, nout = mbw * (TW / 4);
    const dim3 block(BX, BY);
    const dim3 grid((nout + BX - 1) / BX, (H + BY - 1) / BY);
    cudaStream_t s = (cudaStream_t)stream;
    if (bidir)
      mc_swar_kernel<TH, TW, true><<<grid, block, 0, s>>>(
          ref0, ref1, out, fm, bm, modes, mbw, H, Hr, Wr >> 2);
    else
      mc_swar_kernel<TH, TW, false><<<grid, block, 0, s>>>(
          ref0, ref1, out, fm, bm, modes, mbw, H, Hr, Wr >> 2);
  }
  return (int)cudaGetLastError();
}

// ---- the picture form: one thread per 8-pixel row segment ----

constexpr int kThreads = 256;

// Thread t of a grid over NP planes of (TH x TW) MBs -> its MB i, plane
// pl, tile row ty and segment seg, in the segment kernel's order
// (plane-major within a group of mbs_per_group(TW) MBs).  False past the
// last MB.
template <int TH, int TW, int NP>
__device__ __forceinline__ bool seg_of(int t, int n_mb, int& i, int& pl,
                                       int& ty, int& seg) {
  constexpr int SEGS = TW / 8;       // segments per tile row
  constexpr int TPP = TH * SEGS;     // threads per plane of one MB
  constexpr int G = mbs_per_group(TW);
  constexpr int TPG = TPP * NP * G;  // threads per group
  static_assert(kThreads % TPG == 0, "a group's threads share one block");
  const int r = t % TPG;
  i = (t / TPG) * G + (r / TPP) % G;
  pl = NP == 2 ? r / (TPP * G) : 0;
  ty = (r % TPP) / SEGS;
  seg = r % SEGS;
  return i < n_mb;
}

// Blocks of a grid over NP planes of n_mb (th x tw) MBs.
constexpr int seg_blocks(int th, int tw, int np, int n_mb) {
  const int g = mbs_per_group(tw);
  const long long tpg = th * (tw / 8) * np * g;
  return (int)(((n_mb + g - 1) / g * tpg + kThreads - 1) / kThreads);
}

// Predict segment `seg` of tile row ty of MB i of one (Hr, 4 nw) plane of
// (TH x TW) MBs and store its two words.
template <int TH, int TW, bool BIDIR>
__device__ __forceinline__ void pred_seg(const uint8_t* ref0,
                                         const uint8_t* ref1, uint8_t* out,
                                         const FrameMeta& fm,
                                         const FrameMeta& bm, int mode, int i,
                                         int ty, int seg, int mbw, int Hr,
                                         int nw) {
  const bool f = (mode & 1) != 0;
  const bool b = BIDIR && (mode & 2) != 0;
  uint2 pred = make_uint2(0u, 0u);
  if (f)
    pred = mp2v::halfpel_word2((const uint32_t*)ref0, Hr, nw, fm.sy[i] + ty,
                               fm.sx[i], 2 * seg, fm.ph[i], 1);
  if (b) {
    const uint2 pb =
        mp2v::halfpel_word2((const uint32_t*)ref1, Hr, nw, bm.sy[i] + ty,
                            bm.sx[i], 2 * seg, bm.ph[i], 1);
    pred = f ? make_uint2(__vavgu4(pred.x, pb.x), __vavgu4(pred.y, pb.y))
             : pb;
  }
  const long long o = (long long)((i / mbw) * TH + ty) * (mbw * TW) +
                      (i % mbw) * TW + seg * 8;
  *reinterpret_cast<uint2*>(out + o) = pred;
}

// One picture: blocks below luma_blocks take luma (16x16), the others U and
// V at the (TH x TW) chroma tile.  (Hr, 4 nw) is the luma reference; a
// chroma plane is (Hr / 16 * TH, nw / 4 * TW).  The planes are picked by
// selects, not by a run-time index into the parameter arrays, which would
// copy them to local memory.
template <int TH, int TW, bool BIDIR>
__global__ void __launch_bounds__(kThreads)
    mc_swar_yuv_kernel(YuvPlanes p, FrameMeta lf, FrameMeta lb, FrameMeta cf,
                       FrameMeta cb, const int32_t* __restrict__ modes,
                       int n_mb, int mbw, int Hr, int nw, int luma_blocks) {
  int i, pl, ty, seg;
  if ((int)blockIdx.x < luma_blocks) {
    if (!seg_of<16, 16, 1>(blockIdx.x * kThreads + threadIdx.x, n_mb, i, pl,
                           ty, seg))
      return;
    pred_seg<16, 16, BIDIR>(p.ref0[0], p.ref1[0], p.out[0], lf, lb, modes[i],
                            i, ty, seg, mbw, Hr, nw);
  } else {
    if (!seg_of<TH, TW, 2>((blockIdx.x - luma_blocks) * kThreads +
                               threadIdx.x,
                           n_mb, i, pl, ty, seg))
      return;
    pred_seg<TH, TW, BIDIR>(pl ? p.ref0[2] : p.ref0[1],
                            pl ? p.ref1[2] : p.ref1[1],
                            pl ? p.out[2] : p.out[1], cf, cb, modes[i], i, ty,
                            seg, mbw, Hr / 16 * TH, nw / 4 * (TW / 4));
  }
}

// Pointer order: the picture form's, csrc/mc_ptrs.cuh.
template <int TH, int TW>
int launch_yuv(const void* const* ptrs, int n_mb, int mbw, int Hr, int Wr,
               int bidir, void* stream) {
  if (n_mb > 0) {
    const YuvPlanes p = mp2v::yuv_planes_of(ptrs);
    const FrameMeta lf = mp2v::yuv_meta(ptrs, 0, 0);
    const FrameMeta lb = mp2v::yuv_meta(ptrs, 0, 1);
    const FrameMeta cf = mp2v::yuv_meta(ptrs, 1, 0);
    const FrameMeta cb = mp2v::yuv_meta(ptrs, 1, 1);
    const int32_t* modes = mp2v::yuv_modes_of(ptrs);
    const int luma_blocks = seg_blocks(16, 16, 1, n_mb);
    const int blocks = luma_blocks + seg_blocks(TH, TW, 2, n_mb);
    cudaStream_t s = (cudaStream_t)stream;
    if (bidir)
      mc_swar_yuv_kernel<TH, TW, true><<<blocks, kThreads, 0, s>>>(
          p, lf, lb, cf, cb, modes, n_mb, mbw, Hr, Wr >> 2, luma_blocks);
    else
      mc_swar_yuv_kernel<TH, TW, false><<<blocks, kThreads, 0, s>>>(
          p, lf, lb, cf, cb, modes, n_mb, mbw, Hr, Wr >> 2, luma_blocks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One component at its tile.  Pointer order: csrc/mc_ptrs.cuh; this reads
// ref0[0], ref1[0], out[0] (the word plane) and the per-MB frame vectors.
// Any other tile is refused before a launch.
extern "C" int mp2v_mc_swar(MP2V_MC_ARGS) {
  if (th == 16 && tw == 16)
    return launch<16, 16>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 8 && tw == 8)
    return launch<8, 8>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 16 && tw == 8)
    return launch<16, 8>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  return (int)cudaErrorInvalidValue;
}

// One picture; th x tw is the chroma tile, (Hr, Wr) the luma reference.
extern "C" int mp2v_mc_swar_yuv(MP2V_MC_ARGS) {
  if (Hr % 16 || Wr % 16) return (int)cudaErrorInvalidValue;
  if (th == 8 && tw == 8)
    return launch_yuv<8, 8>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 16 && tw == 8)
    return launch_yuv<16, 8>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 16 && tw == 16)
    return launch_yuv<16, 16>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  return (int)cudaErrorInvalidValue;
}
