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
// takes all four taps from the rotated copy.  Both Hopper kernels keep that
// idea with the card's means: each aligned 32-bit word of a direction's
// (h+1)-row window, from the word column sx >> 2, is loaded from global
// memory by exactly one lane; a lane's neighbours' words arrive by warp
// shuffles and the misalignment goes in funnel shifts within the lane.
// Words at or past Wr / 4 and rows at or past Hr read 0, the zero pad of
// pad_for_mc.  A direction the MB does not use, and every direction of an
// uncoded MB, is not read.  One lane holds one 8-pixel row segment; then
// the taps of tap_row2 (funnel shifts and __vavgu4, csrc/swar_word.cuh),
// the packed bidir average, the residual as one 16-byte load, add_clip4 and
// one 8-byte store, as K2; an uncoded MB's lanes read nothing and store
// zeros.  No shared memory and no barrier.
//
// K5 (mc_roll_luma_kernel, roll_pred): one warp per luma MB, 8 MBs per
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
// by lane sit outside them.
//
// K6 (mc_roll_uv_kernel): U and V of an MB share its mode, window starts
// and phases; the lanes are grouped as mc_seg_kernel groups K3's threads,
// so that a warp's residual rows fill whole 32-byte sectors:
//   16x16  a warp per plane tile, U then V: roll_pred, K5's warp, on the
//          plane's pointer; the MB is two warps of one block.
//   16x8   a warp per plane of two horizontally adjacent MBs, lanes 0-15
//          the first, 16-31 the second, one lane per tile row; U's warp,
//          then V's.
//   8x8    eight lanes per plane tile, U and V of two adjacent MBs in one
//          warp: lanes 0-7 U of the first, 8-15 U of the second, 16-23 and
//          24-31 their V.
// At the 8-wide tiles (roll_pred8) a 9-pixel row from byte offset sx & 3
// spans three words, and each lane loads its own row's three; under a
// vertical phase the row below comes from the lane of the next tile row by
// __shfl_down_sync at the width of the plane tile's lanes, so no lane reads
// another tile's, and only the lane of the last tile row loads row sy + th.
// A direction costs a lane 3 loads (6 on the last row) and a plane tile
// 3 x (th + 1).  The two MBs of an 8-wide warp differ in mode, directions
// and phase: the exchange runs on every lane of the warp, its loads gated by
// the lane's MB, and each lane selects by its own phase afterwards.  A
// direction is skipped when no lane of the warp uses it (__any_sync).
//
// What bounds them on an H100: bytes, under a launch floor, as K2/K3: an MB
// reads at most 2 x (h+1) x ceil((w+4)/4) words of reference and h x w
// residual pixels, and writes h x w bytes; the work per pixel is a few
// integer operations.  No wgmma, TMA or asynchronous bulk copy: the tiles
// are a few hundred bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_ptrs.cuh"
#include "swar_word.cuh"

namespace {

using mp2v::DirMeta;
using mp2v::Planes;

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

// One direction's prediction of the lane's tile row (8 pixels, two words)
// of an 8-wide tile whose window starts at (sy, sx) with phase ph: TH lanes
// per plane tile, the lane of tile row ty being lane ty of its group of TH.
// Every lane of the warp calls it together; `use` (the lane's MB uses the
// direction) gates the loads alone, so the shuffles run on the whole warp
// whatever the two MBs of an 8x8 warp do.
template <int TH>
__device__ __forceinline__ uint2 roll_pred8(const uint32_t* __restrict__ ref,
                                            int sy, int sx, int ph, bool use,
                                            int ty, int Hr, int nw) {
  const int y = sy + ty, x = sx >> 2;
  const unsigned s = (unsigned)(sx & 3) << 3;
  const bool vert = (ph & 2) != 0;
  uint32_t w0 = 0u, w1 = 0u, w2 = 0u;
  if (use) {
    w0 = mp2v::word_at(ref, Hr, nw, y, x);
    w1 = mp2v::word_at(ref, Hr, nw, y, x + 1);
    w2 = mp2v::word_at(ref, Hr, nw, y, x + 2);
  }
  // the row below from the lane of tile row ty + 1; at width TH the last
  // row's lane gets its own words back and loads row sy + TH instead
  uint32_t v0 = __shfl_down_sync(kFullWarp, w0, 1, TH);
  uint32_t v1 = __shfl_down_sync(kFullWarp, w1, 1, TH);
  uint32_t v2 = __shfl_down_sync(kFullWarp, w2, 1, TH);
  if (use && vert && ty == TH - 1) {
    v0 = mp2v::word_at(ref, Hr, nw, y + 1, x);
    v1 = mp2v::word_at(ref, Hr, nw, y + 1, x + 1);
    v2 = mp2v::word_at(ref, Hr, nw, y + 1, x + 2);
  }
  uint2 p = mp2v::tap_row2(w0, w1, w2, s, ph);
  if (vert) {
    const uint2 q = mp2v::tap_row2(v0, v1, v2, s, ph);
    p = make_uint2(__vavgu4(p.x, q.x), __vavgu4(p.y, q.y));
  }
  return p;
}

// One direction's prediction of the lane's segment of MB i in plane `ref`
// (see the note at the top); `use` as for roll_pred8, and at 16x16, where a
// warp holds one MB, the same on every lane.
template <int TH, int TW>
__device__ __forceinline__ uint2 uv_pred(const uint8_t* ref, const DirMeta& d,
                                         int i, bool use, int ty, int lane,
                                         int Hr, int nw) {
  const int sy = use ? d.sy[i] : 0;
  const int sx = use ? d.sx[i] : 0;
  const int ph = use ? d.ph[i] : 0;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(ref);
  if constexpr (TW == 16)
    return roll_pred(w, sy, sx, ph, lane, Hr, nw);
  else
    return roll_pred8<TH>(w, sy, sx, ph, use, ty, Hr, nw);
}

// K6: U and V at the (TH, TW) chroma tile, one 8-pixel row segment per
// lane, grouped as the note at the top says.
template <int TH, int TW, bool BIDIR>
__global__ void __launch_bounds__(kThreads)
    mc_roll_uv_kernel(Planes p, DirMeta fm, DirMeta bm,
                      const int32_t* __restrict__ modes, int n_mb, int mbw,
                      int Hr, int nw) {
  constexpr int SEGS = TW / 8;       // segments per tile row
  constexpr int TPP = TH * SEGS;     // lanes per plane tile
  constexpr int G = mp2v::mbs_per_group(TW);
  constexpr int TPG = TPP * 2 * G;   // lanes per group: one or two warps
  static_assert(TPG % 32 == 0 && kThreads % TPG == 0,
                "a group is whole warps of one block");
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int r = t % TPG;
  const int i0 = (t / TPG) * G;
  if (i0 >= n_mb) return;            // whole warps only
  const int i = i0 + (r / TPP) % G;
  const bool live = i < n_mb;        // the second MB of the last pair
  const int pl = r / (TPP * G);
  const int ty = (r % TPP) / SEGS, seg = r % SEGS;
  const int lane = t & 31;
  const int mode = live ? modes[i] : 0;
  const bool coded = (mode & 4) != 0;
  const bool f = coded && (mode & 1) != 0;
  const bool b = BIDIR && coded && (mode & 2) != 0;
  const long long o = (long long)((i / mbw) * TH + ty) * (mbw * TW) +
                      (i % mbw) * TW + seg * 8;
  int4 res = make_int4(0, 0, 0, 0);
  if (coded)
    res = *reinterpret_cast<const int4*>((pl ? p.res[1] : p.res[0]) + o);
  uint2 pf = make_uint2(0u, 0u), pb = pf;
  if (__any_sync(kFullWarp, f))
    pf = uv_pred<TH, TW>(pl ? p.ref0[1] : p.ref0[0], fm, i, f, ty, lane, Hr,
                         nw);
  if (BIDIR && __any_sync(kFullWarp, b))
    pb = uv_pred<TH, TW>(pl ? p.ref1[1] : p.ref1[0], bm, i, b, ty, lane, Hr,
                         nw);
  uint2 pred = make_uint2(0u, 0u);
  if (f && b)
    pred = make_uint2(__vavgu4(pf.x, pb.x), __vavgu4(pf.y, pb.y));
  else if (f)
    pred = pf;
  else if (b)
    pred = pb;
  if (coded)
    pred = make_uint2(mp2v::add_clip4(pred.x, res.x, res.y),
                      mp2v::add_clip4(pred.y, res.z, res.w));
  if (live)
    *reinterpret_cast<uint2*>((pl ? p.out[1] : p.out[0]) + o) = pred;
}

template <int TH, int TW>
int launch_uv(const void* const* ptrs, int n_mb, int mbw, int Hr, int Wr,
              int bidir, void* stream) {
  if (n_mb > 0) {
    constexpr int G = mp2v::mbs_per_group(TW);
    constexpr long long TPG = TH * (TW / 8) * 2 * G;  // lanes per group
    const long long groups = (n_mb + G - 1) / G;
    const int blocks = (int)((groups * TPG + kThreads - 1) / kThreads);
    const Planes p = mp2v::planes_of(ptrs);
    const DirMeta fm = mp2v::dir_meta(ptrs, 0), bm = mp2v::dir_meta(ptrs, 1);
    const int32_t* modes = mp2v::modes_of(ptrs);
    cudaStream_t s = (cudaStream_t)stream;
    if (bidir)
      mc_roll_uv_kernel<TH, TW, true><<<blocks, kThreads, 0, s>>>(
          p, fm, bm, modes, n_mb, mbw, Hr, Wr >> 2);
    else
      mc_roll_uv_kernel<TH, TW, false><<<blocks, kThreads, 0, s>>>(
          p, fm, bm, modes, n_mb, mbw, Hr, Wr >> 2);
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
    return launch_uv<8, 8>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 16 && tw == 8)
    return launch_uv<16, 8>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 16 && tw == 16)
    return launch_uv<16, 16>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  return (int)cudaErrorInvalidValue;
}
