// K2 / K3 / K4: fused motion compensation + residual add + saturation; K8:
// the packed prediction with field motion.  All four are forms of one
// segment kernel, mc_seg_kernel.
//
// Replaces (bidir and forward-only forms):
//   K2  tiny_mp2v_dec_tpu/ops/mc_pallas.py:448 fused_mc_recon_mxu
//       (_make_kernel_mxu + _gather_pred_mxu; pallas_call at :480), luma;
//   K3  mc_pallas.py:492 fused_mc_recon_uv_mxu (_gather_pred_pair_mxu;
//       pallas_call at :523), both chroma planes, at the chroma tile of
//       every format: 8x8 (4:2:0), 16x8 (4:2:2) and 16x16 (4:4:4);
//   K4  the field form of both, _field_pred_mxu (mc_pallas.py:353), which
//       the JAX kernels select per MB by mode bit 8 (:397-412);
//   K8  mc_pallas.py:805 fused_mc_pred_swar_field (_field_pred_swar :692;
//       pallas_call at :832), MP2V_MC_IMPL=swar: the prediction alone, frame
//       or field per MB by mode bit 8, one component per call (luma 16x16,
//       or one chroma plane at 8x8, 16x8 or 16x16), stored as the (H, W/4)
//       word plane, pixel 4x at the least significant byte of word x.  Its
//       frame-only sibling K7 is csrc/mc_swar.cu, on the same grouping.
//
// Per macroblock: the forward and backward (h, w) half-pel predictions at
// the clamped window starts (sy, sx) that mc_meta computed, each selecting
// one of a, (a+b+1)>>1, (a+c+1)>>1, ((a+b+1)>>1 + (c+d+1)>>1 + 1)>>1 by the
// 2-bit phase; mode bit 1 = forward, 2 = backward (read only by the bidir
// form), both = (pf+pb+1)>>1; then (K2-K4) + int16 residual, clip to
// [0, 255], and 0 for an MB whose mode bit 4 (coded) is clear.  K8 adds no
// residual and ignores bit 4 (the caller's epilogue, ops/recon.py, as the
// JAX package's XLA epilogue); a mode with neither direction gives 0.
// Taps at a row >= Hr or a column >= Wr read 0: the zero pad of
// pad_ref_plane / golden.mc.pad_for_mc, so no padded copy of a reference
// plane is ever made.  The TPU kernels' one-hot MXU matmuls, 128-lane
// aligned loads and rolls were Mosaic workarounds and are not carried
// over.
//
// Field prediction (K4, K8; MBs with mode bit 8): output row ty of the tile
// belongs to unit r = ty & 1, whose taps are frame rows C_r + ty and
// C_r + ty + 2 (the next row of the same field) at columns from sx_r, with
// phase ph_r — (C_r, sx_r, ph_r) from mc_field_meta, C_r = 2*syf_r + sel_r
// - r.  Frame row C_r + ty is field row syf_r + (ty >> 1) of field sel_r,
// so this reads exactly what the JAX package's padded field views hold,
// and its zero row is the frame's rows >= Hr.  The TPU kernels evaluated
// both units for every row and selected by parity afterwards (a vector
// trick); here each thread computes only its own unit, and so never reads
// row C_1 = -1.  MBs without bit 8 take the frame prediction.
//
// What bounds these on an H100: bytes, over a launch floor.  The bytes
// depend on the modes: a 1080p luma plane is 2 MB out, 2 bytes of residual
// per pixel of a coded MB, and per direction a coded MB's mode uses one
// window of up to 17x17 reference bytes, or two field windows of 9 rows
// (neighbouring windows overlap); uncoded MBs need only their mode.  With
// modes 0-7 drawn evenly that is 5.2 MB, 1.6 us at 3.35 TB/s (chip_smoke.py's
// bound, mc_read_bytes); the arithmetic is a few integer operations per
// pixel.  What stood between a kernel and that bound is the instructions
// that move the bytes: one thread per pixel (the first design of these
// kernels) makes a byte-wide load per tap, each with a bounds check and
// 64-bit index arithmetic, about ten load and store instructions for three
// bytes of traffic per pixel.  A launch of one MB (16x16 or 8x8) measures
// the floor that no design removes: about 3 us on an H100 80GB HBM3 at
// 700 W, twice K2's byte bound.
//
// Design: one thread per 8-pixel row segment of one MB and one plane,
// blocks of kThreads threads packing several MBs:
//   luma 16x16   32 threads per MB (one warp, so the MB's mode, field bit,
//                phase and window are uniform across it), 8 MBs per block;
//   chroma 8x8   8 threads per plane, U and V 16 per MB, 16 MBs per block
//                (K8, one plane: 8 per MB, 32 MBs per block);
//          16x8  16 per plane, 32 per MB, 8 MBs per block (K8: 16, 16);
//          16x16 32 per plane, 64 per MB, 4 MBs per block (K8: 32, 8).
// Tiles 8 wide pair horizontally adjacent MBs, so that a warp's residual
// and output rows fill whole 32-byte sectors: at 16x8 a warp takes one
// plane of two MBs, at 8x8 U and V of two MBs (K8: four MBs).  (One MB
// per warp at 16x8 reads half a sector per row; on an H100 at 700 W that
// took about twice luma's time per byte.)
// Per direction the MB's mode uses, the segment's two words of reference
// taps come from three aligned 32-bit loads per tap row (halfpel_word2 in
// csrc/swar_word.cuh: funnel shifts and the per-byte rounding average
// __vavgu4, which is (x+y+1)>>1 per byte, the bidir average too).  A field
// MB's segment is the same call at its unit's row, column and phase with
// taps two rows apart, so frame and field MBs sharing a warp (8-wide
// tiles) diverge only while they load their vectors.  The two units of a
// field MB have their own phases, so the phase branches of halfpel_word2
// may split a warp by row parity; a form that loads both tap rows and
// selects instead measured 5-10% slower on K8 and within 5% either way on
// K4 (H100 80GB HBM3, 700 W; PERF.md).  Word reads past Wr/4 or at row Hr
// give 0, exact for the zero pad because the wrapper requires Wr % 4 == 0.
// The residual arrives as one 16-byte load (8 x int16), is added per pixel
// in 32-bit arithmetic (no assumption on its range) and clipped; the 8
// bytes go back with __byte_perm and one 8-byte store (K8 stores its two
// prediction words the same way).  A direction the mode does not use is
// not read; an uncoded MB (K2-K4) reads no reference and no residual and
// stores zeros.  Staging windows in shared memory behind a block-wide barrier
// (K5's and K6's first form) measured slower than one thread per pixel, and
// a tile of a few hundred bytes gives TMA or wgmma nothing to do.
//
// Two front ends feed that body (the Front template parameter): where a
// thread finds its MB's mode, its residual row and, per direction, its
// window.
//   VecFront    the per-MB int32 vectors above (mode, and per direction the
//               window starts and phases of mc_meta, the field tuples of
//               mc_field_meta) and int16 residual planes: the JAX kernels'
//               interface, which the kernel gate and K8 use;
//   BlockFront  the blocks form (mp2v_mc_*_blocks_*), which the decoder's
//               mxu path takes: the picture's int16 metadata rows as the
//               chunk blob carries them (ops/recon.py pack_meta2: flags,
//               then the MVs; 5 columns, or 9 with field motion) and the
//               IDCT's residual block grid ((n_mb * blocks_per_mb, 64)
//               int16).  Each thread derives from its MB's row what the
//               per-picture PyTorch glue of ops/recon.py and ops/mc_fused.py
//               computed before any launch (_unpack_meta2, the mode sum,
//               _scale_mv, mc_meta, mc_field_meta, _tiles_from_blocks,
//               _plane_from_tiles): the MB's plane position from its index
//               (plus the band's first MB), the mode, the chroma vector
//               scaling, the clamped window starts and phases and the
//               field units, all integer arithmetic bit for bit as there;
//               and it reads its 16 residual bytes straight from its 8x8
//               block's row (the field-DCT interleave where a block column
//               spans the tile's 16 rows: luma, 4:2:2 and 4:4:4 chroma).
//               Nothing of it is stored.
// The blocks form reads a luma MB's 512 residual bytes contiguously, a few
// bytes of metadata per MB instead of 28 (or 76 with field tuples) of
// vectors.
//
// The grouped blocks form (mp2v_mc_{recon,field}_blocks_group) is the one
// launch of the blocks form: luma and U+V of up to kGroupMax pictures of
// one geometry, none of which reads another's output (the pictures of a
// chunk between two I/P outputs, ops/recon.py mc_groups; the streams of a
// decode_batch step).  Its grid is, picture after picture, the picture's
// luma block range, then its U+V block range, each the whole blocks that
// the segment kernel gives that component; a block finds its picture and
// component by one division, all pictures' ranges being of one size, and
// runs the segment body with BlockFront as a one-component launch would,
// so each pixel comes from the same arithmetic.  The pictures' pointers
// travel in the kernel's parameter space (__grid_constant__, read by a
// block-uniform index; nothing is uploaded).  A forward-only picture in a
// launch that holds a bidir one takes the forward-only body by a
// block-uniform branch on its bidir bit (which measured faster on the field
// form than the bidir body with the backward bit masked off; PERF.md).  The
// one-picture entries mp2v_mc_*_blocks_{luma,uv} are groups of one with
// one component.  A picture's device work is then its share of one launch
// and the three copies that pack its frame, where with the per-picture
// glue it was 78 launches at 1080p 4:2:0 and 229 at 1080-line 4:2:2 with
// field motion, and with a launch per component 2.  What bounds a launch is
// still bytes, over a floor that it now pays once for the group: a 1080p
// luma grid alone is 1,020 blocks, one wave on the 132 SMs, so a one-picture
// launch paid the ramp, the chain of dependent loads and the tail with
// nothing to hide them behind; a group of 3 or 8 pictures is several waves,
// whose blocks overlap one another's load chains.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_ptrs.cuh"
#include "swar_word.cuh"

namespace {

using mp2v::add_clip4;
using mp2v::DirMeta;
using mp2v::mbs_per_group;
using mp2v::Planes;

// The block size: 8 luma MBs, 16 chroma 8x8 MBs.
constexpr int kThreads = 256;

// Blocks per SM the field forms are held to: 8 (32 registers a thread).
// It was chosen for the one-picture forms, where it lets a 1080p luma
// grid, 1,020 blocks, run in one wave on the 132 SMs.  The grouped form,
// which the decoder launches, runs several waves whatever the limit; at 8
// its bidir kernels spill 20-44 bytes, and 6 blocks per SM read 5-6%
// faster on an H100 (an open question in PERF.md).  Left free, ptxas gives
// the bidir field forms 37-38 registers, six blocks per SM.  The frame
// forms keep no minimum (0: none is set).
constexpr int kFieldBlocks = 8;

// A direction's taps for one tile row: the a/b taps on frame row y from
// pixel column sx, the c/d taps vs rows below, phase ph (bit 0 horizontal,
// bit 1 vertical).
struct Window {
  int y, sx, ph, vs;
};

// Segment `seg` of a tile row's prediction in one direction, two words:
// one halfpel_word2 call at the row's window.
__device__ __forceinline__ uint2 seg_pred(const uint8_t* ref, Window w,
                                          int seg, int Hr, int nw) {
  return mp2v::halfpel_word2((const uint32_t*)ref, Hr, nw, w.y, w.sx,
                             2 * seg, w.ph, w.vs);
}

// The vector front end: the mode vector, per direction the frame window
// (sy, sx, ph) and under FIELD the units' (C, sx, ph), and the residual
// planes of the kernel's Planes.
template <bool FIELD>
struct VecFront {
  DirMeta fm, bm;
  const int32_t* modes;

  __device__ __forceinline__ int mode(int i) const { return modes[i]; }

  // the segment's 8 residual pixels: offset o of the plane's residual
  __device__ __forceinline__ const int16_t* residual(const Planes& p, int i,
                                                     int pl, int ty, int seg,
                                                     long long o) const {
    return (pl ? p.res[1] : p.res[0]) + o;
  }

  // direction s's window for tile row ty of MB i: the field unit of row ty
  // for an MB with mode bit 8 (FIELD forms), the frame window otherwise
  __device__ __forceinline__ Window window(int s, int i, int mode, int ty,
                                           int Hr, int nw) const {
    const DirMeta& d = s ? bm : fm;
    if (FIELD && (mode & 8)) {
      // selects, not a run-time index into the parameter arrays, which
      // would copy them to local memory
      const bool r = ty & 1;
      const int32_t* fc = r ? d.fc[1] : d.fc[0];
      const int32_t* fx = r ? d.fx[1] : d.fx[0];
      const int32_t* fp = r ? d.fp[1] : d.fp[0];
      return Window{fc[i] + ty, fx[i], fp[i], 2};
    }
    return Window{d.sy[i] + ty, d.sx[i], d.ph[i], 1};
  }
};

// The blocks front end (see the note at the top): MB i's metadata row and
// its blocks in the residual grid, for a (TH x TW) tile of NP planes — luma
// (NP = 1, 16x16) or U and V (NP = 2) at the chroma tile of the format,
// 8x8 (4:2:0), 16x8 (4:2:2) or 16x16 (4:4:4), which also gives the
// format's subsampling.  The rows hold flags (bit 0 dct_type, 1 forward, 2
// backward, 3 field_pred, 4 coded, 5 + 2r + s motion_vertical_field_select
// of unit r, direction s) and the half-pel MVs: unit r, direction s at
// columns 1 + 4r + 2s (x) and 2 + 4r + 2s (y), unit 0 alone without field
// motion (5 columns, FIELD false; 9 with it).
template <int TH, int TW, int NP, bool FIELD>
struct BlockFront {
  static constexpr int COLS = FIELD ? 9 : 5;
  // chroma subsampling of the component: 0 for luma and 4:4:4
  static constexpr int XS = TW == 8, YS = TH == 8;
  // blocks across a tile row, and of one chroma plane of an MB
  static constexpr int SEGS = TW / 8;
  static constexpr int NCB = (TH / 8) * (TW / 8);
  const int16_t* grid;  // (n_mb * bpm, 64): MB i's blocks from row i * bpm
  const int16_t* meta;  // (n_mb, COLS)
  int bpm;              // blocks per MB: 4 luma, then NCB of U and of V
  int mb0;              // the first MB's index in the whole picture
  int mbw;              // MBs per picture row

  __device__ __forceinline__ int flags(int i) const {
    return meta[(long long)i * COLS];
  }

  // forward, backward, coded, field_pred -> mode bits 1, 2, 4, 8
  __device__ __forceinline__ int mode(int i) const {
    const int f = flags(i);
    return ((f >> 1) & 3) | ((f >> 2) & 4) | (f & 8);
  }

  // the segment's 8 residual pixels: row `row` of block `blk` of MB i, the
  // tile's block column `seg`; under field DCT a 16-row block column
  // interleaves its two blocks' rows (the top block's the even tile rows)
  __device__ __forceinline__ const int16_t* residual(const Planes&, int i,
                                                     int pl, int ty, int seg,
                                                     long long) const {
    const bool inter = TH == 16 && (flags(i) & 1);
    const int base = NP == 1 ? 0 : (pl ? 4 + NCB : 4);
    const int blk = base + (inter ? ty & 1 : ty >> 3) * SEGS + seg;
    const int row = inter ? ty >> 1 : ty & 7;
    return grid + ((long long)i * bpm + blk) * 64 + row * 8;
  }

  // direction s's window for tile row ty of MB i on the (Hr, 4 * nw)
  // plane: the MB's position, its MV scaled to the component, the start
  // clamped into the plane as mc_meta clamps it; for a field-predicted MB
  // (FIELD), row ty's unit r = ty & 1 with its field select, its field
  // window start clamped in field rows as mc_field_meta clamps it, and the
  // unit's affine row base C_r = 2 * syf_r + sel_r - r
  __device__ __forceinline__ Window window(int s, int i, int mode, int ty,
                                           int Hr, int nw) const {
    const int g = mb0 + i;
    const int mby = g / mbw;
    const int py = (mby * 16) >> YS, px = ((g - mby * mbw) * 16) >> XS;
    const int16_t* m = meta + (long long)i * COLS;
    if (FIELD && (mode & 8)) {
      const int r = ty & 1;
      const int mvx = m[1 + 4 * r + 2 * s] >> XS;
      const int mvy = m[2 + 4 * r + 2 * s] >> YS;
      const int sel = (m[0] >> (5 + 2 * r + s)) & 1;
      const int syf =
          min(max((py >> 1) + (mvy >> 1), 0), (Hr >> 1) - TH / 2);
      const int sx = min(max(px + (mvx >> 1), 0), 4 * nw - TW);
      return Window{2 * syf + sel - r + ty, sx, (mvx & 1) + 2 * (mvy & 1),
                    2};
    }
    const int mvx = m[1 + 2 * s] >> XS, mvy = m[2 + 2 * s] >> YS;
    return Window{min(max(py + (mvy >> 1), 0), Hr - TH) + ty,
                  min(max(px + (mvx >> 1), 0), 4 * nw - TW),
                  (mvx & 1) + 2 * (mvy & 1), 1};
  }
};

// One thread per 8-pixel row segment; thread t of the launch's range is
// segment `seg` of tile row `ty` of plane `pl` of MB i (see the note at the
// top).
// Tiles 8 wide go in pairs of horizontally adjacent MBs, plane-major, so
// that the threads of a plane's row cover 16 pixels: 32 bytes of residual,
// one whole sector.  FIELD: mode bit 8 selects field prediction (K4, K8).
// RECON: residual, clip and coded mask into uint8 planes (K2-K4);
// otherwise the prediction words alone into out[0] (K8, NP = 1).  Front:
// VecFront or BlockFront, where the MB's inputs come from.
template <int TH, int TW, int NP, bool BIDIR, bool FIELD, bool RECON,
          class Front>
__device__ __forceinline__ void mc_seg(int t, const Planes& p,
                                       const Front& in, int n_mb, int mbw,
                                       int Hr, int nw) {
  constexpr int SEGS = TW / 8;       // segments per tile row
  constexpr int TPP = TH * SEGS;     // threads per plane of one MB
  constexpr int G = mbs_per_group(TW);
  constexpr int TPG = TPP * NP * G;  // threads per group
  static_assert(kThreads % TPG == 0, "a group's threads share one block");
  static_assert(RECON || NP == 1, "the prediction form takes one plane");
  const int r = t % TPG;
  const int i = (t / TPG) * G + (r / TPP) % G;
  if (i >= n_mb) return;
  const int pl = NP == 2 ? r / (TPP * G) : 0;
  const int ty = (r % TPP) / SEGS, seg = r % SEGS;
  const long long o = (long long)((i / mbw) * TH + ty) * (mbw * TW) +
                      (i % mbw) * TW + seg * 8;
  uint8_t* out = (pl ? p.out[1] : p.out[0]) + o;
  const int mode = in.mode(i);
  [[maybe_unused]] int4 res;
  if constexpr (RECON) {
    if (!(mode & 4)) {
      *reinterpret_cast<uint2*>(out) = make_uint2(0u, 0u);
      return;
    }
    res = *reinterpret_cast<const int4*>(in.residual(p, i, pl, ty, seg, o));
  }
  const bool f = (mode & 1) != 0;
  const bool b = BIDIR && (mode & 2) != 0;
  uint2 pred = make_uint2(0u, 0u);
  if (f)
    pred = seg_pred(pl ? p.ref0[1] : p.ref0[0],
                    in.window(0, i, mode, ty, Hr, nw), seg, Hr, nw);
  if (b) {
    const uint2 pb = seg_pred(pl ? p.ref1[1] : p.ref1[0],
                              in.window(1, i, mode, ty, Hr, nw), seg, Hr,
                              nw);
    pred = f ? make_uint2(__vavgu4(pred.x, pb.x), __vavgu4(pred.y, pb.y))
             : pb;
  }
  if constexpr (RECON)
    pred = make_uint2(add_clip4(pred.x, res.x, res.y),
                      add_clip4(pred.y, res.z, res.w));
  *reinterpret_cast<uint2*>(out) = pred;
}

// The vector front end's kernel: one launch, one component.
template <int TH, int TW, int NP, bool BIDIR, bool FIELD, bool RECON,
          class Front>
__global__ void __launch_bounds__(kThreads, FIELD ? kFieldBlocks : 0)
    mc_seg_kernel(Planes p, Front in, int n_mb, int mbw, int Hr, int nw) {
  mc_seg<TH, TW, NP, BIDIR, FIELD, RECON>(blockIdx.x * kThreads + threadIdx.x,
                                          p, in, n_mb, mbw, Hr, nw);
}

// The blocks of the segment kernel over n_mb MBs of a (TH x TW) tile and
// NP planes: whole groups of mbs_per_group MBs, rounded up to whole blocks.
template <int TH, int TW, int NP>
int seg_blocks(int n_mb) {
  constexpr int G = mbs_per_group(TW);
  constexpr long long TPG = TH * (TW / 8) * NP * G;  // threads per group
  const long long groups = (n_mb + G - 1) / G;
  return (int)((groups * TPG + kThreads - 1) / kThreads);
}

// One launch of a form of the segment kernel over n_mb MBs of mbw to a
// row, on planes (Hr, Wr).
template <bool FIELD, bool RECON, int TH, int TW, int NP, class Front>
int launch(const Planes& p, const Front& in, int n_mb, int mbw, int Hr,
           int Wr, int bidir, void* stream) {
  if (n_mb > 0) {
    const int blocks = seg_blocks<TH, TW, NP>(n_mb);
    cudaStream_t s = (cudaStream_t)stream;
    if (bidir)
      mc_seg_kernel<TH, TW, NP, true, FIELD, RECON, Front>
          <<<blocks, kThreads, 0, s>>>(p, in, n_mb, mbw, Hr, Wr >> 2);
    else
      mc_seg_kernel<TH, TW, NP, false, FIELD, RECON, Front>
          <<<blocks, kThreads, 0, s>>>(p, in, n_mb, mbw, Hr, Wr >> 2);
  }
  return (int)cudaGetLastError();
}

// Pointer order: csrc/mc_ptrs.cuh.  The one-plane forms read only index 0
// of each plane pair (K8: out[0] is the word plane, res unread); the frame
// forms leave the field tuples unread (null).
template <bool FIELD, bool RECON, int TH, int TW, int NP>
int launch_vec(const void* const* ptrs, int n_mb, int mbw, int Hr, int Wr,
               int bidir, void* stream) {
  const VecFront<FIELD> in{mp2v::dir_meta(ptrs, 0), mp2v::dir_meta(ptrs, 1),
                           mp2v::modes_of(ptrs)};
  return launch<FIELD, RECON, TH, TW, NP>(mp2v::planes_of(ptrs), in, n_mb,
                                          mbw, Hr, Wr, bidir, stream);
}

// The luma forms take 16x16 tiles; the U+V forms and K8 the chroma tile of
// each format (K8 luma is 16x16 too).  Any other tile is refused before a
// launch.
template <bool FIELD, bool RECON, int NP>
int launch_tile(MP2V_MC_ARGS) {
  if (th == 16 && tw == 16)
    return launch_vec<FIELD, RECON, 16, 16, NP>(ptrs, n_mb, mbw, Hr, Wr,
                                                bidir, stream);
  if constexpr (NP == 2 || !RECON) {
    if (th == 8 && tw == 8)
      return launch_vec<FIELD, RECON, 8, 8, NP>(ptrs, n_mb, mbw, Hr, Wr,
                                                bidir, stream);
    if (th == 16 && tw == 8)
      return launch_vec<FIELD, RECON, 16, 8, NP>(ptrs, n_mb, mbw, Hr, Wr,
                                                 bidir, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Block b of picture q's range of the grouped form: its luma blocks, then
// its U+V blocks, through the segment body at the picture's bidir.
template <bool BIDIR, bool FIELD, int TH, int TW>
__device__ __forceinline__ void group_block(const mp2v::Group& g,
                                            const mp2v::GroupPicture& q,
                                            int b) {
  if (b < g.luma_blocks) {
    const Planes p{{q.ref0[0], q.ref0[0]}, {q.ref1[0], q.ref1[0]},
                   {nullptr, nullptr}, {q.out[0], q.out[0]}};
    const BlockFront<16, 16, 1, FIELD> in{q.grid, q.meta, g.bpm, g.mb0,
                                          g.mbw};
    mc_seg<16, 16, 1, BIDIR, FIELD, true>(b * kThreads + threadIdx.x, p, in,
                                          g.n_mb, g.mbw, g.Hr, g.nw);
  } else {
    const Planes p{{q.ref0[1], q.ref0[2]}, {q.ref1[1], q.ref1[2]},
                   {nullptr, nullptr}, {q.out[1], q.out[2]}};
    const BlockFront<TH, TW, 2, FIELD> in{q.grid, q.meta, g.bpm, g.mb0,
                                          g.mbw};
    mc_seg<TH, TW, 2, BIDIR, FIELD, true>(
        (b - g.luma_blocks) * kThreads + threadIdx.x, p, in, g.n_mb, g.mbw,
        g.Hc, g.nwc);
  }
}

// The grouped blocks form (see the note at the top): block b of the grid
// is block b % per of picture b / per, per = luma + uv blocks.  TH x TW:
// the format's chroma tile.  BIDIR: some picture of the launch is bidir;
// each picture then takes its own form by a block-uniform branch.
template <bool BIDIR, bool FIELD, int TH, int TW>
__global__ void __launch_bounds__(kThreads, FIELD ? kFieldBlocks : 0)
    mc_group_kernel(const __grid_constant__ mp2v::Group g) {
  const int k = blockIdx.x / (g.luma_blocks + g.uv_blocks);
  const int b = blockIdx.x - k * (g.luma_blocks + g.uv_blocks);
  const mp2v::GroupPicture& q = g.pic[k];
  if (BIDIR && q.bidir)
    group_block<true, FIELD, TH, TW>(g, q, b);
  else
    group_block<false, FIELD, TH, TW>(g, q, b);
}

// One launch of the grouped form at the chroma tile (TH x TW): the block
// ranges of the components in `comps` (bit 0 luma, bit 1 U+V); `bidir`:
// some picture is.
template <bool FIELD, int TH, int TW>
int launch_group(mp2v::Group& g, int n_pic, int comps, bool bidir,
                 void* stream) {
  g.luma_blocks = comps & 1 ? seg_blocks<16, 16, 1>(g.n_mb) : 0;
  g.uv_blocks = comps & 2 ? seg_blocks<TH, TW, 2>(g.n_mb) : 0;
  const long long blocks = (long long)n_pic * (g.luma_blocks + g.uv_blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    if (bidir)
      mc_group_kernel<true, FIELD, TH, TW>
          <<<(int)blocks, kThreads, 0, s>>>(g);
    else
      mc_group_kernel<false, FIELD, TH, TW>
          <<<(int)blocks, kThreads, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
}

// The grouped form from the chroma format (cf: 1 4:2:0, 2 4:2:2, 3 4:4:4,
// as headers.py): U and V at 8x8, 16x8 or 16x16.  The rows must be the
// form's: 5 columns for the frame form, 9 for the field form.  Bit k of
// `bidir` is picture k's.  Anything else is refused before a launch.
template <bool FIELD>
int launch_group_cf(mp2v::Group& g, int n_pic, int comps, int cols, int cf,
                    int bidir, void* stream) {
  if (cols != (FIELD ? 9 : 5) || cf < 1 || cf > 3 || g.mb0 < 0 ||
      g.mbw <= 0 || g.n_mb < 0)
    return (int)cudaErrorInvalidValue;
  g.bpm = 4 + 2 * (cf == 1 ? 1 : cf == 2 ? 2 : 4);
  for (int k = 0; k < n_pic; ++k)
    g.pic[k].bidir = (bidir >> k) & 1;
  if (cf == 1)
    return launch_group<FIELD, 8, 8>(g, n_pic, comps, bidir != 0, stream);
  if (cf == 2)
    return launch_group<FIELD, 16, 8>(g, n_pic, comps, bidir != 0, stream);
  return launch_group<FIELD, 16, 16>(g, n_pic, comps, bidir != 0, stream);
}

// The grouped form's entry (pointer order: csrc/mc_ptrs.cuh): n_pic
// pictures of kGroupPtrs pointers each, both components.
template <bool FIELD>
int blocks_group(MP2V_MC_GROUP_ARGS) {
  if (n_pic < 1 || n_pic > mp2v::kGroupMax)
    return (int)cudaErrorInvalidValue;
  mp2v::Group g = mp2v::group_of(ptrs, n_pic);
  g.n_mb = n_mb;
  g.mb0 = mb0;
  g.mbw = mbw;
  g.Hr = Hr;
  g.nw = Wr >> 2;
  g.Hc = Hc;
  g.nwc = Wc >> 2;
  return launch_group_cf<FIELD>(g, n_pic, 3, cols, cf, bidir, stream);
}

// A one-picture, one-component entry (pointer order: csrc/mc_ptrs.cuh) as a
// group of one: the luma form (NP = 1) or U+V (NP = 2) on planes (Hr, Wr).
template <bool FIELD, int NP>
int blocks_one(MP2V_MC_BLOCKS_ARGS) {
  mp2v::Group g = mp2v::group_of_one(ptrs, NP == 1 ? 0 : 1);
  g.n_mb = n_mb;
  g.mb0 = mb0;
  g.mbw = mbw;
  g.Hr = g.Hc = Hr;
  g.nw = g.nwc = Wr >> 2;
  return launch_group_cf<FIELD>(g, 1, NP, cols, cf, bidir ? 1 : 0, stream);
}

// A kernel that does nothing, launched with the segment kernels' block
// size: its device time is the launch alone, the part of their one-MB
// floor that no load chain adds to (chip_smoke.py).
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

}  // namespace

extern "C" int mp2v_mc_recon_luma(MP2V_MC_ARGS) {
  return launch_tile<false, true, 1>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_recon_uv(MP2V_MC_ARGS) {
  return launch_tile<false, true, 2>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_field_luma(MP2V_MC_ARGS) {
  return launch_tile<true, true, 1>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_field_uv(MP2V_MC_ARGS) {
  return launch_tile<true, true, 2>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_recon_blocks_luma(MP2V_MC_BLOCKS_ARGS) {
  return blocks_one<false, 1>(MP2V_MC_BLOCKS_FWD);
}

extern "C" int mp2v_mc_recon_blocks_uv(MP2V_MC_BLOCKS_ARGS) {
  return blocks_one<false, 2>(MP2V_MC_BLOCKS_FWD);
}

extern "C" int mp2v_mc_field_blocks_luma(MP2V_MC_BLOCKS_ARGS) {
  return blocks_one<true, 1>(MP2V_MC_BLOCKS_FWD);
}

extern "C" int mp2v_mc_field_blocks_uv(MP2V_MC_BLOCKS_ARGS) {
  return blocks_one<true, 2>(MP2V_MC_BLOCKS_FWD);
}

extern "C" int mp2v_mc_recon_blocks_group(MP2V_MC_GROUP_ARGS) {
  return blocks_group<false>(MP2V_MC_GROUP_FWD);
}

extern "C" int mp2v_mc_field_blocks_group(MP2V_MC_GROUP_ARGS) {
  return blocks_group<true>(MP2V_MC_GROUP_FWD);
}

extern "C" int mp2v_mc_swar_field(MP2V_MC_ARGS) {
  return launch_tile<true, false, 1>(MP2V_MC_FWD);
}

extern "C" int mp2v_empty(int blocks, void* stream) {
  if (blocks > 0)
    empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
