// The argument list every MC entry point of csrc/mc_*.cu takes, and the
// pointer array at its head (MC_PTRS = 27 in ops/_build.py):
//
//   0-1  ref0[2]   forward reference planes (U, V; luma forms use [0])
//   2-3  ref1[2]   backward reference planes
//   4-5  res[2]    int16 residual planes (null for the SWAR forms)
//   6-7  out[2]    output planes: uint8 (H, W); for the SWAR forms out[0]
//                  is the (H, W / 4) uint32 word plane
//   8-14 syf, sxf, phf, syb, sxb, phb, mode   per-MB int32 vectors
//   15-26 the field tuples (C0, sx0, ph0, C1, sx1, ph1), forward then
//        backward (null for the frame forms)
//
// Then the tile rows and columns, n_mb, the MB row width mbw, the
// reference plane's Hr and Wr, bidir and the stream.
//
// The picture form of K7 (mp2v_mc_swar_yuv, csrc/mc_swar.cu) takes the same
// argument list with a pointer array of its own, the three components of
// one picture:
//
//   0-2  ref0[3]   forward reference planes Y, U, V
//   3-5  ref1[3]   backward reference planes
//   6-8  out[3]    the (H, W / 4) uint32 word planes
//   9-14  luma syf, sxf, phf, syb, sxb, phb     per-MB int32 vectors
//   15-20 chroma syf, sxf, phf, syb, sxb, phb   (U and V share them)
//   21   mode      (all three components share it)
//
// th and tw are the chroma tile, Hr and Wr the luma reference's; luma is
// 16x16 and a chroma plane (Hr / 16 * th, Wr / 16 * tw).
//
// The blocks form of K2/K3/K4 (mp2v_mc_{recon,field}_blocks_{luma,uv},
// csrc/mc_recon.cu) takes an array of 8 pointers laid out as the first 8
// above, with the residual pair replaced:
//
//   0-1  ref0[2], 2-3 ref1[2]   as above
//   4    the picture's residual block grid, int16 (n_mb * blocks_per_mb, 64)
//   5    its metadata rows, int16 (n_mb, cols)
//   6-7  out[2]    as above
//
// Then cols (5, or 9 with field motion), the chroma format, n_mb, the first
// MB's index in the picture (a band's), mbw, the planes' Hr and Wr (the
// luma reference's for the luma forms, a chroma plane's for U+V), bidir and
// the stream.
//
// The grouped blocks form (mp2v_mc_{recon,field}_blocks_group,
// csrc/mc_recon.cu) takes n_pic (1 to kGroupMax) pictures of kGroupPtrs
// pointers each, picture k's at k * kGroupPtrs:
//
//   0-2   ref0[3]   forward reference planes Y, U, V
//   3-5   ref1[3]   backward reference planes
//   6     the picture's residual block grid, as above
//   7     its metadata rows, as above
//   8-10  out[3]    output planes Y, U, V
//
// Then n_pic, cols, the chroma format, n_mb, the first MB's index, mbw, the
// luma planes' Hr and Wr, the chroma planes' Hc and Wc, bidir (bit k:
// picture k is bidir) and the stream.  The pictures share everything but
// their pointers and their bidir bit.
#pragma once

#include <stdint.h>

namespace mp2v {

struct Planes {
  const uint8_t* ref0[2];
  const uint8_t* ref1[2];
  const int16_t* res[2];
  uint8_t* out[2];
};

// One direction's per-MB vectors: the frame window (sy, sx, ph) and the
// field units' (C, sx, ph) for r = 0, 1.
struct DirMeta {
  const int32_t* sy;
  const int32_t* sx;
  const int32_t* ph;
  const int32_t* fc[2];
  const int32_t* fx[2];
  const int32_t* fp[2];
};

inline Planes planes_of(const void* const* ptrs) {
  Planes p;
  for (int k = 0; k < 2; ++k) {
    p.ref0[k] = (const uint8_t*)ptrs[0 + k];
    p.ref1[k] = (const uint8_t*)ptrs[2 + k];
    p.res[k] = (const int16_t*)ptrs[4 + k];
    p.out[k] = (uint8_t*)ptrs[6 + k];
  }
  return p;
}

// direction s: 0 forward, 1 backward
inline DirMeta dir_meta(const void* const* ptrs, int s) {
  const int32_t* const* q = (const int32_t* const*)ptrs;
  DirMeta d;
  d.sy = q[8 + 3 * s];
  d.sx = q[9 + 3 * s];
  d.ph = q[10 + 3 * s];
  for (int r = 0; r < 2; ++r) {
    d.fc[r] = q[15 + 6 * s + 3 * r];
    d.fx[r] = q[16 + 6 * s + 3 * r];
    d.fp[r] = q[17 + 6 * s + 3 * r];
  }
  return d;
}

inline const int32_t* modes_of(const void* const* ptrs) {
  return (const int32_t*)ptrs[14];
}

// The picture form's planes (Y, U, V) and one direction's frame vectors of
// luma (c = 0) or chroma (c = 1).
struct YuvPlanes {
  const uint8_t* ref0[3];
  const uint8_t* ref1[3];
  uint8_t* out[3];
};

struct FrameMeta {
  const int32_t* sy;
  const int32_t* sx;
  const int32_t* ph;
};

inline YuvPlanes yuv_planes_of(const void* const* ptrs) {
  YuvPlanes p;
  for (int k = 0; k < 3; ++k) {
    p.ref0[k] = (const uint8_t*)ptrs[0 + k];
    p.ref1[k] = (const uint8_t*)ptrs[3 + k];
    p.out[k] = (uint8_t*)ptrs[6 + k];
  }
  return p;
}

// direction s: 0 forward, 1 backward
inline FrameMeta yuv_meta(const void* const* ptrs, int c, int s) {
  const int32_t* const* q = (const int32_t* const*)ptrs + 9 + 6 * c + 3 * s;
  return FrameMeta{q[0], q[1], q[2]};
}

inline const int32_t* yuv_modes_of(const void* const* ptrs) {
  return (const int32_t*)ptrs[21];
}

// The grouped blocks form's pictures, at most kGroupMax a launch, and the
// launch's shared geometry: all of it travels by value in the kernel's
// parameter space (about 1.6 KB of its 4 KB).
constexpr int kGroupMax = 16;
constexpr int kGroupPtrs = 11;

struct GroupPicture {
  const uint8_t* ref0[3];
  const uint8_t* ref1[3];
  const int16_t* grid;
  const int16_t* meta;
  uint8_t* out[3];
  int bidir;  // 1: both directions; 0: forward only
};

struct Group {
  GroupPicture pic[kGroupMax];
  int luma_blocks, uv_blocks;  // each picture's blocks of either component
  int n_mb, mb0, mbw, bpm;
  int Hr, nw, Hc, nwc;         // luma and chroma rows and words per row
};

inline Group group_of(const void* const* ptrs, int n_pic) {
  Group g{};
  for (int k = 0; k < n_pic; ++k) {
    const void* const* q = ptrs + k * kGroupPtrs;
    GroupPicture& p = g.pic[k];
    for (int c = 0; c < 3; ++c) {
      p.ref0[c] = (const uint8_t*)q[c];
      p.ref1[c] = (const uint8_t*)q[3 + c];
      p.out[c] = (uint8_t*)q[8 + c];
    }
    p.grid = (const int16_t*)q[6];
    p.meta = (const int16_t*)q[7];
  }
  return g;
}

// A one-component call's 8 pointers (the blocks form's layout above) as a
// group of one: luma (c = 0) in component 0, or U and V (c = 1) in 1 and 2.
inline Group group_of_one(const void* const* ptrs, int c) {
  Group g{};
  GroupPicture& p = g.pic[0];
  for (int k = 0; k < 1 + c; ++k) {
    p.ref0[c + k] = (const uint8_t*)ptrs[0 + k];
    p.ref1[c + k] = (const uint8_t*)ptrs[2 + k];
    p.out[c + k] = (uint8_t*)ptrs[6 + k];
  }
  p.grid = (const int16_t*)ptrs[4];
  p.meta = (const int16_t*)ptrs[5];
  return g;
}

}  // namespace mp2v

#define MP2V_MC_ARGS                                                      \
  const void *const *ptrs, int th, int tw, int n_mb, int mbw, int Hr,     \
      int Wr, int bidir, void *stream
#define MP2V_MC_FWD ptrs, th, tw, n_mb, mbw, Hr, Wr, bidir, stream
#define MP2V_MC_BLOCKS_ARGS                                               \
  const void *const *ptrs, int cols, int cf, int n_mb, int mb0, int mbw,  \
      int Hr, int Wr, int bidir, void *stream
#define MP2V_MC_BLOCKS_FWD \
  ptrs, cols, cf, n_mb, mb0, mbw, Hr, Wr, bidir, stream
#define MP2V_MC_GROUP_ARGS                                                 \
  const void *const *ptrs, int n_pic, int cols, int cf, int n_mb, int mb0, \
      int mbw, int Hr, int Wr, int Hc, int Wc, int bidir, void *stream
#define MP2V_MC_GROUP_FWD \
  ptrs, n_pic, cols, cf, n_mb, mb0, mbw, Hr, Wr, Hc, Wc, bidir, stream
