// K2 / K3 / K4: fused motion compensation + residual add + saturation.
//
// Replaces (bidir and forward-only forms):
//   K2  tiny_mp2v_dec_tpu/ops/mc_pallas.py:448 fused_mc_recon_mxu
//       (_make_kernel_mxu + _gather_pred_mxu; pallas_call at :480), luma;
//   K3  mc_pallas.py:492 fused_mc_recon_uv_mxu (_gather_pred_pair_mxu;
//       pallas_call at :523), both chroma planes, at the chroma tile of
//       every format: 8x8 (4:2:0), 16x8 (4:2:2) and 16x16 (4:4:4);
//   K4  the field form of both, _field_pred_mxu (mc_pallas.py:353), which
//       the JAX kernels select per MB by mode bit 8 (:397-412).
//
// Per macroblock: the forward and backward (h, w) half-pel predictions at
// the clamped window starts (sy, sx) that mc_meta computed, each selecting
// one of a, (a+b+1)>>1, (a+c+1)>>1, ((a+b+1)>>1 + (c+d+1)>>1 + 1)>>1 by the
// 2-bit phase; mode bit 1 = forward, 2 = backward (read only by the bidir
// form), both = (pf+pb+1)>>1; then + int16 residual, clip to [0, 255],
// and 0 for an MB whose mode bit 4 (coded) is clear.  Stored as uint8.
// Taps at a row >= Hr or a column >= Wr read 0: the zero pad of
// pad_ref_plane / golden.mc.pad_for_mc, so no padded copy of a reference
// plane is ever made.  The TPU kernels' one-hot MXU matmuls, 128-lane
// aligned loads and rolls were Mosaic workarounds and are not carried
// over.
//
// What bounds the frame forms (K2, K3) on an H100: bytes, over a launch
// floor.  The bytes depend on the modes: a 1080p luma plane is 2 MB out,
// 2 bytes of residual per pixel of a coded MB, and per direction a coded
// MB's mode uses one window of up to 17x17 reference bytes (neighbouring
// windows overlap); uncoded MBs need only their mode.  With modes 0-7
// drawn evenly that is 5.2 MB, 1.6 us at 3.35 TB/s (chip_smoke.py's
// bound, mc_read_bytes); the arithmetic is a few integer operations per
// pixel.  What stood between a kernel and that bound is the instructions
// that move the bytes: one thread per pixel (the field form's design)
// makes a byte-wide load per tap, each with a bounds check and 64-bit
// index arithmetic, about ten load and store instructions for three bytes
// of traffic per pixel.  A launch of one MB (16x16 or 8x8) measures the
// floor that no design removes: about 3 us on an H100 80GB HBM3 at 700 W,
// twice K2's byte bound.
//
// Frame design (mc_seg_kernel): one thread per 8-pixel row segment of one
// MB and one plane, blocks of kThreads threads packing several MBs:
//   luma 16x16   32 threads per MB (one warp, so the MB's mode, phase and
//                window are uniform across it), 8 MBs per block;
//   chroma 8x8   8 threads per plane, U and V 16 per MB, 16 MBs per block;
//          16x8  16 per plane, 32 per MB, 8 MBs per block;
//          16x16 32 per plane, 64 per MB, 4 MBs per block.
// Tiles 8 wide pair horizontally adjacent MBs, so that a warp's residual
// rows fill whole 32-byte sectors: at 16x8 a warp takes one plane of two
// MBs, at 8x8 U and V of two MBs.  (One MB per warp at 16x8 reads half a
// sector per row; on an H100 at 700 W that took about twice luma's time
// per byte.)
// Per direction the MB's mode uses, the segment's two words of reference
// taps come from three aligned 32-bit loads per tap row (halfpel_word2 in
// csrc/swar_word.cuh: funnel shifts and the per-byte rounding average
// __vavgu4, which is (x+y+1)>>1 per byte, the bidir average too).  Word
// reads past Wr/4 or at row Hr give 0, exact for the zero pad because the
// wrapper requires Wr % 4 == 0.  The residual arrives as one 16-byte load
// (8 x int16), is added per pixel in 32-bit arithmetic (no assumption on
// its range) and clipped; the 8 bytes go back with __byte_perm and one
// 8-byte store.  A direction the mode does not use is not read; an
// uncoded MB reads no reference and no residual and stores zeros.
// Staging windows in shared memory (K5/K6, csrc/mc_roll.cu) measured
// slower than one thread per pixel, and a tile of a few hundred bytes
// gives TMA or wgmma nothing to do.
//
// Field design (K4, mc_recon_kernel; MBs with mode bit 8 take field
// prediction): one thread block per macroblock and one thread per output
// pixel, U and V as the two z-slices of one block.  Output row ty of the
// tile belongs to unit r = ty & 1, whose taps are frame rows ty + C_r and
// ty + C_r + 2 (the next row of the same field) at columns sx_r + tx and
// sx_r + tx + 1, with phase ph_r — (C_r, sx_r, ph_r) from mc_field_meta,
// C_r = 2*syf_r + sel_r - r.  Frame row ty + C_r is field row syf_r +
// (ty >> 1) of field sel_r, so this reads exactly what the JAX package's
// padded field views hold, and its zero row is the frame's rows >= Hr.
// The TPU kernel evaluated both units for every row and selected by parity
// afterwards (a vector trick); here each thread computes only its own
// unit, and so never reads row C_1 = -1.  MBs without bit 8 take the frame
// prediction.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_ptrs.cuh"
#include "swar_word.cuh"

namespace {

using mp2v::DirMeta;
using mp2v::Planes;

__device__ __forceinline__ int tap(const uint8_t* __restrict__ ref, int Hr,
                                   int Wr, int y, int x) {
  return (y < Hr && x < Wr) ? (int)ref[(long long)y * Wr + x] : 0;
}

// One pixel of a unidirectional half-pel prediction whose vertical taps are
// `vs` rows apart (1: frame, 2: field); (y, x) >= 0 because window starts
// arrive clamped.
__device__ __forceinline__ int halfpel(const uint8_t* __restrict__ ref,
                                       int Hr, int Wr, int y, int x, int ph,
                                       int vs) {
  const int a = tap(ref, Hr, Wr, y, x);
  switch (ph & 3) {
    case 0:
      return a;
    case 1:
      return (a + tap(ref, Hr, Wr, y, x + 1) + 1) >> 1;
    case 2:
      return (a + tap(ref, Hr, Wr, y + vs, x) + 1) >> 1;
    default: {
      const int b = tap(ref, Hr, Wr, y, x + 1);
      const int c = tap(ref, Hr, Wr, y + vs, x);
      const int d = tap(ref, Hr, Wr, y + vs, x + 1);
      const int ab = (a + b + 1) >> 1;
      const int cd = (c + d + 1) >> 1;
      return (ab + cd + 1) >> 1;
    }
  }
}

// Pixel (ty, tx) of MB i's prediction in one direction (field form): field
// prediction for an MB with mode bit 8, frame prediction otherwise.
__device__ __forceinline__ int predict(const uint8_t* __restrict__ ref,
                                       const DirMeta& d, int i, int mode,
                                       int ty, int tx, int Hr, int Wr) {
  if (mode & 8) {
    // selects, not a runtime index into the parameter arrays, which would
    // copy them to local memory
    const bool r = ty & 1;
    const int32_t* fc = r ? d.fc[1] : d.fc[0];
    const int32_t* fx = r ? d.fx[1] : d.fx[0];
    const int32_t* fp = r ? d.fp[1] : d.fp[0];
    return halfpel(ref, Hr, Wr, fc[i] + ty, fx[i] + tx, fp[i], 2);
  }
  return halfpel(ref, Hr, Wr, d.sy[i] + ty, d.sx[i] + tx, d.ph[i], 1);
}

// The field form: blockDim = (TW, TH, NP); blockIdx.x = macroblock
// (row-major).
template <int TH, int TW, bool BIDIR>
__global__ void mc_recon_kernel(Planes p, DirMeta fm, DirMeta bm,
                                const int32_t* __restrict__ modes, int mbw,
                                int Hr, int Wr) {
  const int i = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y, pl = threadIdx.z;
  const int W = mbw * TW;
  const long long o =
      (long long)((i / mbw) * TH + ty) * W + (i % mbw) * TW + tx;
  const int mode = modes[i];
  int val = 0;
  if (mode & 4) {
    const bool f = (mode & 1) != 0;
    const bool b = BIDIR && (mode & 2) != 0;
    int pf = 0, pb = 0;
    if (f)
      pf = predict(pl ? p.ref0[1] : p.ref0[0], fm, i, mode, ty, tx, Hr, Wr);
    if (b)
      pb = predict(pl ? p.ref1[1] : p.ref1[0], bm, i, mode, ty, tx, Hr, Wr);
    const int pred = (f && b) ? (pf + pb + 1) >> 1 : (f ? pf : pb);
    val = min(max(pred + (int)(pl ? p.res[1] : p.res[0])[o], 0), 255);
  }
  (pl ? p.out[1] : p.out[0])[o] = (uint8_t)val;
}

// The frame forms' block size: 8 luma MBs, 16 chroma 8x8 MBs.
constexpr int kThreads = 256;

// MBs side by side in one thread group of the frame forms: tiles 8 wide
// go in pairs (see mc_seg_kernel).
__host__ __device__ constexpr int mbs_per_group(int tw) {
  return tw == 8 ? 2 : 1;
}

// Residual add and clip of one 4-pixel word: prediction bytes + the two
// int16 pairs r01, r23 (pixel 0 in the low half of r01), in 32-bit
// arithmetic, clipped to [0, 255] and packed back into a word.
__device__ __forceinline__ uint32_t add_clip4(uint32_t pred, int r01,
                                              int r23) {
  const int v0 = min(max((int)(pred & 0xFF) + (int)(int16_t)r01, 0), 255);
  const int v1 = min(max((int)((pred >> 8) & 0xFF) + (r01 >> 16), 0), 255);
  const int v2 = min(max((int)((pred >> 16) & 0xFF) + (int)(int16_t)r23, 0),
                     255);
  const int v3 = min(max((int)(pred >> 24) + (r23 >> 16), 0), 255);
  return __byte_perm(__byte_perm(v0, v1, 0x0040), __byte_perm(v2, v3, 0x0040),
                     0x5410);
}

// One thread per 8-pixel row segment; thread t of the grid is segment
// `seg` of tile row `ty` of plane `pl` of MB i (see the note at the top).
// Tiles 8 wide go in pairs of horizontally adjacent MBs, plane-major, so
// that the threads of a plane's row cover 16 pixels: 32 bytes of residual,
// one whole sector.
template <int TH, int TW, int NP, bool BIDIR>
__global__ void __launch_bounds__(kThreads)
    mc_seg_kernel(Planes p, DirMeta fm, DirMeta bm,
                  const int32_t* __restrict__ modes, int n_mb, int mbw,
                  int Hr, int nw) {
  constexpr int SEGS = TW / 8;       // segments per tile row
  constexpr int TPP = TH * SEGS;     // threads per plane of one MB
  constexpr int G = mbs_per_group(TW);
  constexpr int TPG = TPP * NP * G;  // threads per group
  static_assert(kThreads % TPG == 0, "a group's threads share one block");
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int r = t % TPG;
  const int i = (t / TPG) * G + (r / TPP) % G;
  if (i >= n_mb) return;
  const int pl = NP == 2 ? r / (TPP * G) : 0;
  const int ty = (r % TPP) / SEGS, seg = r % SEGS;
  const long long o = (long long)((i / mbw) * TH + ty) * (mbw * TW) +
                      (i % mbw) * TW + seg * 8;
  uint8_t* out = (pl ? p.out[1] : p.out[0]) + o;
  const int mode = modes[i];
  if (!(mode & 4)) {
    *reinterpret_cast<uint2*>(out) = make_uint2(0u, 0u);
    return;
  }
  const int4 res =
      *reinterpret_cast<const int4*>((pl ? p.res[1] : p.res[0]) + o);
  const bool f = (mode & 1) != 0;
  const bool b = BIDIR && (mode & 2) != 0;
  uint2 pred = make_uint2(0u, 0u);
  if (f)
    pred = mp2v::halfpel_word2(
        (const uint32_t*)(pl ? p.ref0[1] : p.ref0[0]), Hr, nw,
        fm.sy[i] + ty, fm.sx[i], 2 * seg, fm.ph[i], 1);
  if (b) {
    const uint2 pb = mp2v::halfpel_word2(
        (const uint32_t*)(pl ? p.ref1[1] : p.ref1[0]), Hr, nw,
        bm.sy[i] + ty, bm.sx[i], 2 * seg, bm.ph[i], 1);
    pred = f ? make_uint2(__vavgu4(pred.x, pb.x), __vavgu4(pred.y, pb.y))
             : pb;
  }
  *reinterpret_cast<uint2*>(out) = make_uint2(
      add_clip4(pred.x, res.x, res.y), add_clip4(pred.y, res.z, res.w));
}

// Pointer order: csrc/mc_ptrs.cuh.  The luma forms read only index 0 of
// each plane pair; the frame forms leave the field tuples unread (null).
// Each form's launch: Frame takes mc_seg_kernel, Field mc_recon_kernel.

struct Frame {
  template <int TH, int TW, int NP>
  static void launch(const Planes& p, const DirMeta& fm, const DirMeta& bm,
                     const int32_t* modes, int n_mb, int mbw, int Hr, int Wr,
                     int bidir, cudaStream_t s) {
    constexpr int G = mbs_per_group(TW);
    constexpr long long TPG = TH * (TW / 8) * NP * G;  // threads per group
    const long long groups = (n_mb + G - 1) / G;
    const int blocks = (int)((groups * TPG + kThreads - 1) / kThreads);
    if (bidir)
      mc_seg_kernel<TH, TW, NP, true><<<blocks, kThreads, 0, s>>>(
          p, fm, bm, modes, n_mb, mbw, Hr, Wr >> 2);
    else
      mc_seg_kernel<TH, TW, NP, false><<<blocks, kThreads, 0, s>>>(
          p, fm, bm, modes, n_mb, mbw, Hr, Wr >> 2);
  }
};

struct Field {
  template <int TH, int TW, int NP>
  static void launch(const Planes& p, const DirMeta& fm, const DirMeta& bm,
                     const int32_t* modes, int n_mb, int mbw, int Hr, int Wr,
                     int bidir, cudaStream_t s) {
    const dim3 block(TW, TH, NP);
    if (bidir)
      mc_recon_kernel<TH, TW, true>
          <<<n_mb, block, 0, s>>>(p, fm, bm, modes, mbw, Hr, Wr);
    else
      mc_recon_kernel<TH, TW, false>
          <<<n_mb, block, 0, s>>>(p, fm, bm, modes, mbw, Hr, Wr);
  }
};

template <class Form, int TH, int TW, int NP>
int launch(const void* const* ptrs, int n_mb, int mbw, int Hr, int Wr,
           int bidir, void* stream) {
  if (n_mb > 0)
    Form::template launch<TH, TW, NP>(
        mp2v::planes_of(ptrs), mp2v::dir_meta(ptrs, 0),
        mp2v::dir_meta(ptrs, 1), mp2v::modes_of(ptrs), n_mb, mbw, Hr, Wr,
        bidir, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The luma forms take 16x16 tiles; the chroma forms the chroma tile of
// each format.  Any other tile is refused before a launch.
template <class Form, int NP>
int launch_tile(const void* const* ptrs, int th, int tw, int n_mb, int mbw,
                int Hr, int Wr, int bidir, void* stream) {
  if (th == 16 && tw == 16)
    return launch<Form, 16, 16, NP>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if constexpr (NP == 2) {
    if (th == 8 && tw == 8)
      return launch<Form, 8, 8, NP>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
    if (th == 16 && tw == 8)
      return launch<Form, 16, 8, NP>(ptrs, n_mb, mbw, Hr, Wr, bidir,
                                     stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int mp2v_mc_recon_luma(MP2V_MC_ARGS) {
  return launch_tile<Frame, 1>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_recon_uv(MP2V_MC_ARGS) {
  return launch_tile<Frame, 2>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_field_luma(MP2V_MC_ARGS) {
  return launch_tile<Field, 1>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_field_uv(MP2V_MC_ARGS) {
  return launch_tile<Field, 2>(MP2V_MC_FWD);
}
