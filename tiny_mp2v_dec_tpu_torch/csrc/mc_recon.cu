// K2 / K3 / K4: fused motion compensation + residual add + saturation.
//
// Replaces (bidir and forward-only forms):
//   K2  tiny_mp2v_dec_tpu/ops/mc_pallas.py fused_mc_recon_mxu
//       (_make_kernel_mxu + _gather_pred_mxu; pallas_call at :480), luma;
//   K3  tiny_mp2v_dec_tpu/ops/mc_pallas.py fused_mc_recon_uv_mxu
//       (_gather_pred_pair_mxu; pallas_call at :523), both chroma planes,
//       at the chroma tile of every format: 8x8 (4:2:0), 16x8 (4:2:2) and
//       16x16 (4:4:4);
//   K4  the field form of both, _field_pred_mxu (mc_pallas.py:353), which
//       the JAX kernels select per MB by mode bit 8 (:397-412).
//
// Per macroblock: the forward and backward (h, w) half-pel predictions at
// the clamped window starts (sy, sx) that mc_meta computed, each selecting
// one of a, (a+b+1)>>1, (a+c+1)>>1, ((a+b+1)>>1 + (c+d+1)>>1 + 1)>>1 by the
// 2-bit phase; mode bit 1 = forward, 2 = backward (read only by the bidir
// form), both = (pf+pb+1)>>1; then + int16 residual, clip to [0, 255],
// and 0 for an MB whose mode bit 4 (coded) is clear.  Stored as uint8.
//
// Field prediction (the FIELD form, MBs with mode bit 8): output row ty of
// the tile belongs to unit r = ty & 1, whose taps are frame rows ty + C_r
// and ty + C_r + 2 (the next row of the same field) at columns sx_r + tx
// and sx_r + tx + 1, with phase ph_r — (C_r, sx_r, ph_r) from
// mc_field_meta, C_r = 2*syf_r + sel_r - r.  Frame row ty + C_r is field
// row syf_r + (ty >> 1) of field sel_r, so this reads exactly what the
// JAX package's padded field views hold, and its zero row is the frame's
// rows >= Hr.  The TPU kernel evaluated both units for every row and
// selected by parity afterwards (a vector trick); here each thread
// computes only its own unit, and so never reads row C_1 = -1.  MBs
// without bit 8 take the frame prediction unchanged.
//
// What bounds it on an H100: memory and per-MB latency, not arithmetic.
// A 1080p luma plane is 2 MB out, 4 MB of residual in and up to 2 x 2 MB of
// reference reads (the window overlap of neighbouring MBs hits in L1/L2);
// the work per pixel is a handful of integer adds.
//
// Design: one thread block per macroblock and one thread per output pixel;
// the chroma form runs U and V as the two z-slices of one block, sharing
// the MB's window start, phase and mode, with each plane kept planar.  Each
// thread reads its (up to 4) taps per direction straight from the
// reference plane in device memory; neighbouring threads read neighbouring
// bytes.  A tap at row >= Hr or column >= Wr reads 0 — the zero pad of
// pad_ref_plane / golden.mc.pad_for_mc — so no padded copy of a reference
// plane is ever made.  The TPU kernel's one-hot MXU matmuls, 128-lane
// aligned loads and rolls were Mosaic workarounds and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_ptrs.cuh"

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

// Pixel (ty, tx) of MB i's prediction in one direction.
template <bool FIELD>
__device__ __forceinline__ int predict(const uint8_t* __restrict__ ref,
                                       const DirMeta& d, int i, int mode,
                                       int ty, int tx, int Hr, int Wr) {
  if (FIELD && (mode & 8)) {
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

// blockDim = (TW, TH, NP); blockIdx.x = macroblock (row-major).
template <int TH, int TW, bool BIDIR, bool FIELD>
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
      pf = predict<FIELD>(pl ? p.ref0[1] : p.ref0[0], fm, i, mode, ty, tx,
                          Hr, Wr);
    if (b)
      pb = predict<FIELD>(pl ? p.ref1[1] : p.ref1[0], bm, i, mode, ty, tx,
                          Hr, Wr);
    const int pred = (f && b) ? (pf + pb + 1) >> 1 : (f ? pf : pb);
    val = min(max(pred + (int)(pl ? p.res[1] : p.res[0])[o], 0), 255);
  }
  (pl ? p.out[1] : p.out[0])[o] = (uint8_t)val;
}

// Pointer order: csrc/mc_ptrs.cuh.  The luma forms read only index 0 of
// each plane pair; the frame forms leave the field tuples unread (null).

template <int TH, int TW, int NP, bool FIELD>
int launch(const void* const* ptrs, int n_mb, int mbw, int Hr, int Wr,
           int bidir, void* stream) {
  const Planes p = mp2v::planes_of(ptrs);
  const DirMeta fm = mp2v::dir_meta(ptrs, 0), bm = mp2v::dir_meta(ptrs, 1);
  const int32_t* modes = mp2v::modes_of(ptrs);
  if (n_mb > 0) {
    const dim3 block(TW, TH, NP);
    cudaStream_t s = (cudaStream_t)stream;
    if (bidir)
      mc_recon_kernel<TH, TW, true, FIELD>
          <<<n_mb, block, 0, s>>>(p, fm, bm, modes, mbw, Hr, Wr);
    else
      mc_recon_kernel<TH, TW, false, FIELD>
          <<<n_mb, block, 0, s>>>(p, fm, bm, modes, mbw, Hr, Wr);
  }
  return (int)cudaGetLastError();
}

// The luma forms take 16x16 tiles; the chroma forms the chroma tile of
// each format.  Any other tile is refused before a launch.
template <int NP, bool FIELD>
int launch_tile(const void* const* ptrs, int th, int tw, int n_mb, int mbw,
                int Hr, int Wr, int bidir, void* stream) {
  if (th == 16 && tw == 16)
    return launch<16, 16, NP, FIELD>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if constexpr (NP == 2) {
    if (th == 8 && tw == 8)
      return launch<8, 8, NP, FIELD>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
    if (th == 16 && tw == 8)
      return launch<16, 8, NP, FIELD>(ptrs, n_mb, mbw, Hr, Wr, bidir,
                                      stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int mp2v_mc_recon_luma(MP2V_MC_ARGS) {
  return launch_tile<1, false>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_recon_uv(MP2V_MC_ARGS) {
  return launch_tile<2, false>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_field_luma(MP2V_MC_ARGS) {
  return launch_tile<1, true>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_field_uv(MP2V_MC_ARGS) {
  return launch_tile<2, true>(MP2V_MC_FWD);
}
