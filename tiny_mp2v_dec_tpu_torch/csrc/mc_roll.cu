// K5 / K6: fused motion compensation + residual add + saturation through a
// window staged in shared memory (MP2V_MC_IMPL=roll).
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
// and rotates the misalignment away in registers (pltpu.roll), then takes
// all four taps from the rotated copy.  The Hopper form keeps that idea:
// one thread block per MB (U and V as the two z-slices of K6's block)
// stages each direction's (h+1) x (w+1)-pixel window into shared memory
// with 32-bit loads from the word-aligned column sx & ~3, neighbouring
// threads on neighbouring words; after __syncthreads() each thread reads
// its four taps from shared memory at byte offset sx & 3.  Words at or past
// Wr and rows at or past Hr stage as 0, the zero pad of pad_for_mc.  A
// direction the MB does not use, and every direction of an uncoded MB, is
// not staged (mode is uniform across the block).
//
// What bounds it on an H100: memory and per-MB latency, as K2: each MB
// reads at most 2 x (h+1) x ceil((w+4)/4) words of reference and h x w
// residual pixels, and writes h x w bytes; the work per pixel is a few
// integer adds.  Against K2 the staging replaces up to 8 scattered byte
// reads per pixel with one coalesced word load per 4 pixels, at the cost of
// a block-wide barrier.  No wgmma or TMA: the tiles are a few hundred
// bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_ptrs.cuh"

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

// blockDim = (TW, TH, NP); blockIdx.x = macroblock (row-major).
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

}  // namespace

// K5: luma, 16x16 tiles only.  Any other tile is refused before a launch.
extern "C" int mp2v_mc_roll_luma(MP2V_MC_ARGS) {
  if (th == 16 && tw == 16)
    return launch<16, 16, 1>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
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
