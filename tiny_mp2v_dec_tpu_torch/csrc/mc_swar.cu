// K7 / K8: packed motion-compensated prediction, four pixels per 32-bit
// word (MP2V_MC_IMPL=swar).
//
// Replaces (bidir and forward-only forms):
//   K7  tiny_mp2v_dec_tpu/ops/mc_pallas.py fused_mc_pred_swar
//       (_make_kernel_swar + _gather_pred_swar, _avg_up; pallas_call at
//       :794), frame prediction;
//   K8  fused_mc_pred_swar_field (_field_pred_swar; pallas_call at :832),
//       frame or field prediction per MB by mode bit 8.
// One component per call: luma 16x16, or one chroma plane at 8x8, 16x8 or
// 16x16.
//
// Output word (y, wx) of the (H, W/4) plane holds pixels 4wx .. 4wx+3, the
// first at the least significant byte.  Its MB is i = (y / h) * mbw +
// wx / (w/4), and it is word k = wx % (w/4) of the MB's tile row: the
// funnel-shift taps and per-byte averages of csrc/swar_word.cuh, with c
// and d from the row below (two rows below for field prediction).  The
// bidir average stays packed too (__vavgu4).
// Mode bit 1 = forward, 2 = backward (bidir form only); neither gives 0.
// No residual and no coded bit: the caller adds the residual and masks
// uncoded MBs (ops/recon.py), as the JAX package's XLA epilogue does.
//
// Field prediction (K8, MBs with mode bit 8): output row ty belongs to
// unit r = ty & 1, whose taps are frame rows C_r + ty and C_r + ty + 2 at
// columns from sx_r, with phase ph_r ((C_r, sx_r, ph_r) from
// mc_field_meta), as K4 maps them (csrc/mc_recon.cu).  Each thread takes
// only its own unit, so it never reads row C_1 = -1, which the TPU kernel
// reads and then masks.
//
// Reference planes are read unpadded as (Hr, Wr/4) words: a word at or
// past Wr/4, or a row at or past Hr, reads 0 (the zero pad of
// pad_ref_words).  JAX's 512-pixel load granules were a Mosaic rule.
//
// What bounds it on an H100: memory.  Each thread reads 2 or 4 words per
// direction and writes one; neighbouring threads read neighbouring words,
// so the loads coalesce, and the plane is 1/4 the threads of K2's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_ptrs.cuh"
#include "swar_word.cuh"

namespace {

using mp2v::DirMeta;
using mp2v::halfpel_word;

template <bool FIELD>
__device__ __forceinline__ uint32_t predict(const uint32_t* __restrict__ ref,
                                            const DirMeta& d, int i,
                                            int mode, int ty, int k, int Hr,
                                            int nw) {
  if (FIELD && (mode & 8)) {
    // selects, not a run-time index into the parameter arrays, which would
    // copy them to local memory
    const bool r = ty & 1;
    const int32_t* fc = r ? d.fc[1] : d.fc[0];
    const int32_t* fx = r ? d.fx[1] : d.fx[0];
    const int32_t* fp = r ? d.fp[1] : d.fp[0];
    return halfpel_word(ref, Hr, nw, fc[i] + ty, fx[i], k, fp[i], 2);
  }
  return halfpel_word(ref, Hr, nw, d.sy[i] + ty, d.sx[i], k, d.ph[i], 1);
}

// One thread per output word; 2-D grid over the (H, W/4) word plane.
template <int TH, int TW, bool BIDIR, bool FIELD>
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
  const uint32_t pf = f ? predict<FIELD>(ref0, fm, i, mode, ty, k, Hr, nw) : 0u;
  const uint32_t pb = b ? predict<FIELD>(ref1, bm, i, mode, ty, k, Hr, nw) : 0u;
  out[(long long)y * nout + wx] = (f && b) ? __vavgu4(pf, pb) : (f ? pf : pb);
}

constexpr int BX = 32, BY = 8;

template <int TH, int TW, bool FIELD>
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
      mc_swar_kernel<TH, TW, true, FIELD><<<grid, block, 0, s>>>(
          ref0, ref1, out, fm, bm, modes, mbw, H, Hr, Wr >> 2);
    else
      mc_swar_kernel<TH, TW, false, FIELD><<<grid, block, 0, s>>>(
          ref0, ref1, out, fm, bm, modes, mbw, H, Hr, Wr >> 2);
  }
  return (int)cudaGetLastError();
}

template <bool FIELD>
int launch_tile(MP2V_MC_ARGS) {
  if (th == 16 && tw == 16)
    return launch<16, 16, FIELD>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 8 && tw == 8)
    return launch<8, 8, FIELD>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 16 && tw == 8)
    return launch<16, 8, FIELD>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Pointer order: csrc/mc_ptrs.cuh; these read ref0[0], ref1[0], out[0]
// (the word plane), the per-MB vectors and, for K8, the field tuples.
extern "C" int mp2v_mc_swar(MP2V_MC_ARGS) {
  return launch_tile<false>(MP2V_MC_FWD);
}

extern "C" int mp2v_mc_swar_field(MP2V_MC_ARGS) {
  return launch_tile<true>(MP2V_MC_FWD);
}
