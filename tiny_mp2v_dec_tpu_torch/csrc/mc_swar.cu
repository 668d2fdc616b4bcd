// K7: packed motion-compensated frame prediction, four pixels per 32-bit
// word (MP2V_MC_IMPL=swar).
//
// Replaces (bidir and forward-only forms):
//   K7  tiny_mp2v_dec_tpu/ops/mc_pallas.py fused_mc_pred_swar
//       (_make_kernel_swar + _gather_pred_swar, _avg_up; pallas_call at
//       :794), frame prediction.
// One component per call: luma 16x16, or one chroma plane at 8x8, 16x8 or
// 16x16.  Its field form K8 (fused_mc_pred_swar_field) is a form of the
// segment kernel of csrc/mc_recon.cu.
//
// Output word (y, wx) of the (H, W/4) plane holds pixels 4wx .. 4wx+3, the
// first at the least significant byte.  Its MB is i = (y / h) * mbw +
// wx / (w/4), and it is word k = wx % (w/4) of the MB's tile row: the
// funnel-shift taps and per-byte averages of csrc/swar_word.cuh, with c
// and d from the row below.  The bidir average stays packed too
// (__vavgu4).
// Mode bit 1 = forward, 2 = backward (bidir form only); neither gives 0.
// No residual and no coded bit: the caller adds the residual and masks
// uncoded MBs (ops/recon.py), as the JAX package's XLA epilogue does.
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

}  // namespace

// Pointer order: csrc/mc_ptrs.cuh; this reads ref0[0], ref1[0], out[0]
// (the word plane) and the per-MB frame vectors.
extern "C" int mp2v_mc_swar(MP2V_MC_ARGS) {
  if (th == 16 && tw == 16)
    return launch<16, 16>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 8 && tw == 8)
    return launch<8, 8>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  if (th == 16 && tw == 8)
    return launch<16, 8>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
  return (int)cudaErrorInvalidValue;
}
