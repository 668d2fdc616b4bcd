// K2 / K3: fused frame motion compensation + residual add + saturation.
//
// Replaces (frame prediction, bidir and forward-only forms):
//   K2  tiny_mp2v_dec_tpu/ops/mc_pallas.py fused_mc_recon_mxu
//       (_make_kernel_mxu + _gather_pred_mxu; pallas_call at :480), luma;
//   K3  tiny_mp2v_dec_tpu/ops/mc_pallas.py fused_mc_recon_uv_mxu, pair=True
//       (_gather_pred_pair_mxu; pallas_call at :523), both chroma planes.
//
// Per macroblock: the forward and backward (h, w) half-pel predictions at
// the clamped window starts (sy, sx) that mc_meta computed, each selecting
// one of a, (a+b+1)>>1, (a+c+1)>>1, ((a+b+1)>>1 + (c+d+1)>>1 + 1)>>1 by the
// 2-bit phase; mode bit 1 = forward, 2 = backward (read only by the bidir
// form), both = (pf+pb+1)>>1; then + int16 residual, clip to [0, 255],
// and 0 for an MB whose mode bit 4 (coded) is clear.  Stored as uint8.
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

namespace {

struct Planes {
  const uint8_t* ref0[2];
  const uint8_t* ref1[2];
  const int16_t* res[2];
  uint8_t* out[2];
};

struct MBMeta {
  const int32_t* syf;
  const int32_t* sxf;
  const int32_t* phf;
  const int32_t* syb;
  const int32_t* sxb;
  const int32_t* phb;
  const int32_t* mode;
};

__device__ __forceinline__ int tap(const uint8_t* __restrict__ ref, int Hr,
                                   int Wr, int y, int x) {
  return (y < Hr && x < Wr) ? (int)ref[(long long)y * Wr + x] : 0;
}

// One pixel of a unidirectional half-pel prediction; (y, x) >= 0 because
// window starts arrive clamped to [0, Hr-h] x [0, Wr-w].
__device__ __forceinline__ int halfpel(const uint8_t* __restrict__ ref,
                                       int Hr, int Wr, int y, int x, int ph) {
  const int a = tap(ref, Hr, Wr, y, x);
  switch (ph & 3) {
    case 0:
      return a;
    case 1:
      return (a + tap(ref, Hr, Wr, y, x + 1) + 1) >> 1;
    case 2:
      return (a + tap(ref, Hr, Wr, y + 1, x) + 1) >> 1;
    default: {
      const int b = tap(ref, Hr, Wr, y, x + 1);
      const int c = tap(ref, Hr, Wr, y + 1, x);
      const int d = tap(ref, Hr, Wr, y + 1, x + 1);
      const int ab = (a + b + 1) >> 1;
      const int cd = (c + d + 1) >> 1;
      return (ab + cd + 1) >> 1;
    }
  }
}

// blockDim = (TW, TH, NP); blockIdx.x = macroblock (row-major).
template <int TH, int TW, int NP, bool BIDIR>
__global__ void mc_recon_kernel(Planes p, MBMeta m, int mbw, int Hr,
                                int Wr) {
  const int i = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y, pl = threadIdx.z;
  const int W = mbw * TW;
  const long long o =
      (long long)((i / mbw) * TH + ty) * W + (i % mbw) * TW + tx;
  const int mode = m.mode[i];
  int val = 0;
  if (mode & 4) {
    const bool f = (mode & 1) != 0;
    const bool b = BIDIR && (mode & 2) != 0;
    int pf = 0, pb = 0;
    if (f) pf = halfpel(p.ref0[pl], Hr, Wr, m.syf[i] + ty, m.sxf[i] + tx,
                        m.phf[i]);
    if (b) pb = halfpel(p.ref1[pl], Hr, Wr, m.syb[i] + ty, m.sxb[i] + tx,
                        m.phb[i]);
    const int pred = (f && b) ? (pf + pb + 1) >> 1 : (f ? pf : pb);
    val = min(max(pred + (int)p.res[pl][o], 0), 255);
  }
  p.out[pl][o] = (uint8_t)val;
}

template <int TH, int TW, int NP>
int launch(const void* const* ptrs, int n_mb, int mbw, int Hr, int Wr,
           int bidir, void* stream) {
  Planes p;
  for (int k = 0; k < 2; ++k) {
    p.ref0[k] = (const uint8_t*)ptrs[0 + k];
    p.ref1[k] = (const uint8_t*)ptrs[2 + k];
    p.res[k] = (const int16_t*)ptrs[4 + k];
    p.out[k] = (uint8_t*)ptrs[6 + k];
  }
  MBMeta m{(const int32_t*)ptrs[8],  (const int32_t*)ptrs[9],
           (const int32_t*)ptrs[10], (const int32_t*)ptrs[11],
           (const int32_t*)ptrs[12], (const int32_t*)ptrs[13],
           (const int32_t*)ptrs[14]};
  if (n_mb > 0) {
    const dim3 block(TW, TH, NP);
    cudaStream_t s = (cudaStream_t)stream;
    if (bidir)
      mc_recon_kernel<TH, TW, NP, true><<<n_mb, block, 0, s>>>(p, m, mbw, Hr,
                                                              Wr);
    else
      mc_recon_kernel<TH, TW, NP, false><<<n_mb, block, 0, s>>>(p, m, mbw,
                                                               Hr, Wr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Pointer order (15): ref0[2], ref1[2], res[2], out[2], syf, sxf, phf, syb,
// sxb, phb, mode.  The luma form reads only index 0 of each plane pair.
#define MP2V_MC_ARGS                                                        \
  const void *r0a, const void *r0b, const void *r1a, const void *r1b,       \
      const void *resa, const void *resb, void *outa, void *outb,           \
      const void *syf, const void *sxf, const void *phf, const void *syb,   \
      const void *sxb, const void *phb, const void *mode, int n_mb, int mbw, \
      int Hr, int Wr, int bidir, void *stream
#define MP2V_MC_PTRS                                                     \
  const void* ptrs[15] = {r0a, r0b, r1a, r1b, resa, resb, outa, outb, syf, \
                          sxf, phf, syb, sxb, phb, mode}

extern "C" int mp2v_mc_recon_luma(MP2V_MC_ARGS) {
  MP2V_MC_PTRS;
  return launch<16, 16, 1>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
}

extern "C" int mp2v_mc_recon_uv(MP2V_MC_ARGS) {
  MP2V_MC_PTRS;
  return launch<8, 8, 2>(ptrs, n_mb, mbw, Hr, Wr, bidir, stream);
}
