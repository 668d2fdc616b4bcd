// Native slice tokenizer for tiny_mp2v_dec_tpu.
//
// The production host-side hot path: bit-serial VLC decode of the MPEG-2
// macroblock layer with all sequential state (PMV prediction, DC prediction,
// quantiser tracking, skipped-MB semantics) resolved here, emitting the
// dense per-picture tensors the device reconstruction consumes.  Slices are
// independently decodable, so worker threads claim slices off an atomic
// counter — the same parallel grain the reference uses for its thread pool
// (reference: src/core/threads.cpp:138-159, decoder.cpp:316-318).
//
// Semantics mirror tiny_mp2v_dec_tpu/tokenizer/python_tok.py exactly (the
// golden model); cross-implementation parity is enforced by tests over
// randomized streams.  Decode LUTs are built at load time from the canonical
// Annex-B tables generated out of vlc/tables.py (vlc_tables.inc).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC tokenizer.cpp -o _tokenizer.so

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct VlcEntry { uint32_t code; uint8_t len; int16_t value; };
struct CoeffEntry { uint32_t code; uint8_t len; uint8_t run; uint8_t level; };

#include "vlc_tables.inc"

// ---------------------------------------------------------------------------
// Flat decode LUTs (single peek per symbol)
// ---------------------------------------------------------------------------
template <int MAXLEN>
struct VlcLut {
  std::vector<int16_t> value;
  std::vector<uint8_t> len;
  void build(const VlcEntry* entries, size_t n) {
    value.assign(size_t(1) << MAXLEN, -1);
    len.assign(size_t(1) << MAXLEN, 0);
    for (size_t e = 0; e < n; ++e) {
      uint32_t base = entries[e].code << (MAXLEN - entries[e].len);
      uint32_t span = 1u << (MAXLEN - entries[e].len);
      for (uint32_t i = 0; i < span; ++i) {
        value[base + i] = entries[e].value;
        len[base + i] = entries[e].len;
      }
    }
  }
};

struct CoeffLut {
  // packed: run<<24 | level<<8 | len  (run 64=EOB, 65=escape)
  std::vector<uint32_t> packed;
  void build(const CoeffEntry* entries, size_t n) {
    packed.assign(size_t(1) << 16, 0);
    for (size_t e = 0; e < n; ++e) {
      uint32_t base = entries[e].code << (16 - entries[e].len);
      uint32_t span = 1u << (16 - entries[e].len);
      uint32_t v = (uint32_t(entries[e].run) << 24) |
                   (uint32_t(entries[e].level) << 8) | entries[e].len;
      for (uint32_t i = 0; i < span; ++i) packed[base + i] = v;
    }
  }
};

struct Tables {
  VlcLut<11> mba;
  VlcLut<9> mbtype[4];  // index by picture_coding_type 1..3
  VlcLut<9> cbp;
  VlcLut<11> motion;
  VlcLut<2> dmv;
  VlcLut<10> dc_luma, dc_chroma;
  CoeffLut coeff0, coeff1;
  Tables() {
    mba.build(kMbaEntries, sizeof(kMbaEntries) / sizeof(VlcEntry));
    mbtype[1].build(kMbTypeEntries1, sizeof(kMbTypeEntries1) / sizeof(VlcEntry));
    mbtype[2].build(kMbTypeEntries2, sizeof(kMbTypeEntries2) / sizeof(VlcEntry));
    mbtype[3].build(kMbTypeEntries3, sizeof(kMbTypeEntries3) / sizeof(VlcEntry));
    cbp.build(kCbpEntries, sizeof(kCbpEntries) / sizeof(VlcEntry));
    motion.build(kMotionEntries, sizeof(kMotionEntries) / sizeof(VlcEntry));
    dmv.build(kDmvEntries, sizeof(kDmvEntries) / sizeof(VlcEntry));
    dc_luma.build(kDcLumaEntries, sizeof(kDcLumaEntries) / sizeof(VlcEntry));
    dc_chroma.build(kDcChromaEntries, sizeof(kDcChromaEntries) / sizeof(VlcEntry));
    coeff0.build(kCoeff0Entries, sizeof(kCoeff0Entries) / sizeof(CoeffEntry));
    coeff1.build(kCoeff1Entries, sizeof(kCoeff1Entries) / sizeof(CoeffEntry));
  }
};
const Tables& tables() { static Tables t; return t; }

// ---------------------------------------------------------------------------
// Bit reader: 64-bit shift register, refilled 32 bits at a time, MSB-first;
// reads past the buffer end yield zero bits (same design as the reference's
// bitstream_reader_c, src/core/bitstream.h:22-64).
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* data;
  size_t size;        // bytes
  size_t byte_pos;    // next byte to load
  uint64_t buf = 0;   // top `bits` bits valid (MSB-aligned at bit 63)
  int bits = 0;

  BitReader(const uint8_t* d, size_t n, uint64_t bit_pos) : data(d), size(n) {
    byte_pos = bit_pos >> 3;
    int skew = int(bit_pos & 7);
    fill();
    if (skew) skip(skew);
  }
  void fill() {
    while (bits <= 32) {
      uint32_t w = 0;
      if (byte_pos + 4 <= size) {
        w = (uint32_t(data[byte_pos]) << 24) | (uint32_t(data[byte_pos + 1]) << 16) |
            (uint32_t(data[byte_pos + 2]) << 8) | uint32_t(data[byte_pos + 3]);
        byte_pos += 4;
      } else {
        for (int i = 0; i < 4; ++i) {
          w <<= 8;
          if (byte_pos < size) w |= data[byte_pos++]; else byte_pos++;
        }
      }
      buf |= uint64_t(w) << (32 - bits);
      bits += 32;
    }
  }
  inline uint32_t peek(int n) const {
    return n ? uint32_t(buf >> (64 - n)) : 0;
  }
  inline void skip(int n) {
    buf <<= n;
    bits -= n;
    if (bits <= 32) fill();
  }
  inline uint32_t read(int n) {
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

// ---------------------------------------------------------------------------
// Parameter / output structs (C ABI, mirrored in native.py)
// ---------------------------------------------------------------------------
extern "C" {
struct PicParams {
  int32_t picture_coding_type;
  int32_t f_code[2][2];
  int32_t intra_dc_precision;
  int32_t picture_structure;
  int32_t frame_pred_frame_dct;
  int32_t concealment_motion_vectors;
  int32_t q_scale_type;
  int32_t intra_vlc_format;
  int32_t alternate_scan;
  int32_t chroma_format;
  int32_t vertical_size;
  int32_t mb_width;
  int32_t mb_height;
  uint8_t quant_matrices[4][64];  // raster order
};

struct TokenOut {
  // Sparse coefficient emission: coded block k occupies cblk[k*64..k*64+63]
  // with global block index cblk_idx[k] (= mb * n_blk + slot); *cblk_count
  // is the shared row counter, claimed atomically by slice threads.
  int16_t* cblk;      // (n_mb * n_blk, 64) capacity
  int32_t* cblk_idx;  // (n_mb * n_blk,) capacity
  int32_t* cblk_count;
  uint8_t* intra;
  uint8_t* fwd;
  uint8_t* bwd;
  uint8_t* field_pred;
  uint8_t* dct_type;
  uint8_t* coded;
  int16_t* mv;      // (n_mb, 2, 2, 2)
  uint8_t* mvfs;    // (n_mb, 2, 2)
  // capacity of cblk/cblk_idx in rows; claims past it are a stream error
  // (e.g. duplicated slice vertical positions re-coding the same MB rows),
  // not a buffer overrun
  int32_t cblk_capacity;
  // per claimed row: number of nonzero coefficients, filled DURING the
  // parse — the pair-packing fill stage then needs no counting re-read of
  // the (cold by then) coefficient rows
  uint8_t* row_nnz;
};
}  // extern "C"

constexpr int kMbQuant = 0x20, kMbFwd = 0x10, kMbBwd = 0x08;
constexpr int kMbPattern = 0x04, kMbIntra = 0x02;
constexpr int PT_FIELD = 0, PT_FRAME = 1, PT_DUAL_PRIME = 2, PT_16X8 = 3;

// bitstream block index -> token slot, per chroma format
static const int kSlot420[6] = {0, 1, 2, 3, 4, 5};
static const int kSlot422[8] = {0, 1, 2, 3, 4, 6, 5, 7};
static const int kSlot444[12] = {0, 1, 2, 3, 4, 8, 6, 10, 5, 9, 7, 11};

inline int quantiser_scale(int code, int q_scale_type) {
  if (!q_scale_type) return code << 1;
  if (code < 9) return code;
  if (code < 17) return (code - 4) << 1;
  if (code < 25) return (code - 10) << 2;
  return (code - 17) << 3;
}

struct SliceState {
  int32_t pmv[2][2][2];
  int dc_pred[3];
  int qscale;
  bool prev_fwd = false, prev_bwd = false;
};

template <int MAXLEN>
inline int decode_vlc(BitReader& r, const VlcLut<MAXLEN>& lut, int* err) {
  uint32_t peek = r.peek(MAXLEN);
  uint8_t len = lut.len[peek];
  if (!len) { *err = 1; return 0; }
  r.skip(len);
  return lut.value[peek];
}

inline int decode_motion_delta(BitReader& r, int f_code, int* err) {
  int code = decode_vlc(r, tables().motion, err) - 16;
  if (f_code != 1 && code != 0) {
    int residual = int(r.read(f_code - 1));
    int delta = (std::abs(code) - 1) * (1 << (f_code - 1)) + residual + 1;
    return code < 0 ? -delta : delta;
  }
  return code;
}

inline int update_motion_predictor(SliceState& st, int r_idx, int s, int t,
                                   int delta, int f_code, bool field_in_frame) {
  int fsize = 1 << (f_code - 1);
  int high = 16 * fsize - 1, low = -16 * fsize, range = 32 * fsize;
  int prediction = st.pmv[r_idx][s][t];
  if (field_in_frame && t == 1) prediction >>= 1;
  int mv = prediction + delta;
  if (mv < low) mv += range;
  if (mv > high) mv -= range;
  st.pmv[r_idx][s][t] = (field_in_frame && t == 1) ? mv * 2 : mv;
  return mv;
}

static void parse_motion_vector(BitReader& r, SliceState& st, int r_idx, int s,
                                const int32_t f_code_s[2], int16_t mv_out[2],
                                bool field_in_frame, bool dmv, int* err) {
  for (int t = 0; t < 2; ++t) {
    int delta = decode_motion_delta(r, f_code_s[t], err);
    mv_out[t] = int16_t(update_motion_predictor(st, r_idx, s, t, delta,
                                                f_code_s[t], field_in_frame));
    if (dmv) decode_vlc(r, tables().dmv, err);  // parse-only
  }
}

static int parse_block(BitReader& r, const PicParams& p, SliceState& st,
                       int16_t* out64, bool intra, bool luma, int chroma_idx,
                       bool use_chroma_w, int* err) {
  // returns the number of nonzero values written (the row's pair count)
  const uint8_t* scan = p.alternate_scan ? kScanRaster1 : kScanRaster0;
  // Reference-compat: chroma quant matrices (W[2]/W[3]) apply only to the
  // 4:2:2/4:4:4 extension blocks (bitstream index >= 6); the first chroma
  // pair always uses W[0]/W[1] (reference: mb_decoder.cpp:177-196).
  int w_sel = use_chroma_w ? (intra ? 2 : 3) : (intra ? 0 : 1);
  const uint8_t* W = p.quant_matrices[w_sel];
  int qs = st.qscale;
  bool use_one = p.intra_vlc_format && intra;
  const CoeffLut& clut = use_one ? tables().coeff1 : tables().coeff0;
  int parity = 0;
  int nnz = 0;
  int i;

  if (intra) {
    int size = luma ? decode_vlc(r, tables().dc_luma, err)
                    : decode_vlc(r, tables().dc_chroma, err);
    int diff = 0;
    if (size) {
      int bitsv = int(r.read(size));
      int half = 1 << (size - 1);
      diff = bitsv >= half ? bitsv : bitsv + 1 - 2 * half;
    }
    int comp = luma ? 0 : chroma_idx;
    st.dc_pred[comp] += diff;
    int dc = st.dc_pred[comp] << (3 - p.intra_dc_precision);
    out64[0] = int16_t(dc);
    nnz += int16_t(dc) != 0;
    // intra DC is excluded from the mismatch-control sum (matches the
    // reference, which accumulates parity only over parse_block output,
    // mb_decoder.cpp:74-155)
    i = 1;
  } else {
    i = 0;
    if (!use_one && r.peek(1) == 1) {
      // B.14 first-coefficient short form '1s'
      r.skip(1);
      int sign = int(r.read(1));
      // reference applies NO saturation here (mb_decoder.cpp:80-87,
      // int16 val stored directly); max 3*255*112>>5 = 2677 fits int16
      int val = (3 * W[0] * qs) >> 5;
      if (sign) val = -val;
      out64[0] = int16_t(val);
      nnz += val != 0;
      parity += val;
      i = 1;
    }
  }

  for (;;) {
    uint32_t peek = r.peek(16);
    uint32_t packed = clut.packed[peek];
    int len = packed & 0xFF;
    if (!len) { *err = 1; return nnz; }
    int run = int(packed >> 24);
    int level, sign;
    if (run == 64) { r.skip(len); break; }  // EOB
    if (run == 65) {                        // escape
      r.skip(len);
      run = int(r.read(6));
      level = int(r.read(12));
      if (level & 0x800) level -= 0x1000;
      sign = level < 0;
      level = std::abs(level);
    } else {
      level = int((packed >> 8) & 0xFFFF);
      r.skip(len);
      sign = int(r.read(1));
    }
    i += run;
    if (i > 63) { *err = 2; return nnz; }
    int raster = scan[i];
    int val = intra ? ((level * W[raster] * qs) >> 4)
                    : (((2 * level + 1) * W[raster] * qs) >> 5);
    if (sign) val = -val;
    // reference saturation (mb_decoder.cpp:146): std::min/max<int16_t>
    // convert the int32 product to int16 FIRST (wraparound), then clamp
    val = int16_t(uint16_t(val));
    if (val > 2047) val = 2047;
    if (val < -2048) val = -2048;
    out64[kTranspose64[raster]] = int16_t(val);
    nnz += val != 0;
    parity += val;
    ++i;
  }

  if ((parity & 1) == 0) {  // mismatch control (spec 7.4.4)
    int16_t before = out64[63];
    out64[63] = before ^ 1;
    nnz += int((before ^ 1) != 0) - int(before != 0);
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// Slice tokenizer (mirrors python_tok.tokenize_slice)
// ---------------------------------------------------------------------------
static int tokenize_slice(const uint8_t* data, size_t len, uint64_t bit_pos,
                          int start_code, const PicParams& p, TokenOut& out,
                          int tolerate = 0) {
  BitReader r(data, len, bit_pos);
  int err = 0;

  // slice header (spec 6.2.4)
  int vertical_ext = 0;
  if (p.vertical_size > 2800) vertical_ext = int(r.read(3));
  int qcode = int(r.read(5));
  if (r.peek(1) == 1) {
    r.skip(1);       // slice_extension_flag
    r.skip(1 + 1 + 6);  // intra_slice, slice_picture_id_enable, slice_picture_id
    while (r.peek(1) == 1) r.skip(9);
  }
  r.skip(1);  // extra_bit_slice

  SliceState st;
  std::memset(st.pmv, 0, sizeof(st.pmv));
  for (int c = 0; c < 3; ++c) st.dc_pred[c] = 1 << (p.intra_dc_precision + 7);
  st.qscale = quantiser_scale(qcode, p.q_scale_type);

  int mb_row = (vertical_ext << 7) + (start_code & 0xFF) - 1;
  const int pct = p.picture_coding_type;
  const bool frame_pic = p.picture_structure == 3;
  const bool fpfd = p.frame_pred_frame_dct != 0;
  const bool cmv = p.concealment_motion_vectors != 0;
  const int cf = p.chroma_format;
  const int n_cb = cf == 1 ? 1 : (cf == 2 ? 2 : 4);
  const int n_blocks = 4 + 2 * n_cb;
  const int* slot = cf == 1 ? kSlot420 : (cf == 2 ? kSlot422 : kSlot444);
  // In tolerant mode a slice's writes are confined to its own MB row
  // (13818-2 6.1.2: a slice shall not span macroblock rows), so a
  // corrupted address increment cannot clobber MBs another slice thread
  // already wrote; strict mode keeps the whole-picture bound (the error
  // aborts the picture anyway).
  const int n_mb_total = tolerate ? (mb_row + 1) * p.mb_width
                                  : p.mb_width * p.mb_height;
  int64_t mb_addr = int64_t(mb_row) * p.mb_width - 1;

  bool first_mb = true;
  for (;;) {
    // macroblock_address_increment (+ escapes)
    int increment = 0;
    for (;;) {
      int v = decode_vlc(r, tables().mba, &err);
      if (err) return err;
      if (v == 99) { increment += 33; } else { increment += v; break; }
    }

    // skipped macroblocks (spec 7.6.6)
    if (increment > 1) {
      if (pct == 2) std::memset(st.pmv, 0, sizeof(st.pmv));
      for (int k = 0; k < increment - 1; ++k) {
        ++mb_addr;
        if (first_mb) continue;
        if (mb_addr < 0 || mb_addr >= n_mb_total) return 3;
        size_t m = size_t(mb_addr);
        out.coded[m] = 1;
        out.dct_type[m] = 0;
        int16_t* mvp = out.mv + m * 8;
        if (pct == 2) {
          out.fwd[m] = 1;
          std::memset(mvp, 0, 8 * sizeof(int16_t));
        } else if (pct == 3) {
          out.fwd[m] = st.prev_fwd;
          out.bwd[m] = st.prev_bwd;
          mvp[0] = int16_t(st.pmv[0][0][0]);
          mvp[1] = int16_t(st.pmv[0][0][1]);
          mvp[2] = int16_t(st.pmv[0][1][0]);
          mvp[3] = int16_t(st.pmv[0][1][1]);
        }
      }
      ++mb_addr;
    } else {
      mb_addr += increment;
    }
    first_mb = false;
    if (mb_addr < 0 || mb_addr >= n_mb_total) return 3;
    size_t m = size_t(mb_addr);

    // macroblock modes
    int mb_type = decode_vlc(r, tables().mbtype[pct], &err);
    if (err) return err;
    bool intra = mb_type & kMbIntra;
    bool has_fwd = mb_type & kMbFwd;
    bool has_bwd = mb_type & kMbBwd;
    bool pattern = mb_type & kMbPattern;

    int motion_type = 2;
    if (has_fwd || has_bwd) {
      if (frame_pic) {
        if (!fpfd) motion_type = int(r.read(2));
      } else {
        motion_type = int(r.read(2));
      }
    }
    bool dct_type = false;
    if (frame_pic && !fpfd && (intra || pattern)) dct_type = r.read(1) != 0;

    int mv_count, pred_type;
    bool mv_field, dmv = false;
    if (intra) {
      mv_count = cmv ? 1 : 0;  // concealment MVs: one vector (table 6-17)
      mv_field = !frame_pic;
      pred_type = frame_pic ? PT_FRAME : PT_FIELD;
    } else {
      mv_count = 1;
      if (frame_pic) {
        if (motion_type == 1) { mv_count = 2; mv_field = true; pred_type = PT_FIELD; }
        else if (motion_type == 3) { mv_field = true; pred_type = PT_DUAL_PRIME; dmv = true; }
        else { mv_field = false; pred_type = PT_FRAME; }
      } else {
        if (motion_type == 2) { mv_count = 2; mv_field = true; pred_type = PT_16X8; }
        else if (motion_type == 3) { mv_field = true; pred_type = PT_DUAL_PRIME; dmv = true; }
        else { mv_field = true; pred_type = PT_FIELD; }
      }
    }

    if (mb_type & kMbQuant)
      st.qscale = quantiser_scale(int(r.read(5)), p.q_scale_type);

    // motion vectors
    int16_t mvs[2][2][2];
    uint8_t mvfs[2][2];
    std::memset(mvs, 0, sizeof(mvs));
    std::memset(mvfs, 0, sizeof(mvfs));
    bool field_in_frame = mv_field && frame_pic;

    auto parse_direction = [&](int s) {
      if (mv_count == 1) {
        if (mv_field && !dmv) mvfs[0][s] = uint8_t(r.read(1));
        parse_motion_vector(r, st, 0, s, p.f_code[s], mvs[0][s],
                            field_in_frame, dmv, &err);
      } else {
        mvfs[0][s] = uint8_t(r.read(1));
        parse_motion_vector(r, st, 0, s, p.f_code[s], mvs[0][s],
                            field_in_frame, dmv, &err);
        mvfs[1][s] = uint8_t(r.read(1));
        parse_motion_vector(r, st, 1, s, p.f_code[s], mvs[1][s],
                            field_in_frame, dmv, &err);
      }
    };

    if (has_fwd || (intra && cmv)) parse_direction(0);
    if (has_bwd) parse_direction(1);
    if (err) return err;
    if (intra && cmv) r.skip(1);  // marker_bit

    // PMV bookkeeping, Table 7-9
    if (pred_type == PT_FRAME || (intra && cmv)) {
      if (intra) {
        st.pmv[1][0][0] = st.pmv[0][0][0]; st.pmv[1][0][1] = st.pmv[0][0][1];
      } else if (has_fwd && has_bwd) {
        std::memcpy(st.pmv[1], st.pmv[0], sizeof(st.pmv[0]));
      } else if (has_fwd) {
        st.pmv[1][0][0] = st.pmv[0][0][0]; st.pmv[1][0][1] = st.pmv[0][0][1];
      } else if (has_bwd) {
        st.pmv[1][1][0] = st.pmv[0][1][0]; st.pmv[1][1][1] = st.pmv[0][1][1];
      }
    }
    if (pred_type == PT_DUAL_PRIME && has_fwd && !has_bwd && !intra) {
      st.pmv[1][0][0] = st.pmv[0][0][0]; st.pmv[1][0][1] = st.pmv[0][0][1];
    }

    // 7.6.3.4 predictor resets
    if ((intra && !cmv) || (pct == 2 && !intra && !has_fwd)) {
      std::memset(st.pmv, 0, sizeof(st.pmv));
      std::memset(mvs, 0, sizeof(mvs));
      pred_type = frame_pic ? PT_FRAME : PT_FIELD;
      field_in_frame = false;
    }

    // emit prediction tokens
    out.coded[m] = 1;
    out.intra[m] = intra;
    out.dct_type[m] = dct_type;
    if (!intra) {
      if (pred_type == PT_DUAL_PRIME || pred_type == PT_16X8) {
        out.fwd[m] = 0;
        out.bwd[m] = 0;
      } else {
        out.fwd[m] = (has_fwd || (pct == 2 && !has_bwd)) ? 1 : 0;
        out.bwd[m] = has_bwd ? 1 : 0;
        out.field_pred[m] = (pred_type == PT_FIELD && frame_pic) ? 1 : 0;
        std::memcpy(out.mv + m * 8, mvs, sizeof(mvs));
        std::memcpy(out.mvfs + m * 4, mvfs, sizeof(mvfs));
      }
      st.prev_fwd = out.fwd[m] != 0;
      st.prev_bwd = out.bwd[m] != 0;
    }

    // DC predictor reset (spec 7.2.1)
    if (increment > 1 || !intra)
      for (int c = 0; c < 3; ++c) st.dc_pred[c] = 1 << (p.intra_dc_precision + 7);

    // coded block pattern
    int cbp = 0;
    if (intra) {
      cbp = (1 << n_blocks) - 1;
    } else if (pattern) {
      int base = decode_vlc(r, tables().cbp, &err);
      if (err) return err;
      for (int i = 0; i < 6; ++i)
        if (base & (1 << (5 - i))) cbp |= 1 << i;
      if (cf == 2) {
        int ext = int(r.read(2));
        for (int i = 0; i < 2; ++i)
          if (ext & (1 << (1 - i))) cbp |= 1 << (6 + i);
      } else if (cf == 3) {
        int ext = int(r.read(6));
        for (int i = 0; i < 6; ++i)
          if (ext & (1 << (5 - i))) cbp |= 1 << (6 + i);
      }
    }

    // coefficient blocks: ONE atomic row claim for the whole MB (popcount
    // of cbp) instead of one per block — the claim counter is contended
    // across slice threads
    int n_coded = __builtin_popcount(unsigned(cbp));
    if (n_coded) {
      int32_t k0 = __atomic_fetch_add(out.cblk_count, n_coded,
                                      __ATOMIC_RELAXED);
      if (k0 + n_coded > out.cblk_capacity) return 5;
      int32_t k = k0;
      for (int b = 0; b < n_blocks; ++b) {
        if (!(cbp & (1 << b))) continue;
        out.cblk_idx[k] = m * n_blocks + slot[b];
        int16_t* dst = out.cblk + (size_t)k * 64;
        memset(dst, 0, 64 * sizeof(int16_t));
        if (!err) {
          bool luma = b < 4;
          int chroma_idx = luma ? 0 : 1 + ((b - 4) & 1);
          out.row_nnz[k] = uint8_t(parse_block(
              r, p, st, dst, intra, luma, chroma_idx, b >= 6, &err));
        } else {
          // a block already errored: the rest of this MB's batch-claimed
          // rows must still be VALID (zero) rows — tolerate mode keeps
          // decoding the rest of the picture around them
          out.row_nnz[k] = 0;
        }
        ++k;
      }
      if (err) return err;
    }

    if (r.peek(23) == 0) break;
  }
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// Public entry point
// ---------------------------------------------------------------------------
// tolerate=0: first slice error aborts the picture (return its rc).
// tolerate=1: per-slice error containment — a bad slice keeps whatever it
// parsed before the error (the reference likewise keeps decoding past
// garbage, mp2v_vlc_dec.hpp:69, but emits corrupt pixels; here the rest of
// the picture is untouched), *bad_slices counts drops, and only
// coefficient-capacity exhaustion (rc 5, a structural/global condition)
// stays fatal.
extern "C" int mp2v_tokenize_picture(
    const uint8_t* data, size_t len, const uint64_t* slice_bitpos,
    const int32_t* slice_codes, int n_slices, const PicParams* params,
    TokenOut* out, int num_threads, int tolerate, int32_t* bad_slices) {
  tables();  // ensure LUTs are built before threads start
  if (bad_slices) *bad_slices = 0;
  if (num_threads <= 0)
    num_threads = int(std::thread::hardware_concurrency());
  if (num_threads > n_slices) num_threads = n_slices;
  if (num_threads <= 1) {
    int bad = 0;
    for (int i = 0; i < n_slices; ++i) {
      int rc = tokenize_slice(data, len, slice_bitpos[i], slice_codes[i],
                              *params, *out, tolerate);
      if (rc) {
        if (!tolerate || rc == 5) return rc;
        ++bad;
      }
    }
    if (bad_slices) *bad_slices = bad;
    return 0;
  }
  std::atomic<int> next{0};
  std::atomic<int> error{0};
  std::atomic<int> bad{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&] {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n_slices || error.load()) break;
        int rc = tokenize_slice(data, len, slice_bitpos[i], slice_codes[i],
                                *params, *out, tolerate);
        if (rc) {
          if (!tolerate || rc == 5) error.store(rc);
          else bad.fetch_add(1);
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  if (bad_slices) *bad_slices = bad.load();
  return error.load();
}

// ---------------------------------------------------------------------
// Pair packing for the GOP-chunk upload (ops/recon.GopRecon): the chunk
// blob carries only the nonzero (column, value) pairs of each coded
// coefficient row plus per-row counts.  These two single-pass scans
// replace numpy nonzero/bincount/fancy-indexing on the host hot path
// (measured ~10x: one linear read of the rows at memory speed).

extern "C" long long mp2v_count_pairs(const int16_t* rows, int32_t k,
                                      uint8_t* nnz) {
  long long total = 0;
  for (int32_t r = 0; r < k; ++r) {
    const int16_t* row = rows + (size_t)r * 64;
    int c = 0;
    for (int j = 0; j < 64; ++j) c += (row[j] != 0);
    nnz[r] = (uint8_t)c;
    total += c;
  }
  return total;
}

extern "C" long long mp2v_pack_pairs(const int16_t* rows, int32_t k,
                                     uint8_t* pos, int16_t* val) {
  long long p = 0;
  for (int32_t r = 0; r < k; ++r) {
    const int16_t* row = rows + (size_t)r * 64;
    for (int j = 0; j < 64; ++j) {
      if (row[j] != 0) {
        pos[p] = (uint8_t)j;
        val[p] = row[j];
        ++p;
      }
    }
  }
  return p;
}

extern "C" int mp2v_tokenizer_abi_version() { return 5; }
