// JPEG decoder (host C++, plain C interface for ctypes) computing what
// libjpeg-turbo 3 computes with its default decompression parameters, as
// Pillow uses them:
//
//   * 8-bit samples, 1, 3 or 4 components, every integral sampling ratio
//     (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...), interleaved or
//     single-component scans, restart intervals;
//   * baseline and extended sequential (SOF0, SOF1), progressive (SOF2) and
//     lossless (SOF3) Huffman coding, and sequential and progressive
//     arithmetic coding (SOF9, SOF10, with DAC conditioning): the QM coder
//     of ITU-T T.81 Annex D with its Table D.2;
//   * multi-scan files are gathered into one coefficient buffer per
//     component, then transformed once, as libjpeg does when it has the
//     whole file; a progressive file whose low-frequency coefficients are
//     not all exact gets libjpeg-turbo's (2.1+) block smoothing (jdcoefct.c
//     decompress_smooth_data: a 5x5 window of DC values);
//   * the integer "islow" IDCT (jidctint.c), with its range-limit table;
//   * "fancy" (triangle-filter) chroma upsampling (jdsample.c: h2v1, h1v2
//     and h2v2, the row above the first and below the last replicated),
//     plain replication where a 2x-wide component is at most 2 samples wide,
//     for lossless files and for every other integral ratio (int_upsample);
//   * libjpeg's fixed-point YCbCr -> RGB and YCCK -> CMYK (jdcolor.c, 16-bit
//     tables); lossless files: predictors 1-7 and the point transform.
//
// A 4-component image is returned as Pillow shows it: CMYK with every
// sample inverted (Pillow's raw mode "CMYK;I", which it takes for every
// CMYK JPEG). Hierarchical files (SOF5-7, SOF13-15), lossless arithmetic
// coding (SOF11), precisions other than 8 bits, fractional sampling ratios
// and a height given in a DNL marker are refused with a message that names
// the mode, as libjpeg or Pillow refuse them.
//
//   int jd_info(data, len, &w, &h, &channels, err, errlen)
//   int jd_decode(data, len, out, err, errlen)   out: h * w * channels bytes
//
// Both return 0 on success, else 1 with a message in err. channels is 1
// (grayscale), 3 (RGB) or 4 (CMYK).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string &msg) { throw Error{msg}; }

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for a run past the end of a corrupt block
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ITU-T T.81 Table D.2 (Qe, Next_Index_MPS, Next_Index_LPS, Switch_MPS) for
// states 0..112, packed as (Qe << 16) | (NMPS << 8) | (Switch << 7) | NLPS;
// state 113 is a fixed probability of one half (sign bits, DC refinement).
#define QE(qe, nmps, nlps, sw) ((uint32_t(qe) << 16) | (uint32_t(nmps) << 8) | ((sw) << 7) | (nlps))
const uint32_t kQe[114] = {
    QE(0x5a1d, 1, 1, 1),     QE(0x2586, 2, 14, 0),    QE(0x1114, 3, 16, 0),
    QE(0x080b, 4, 18, 0),    QE(0x03d8, 5, 20, 0),    QE(0x01da, 6, 23, 0),
    QE(0x00e5, 7, 25, 0),    QE(0x006f, 8, 28, 0),    QE(0x0036, 9, 30, 0),
    QE(0x001a, 10, 33, 0),   QE(0x000d, 11, 35, 0),   QE(0x0006, 12, 9, 0),
    QE(0x0003, 13, 10, 0),   QE(0x0001, 13, 12, 0),   QE(0x5a7f, 15, 15, 1),
    QE(0x3f25, 16, 36, 0),   QE(0x2cf2, 17, 38, 0),   QE(0x207c, 18, 39, 0),
    QE(0x17b9, 19, 40, 0),   QE(0x1182, 20, 42, 0),   QE(0x0cef, 21, 43, 0),
    QE(0x09a1, 22, 45, 0),   QE(0x072f, 23, 46, 0),   QE(0x055c, 24, 48, 0),
    QE(0x0406, 25, 49, 0),   QE(0x0303, 26, 51, 0),   QE(0x0240, 27, 52, 0),
    QE(0x01b1, 28, 54, 0),   QE(0x0144, 29, 56, 0),   QE(0x00f5, 30, 57, 0),
    QE(0x00b7, 31, 59, 0),   QE(0x008a, 32, 60, 0),   QE(0x0068, 33, 62, 0),
    QE(0x004e, 34, 63, 0),   QE(0x003b, 35, 32, 0),   QE(0x002c, 9, 33, 0),
    QE(0x5ae1, 37, 37, 1),   QE(0x484c, 38, 64, 0),   QE(0x3a0d, 39, 65, 0),
    QE(0x2ef1, 40, 67, 0),   QE(0x261f, 41, 68, 0),   QE(0x1f33, 42, 69, 0),
    QE(0x19a8, 43, 70, 0),   QE(0x1518, 44, 72, 0),   QE(0x1177, 45, 73, 0),
    QE(0x0e74, 46, 74, 0),   QE(0x0bfb, 47, 75, 0),   QE(0x09f8, 48, 77, 0),
    QE(0x0861, 49, 78, 0),   QE(0x0706, 50, 79, 0),   QE(0x05cd, 51, 48, 0),
    QE(0x04de, 52, 50, 0),   QE(0x040f, 53, 50, 0),   QE(0x0363, 54, 51, 0),
    QE(0x02d4, 55, 52, 0),   QE(0x025c, 56, 53, 0),   QE(0x01f8, 57, 54, 0),
    QE(0x01a4, 58, 55, 0),   QE(0x0160, 59, 56, 0),   QE(0x0125, 60, 57, 0),
    QE(0x00f6, 61, 58, 0),   QE(0x00cb, 62, 59, 0),   QE(0x00ab, 63, 61, 0),
    QE(0x008f, 32, 61, 0),   QE(0x5b12, 65, 65, 1),   QE(0x4d04, 66, 80, 0),
    QE(0x412c, 67, 81, 0),   QE(0x37d8, 68, 82, 0),   QE(0x2fe8, 69, 83, 0),
    QE(0x293c, 70, 84, 0),   QE(0x2379, 71, 86, 0),   QE(0x1edf, 72, 87, 0),
    QE(0x1aa9, 73, 87, 0),   QE(0x174e, 74, 72, 0),   QE(0x1424, 75, 72, 0),
    QE(0x119c, 76, 74, 0),   QE(0x0f6b, 77, 74, 0),   QE(0x0d51, 78, 75, 0),
    QE(0x0bb6, 79, 77, 0),   QE(0x0a40, 48, 77, 0),   QE(0x5832, 81, 80, 1),
    QE(0x4d1c, 82, 88, 0),   QE(0x438e, 83, 89, 0),   QE(0x3bdd, 84, 90, 0),
    QE(0x34ee, 85, 91, 0),   QE(0x2eae, 86, 92, 0),   QE(0x299a, 87, 93, 0),
    QE(0x2516, 71, 86, 0),   QE(0x5570, 89, 88, 1),   QE(0x4ca9, 90, 95, 0),
    QE(0x44d9, 91, 96, 0),   QE(0x3e22, 92, 97, 0),   QE(0x3824, 93, 99, 0),
    QE(0x32b4, 94, 99, 0),   QE(0x2e17, 86, 93, 0),   QE(0x56a8, 96, 95, 1),
    QE(0x4f46, 97, 101, 0),  QE(0x47e5, 98, 102, 0),  QE(0x41cf, 99, 103, 0),
    QE(0x3c3d, 100, 104, 0), QE(0x375e, 93, 99, 0),   QE(0x5231, 102, 105, 0),
    QE(0x4c0f, 103, 106, 0), QE(0x4639, 104, 107, 0), QE(0x415e, 99, 103, 0),
    QE(0x5627, 106, 105, 1), QE(0x50e7, 107, 108, 0), QE(0x4b85, 103, 109, 0),
    QE(0x5597, 109, 110, 0), QE(0x504f, 107, 111, 0), QE(0x5a10, 111, 110, 1),
    QE(0x5522, 109, 112, 0), QE(0x59eb, 111, 112, 1), QE(0x5a1d, 113, 113, 0)};
#undef QE

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | symbol, or 0 when the code is longer
  uint16_t look[1 << 9];
};

void build_huffman(Huffman &t, const uint8_t counts[16], const uint8_t *vals, int nvals) {
  std::memcpy(t.vals, vals, nvals);
  int code = 0, k = 0;
  std::memset(t.look, 0, sizeof(t.look));
  for (int len = 1; len <= 16; ++len) {
    t.valptr[len] = k;
    t.mincode[len] = code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (len <= 9) {
        int shift = 9 - len;
        for (int j = 0; j < (1 << shift); ++j)
          t.look[(code << shift) | j] = static_cast<uint16_t>((len << 8) | vals[k]);
      }
    }
    t.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) fail("bad Huffman table");
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  t.defined = true;
}

enum ColorSpace { GRAY, RGB, YCBCR, CMYK, YCCK };

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  bool latched = false;    // quantisation table fixed at the component's first scan
  int quant[64];
  int ds_w, ds_h;          // downsampled size (samples that are real)
  int bw, bh;              // units (8x8 blocks, or samples when lossless) holding them
  int blocks_w, blocks_h;  // units in the MCU-padded grid
  std::vector<int16_t> coef;   // blocks_h * blocks_w blocks of 64, natural order
  std::vector<int32_t> diff;   // lossless: blocks_h * blocks_w differences
  std::vector<uint8_t> plane;  // the component's samples, `stride` bytes a row
  size_t stride = 0;
  int coef_bits[64];       // progressive: Al of the last scan of each coefficient, -1 if none
  int dc_pred = 0;
  int16_t *block(int bx, int by) {
    return &coef[(static_cast<size_t>(by) * blocks_w + bx) * 64];
  }
};

struct Decoder {
  const uint8_t *data;
  size_t len, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false, have_frame = false;
  bool progressive = false, arithmetic = false, lossless = false;
  int adobe_transform = -1;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];
  int mcus_x = 0, mcus_y = 0;
  // the current scan
  Component *sc[4];
  int ns = 0, Ss = 0, Se = 63, Ah = 0, Al = 0;
  int eobrun = 0;
  // Huffman entropy-coded segment reader
  uint64_t bits = 0;
  int nbits = 0;
  bool hit_marker = false;
  // arithmetic decoder (jdarith.c): registers, conditioning and statistics
  int64_t ar_c = 0, ar_a = 0;
  int ar_ct = -16;
  int dc_L[16], dc_U[16], ac_K[16];
  int dc_context[4];
  int last_dc[4];
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin[4];
  // lossless: the MCU rows at which the predictor restarts
  std::vector<uint8_t> first_row;
  int cur_row = 0;

  uint8_t byte() {
    if (pos >= len) fail("truncated file");
    return data[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // ---------------- markers ----------------

  void read_dqt(int seg_len) {
    size_t end = pos + seg_len;
    while (pos < end) {
      int pq_tq = byte(), pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad DQT");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNaturalOrder[k]] = static_cast<uint16_t>(pq ? u16() : byte());
      qt_defined[tq] = true;
    }
  }

  void read_dht(int seg_len) {
    size_t end = pos + seg_len;
    while (pos < end) {
      int tc_th = byte(), tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = byte();
      if (total > 256) fail("bad DHT");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = byte();
      build_huffman(tc ? ac[th] : dc[th], counts, vals, total);
    }
  }

  void read_dac(int seg_len) {
    size_t end = pos + seg_len;
    while (pos < end) {
      int index = byte(), val = byte();
      if (index >= 32) fail("bad DAC");
      if (index >= 16) {
        ac_K[index - 16] = val;
      } else {
        dc_L[index] = val & 15;
        dc_U[index] = val >> 4;
        if (dc_L[index] > dc_U[index]) fail("bad DAC");
      }
    }
  }

  void read_sof(int marker) {
    std::string sof = "(SOF" + std::to_string(marker - 0xC0) + ")";
    if (marker == 0xC5 || marker == 0xC6 || marker == 0xC7 || marker == 0xCD || marker == 0xCE ||
        marker == 0xCF)
      fail("hierarchical JPEG " + sof + " is not supported (libjpeg refuses it)");
    if (marker == 0xCB) fail("lossless arithmetic-coded JPEG (SOF11) is not supported "
                             "(libjpeg refuses it)");
    if (have_frame) fail("more than one frame");
    progressive = marker == 0xC2 || marker == 0xCA;
    arithmetic = marker >= 0xC9;
    lossless = marker == 0xC3;
    u16();
    int precision = byte();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG " + sof +
           " is not supported (8-bit samples only, as Pillow)");
    height = u16();
    width = u16();
    ncomp = byte();
    if (height == 0) fail("JPEG with its height in a DNL marker is not supported");
    if (width == 0) fail("zero image width");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(std::to_string(ncomp) + "-component JPEG is not supported (1, 3 or 4)");
    for (int i = 0; i < ncomp; ++i) {
      Component &c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad SOF component");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    int unit = lossless ? 1 : 8;
    mcus_x = (width + unit * hmax - 1) / (unit * hmax);
    mcus_y = (height + unit * vmax - 1) / (unit * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component &c = comp[i];
      if (hmax % c.h || vmax % c.v)
        fail("fractional sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) +
             " of " + std::to_string(hmax) + "x" + std::to_string(vmax) +
             " are not supported (libjpeg: \"Fractional sampling not implemented yet\")");
      c.ds_w = (width * c.h + hmax - 1) / hmax;
      c.ds_h = (height * c.v + vmax - 1) / vmax;
      c.bw = (c.ds_w + unit - 1) / unit;
      c.bh = (c.ds_h + unit - 1) / unit;
      c.blocks_w = mcus_x * c.h;
      c.blocks_h = mcus_y * c.v;
      if (lossless)
        c.diff.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h, 0);
      else
        c.coef.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h * 64, 0);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  // ---------------- Huffman-coded data ----------------

  void fill() {
    while (nbits <= 56) {
      uint8_t b = 0;
      if (!hit_marker && pos < len) {
        b = data[pos];
        if (b == 0xFF) {
          size_t p = pos + 1;
          while (p < len && data[p] == 0xFF) ++p;   // fill bytes
          if (p < len && data[p] == 0x00) {
            pos = p + 1;
          } else {
            hit_marker = true;  // leave the marker; feed zeros from here
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      bits |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = static_cast<int>(bits >> (64 - n));
    bits <<= n;
    nbits -= n;
    return v;
  }

  int decode(const Huffman &t) {
    if (nbits < 16) fill();
    int look = t.look[bits >> (64 - 9)];
    if (look) {
      int l = look >> 8;
      bits <<= l;
      nbits -= l;
      return look & 0xFF;
    }
    int code = get_bits(9), l = 9;
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      if (++l > 16) return 0;  // corrupt data: as libjpeg, a zero symbol
    }
    return t.vals[t.valptr[l] + code - t.mincode[l]];
  }

  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void huff_sequential(Component &c, int16_t *blk) {
    int s = decode(dc[c.td]);
    int diff = s ? extend(get_bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      int rs = decode(ac[c.ta]);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNaturalOrder[k]] = static_cast<int16_t>(extend(get_bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c: the four kinds of progressive scan
  void huff_dc_first(Component &c, int16_t *blk) {
    int s = decode(dc[c.td]);
    if (s) s = extend(get_bits(s), s);
    c.dc_pred += s;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << Al);
  }

  void huff_dc_refine(int16_t *blk) {
    if (get_bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << Al));
  }

  void huff_ac_first(Component &c, int16_t *blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = Ss; k <= Se; ++k) {
      int rs = decode(ac[c.ta]);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNaturalOrder[k]] =
            static_cast<int16_t>(static_cast<unsigned>(extend(get_bits(s), s)) << Al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get_bits(r);
        --eobrun;
        break;
      }
    }
  }

  void refine_nonzero(int16_t *coef) {
    int p1 = 1 << Al, m1 = -1 * (1 << Al);
    if (get_bits(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
  }

  void huff_ac_refine(Component &c, int16_t *blk) {
    int p1 = 1 << Al, m1 = -1 * (1 << Al);
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; ++k) {
        int rs = decode(ac[c.ta]);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get_bits(r);
          break;
        }
        do {
          int16_t *coef = blk + kNaturalOrder[k];
          if (*coef != 0) {
            refine_nonzero(coef);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= Se);
        if (s) blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k) {
        int16_t *coef = blk + kNaturalOrder[k];
        if (*coef != 0) refine_nonzero(coef);
      }
      --eobrun;
    }
  }

  // jdlhuff.c: one difference of a lossless scan
  void huff_lossless(Component &c, int x, int y) {
    int s = decode(dc[c.td]);
    if (s == 16)
      s = 32768;
    else if (s)
      s = extend(get_bits(s), s);
    c.diff[static_cast<size_t>(y) * c.blocks_w + x] = s;
  }

  // ---------------- arithmetic-coded data (jdarith.c) ----------------

  int arith_byte() {
    if (hit_marker || pos >= len) {
      hit_marker = true;
      return 0;
    }
    int d = data[pos++];
    if (d != 0xFF) return d;
    size_t p = pos;
    while (p < len && data[p] == 0xFF) ++p;
    if (p < len && data[p] == 0x00) {
      pos = p + 1;
      return 0xFF;
    }
    hit_marker = true;  // a marker ends the segment: leave it, decode zeros
    pos = p - 1;
    return 0;
  }

  int arith_decode(uint8_t *st) {
    // renormalisation and data input, T.81 D.2.6
    while (ar_a < 0x8000) {
      if (--ar_ct < 0) {
        ar_c = (ar_c << 8) | arith_byte();
        if ((ar_ct += 8) < 0)        // still reading the two initial bytes
          if (++ar_ct == 0) ar_a = 0x8000;
      }
      ar_a <<= 1;
    }
    int sv = *st;
    uint32_t e = kQe[sv & 0x7F];
    int64_t qe = e >> 16;
    int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    int64_t temp = ar_a - qe;
    ar_a = temp;
    temp <<= ar_ct;
    if (ar_c >= temp) {
      ar_c -= temp;
      if (ar_a < qe) {                 // conditional exchange, LPS path
        ar_a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        ar_a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ar_a < 0x8000) {
      if (ar_a < qe) {                 // conditional exchange, MPS path
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  int arith_dc_diff(int si, int tbl) {
    uint8_t *st = dc_stats[tbl] + dc_context[si];
    if (arith_decode(st) == 0) {
      dc_context[si] = 0;
      return 0;
    }
    int sign = arith_decode(st + 1);
    st += 2 + sign;
    // magnitude category, F.23: the first decision in the context's bin,
    // the rest from X1 = 20
    int m = arith_decode(st);
    if (m) {
      uint8_t *sx = dc_stats[tbl] + 20;
      while (arith_decode(sx)) {
        if ((m <<= 1) == 0x8000) fail("corrupt arithmetic-coded data");
        ++sx;
      }
      st = sx;
    }
    if (m < static_cast<int>((1L << dc_L[tbl]) >> 1))
      dc_context[si] = 0;
    else if (m > static_cast<int>((1L << dc_U[tbl]) >> 1))
      dc_context[si] = 12 + sign * 4;
    else
      dc_context[si] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // AC coefficients Ss..Se of a block (F.20), each scaled by << Al
  void arith_ac(int tbl, int16_t *blk, int ss, int se, int al) {
    for (int k = ss; k <= se; ++k) {
      uint8_t *st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se) fail("corrupt arithmetic-coded data");
      }
      int sign = arith_decode(fixed_bin);
      st += 2;
      int m = arith_decode(st);
      if (m) {
        if (arith_decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= ac_K[tbl] ? 189 : 217);
          while (arith_decode(st)) {
            if ((m <<= 1) == 0x8000) fail("corrupt arithmetic-coded data");
            ++st;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
  }

  void arith_sequential(int si, Component &c, int16_t *blk) {
    last_dc[si] = (last_dc[si] + arith_dc_diff(si, c.td)) & 0xffff;
    blk[0] = static_cast<int16_t>(last_dc[si]);
    arith_ac(c.ta, blk, 1, 63, 0);
  }

  void arith_dc_first(int si, Component &c, int16_t *blk) {
    last_dc[si] = (last_dc[si] + arith_dc_diff(si, c.td)) & 0xffff;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[si]) << Al);
  }

  void arith_dc_refine(int16_t *blk) {
    if (arith_decode(fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | (1 << Al));
  }

  void arith_ac_refine(Component &c, int16_t *blk) {
    int p1 = 1 << Al, m1 = -1 * (1 << Al);
    int kex = Se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kNaturalOrder[kex]]) break;
    for (int k = Ss; k <= Se; ++k) {
      uint8_t *st = ac_stats[c.ta] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t *coef = blk + kNaturalOrder[k];
        if (*coef) {
          if (arith_decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {
          *coef = static_cast<int16_t>(arith_decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) fail("corrupt arithmetic-coded data");
      }
    }
  }

  void arith_reset_statistics() {
    for (int si = 0; si < ns; ++si) {
      Component &c = *sc[si];
      if (!progressive || (Ss == 0 && Ah == 0)) {
        std::memset(dc_stats[c.td], 0, sizeof(dc_stats[0]));
        last_dc[si] = 0;
        dc_context[si] = 0;
      }
      if (!progressive || Ss) std::memset(ac_stats[c.ta], 0, sizeof(ac_stats[0]));
    }
    ar_c = 0;
    ar_a = 0;
    ar_ct = -16;  // read two bytes into C first
  }

  // ---------------- scans ----------------

  void restart() {
    // the next marker must be RSTn: consume it, reset the entropy decoder
    bits = 0;
    nbits = 0;
    hit_marker = false;
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7))
      ++pos;
    if (pos + 1 < len) pos += 2;
    eobrun = 0;
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
    if (arithmetic) arith_reset_statistics();
    if (lossless) first_row[cur_row] = 1;
  }

  // every unit (block, or sample when lossless) of the scan in coding
  // order: fn(scan component, x, y)
  template <class F>
  void for_each_unit(F &&fn) {
    int todo = restart_interval;
    auto start_mcu = [&]() {
      if (!restart_interval) return;
      if (todo == 0) {
        restart();
        todo = restart_interval;
      }
      --todo;
    };
    if (ns == 1) {  // non-interleaved: one unit per MCU, over the real units
      Component &c = *sc[0];
      for (int by = 0; by < c.bh; ++by) {
        cur_row = by;
        for (int bx = 0; bx < c.bw; ++bx) {
          start_mcu();
          fn(0, bx, by);
        }
      }
    } else {
      for (int my = 0; my < mcus_y; ++my) {
        cur_row = my;
        for (int mx = 0; mx < mcus_x; ++mx) {
          start_mcu();
          for (int i = 0; i < ns; ++i) {
            Component &c = *sc[i];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) fn(i, mx * c.h + x, my * c.v + y);
          }
        }
      }
    }
  }

  void check_progressive_scan() {
    bool bad = false;
    if (Ss == 0) {
      if (Se != 0) bad = true;
    } else {
      if (Ss > Se || Se > 63 || ns != 1) bad = true;
    }
    if (Ah != 0 && Al != Ah - 1) bad = true;
    if (Al > 13) bad = true;
    if (bad)
      fail("invalid progressive scan (Ss=" + std::to_string(Ss) + " Se=" + std::to_string(Se) +
           " Ah=" + std::to_string(Ah) + " Al=" + std::to_string(Al) + ")");
    for (int i = 0; i < ns; ++i)
      for (int k = Ss; k <= Se; ++k) sc[i]->coef_bits[k] = Al;
  }

  void read_scan() {
    if (!have_frame) fail("scan before the frame header");
    u16();
    ns = byte();
    if (ns < 1 || ns > ncomp) fail("bad SOS");
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component *c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (!lossless) {
        if (!qt_defined[c->tq]) fail("component uses an undefined quantisation table");
        if (!c->latched)
          for (int k = 0; k < 64; ++k) c->quant[k] = qt[c->tq][k];
        c->latched = true;
      }
      c->dc_pred = 0;
      sc[i] = c;
    }
    Ss = byte();
    Se = byte();
    int ahal = byte();
    Ah = ahal >> 4;
    Al = ahal & 15;
    if (lossless) {
      if (Ss < 1 || Ss > 7 || Al >= 8)
        fail("invalid lossless scan (predictor " + std::to_string(Ss) + ", point transform " +
             std::to_string(Al) + ")");
    } else if (progressive) {
      check_progressive_scan();
    } else if (Ss != 0 || Se != 63 || ahal != 0) {
      fail("bad spectral selection for a sequential scan");
    }
    // the tables this scan's kind reads
    for (int i = 0; i < ns; ++i) {
      Component &c = *sc[i];
      bool dc_used = lossless || !progressive || (Ss == 0 && Ah == 0);
      bool ac_used = !lossless && (!progressive || Ss != 0);
      if (arithmetic) {
        if (c.td > 15 || c.ta > 15) fail("scan uses an undefined arithmetic-coding table");
      } else if ((dc_used && (c.td > 3 || !dc[c.td].defined)) ||
                 (ac_used && (c.ta > 3 || !ac[c.ta].defined))) {
        fail("scan uses an undefined Huffman table");
      }
    }
    bits = 0;
    nbits = 0;
    hit_marker = false;
    eobrun = 0;
    if (arithmetic) arith_reset_statistics();
    if (lossless) {
      first_row.assign(ns == 1 ? sc[0]->bh : mcus_y, 0);
      first_row[0] = 1;
      if (restart_interval && restart_interval % (ns == 1 ? sc[0]->bw : mcus_x))
        fail("lossless JPEG with a restart interval that is not a whole number of MCU rows");
      for_each_unit([&](int i, int x, int y) { huff_lossless(*sc[i], x, y); });
      undifference();
    } else if (!progressive) {
      if (arithmetic)
        for_each_unit([&](int i, int x, int y) { arith_sequential(i, *sc[i], sc[i]->block(x, y)); });
      else
        for_each_unit([&](int i, int x, int y) { huff_sequential(*sc[i], sc[i]->block(x, y)); });
    } else if (arithmetic) {
      if (Ss == 0 && Ah == 0)
        for_each_unit([&](int i, int x, int y) { arith_dc_first(i, *sc[i], sc[i]->block(x, y)); });
      else if (Ss == 0)
        for_each_unit([&](int i, int x, int y) { arith_dc_refine(sc[i]->block(x, y)); });
      else if (Ah == 0)
        for_each_unit([&](int i, int x, int y) {
          arith_ac(sc[i]->ta, sc[i]->block(x, y), Ss, Se, Al);
        });
      else
        for_each_unit([&](int i, int x, int y) { arith_ac_refine(*sc[i], sc[i]->block(x, y)); });
    } else {
      if (Ss == 0 && Ah == 0)
        for_each_unit([&](int i, int x, int y) { huff_dc_first(*sc[i], sc[i]->block(x, y)); });
      else if (Ss == 0)
        for_each_unit([&](int i, int x, int y) { huff_dc_refine(sc[i]->block(x, y)); });
      else if (Ah == 0)
        for_each_unit([&](int i, int x, int y) { huff_ac_first(*sc[i], sc[i]->block(x, y)); });
      else
        for_each_unit([&](int i, int x, int y) { huff_ac_refine(*sc[i], sc[i]->block(x, y)); });
    }
    // continue at the next marker
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                              !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      ++pos;
  }

  // jdlossls.c: the samples of a lossless scan's components from their
  // differences; the first row of the scan and of each restart interval
  // predicts from the left (the first sample from 1 << (7 - Pt)), the first
  // column from above
  void undifference() {
    for (int i = 0; i < ns; ++i) {
      Component &c = *sc[i];
      int rows_per_mcu = ns == 1 ? 1 : c.v;
      c.stride = c.ds_w;
      c.plane.resize(static_cast<size_t>(c.ds_h) * c.stride);
      std::vector<int> prev(c.ds_w), cur(c.ds_w);
      for (int y = 0; y < c.ds_h; ++y) {
        const int32_t *d = &c.diff[static_cast<size_t>(y) * c.blocks_w];
        bool first = y % rows_per_mcu == 0 && first_row[y / rows_per_mcu];
        if (first) {
          int ra = (d[0] + (1 << (7 - Al))) & 0xFFFF;
          cur[0] = ra;
          for (int x = 1; x < c.ds_w; ++x) cur[x] = ra = (d[x] + ra) & 0xFFFF;
        } else {
          int rb = prev[0], ra = (d[0] + rb) & 0xFFFF, rc;
          cur[0] = ra;
          for (int x = 1; x < c.ds_w; ++x) {
            rc = rb;
            rb = prev[x];
            int p;
            switch (Ss) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
            cur[x] = ra = (d[x] + p) & 0xFFFF;
          }
        }
        uint8_t *o = &c.plane[static_cast<size_t>(y) * c.stride];
        for (int x = 0; x < c.ds_w; ++x) o[x] = static_cast<uint8_t>(cur[x] << Al);
        std::swap(prev, cur);
      }
    }
  }

  // ---------------- islow IDCT (jidctint.c) ----------------

  static uint8_t idct_limit(int64_t x) {
    // libjpeg's post-IDCT range-limit table, indexed by x & 1023
    int i = static_cast<int>(x & 1023);
    if (i < 128) return static_cast<uint8_t>(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return static_cast<uint8_t>(i - 896);
  }

  static void idct_islow(const int16_t *coef, const int *quant, uint8_t *out, size_t stride) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      auto in = [&](int r) { return int64_t(coef[r * 8 + c]) * quant[r * 8 + c]; };
      if (!coef[8 + c] && !coef[16 + c] && !coef[24 + c] && !coef[32 + c] && !coef[40 + c] &&
          !coef[48 + c] && !coef[56 + c]) {
        int dcval = static_cast<int>(in(0) * (1 << PASS1_BITS));
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dcval;
        continue;
      }
      int64_t z2 = in(2), z3 = in(6);
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = in(0);
      z3 = in(4);
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = in(7);
      tmp1 = in(5);
      tmp2 = in(3);
      tmp3 = in(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int n = CONST_BITS - PASS1_BITS;
      ws[0 * 8 + c] = static_cast<int>(descale(tmp10 + tmp3, n));
      ws[7 * 8 + c] = static_cast<int>(descale(tmp10 - tmp3, n));
      ws[1 * 8 + c] = static_cast<int>(descale(tmp11 + tmp2, n));
      ws[6 * 8 + c] = static_cast<int>(descale(tmp11 - tmp2, n));
      ws[2 * 8 + c] = static_cast<int>(descale(tmp12 + tmp1, n));
      ws[5 * 8 + c] = static_cast<int>(descale(tmp12 - tmp1, n));
      ws[3 * 8 + c] = static_cast<int>(descale(tmp13 + tmp0, n));
      ws[4 * 8 + c] = static_cast<int>(descale(tmp13 - tmp0, n));
    }
    for (int r = 0; r < 8; ++r) {
      const int *w = ws + r * 8;
      uint8_t *o = out + r * stride;
      const int n = CONST_BITS + PASS1_BITS + 3;
      if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
        uint8_t v = idct_limit(descale(w[0], PASS1_BITS + 3));
        for (int i = 0; i < 8; ++i) o[i] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CONST_BITS);
      int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = idct_limit(descale(tmp10 + tmp3, n));
      o[7] = idct_limit(descale(tmp10 - tmp3, n));
      o[1] = idct_limit(descale(tmp11 + tmp2, n));
      o[6] = idct_limit(descale(tmp11 - tmp2, n));
      o[2] = idct_limit(descale(tmp12 + tmp1, n));
      o[5] = idct_limit(descale(tmp12 - tmp1, n));
      o[3] = idct_limit(descale(tmp13 + tmp0, n));
      o[4] = idct_limit(descale(tmp13 - tmp0, n));
    }
  }

  // ---------------- block smoothing (jdcoefct.c, libjpeg-turbo 2.1+) ----------------

  // smoothing_ok: a progressive file, every component's DC known and its
  // quantisation values 0..9 nonzero, and some coefficient 1..9 (zigzag)
  // of some component not known to full precision
  bool smoothing_wanted() const {
    if (!progressive) return false;
    bool useful = false;
    for (int ci = 0; ci < ncomp; ++ci) {
      const Component &c = comp[ci];
      for (int k = 0; k <= 9; ++k)
        if (c.quant[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k <= 9; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  static int smooth_pred(int64_t num, int64_t q, int al, bool limit) {
    int pred;
    if (num >= 0) {
      pred = static_cast<int>(((q << 7) + num) / (q << 8));
      if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = static_cast<int>(((q << 7) - num) / (q << 8));
      if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return pred;
  }

  void smooth_and_idct(Component &c) {
    const int *cb = c.coef_bits;
    bool change_dc = true;  // DC interpolation only when no AC coefficient is known
    for (int k = 1; k <= 9; ++k) change_dc = change_dc && cb[k] == -1;
    const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8], Q20 = c.quant[16],
                  Q11 = c.quant[9], Q02 = c.quant[2], Q03 = c.quant[3], Q12 = c.quant[10],
                  Q21 = c.quant[17], Q30 = c.quant[24];
    int last_col = c.bw - 1;
    int16_t ws[64];
    for (int row = 0; row < c.bh; ++row) {
      int DC[25];  // DC[r * 5 + i] is libjpeg's DC(r * 5 + i + 1): the window's DC
                   // values, rows and columns clamped to the component's blocks
      for (int bx = 0; bx <= last_col; ++bx) {
        std::memcpy(ws, c.block(bx, row), sizeof(ws));
        for (int r = 0; r < 5; ++r) {
          int y = std::min(std::max(row + r - 2, 0), c.bh - 1);
          for (int i = 0; i < 5; ++i)
            DC[r * 5 + i] = c.block(std::min(std::max(bx + i - 2, 0), last_col), y)[0];
        }
        auto D = [&](int n) -> int64_t { return DC[n - 1]; };
        int al;
        if ((al = cb[1]) != 0 && ws[1] == 0) {
          int64_t num = Q00 * (change_dc
              ? (-D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) - 13 * D(9) + 3 * D(10) -
                 3 * D(11) + 38 * D(12) - 38 * D(14) + 3 * D(15) - 3 * D(16) + 13 * D(17) -
                 13 * D(19) + 3 * D(20) - D(21) - D(22) + D(24) + D(25))
              : (-7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15)));
          ws[1] = static_cast<int16_t>(smooth_pred(num, Q01, al, true));
        }
        if ((al = cb[2]) != 0 && ws[8] == 0) {
          int64_t num = Q00 * (change_dc
              ? (-D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) + 13 * D(7) +
                 38 * D(8) + 13 * D(9) - D(10) + D(16) - 13 * D(17) - 38 * D(18) -
                 13 * D(19) + D(20) + D(21) + 3 * D(22) + 3 * D(23) + 3 * D(24) + D(25))
              : (-7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23)));
          ws[8] = static_cast<int16_t>(smooth_pred(num, Q10, al, true));
        }
        if ((al = cb[3]) != 0 && ws[16] == 0) {
          int64_t num = Q00 * (change_dc
              ? (D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) - 14 * D(13) - 5 * D(14) +
                 2 * D(17) + 7 * D(18) + 2 * D(19) + D(23))
              : (-D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23)));
          ws[16] = static_cast<int16_t>(smooth_pred(num, Q20, al, true));
        }
        if ((al = cb[4]) != 0 && ws[9] == 0) {
          int64_t num = Q00 * (change_dc
              ? (-D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) + 9 * D(19) + D(21) - D(25))
              : (D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) + D(22) - D(24) +
                 D(4) - D(6) + 10 * D(7) - 10 * D(9)));
          ws[9] = static_cast<int16_t>(smooth_pred(num, Q11, al, true));
        }
        if ((al = cb[5]) != 0 && ws[2] == 0) {
          int64_t num = Q00 * (change_dc
              ? (2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) - 14 * D(13) +
                 7 * D(14) + D(15) + 2 * D(17) - 5 * D(18) + 2 * D(19))
              : (-D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15)));
          ws[2] = static_cast<int16_t>(smooth_pred(num, Q02, al, true));
        }
        if (change_dc) {
          if ((al = cb[6]) != 0 && ws[3] == 0) {
            int64_t num = Q00 * (D(7) - D(9) + 2 * D(12) - 2 * D(14) + D(17) - D(19));
            ws[3] = static_cast<int16_t>(smooth_pred(num, Q03, al, true));
          }
          if ((al = cb[7]) != 0 && ws[10] == 0) {
            int64_t num = Q00 * (D(7) - 3 * D(8) + D(9) - D(17) + 3 * D(18) - D(19));
            ws[10] = static_cast<int16_t>(smooth_pred(num, Q12, al, true));
          }
          if ((al = cb[8]) != 0 && ws[17] == 0) {
            int64_t num = Q00 * (D(7) - 3 * D(12) + D(17) - D(9) + 3 * D(14) - D(19));
            ws[17] = static_cast<int16_t>(smooth_pred(num, Q21, al, true));
          }
          if ((al = cb[9]) != 0 && ws[24] == 0) {
            int64_t num = Q00 * (D(7) + 2 * D(8) + D(9) - D(17) - 2 * D(18) - D(19));
            ws[24] = static_cast<int16_t>(smooth_pred(num, Q30, al, true));
          }
          int64_t num = Q00 *
              (-2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) - 6 * D(6) + 6 * D(7) +
               42 * D(8) + 6 * D(9) - 6 * D(10) - 8 * D(11) + 42 * D(12) + 152 * D(13) +
               42 * D(14) - 8 * D(15) - 6 * D(16) + 6 * D(17) + 42 * D(18) + 6 * D(19) -
               6 * D(20) - 2 * D(21) - 6 * D(22) - 8 * D(23) - 6 * D(24) - 2 * D(25));
          ws[0] = static_cast<int16_t>(smooth_pred(num, Q00, 0, false));
        }
        idct_islow(ws, c.quant, &c.plane[(static_cast<size_t>(row) * 8 * c.stride) + bx * 8],
                   c.stride);
      }
    }
  }

  // every component's coefficients to samples
  void transform() {
    if (lossless) {
      for (int ci = 0; ci < ncomp; ++ci)
        if (comp[ci].plane.empty()) fail("a component has no scan");
      return;
    }
    for (int ci = 0; ci < ncomp; ++ci)
      if (!comp[ci].latched) fail("a component has no scan");
    bool smooth = smoothing_wanted();
    for (int ci = 0; ci < ncomp; ++ci) {
      Component &c = comp[ci];
      c.stride = static_cast<size_t>(c.bw) * 8;
      c.plane.assign(c.stride * c.bh * 8, 0);
      if (smooth) {
        smooth_and_idct(c);
        continue;
      }
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.block(bx, by), c.quant, &c.plane[static_cast<size_t>(by) * 8 * c.stride + bx * 8],
                     c.stride);
    }
  }

  // ---------------- parse ----------------

  void parse(bool header_only) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (int i = 0; i < 16; ++i) {  // libjpeg's DAC defaults
      dc_L[i] = 0;
      dc_U[i] = 1;
      ac_K[i] = 5;
    }
    fixed_bin[0] = 113;
    bool scanned = false;
    while (true) {
      if (pos >= len) {
        if (scanned && !header_only) return;  // a file cut after its scans
        fail("truncated file");
      }
      if (data[pos] != 0xFF) {  // garbage between segments: skip, as libjpeg
        ++pos;
        continue;
      }
      while (pos < len && data[pos] == 0xFF) ++pos;
      int marker = byte();
      if (marker == 0xD9) {
        if (!scanned) fail("no image data");
        return;
      }
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      int seg = u16() - 2;
      if (seg < 0 || pos + seg > len) fail("truncated segment");
      size_t seg_start = pos;
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
          marker != 0xCC) {
        pos -= 2;
        read_sof(marker);
        if (header_only) return;
      } else if (marker == 0xC4) {
        read_dht(seg);
      } else if (marker == 0xCC) {
        read_dac(seg);
      } else if (marker == 0xDB) {
        read_dqt(seg);
      } else if (marker == 0xDD) {
        restart_interval = u16();
      } else if (marker == 0xDA) {
        pos -= 2;
        read_scan();
        scanned = true;
        continue;
      } else if (marker == 0xE0) {
        if (seg >= 5 && !std::memcmp(data + pos, "JFIF\0", 5)) saw_jfif = true;
      } else if (marker == 0xEE) {
        if (seg >= 12 && !std::memcmp(data + pos, "Adobe", 5)) {
          saw_adobe = true;
          adobe_transform = data[pos + 11];
        }
      } else if (marker == 0xDC) {
        fail("JPEG with a DNL marker is not supported");
      }
      pos = seg_start + seg;
    }
  }

  // jdapimin.c default_decompress_parms
  ColorSpace color_space() const {
    if (ncomp == 1) return GRAY;
    if (ncomp == 4) return saw_adobe && adobe_transform == 0 ? CMYK : (saw_adobe ? YCCK : CMYK);
    if (saw_jfif) return YCBCR;
    if (saw_adobe) return adobe_transform == 0 ? RGB : YCBCR;
    if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return lossless ? RGB : YCBCR;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return RGB;
    return lossless ? RGB : YCBCR;
  }

  // ---------------- upsampling ----------------

  // component sample, rows clamped to the real ones (libjpeg replicates the
  // first row above and the last row below)
  int at(const Component &c, int x, int y) const {
    y = y < 0 ? 0 : (y >= c.ds_h ? c.ds_h - 1 : y);
    return c.plane[static_cast<size_t>(y) * c.stride + x];
  }

  // the component upsampled to the frame's width, for output row y
  // (jdsample.c jinit_upsampler's choice of method)
  void upsample_row(const Component &c, int y, std::vector<uint8_t> &row) const {
    int w = c.ds_w, hr = hmax / c.h, vr = vmax / c.v;
    bool fancy = !lossless;
    row.resize(static_cast<size_t>(w) * hr);
    if (hr == 1 && vr == 1) {
      for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(at(c, x, y));
      return;
    }
    if (hr == 1 && vr == 2 && fancy) {  // h1v2: the nearest row (x3) and the next nearest
      int yin = y / 2, ynext = (y & 1) ? yin + 1 : yin - 1, bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < w; ++x)
        row[x] = static_cast<uint8_t>((at(c, x, yin) * 3 + at(c, x, ynext) + bias) >> 2);
      return;
    }
    if (hr != 2 || vr > 2 || !fancy || w <= 2) {  // plain replication (int_upsample)
      int yy = y / vr;
      for (int x = 0; x < w; ++x) {
        uint8_t s = static_cast<uint8_t>(at(c, x, yy));
        for (int i = 0; i < hr; ++i) row[hr * x + i] = s;
      }
      return;
    }
    if (vr == 1) {  // h2v1
      int cur0 = at(c, 0, y);
      row[0] = static_cast<uint8_t>(cur0);
      row[1] = static_cast<uint8_t>((cur0 * 3 + at(c, 1, y) + 2) >> 2);
      for (int x = 1; x < w - 1; ++x) {
        int v = at(c, x, y) * 3;
        row[2 * x] = static_cast<uint8_t>((v + at(c, x - 1, y) + 1) >> 2);
        row[2 * x + 1] = static_cast<uint8_t>((v + at(c, x + 1, y) + 2) >> 2);
      }
      int last = at(c, w - 1, y);
      row[2 * w - 2] = static_cast<uint8_t>((last * 3 + at(c, w - 2, y) + 1) >> 2);
      row[2 * w - 1] = static_cast<uint8_t>(last);
      return;
    }
    // h2v2: column sums of the nearest row (x3) and the next nearest
    int yin = y / 2, ynext = (y & 1) ? yin + 1 : yin - 1;
    auto colsum = [&](int x) { return at(c, x, yin) * 3 + at(c, x, ynext); };
    int thiscol = colsum(0), nextcol = colsum(1), lastcol;
    row[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
    row[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
    lastcol = thiscol;
    thiscol = nextcol;
    for (int x = 1; x < w - 1; ++x) {
      nextcol = colsum(x + 1);
      row[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      row[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
    }
    row[2 * w - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
    row[2 * w - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
  }

  void output(uint8_t *out) const {
    if (ncomp == 1) {
      const Component &c = comp[0];
      std::vector<uint8_t> r;
      for (int y = 0; y < height; ++y) {
        upsample_row(c, y, r);
        std::memcpy(out + static_cast<size_t>(y) * width, r.data(), width);
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table: SCALEBITS 16, tables indexed by Cb / Cr
    const int64_t ONE_HALF = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    ColorSpace cs = color_space();
    std::vector<uint8_t> r[4];
    for (int y = 0; y < height; ++y) {
      for (int ci = 0; ci < ncomp; ++ci) upsample_row(comp[ci], y, r[ci]);
      uint8_t *o = out + static_cast<size_t>(y) * width * ncomp;
      for (int x = 0; x < width; ++x, o += ncomp) {
        int Y = r[0][x], cb = r[1][x], cr = r[2][x];
        if (cs == RGB || cs == CMYK) {
          for (int ci = 0; ci < ncomp; ++ci) o[ci] = r[ci][x];
        } else {
          int g = Y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16);
          if (cs == YCBCR) {
            o[0] = clamp(Y + cr_r[cr]);
            o[1] = clamp(g);
            o[2] = clamp(Y + cb_b[cb]);
          } else {  // YCCK -> CMYK (ycck_cmyk_convert): inverted RGB, K as is
            o[0] = clamp(255 - (Y + cr_r[cr]));
            o[1] = clamp(255 - g);
            o[2] = clamp(255 - (Y + cb_b[cb]));
            o[3] = r[3][x];
          }
        }
        if (ncomp == 4)  // Pillow's raw mode "CMYK;I"
          for (int ci = 0; ci < 4; ++ci) o[ci] = static_cast<uint8_t>(255 - o[ci]);
      }
    }
  }
};

void set_error(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

int jd_info(const uint8_t *data, size_t len, int *w, int *h, int *channels, char *err,
            int errlen) {
  try {
    Decoder d;
    d.data = data;
    d.len = len;
    d.parse(true);
    if (!d.have_frame) throw Error{"no frame header"};
    *w = d.width;
    *h = d.height;
    *channels = d.ncomp;
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
    return 1;
  }
}

int jd_decode(const uint8_t *data, size_t len, uint8_t *out, char *err, int errlen) {
  try {
    Decoder d;
    d.data = data;
    d.len = len;
    d.parse(false);
    d.transform();
    d.output(out);
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
    return 1;
  }
}

}  // extern "C"
