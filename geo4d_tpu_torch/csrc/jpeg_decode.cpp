// Baseline and extended-sequential Huffman JPEG decoder (host C++, plain C
// interface for ctypes), computing what libjpeg-turbo computes with its
// default decompression parameters, as Pillow uses them:
//
//   * 8-bit samples, 1 or 3 components, any sampling factors whose ratio to
//     the largest is 1 or 2 in each direction (4:4:4, 4:2:2, 4:2:0, 4:4:0),
//     interleaved or single-component scans, restart intervals;
//   * the integer "islow" IDCT (jidctint.c), with its range-limit table;
//   * "fancy" (triangle-filter) chroma upsampling (jdsample.c: h2v1, h1v2
//     and h2v2, the row above the first and below the last replicated),
//     plain replication where a 2x-wide component is at most 2 samples wide;
//   * libjpeg's fixed-point YCbCr -> RGB (jdcolor.c, 16-bit tables).
//
// Progressive, lossless, hierarchical and arithmetic-coded files, other
// precisions and 4-component images are refused with a message that names
// the mode.
//
//   int jd_info(data, len, &w, &h, &channels, err, errlen)
//   int jd_decode(data, len, out, err, errlen)   out: h * w * channels bytes
//
// Both return 0 on success, else 1 with a message in err. channels is 1
// (grayscale) or 3 (RGB).

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

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int quant[64];
  int ds_w, ds_h;        // downsampled size (samples that are real)
  int blocks_w, blocks_h;  // blocks in the component's plane
  std::vector<uint8_t> plane;  // blocks_h * 8 rows of blocks_w * 8 samples
  int dc_pred = 0;
};

struct Decoder {
  const uint8_t *data;
  size_t len, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false, have_frame = false;
  int adobe_transform = -1;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];
  int mcus_x = 0, mcus_y = 0;
  // entropy-coded segment reader
  uint64_t bits = 0;
  int nbits = 0;
  bool hit_marker = false;

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

  void read_sof(int marker) {
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
      fail("progressive JPEG (SOF" + std::to_string(marker - 0xC0) + ") is not supported");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      fail("lossless JPEG (SOF" + std::to_string(marker - 0xC0) + ") is not supported");
    if (marker >= 0xC9)
      fail("arithmetic-coded JPEG (SOF" + std::to_string(marker - 0xC0) + ") is not supported");
    if (marker == 0xC5) fail("hierarchical JPEG (SOF5) is not supported");
    if (have_frame) fail("more than one frame");
    u16();
    int precision = byte();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG is not supported (8-bit samples only)");
    height = u16();
    width = u16();
    ncomp = byte();
    if (height == 0) fail("JPEG with its height in a DNL marker is not supported");
    if (width == 0) fail("zero image width");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG is not supported (1 or 3)");
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
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component &c = comp[i];
      if (ncomp > 1 && ((hmax != c.h && hmax != 2 * c.h) || (vmax != c.v && vmax != 2 * c.v)))
        fail("sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) + " of " +
             std::to_string(hmax) + "x" + std::to_string(vmax) + " are not supported");
      c.ds_w = (width * c.h + hmax - 1) / hmax;
      c.ds_h = (height * c.v + vmax - 1) / vmax;
      c.blocks_w = mcus_x * c.h;
      c.blocks_h = mcus_y * c.v;
      c.plane.assign(static_cast<size_t>(c.blocks_w) * 8 * c.blocks_h * 8, 0);
    }
    have_frame = true;
  }

  // ---------------- entropy-coded data ----------------

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

  void decode_block(Component &c, int bx, int by) {
    int coef[64] = {0};
    int s = decode(dc[c.td]);
    int diff = s ? extend(get_bits(s), s) : 0;
    c.dc_pred += diff;
    coef[0] = c.dc_pred;
    for (int k = 1; k < 64; ++k) {
      int rs = decode(ac[c.ta]);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNaturalOrder[k]] = extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    size_t stride = static_cast<size_t>(c.blocks_w) * 8;
    idct_islow(coef, c.quant, &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
  }

  void restart() {
    // the next marker must be RSTn: consume it, reset the bit reader and
    // the DC predictions
    bits = 0;
    nbits = 0;
    hit_marker = false;
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7))
      ++pos;
    if (pos + 1 < len) pos += 2;
    for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
  }

  void read_scan() {
    if (!have_frame) fail("scan before the frame header");
    u16();
    int ns = byte();
    if (ns < 1 || ns > ncomp) fail("bad SOS");
    Component *sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component *c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        fail("scan uses an undefined Huffman table");
      if (!qt_defined[c->tq]) fail("component uses an undefined quantisation table");
      for (int k = 0; k < 64; ++k) c->quant[k] = qt[c->tq][k];
      c->dc_pred = 0;
      sc[i] = c;
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0) fail("bad spectral selection for a sequential scan");
    bits = 0;
    nbits = 0;
    hit_marker = false;
    int todo = restart_interval;
    auto mcu_done = [&](bool last) {
      if (restart_interval && !last && --todo == 0) {
        restart();
        todo = restart_interval;
      }
    };
    if (ns == 1) {  // non-interleaved: one block per MCU, over the real blocks
      Component &c = *sc[0];
      int bw = (c.ds_w + 7) / 8, bh = (c.ds_h + 7) / 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          decode_block(c, bx, by);
          mcu_done(by == bh - 1 && bx == bw - 1);
        }
    } else {
      for (int my = 0; my < mcus_y; ++my)
        for (int mx = 0; mx < mcus_x; ++mx) {
          for (int i = 0; i < ns; ++i) {
            Component &c = *sc[i];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) decode_block(c, mx * c.h + x, my * c.v + y);
          }
          mcu_done(my == mcus_y - 1 && mx == mcus_x - 1);
        }
    }
    // continue at the next marker
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                              !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      ++pos;
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

  static void idct_islow(const int *coef, const int *quant, uint8_t *out, size_t stride) {
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

  // ---------------- parse ----------------

  void parse(bool header_only) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
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
        fail("arithmetic-coded JPEG (DAC) is not supported");
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

  bool is_rgb() const {
    if (ncomp != 3) return false;
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  // ---------------- upsampling ----------------

  // component sample, rows clamped to the real ones (libjpeg replicates the
  // first row above and the last row below)
  int at(const Component &c, int x, int y) const {
    y = y < 0 ? 0 : (y >= c.ds_h ? c.ds_h - 1 : y);
    return c.plane[static_cast<size_t>(y) * c.blocks_w * 8 + x];
  }

  // the component upsampled to the frame's width, for output row y
  void upsample_row(const Component &c, int y, std::vector<uint8_t> &row) const {
    int w = c.ds_w;
    bool h2 = c.h * 2 == hmax, v2 = c.v * 2 == vmax;
    row.resize(static_cast<size_t>(w) * (h2 ? 2 : 1));
    if (!h2 && !v2) {
      for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(at(c, x, y));
      return;
    }
    if (!h2) {  // h1v2: the nearest row (x3) and the next nearest
      int yin = y / 2, ynext = (y & 1) ? yin + 1 : yin - 1, bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < w; ++x)
        row[x] = static_cast<uint8_t>((at(c, x, yin) * 3 + at(c, x, ynext) + bias) >> 2);
      return;
    }
    if (w <= 2) {  // fancy upsampling needs 3 samples: plain replication
      int yy = v2 ? y / 2 : y;
      for (int x = 0; x < w; ++x) {
        uint8_t s = static_cast<uint8_t>(at(c, x, yy));
        row[2 * x] = row[2 * x + 1] = s;
      }
      return;
    }
    if (!v2) {  // h2v1
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
      for (int y = 0; y < height; ++y)
        std::memcpy(out + static_cast<size_t>(y) * width,
                    &c.plane[static_cast<size_t>(y) * c.blocks_w * 8], width);
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
    bool rgb = is_rgb();
    std::vector<uint8_t> r0, r1, r2;
    for (int y = 0; y < height; ++y) {
      upsample_row(comp[0], y, r0);
      upsample_row(comp[1], y, r1);
      upsample_row(comp[2], y, r2);
      uint8_t *o = out + static_cast<size_t>(y) * width * 3;
      for (int x = 0; x < width; ++x) {
        int Y = r0[x], cb = r1[x], cr = r2[x];
        if (rgb) {
          o[3 * x] = static_cast<uint8_t>(Y);
          o[3 * x + 1] = static_cast<uint8_t>(cb);
          o[3 * x + 2] = static_cast<uint8_t>(cr);
          continue;
        }
        o[3 * x] = clamp(Y + cr_r[cr]);
        o[3 * x + 1] = clamp(Y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(Y + cb_b[cb]);
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
    *channels = d.ncomp == 1 ? 1 : 3;
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
    d.output(out);
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
    return 1;
  }
}

}  // extern "C"
