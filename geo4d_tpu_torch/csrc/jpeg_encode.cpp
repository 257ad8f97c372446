// Baseline JPEG encoder (host C++, plain C interface for ctypes) that writes
// what libjpeg-turbo writes with its default compression parameters, as
// Pillow's `Image.save(path, quality=q)` and OpenCV's `imwrite` use them:
//
//   * SOI, a JFIF 1.01 APP0 (density 1:1, no unit), one DQT marker per
//     table, SOF0, one DHT marker per table (DC then AC of each component
//     of the scan, in component order), SOS, the entropy-coded data, EOI;
//     no restart markers;
//   * the quantisation tables of ITU T.81 Annex K.1 scaled by quality as
//     libjpeg scales them (below 50: 5000 / q percent, else 200 - 2q), each
//     value clamped to 1..255 (baseline);
//   * RGB -> YCbCr in 16-bit fixed point (the JFIF equations, rounded as
//     libjpeg's conversion tables round them);
//   * 4:2:0: each chroma sample is the mean of a 2x2 block, rounded with a
//     bias that alternates 1, 2 along the row; the image is first extended
//     by repeating its last column and row;
//   * edges: a partial 8x8 block repeats the image's last column and row; a
//     block of a 16x16 MCU that lies wholly outside the image is coded with
//     no AC coefficient and the DC of the block before it;
//   * the integer forward DCT of Loeffler, Ligtenberg and Moschytz with
//     13-bit constants (libjpeg's "islow"), output scaled by 8, and
//     quantisation by division rounded half away from zero;
//   * the Huffman tables of Annex K.3, byte stuffing, the last byte padded
//     with 1 bits.
//
// A grayscale image is one component (sampling 1x1, table 0) coded in a
// non-interleaved scan of its 8x8 blocks.
//
//   int64_t je_encode(pixels, w, h, channels, quality, out, cap, err, errlen)
//
// pixels: h * w * channels bytes (channels 1: gray, 3: RGB). Returns the size
// of the file; the bytes are written to `out` only if it fits in `cap` (call
// again with a larger buffer otherwise). Returns -1 with a message in err on
// bad arguments.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// Annex K.1, natural (row-major) order
const uint8_t kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: code counts per length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {
  const uint8_t *bits;
  const uint8_t *vals;
};
const HuffSpec kDc[2] = {{kDcLumaBits, kDcVals}, {kDcChromaBits, kDcVals}};
const HuffSpec kAc[2] = {{kAcLumaBits, kAcLumaVals}, {kAcChromaBits, kAcChromaVals}};

int n_symbols(const HuffSpec &s) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += s.bits[i];
  return n;
}

// Annex C: canonical codes, shortest first, in symbol-list order
struct HuffCodes {
  uint16_t code[256];
  uint8_t len[256];
  explicit HuffCodes(const HuffSpec &s) {
    std::memset(len, 0, sizeof(len));
    int code_val = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < s.bits[l - 1]; ++i, ++k) {
        code[s.vals[k]] = static_cast<uint16_t>(code_val++);
        len[s.vals[k]] = static_cast<uint8_t>(l);
      }
      code_val <<= 1;
    }
  }
};

// zigzag position -> natural index (Figure A.6), walked along anti-diagonals
struct Zigzag {
  int natural[64];
  Zigzag() {
    int k = 0;
    for (int s = 0; s < 15; ++s) {
      int lo = std::max(0, s - 7), hi = std::min(s, 7);
      for (int i = lo; i <= hi; ++i) {
        int row = (s % 2) ? i : s - i;  // odd diagonals run down-left, even up-right
        natural[k++] = row * 8 + (s - row);
      }
    }
  }
};
const Zigzag kZigzag;

void scale_quant(const uint8_t base[64], int quality, uint16_t out[64]) {
  quality = std::min(std::max(quality, 1), 100);
  long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long v = (base[i] * scale + 50) / 100;
    out[i] = static_cast<uint16_t>(std::min(std::max(v, 1L), 255L));
  }
}

// ---------------------------------------------------------------- FDCT ----

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t fix(double x) { return static_cast<int32_t>(x * (1 << kConstBits) + 0.5); }

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// One 8-point transform of the LL&M flow graph on in[0], in[step], ...;
// the even part's DC and Nyquist terms are shifted left by `dc_shift` (pass
// 1) or descaled by `-dc_shift` (pass 2), the rotations descaled by `rot`.
void fdct_1d(int32_t *d, int step, int dc_shift, int rot) {
  int32_t t0 = d[0] + d[7 * step], t7 = d[0] - d[7 * step];
  int32_t t1 = d[step] + d[6 * step], t6 = d[step] - d[6 * step];
  int32_t t2 = d[2 * step] + d[5 * step], t5 = d[2 * step] - d[5 * step];
  int32_t t3 = d[3 * step] + d[4 * step], t4 = d[3 * step] - d[4 * step];

  int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
  if (dc_shift >= 0) {
    d[0] = (t10 + t11) * (1 << dc_shift);
    d[4 * step] = (t10 - t11) * (1 << dc_shift);
  } else {
    d[0] = descale(t10 + t11, -dc_shift);
    d[4 * step] = descale(t10 - t11, -dc_shift);
  }
  int32_t z1 = (t12 + t13) * fix(0.541196100);
  d[2 * step] = descale(z1 + t13 * fix(0.765366865), rot);
  d[6 * step] = descale(z1 + t12 * -fix(1.847759065), rot);

  z1 = t4 + t7;
  int32_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
  int32_t z5 = (z3 + z4) * fix(1.175875602);
  t4 *= fix(0.298631336);
  t5 *= fix(2.053119869);
  t6 *= fix(3.072711026);
  t7 *= fix(1.501321110);
  z1 *= -fix(0.899976223);
  z2 *= -fix(2.562915447);
  z3 = z3 * -fix(1.961570560) + z5;
  z4 = z4 * -fix(0.390180644) + z5;
  d[7 * step] = descale(t4 + z1 + z3, rot);
  d[5 * step] = descale(t5 + z2 + z4, rot);
  d[3 * step] = descale(t6 + z2 + z3, rot);
  d[step] = descale(t7 + z1 + z4, rot);
}

// level-shifted samples -> quantised coefficients in natural order
void fdct_quantize(int32_t blk[64], const uint16_t quant[64], int16_t out[64]) {
  for (int r = 0; r < 8; ++r) fdct_1d(blk + 8 * r, 1, kPass1Bits, kConstBits - kPass1Bits);
  for (int c = 0; c < 8; ++c) fdct_1d(blk + c, 8, -kPass1Bits, kConstBits + kPass1Bits);
  for (int i = 0; i < 64; ++i) {
    int32_t q = quant[i] * 8;  // the transform's output is scaled by 8
    int32_t a = blk[i] < 0 ? -blk[i] : blk[i];
    a = (a + q / 2) / q;
    out[i] = static_cast<int16_t>(blk[i] < 0 ? -a : a);
  }
}

// ---------------------------------------------------------- bit writer ----

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int nbits = 0;

  void byte(uint8_t b) { out.push_back(b); }
  void word(int v) {
    byte(static_cast<uint8_t>(v >> 8));
    byte(static_cast<uint8_t>(v));
  }
  void marker(uint8_t m, int length) {  // length counts itself, not the marker
    byte(0xFF);
    byte(m);
    word(length);
  }
  void bits(uint32_t code, int len) {
    acc = (acc << len) | (code & ((1u << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      byte(b);
      if (b == 0xFF) byte(0);  // byte stuffing
      nbits -= 8;
    }
    acc &= (1u << nbits) - 1;
  }
  void flush() {
    if (nbits) bits(0x7F, 8 - nbits);
  }
};

int magnitude_bits(int v) {
  int a = v < 0 ? -v : v, n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

void encode_block(Writer &w, const int16_t coef[64], int &dc_pred, const HuffCodes &dc,
                  const HuffCodes &ac) {
  int diff = coef[0] - dc_pred;
  dc_pred = coef[0];
  int n = magnitude_bits(diff);
  w.bits(dc.code[n], dc.len[n]);
  if (n) w.bits(diff < 0 ? diff - 1 : diff, n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kZigzag.natural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) w.bits(ac.code[0xF0], ac.len[0xF0]);
    n = magnitude_bits(v);
    int sym = (run << 4) | n;
    w.bits(ac.code[sym], ac.len[sym]);
    w.bits(v < 0 ? v - 1 : v, n);
    run = 0;
  }
  if (run) w.bits(ac.code[0], ac.len[0]);
}

// ------------------------------------------------------------- planes ----

struct Plane {
  int w, h;  // a multiple of 8 each
  std::vector<uint8_t> px;
  uint8_t at(int x, int y) const { return px[static_cast<size_t>(y) * w + x]; }
};

// 8x8 block (bx, by) of a plane, level-shifted, quantised
void block_coefs(const Plane &p, int bx, int by, const uint16_t quant[64], int16_t out[64]) {
  int32_t blk[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) blk[y * 8 + x] = p.at(bx * 8 + x, by * 8 + y) - 128;
  fdct_quantize(blk, quant, out);
}

int32_t fix16(double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); }

void write_headers(Writer &w, int width, int height, int ncomp, const uint16_t quant[2][64]) {
  w.byte(0xFF);
  w.byte(0xD8);  // SOI
  w.marker(0xE0, 16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : jfif) w.byte(b);  // version 1.01, no unit, density 1:1, no thumbnail
  int ntables = ncomp == 1 ? 1 : 2;
  for (int t = 0; t < ntables; ++t) {
    w.marker(0xDB, 67);
    w.byte(static_cast<uint8_t>(t));  // 8-bit precision, table t
    for (int k = 0; k < 64; ++k) w.byte(static_cast<uint8_t>(quant[t][kZigzag.natural[k]]));
  }
  w.marker(0xC0, 8 + 3 * ncomp);
  w.byte(8);
  w.word(height);
  w.word(width);
  w.byte(static_cast<uint8_t>(ncomp));
  for (int c = 0; c < ncomp; ++c) {
    w.byte(static_cast<uint8_t>(c + 1));
    w.byte(ncomp == 3 && c == 0 ? 0x22 : 0x11);
    w.byte(c == 0 ? 0 : 1);
  }
  for (int t = 0; t < ntables; ++t) {
    for (int is_ac = 0; is_ac < 2; ++is_ac) {
      const HuffSpec &s = is_ac ? kAc[t] : kDc[t];
      int n = n_symbols(s);
      w.marker(0xC4, 2 + 1 + 16 + n);
      w.byte(static_cast<uint8_t>(is_ac * 0x10 + t));
      for (int i = 0; i < 16; ++i) w.byte(s.bits[i]);
      for (int i = 0; i < n; ++i) w.byte(s.vals[i]);
    }
  }
  w.marker(0xDA, 6 + 2 * ncomp);
  w.byte(static_cast<uint8_t>(ncomp));
  for (int c = 0; c < ncomp; ++c) {
    w.byte(static_cast<uint8_t>(c + 1));
    w.byte(c == 0 ? 0x00 : 0x11);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);
}

void encode(const uint8_t *px, int width, int height, int channels, int quality,
            Writer &w) {
  uint16_t quant[2][64];
  scale_quant(kLumaQuant, quality, quant[0]);
  scale_quant(kChromaQuant, quality, quant[1]);
  write_headers(w, width, height, channels, quant);
  const HuffCodes dc0(kDc[0]), ac0(kAc[0]), dc1(kDc[1]), ac1(kAc[1]);
  int wb = (width + 7) / 8, hb = (height + 7) / 8;  // luma blocks that hold pixels
  auto clampx = [&](int x) { return std::min(x, width - 1); };
  auto clampy = [&](int y) { return std::min(y, height - 1); };
  int16_t coef[64];

  if (channels == 1) {  // one component, non-interleaved: only blocks that hold pixels
    Plane g{wb * 8, hb * 8, {}};
    g.px.resize(static_cast<size_t>(g.w) * g.h);
    for (int y = 0; y < g.h; ++y)
      for (int x = 0; x < g.w; ++x)
        g.px[static_cast<size_t>(y) * g.w + x] =
            px[static_cast<size_t>(clampy(y)) * width + clampx(x)];
    int pred = 0;
    for (int by = 0; by < hb; ++by)
      for (int bx = 0; bx < wb; ++bx) {
        block_coefs(g, bx, by, quant[0], coef);
        encode_block(w, coef, pred, dc0, ac0);
      }
    w.flush();
    w.byte(0xFF);
    w.byte(0xD9);
    return;
  }

  // colour conversion at full resolution
  const int32_t ry = fix16(0.29900), gy = fix16(0.58700), by_ = fix16(0.11400);
  const int32_t rcb = fix16(0.16874), gcb = fix16(0.33126), half = fix16(0.5);
  const int32_t gcr = fix16(0.41869), bcr = fix16(0.08131);
  const int32_t one_half = 1 << 15, center = 128 << 16;
  size_t n = static_cast<size_t>(width) * height;
  std::vector<uint8_t> Y(n), Cb(n), Cr(n);
  for (size_t i = 0; i < n; ++i) {
    int32_t r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
    Y[i] = static_cast<uint8_t>((ry * r + gy * g + by_ * b + one_half) >> 16);
    Cb[i] = static_cast<uint8_t>((-rcb * r - gcb * g + half * b + center + one_half - 1) >> 16);
    Cr[i] = static_cast<uint8_t>((half * r - gcr * g - bcr * b + center + one_half - 1) >> 16);
  }

  int mcux = (width + 15) / 16, mcuy = (height + 15) / 16;
  Plane luma{wb * 8, hb * 8, {}};
  luma.px.resize(static_cast<size_t>(luma.w) * luma.h);
  for (int y = 0; y < luma.h; ++y)
    for (int x = 0; x < luma.w; ++x)
      luma.px[static_cast<size_t>(y) * luma.w + x] =
          Y[static_cast<size_t>(clampy(y)) * width + clampx(x)];
  // 2x2 means of the edge-extended plane; rows past the image repeat the last
  Plane chroma[2] = {{mcux * 8, mcuy * 8, {}}, {mcux * 8, mcuy * 8, {}}};
  int last_row = (height + 1) / 2 - 1;
  for (int c = 0; c < 2; ++c) {
    const std::vector<uint8_t> &src = c == 0 ? Cb : Cr;
    Plane &p = chroma[c];
    p.px.resize(static_cast<size_t>(p.w) * p.h);
    for (int y = 0; y < p.h; ++y) {
      int sy = std::min(y, last_row);
      const uint8_t *r0 = &src[static_cast<size_t>(clampy(2 * sy)) * width];
      const uint8_t *r1 = &src[static_cast<size_t>(clampy(2 * sy + 1)) * width];
      for (int x = 0; x < p.w; ++x) {
        int x0 = clampx(2 * x), x1 = clampx(2 * x + 1);
        int bias = (x & 1) ? 2 : 1;
        p.px[static_cast<size_t>(y) * p.w + x] =
            static_cast<uint8_t>((r0[x0] + r0[x1] + r1[x0] + r1[x1] + bias) >> 2);
      }
    }
  }

  int pred[3] = {0, 0, 0};
  int16_t mcu[4][64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int k = 0; k < 4; ++k) {
        int bx = 2 * mx + (k & 1), byk = 2 * my + (k >> 1);
        if (byk >= hb || bx >= wb) {  // outside the image: the DC of the block before
          std::memset(mcu[k], 0, sizeof(mcu[k]));
          mcu[k][0] = mcu[byk >= hb ? 1 : k - 1][0];
        } else {
          block_coefs(luma, bx, byk, quant[0], mcu[k]);
        }
        encode_block(w, mcu[k], pred[0], dc0, ac0);
      }
      for (int c = 0; c < 2; ++c) {
        block_coefs(chroma[c], mx, my, quant[1], coef);
        encode_block(w, coef, pred[1 + c], dc1, ac1);
      }
    }
  }
  w.flush();
  w.byte(0xFF);
  w.byte(0xD9);
}

}  // namespace

extern "C" {

int64_t je_encode(const uint8_t *pixels, int width, int height, int channels, int quality,
                  uint8_t *out, int64_t cap, char *err, int errlen) {
  if (width < 1 || height < 1 || width > 65535 || height > 65535 ||
      (channels != 1 && channels != 3)) {
    std::snprintf(err, errlen, "cannot encode a %dx%d image of %d channels as JPEG", width,
                  height, channels);
    return -1;
  }
  Writer w;
  encode(pixels, width, height, channels, quality, w);
  int64_t size = static_cast<int64_t>(w.out.size());
  if (size <= cap) std::memcpy(out, w.out.data(), w.out.size());
  return size;
}

}  // extern "C"
