// Writes the JPEG fixtures that neither Pillow nor OpenCV can write, through
// libjpeg's own compressor (built and run by make_fixtures.py):
//
//   jpeg_writer MODE IN.raw OUT.jpg
//
// IN.raw is "W H C\n" and W * H * C bytes of samples (C = 1, 3 or 4). MODE:
//
//   arith_420_rst   arithmetic sequential (SOF9), 4:2:0, a restart every 5 MCUs,
//                   DC and AC conditioning other than the defaults (DAC)
//   arith_prog      arithmetic progressive (SOF10), 4:2:0, libjpeg's scan script
//   arith_prog_gray arithmetic progressive, grayscale, a restart every MCU row
//   h411            true 4:1:1 (luma 4x1, chroma 1x1), Huffman, quality 90
//   ycck            4 components, Adobe transform 2 (YCCK), 4:2:0 chroma
//   smooth          progressive, a scan script that never sends the last bit
//                   of the AC coefficients (libjpeg then smooths the blocks)
//   smooth_dc       progressive, DC scans and a high-frequency AC band only
//                   (libjpeg then also interpolates the DC values)
//   lossless_rgb    lossless (SOF3), RGB, predictor 6, a restart every row
//   lossless_gray   lossless, grayscale, predictor 7, point transform 2
//   lossless_420    lossless, YCbCr 4:2:0 (the colour transform and the
//                   chroma subsampling lose data; the coding does not), predictor 1
//   bits12          12-bit extended sequential (SOF1)
//
// The lossless and 12-bit modes need libjpeg-turbo 3 (jpeg_enable_lossless,
// jpeg12_write_scanlines); the others build against libjpeg-turbo 2.1 or
// later with arithmetic coding.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <jpeglib.h>

#ifdef WITH_TURBO3
extern "C" void jpeg_enable_lossless(j_compress_ptr cinfo, int predictor_selection_value,
                                     int point_transform);
extern "C" JDIMENSION jpeg12_write_scanlines(j_compress_ptr cinfo, short **scanlines,
                                             JDIMENSION num_lines);
#endif

static void scan(jpeg_scan_info *s, int ncomps, int c0, int ss, int se, int ah, int al) {
  s->comps_in_scan = ncomps;
  for (int i = 0; i < ncomps; ++i) s->component_index[i] = c0 + i;
  s->Ss = ss;
  s->Se = se;
  s->Ah = ah;
  s->Al = al;
}

int main(int argc, char **argv) {
  if (argc != 4) {
    std::fprintf(stderr, "usage: jpeg_writer MODE IN.raw OUT.jpg\n");
    return 2;
  }
  std::string mode = argv[1];
  FILE *in = std::fopen(argv[2], "rb");
  if (!in) return 2;
  int w, h, c;
  if (std::fscanf(in, "%d %d %d", &w, &h, &c) != 3) return 2;
  std::fgetc(in);
  std::vector<unsigned char> px(static_cast<size_t>(w) * h * c);
  if (std::fread(px.data(), 1, px.size(), in) != px.size()) return 2;
  std::fclose(in);

  jpeg_compress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE *out = std::fopen(argv[3], "wb");
  if (!out) return 2;
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : (c == 3 ? JCS_RGB : JCS_CMYK);
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, 85, TRUE);
  static jpeg_scan_info scans[16];

  if (mode == "arith_420_rst") {
    cinfo.arith_code = TRUE;
    cinfo.restart_interval = 5;
    // conditioning other than libjpeg's defaults (L 0, U 1, Kx 5), in DAC
    cinfo.arith_dc_L[0] = 2;
    cinfo.arith_dc_U[0] = 6;
    cinfo.arith_dc_U[1] = 3;
    cinfo.arith_ac_K[0] = 12;
    cinfo.arith_ac_K[1] = 2;
  } else if (mode == "arith_prog") {
    cinfo.arith_code = TRUE;
    jpeg_simple_progression(&cinfo);
  } else if (mode == "arith_prog_gray") {
    cinfo.arith_code = TRUE;
    cinfo.restart_in_rows = 1;
    jpeg_simple_progression(&cinfo);
  } else if (mode == "h411") {
    jpeg_set_quality(&cinfo, 90, TRUE);
    cinfo.comp_info[0].h_samp_factor = 4;
    cinfo.comp_info[0].v_samp_factor = 1;
    for (int i = 1; i < 3; ++i) cinfo.comp_info[i].h_samp_factor = cinfo.comp_info[i].v_samp_factor = 1;
  } else if (mode == "ycck") {
    jpeg_set_colorspace(&cinfo, JCS_YCCK);
    cinfo.comp_info[0].h_samp_factor = cinfo.comp_info[0].v_samp_factor = 2;
    cinfo.comp_info[3].h_samp_factor = cinfo.comp_info[3].v_samp_factor = 2;
  } else if (mode == "smooth") {
    // DC exact; luma AC 1-5 and 6-63 to 2 bits short, refined once; chroma
    // AC to 1 bit short: the last bit of every AC coefficient never comes
    int n = 0;
    scan(&scans[n++], 3, 0, 0, 0, 0, 1);
    scan(&scans[n++], 1, 0, 1, 5, 0, 2);
    scan(&scans[n++], 1, 2, 1, 63, 0, 1);
    scan(&scans[n++], 1, 1, 1, 63, 0, 1);
    scan(&scans[n++], 1, 0, 6, 63, 0, 2);
    scan(&scans[n++], 1, 0, 1, 63, 2, 1);
    scan(&scans[n++], 3, 0, 0, 0, 1, 0);
    cinfo.scan_info = scans;
    cinfo.num_scans = n;
  } else if (mode == "smooth_dc") {
    int n = 0;
    scan(&scans[n++], 1, 0, 0, 0, 0, 0);
    scan(&scans[n++], 1, 0, 20, 63, 0, 0);
    cinfo.scan_info = scans;
    cinfo.num_scans = n;
#ifdef WITH_TURBO3
  } else if (mode == "lossless_rgb") {
    jpeg_set_colorspace(&cinfo, JCS_RGB);
    jpeg_enable_lossless(&cinfo, 6, 0);
    cinfo.restart_in_rows = 1;
  } else if (mode == "lossless_420") {
    jpeg_enable_lossless(&cinfo, 1, 0);
  } else if (mode == "lossless_gray") {
    jpeg_enable_lossless(&cinfo, 7, 2);
  } else if (mode == "bits12") {
    cinfo.data_precision = 12;
    jpeg_set_defaults(&cinfo);
#endif
  } else {
    std::fprintf(stderr, "unknown mode %s\n", mode.c_str());
    return 2;
  }

  jpeg_start_compress(&cinfo, TRUE);
#ifdef WITH_TURBO3
  if (mode == "bits12") {
    std::vector<short> row(static_cast<size_t>(w) * c);
    while (cinfo.next_scanline < cinfo.image_height) {
      const unsigned char *p = &px[static_cast<size_t>(cinfo.next_scanline) * w * c];
      for (size_t i = 0; i < row.size(); ++i) row[i] = static_cast<short>(p[i] * 16 + (i & 15));
      short *rows[1] = {row.data()};
      jpeg12_write_scanlines(&cinfo, rows, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    std::fclose(out);
    return 0;
  }
#endif
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = &px[static_cast<size_t>(cinfo.next_scanline) * w * c];
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::fclose(out);
  return 0;
}
