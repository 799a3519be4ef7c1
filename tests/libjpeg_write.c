/* The JPEG writer of tests/torch_images.py::libjpeg_bytes: libjpeg's
 * compressor with the settings PIL does not pass (a CMYK or YCCK colour
 * space, arithmetic coding, per-component sampling factors, a restart
 * interval in MCUs, DAC conditioning values, lossless frames). Built with the system's
 * jpeglib.h and linked against PIL's bundled libjpeg-turbo, which has the
 * arithmetic encoder. */

#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>

#include <jpeglib.h>

/* libjpeg-turbo 3's lossless mode (SOF3), which the system's 2.1 header
 * does not declare */
void jpeg_enable_lossless(j_compress_ptr c, int predictor, int point_transform);

struct fail {
  struct jpeg_error_mgr pub;
  jmp_buf env;
};

static void fail_exit(j_common_ptr c) { longjmp(((struct fail *)c->err)->env, 1); }

/* in_cs/jpeg_cs: J_COLOR_SPACE values; hv: h0 v0 h1 v1 ...; dac: L, U and
 * K of table 0, then of table 1 (-1: libjpeg's default). Returns the
 * file's size and *out (free with pts_free), 0 on failure. */
unsigned long pts_write(const unsigned char *px, int w, int h, int ncomp,
                        int in_cs, int jpeg_cs, int quality, int arith,
                        int progressive, int lossless, int restart,
                        const int *hv,
                        const int *dac, unsigned char **out) {
  struct jpeg_compress_struct c;
  struct fail err;
  unsigned long size = 0;
  c.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = fail_exit;
  *out = NULL;
  if (setjmp(err.env)) {
    jpeg_destroy_compress(&c);
    free(*out);
    *out = NULL;
    return 0;
  }
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, out, &size);
  c.image_width = (JDIMENSION)w;
  c.image_height = (JDIMENSION)h;
  c.input_components = ncomp;
  c.in_color_space = (J_COLOR_SPACE)in_cs;
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, (J_COLOR_SPACE)jpeg_cs);
  jpeg_set_quality(&c, quality, TRUE);
  for (int i = 0; i < c.num_components; ++i) {
    c.comp_info[i].h_samp_factor = hv[2 * i];
    c.comp_info[i].v_samp_factor = hv[2 * i + 1];
  }
  c.arith_code = arith ? TRUE : FALSE;
  c.restart_interval = (unsigned int)restart;
  for (int t = 0; t < 2; ++t) {
    if (dac[3 * t] >= 0) c.arith_dc_L[t] = (UINT8)dac[3 * t];
    if (dac[3 * t + 1] >= 0) c.arith_dc_U[t] = (UINT8)dac[3 * t + 1];
    if (dac[3 * t + 2] >= 0) c.arith_ac_K[t] = (UINT8)dac[3 * t + 2];
  }
  if (progressive) jpeg_simple_progression(&c);
  if (lossless) jpeg_enable_lossless(&c, 1, 0);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = (JSAMPROW)(px + (size_t)c.next_scanline * w * ncomp);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  return size;
}

void pts_free(unsigned char *p) { free(p); }
