/* A pure-C client of the vvenc_tpu C API (the shape of the reference's
 * test/vvencinterfacetest.c): opens an encoder from a params string,
 * checks get_headers and the reconfig contract, encodes synthetic
 * gradient pictures with the reconstruction callback set, flushes,
 * closes, and writes the Annex-B stream.
 *
 *   client OUT.266 PARAMS WIDTH HEIGHT FRAMES
 *
 * PARAMS is the key=value string of vvenc_tpu_encoder_open (e.g.
 * "width=416;height=240;qp=37;intra_period=1;gop_size=1;device=cpu").
 * Picture t: Y(r, c) = (2r + 3c + 16t) & 255, U = 100 + 8t, V = 160 - 8t
 * (vvenc_tpu_torch.capi_c.client_frames builds the same pictures).
 * Exit code 0 and a "capi ok" line on success. */
#include "vvenc_tpu.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static int g_rec_count = 0;
static int g_width = 0, g_height = 0;

static void rec_cb(void *ctx, int poc, const uint16_t *y, const uint16_t *u,
                   const uint16_t *v, int w, int h) {
  (void)ctx;
  (void)y;
  (void)u;
  (void)v;
  if (w == g_width && h == g_height && poc >= 0) ++g_rec_count;
}

int main(int argc, char **argv) {
  if (argc != 6) {
    fprintf(stderr, "usage: %s OUT.266 PARAMS WIDTH HEIGHT FRAMES\n", argv[0]);
    return 2;
  }
  const char *out_path = argv[1];
  const int W = atoi(argv[3]), H = atoi(argv[4]), frames = atoi(argv[5]);
  g_width = W;
  g_height = H;
  vvenc_tpu_encoder *enc = vvenc_tpu_encoder_open(argv[2]);
  if (!enc) {
    fprintf(stderr, "open failed\n");
    return 1;
  }
  {
    /* get_headers before any picture: SPS+PPS NALs (vvenc_get_headers) */
    const uint8_t *hdrs = NULL;
    size_t hlen = 0;
    if (vvenc_tpu_get_headers(enc, &hdrs, &hlen) != VVENC_TPU_OK ||
        hlen < 8 || hdrs[0] != 0 || hdrs[1] != 0 || hdrs[2] != 0 ||
        hdrs[3] != 1) {
      fprintf(stderr, "get_headers failed\n");
      return 6;
    }
  }
  /* reconfig: a structural change must demand a restart (the
   * vvenc_reconfig contract) */
  if (vvenc_tpu_reconfig(enc, "width=8") != VVENC_TPU_ERR_RESTART_REQUIRED) {
    fprintf(stderr, "structural reconfig not flagged\n");
    return 8;
  }
  if (vvenc_tpu_set_rec_callback(enc, rec_cb, NULL) != VVENC_TPU_OK) return 9;
  uint8_t *y = malloc((size_t)W * H);
  uint8_t *u = malloc((size_t)W * H / 4);
  uint8_t *v = malloc((size_t)W * H / 4);
  FILE *f = fopen(out_path, "wb");
  if (!y || !u || !v || !f) return 11;
  size_t total = 0;
  for (int t = 0; t < frames; ++t) {
    for (int r = 0; r < H; ++r)
      for (int c = 0; c < W; ++c)
        y[r * W + c] = (uint8_t)((r * 2 + c * 3 + t * 16) & 0xFF);
    memset(u, 100 + 8 * t, (size_t)W * H / 4);
    memset(v, 160 - 8 * t, (size_t)W * H / 4);
    const uint8_t *au = NULL;
    size_t au_len = 0;
    const int rc = vvenc_tpu_encode(enc, y, u, v, &au, &au_len);
    if (rc != VVENC_TPU_OK) {
      fprintf(stderr, "encode failed rc=%d\n", rc);
      return 2;
    }
    fwrite(au, 1, au_len, f);
    total += au_len;
  }
  {
    /* NULL-picture flush analog: drains what the GOP buffered */
    const uint8_t *au = NULL;
    size_t au_len = 0;
    if (vvenc_tpu_flush(enc, &au, &au_len) != VVENC_TPU_OK) return 5;
    fwrite(au, 1, au_len, f);
    total += au_len;
  }
  fclose(f);
  if (g_rec_count != frames) {
    fprintf(stderr, "rec callback fired %d times (want %d)\n", g_rec_count,
            frames);
    return 10;
  }
  if (vvenc_tpu_encoder_close(enc) != VVENC_TPU_OK) return 4;
  free(y);
  free(u);
  free(v);
  printf("capi ok: %zu bytes (%s by %s)\n", total, out_path,
         vvenc_tpu_version());
  return 0;
}
