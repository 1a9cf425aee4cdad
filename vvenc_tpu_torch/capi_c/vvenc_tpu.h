/* vvenc_tpu C API — stable C ABI over the VVC encoder.
 *
 * Mirrors the reference encoder's C interface shape
 * (vvenc include/vvenc/vvenc.h.in: vvenc_encoder_create/open/encode/close):
 * create+open an encoder from a key=value parameter string, push 8-bit
 * planar 4:2:0 frames, receive Annex-B access units.
 *
 * A copy of capi/vvenc_tpu.h: the same declarations.  This directory's
 * implementation embeds CPython and drives the vvenc_tpu_torch package
 * (PyTorch/CUDA; "device=cpu" in the params runs it on the host); link
 * with -lvvenc_tpu_torch_capi (built from vvenc_tpu_torch_capi.cpp).
 */
#ifndef VVENC_TPU_CAPI_H
#define VVENC_TPU_CAPI_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct vvenc_tpu_encoder vvenc_tpu_encoder;

#define VVENC_TPU_OK 0
#define VVENC_TPU_ERR_PARAMETER (-1)
#define VVENC_TPU_ERR_INITIALIZE (-2)
#define VVENC_TPU_ERR_UNSPECIFIED (-3)
#define VVENC_TPU_ERR_RESTART_REQUIRED (-11)

/* Open an encoder. params: semicolon-separated key=value pairs, e.g.
 * "width=176;height=144;qp=32;preset=faster;intra_period=1".
 * Returns NULL on error. */
vvenc_tpu_encoder *vvenc_tpu_encoder_open(const char *params);

/* Encode one frame (8-bit planar 4:2:0, tightly packed).  On success
 * *au/*au_len describe the Annex-B access unit; the buffer stays valid
 * until the next call on this encoder.  Returns VVENC_TPU_OK. */
int vvenc_tpu_encode(vvenc_tpu_encoder *enc,
                     const uint8_t *y, const uint8_t *u, const uint8_t *v,
                     const uint8_t **au, size_t *au_len);

/* Flush: drain any buffered pictures (hierarchical-B GOP tail) —
 * the analog of the reference's NULL-picture encode call.  *au/*au_len
 * receive the remaining access units (may be empty). */
int vvenc_tpu_flush(vvenc_tpu_encoder *enc,
                    const uint8_t **au, size_t *au_len);

/* Close and free the encoder. */
int vvenc_tpu_encoder_close(vvenc_tpu_encoder *enc);

/* Parameter-set NALs (SPS+PPS) without encoding a picture — the
 * vvenc_get_headers analog (vvenc.h.in:365).  The buffer stays valid
 * until the next call on this encoder. */
int vvenc_tpu_get_headers(vvenc_tpu_encoder *enc,
                          const uint8_t **buf, size_t *len);

/* Reconfigure mid-stream.  Only non-structural fields (currently: qp)
 * may change; anything else returns VVENC_TPU_ERR_RESTART_REQUIRED —
 * the vvenc_reconfig contract (vvenc.h.in:347). */
int vvenc_tpu_reconfig(vvenc_tpu_encoder *enc, const char *params);

/* Reconstructed-picture callback (the rec-YUV output hook of
 * vvenc_encode, vvenc.h.in:286-296): invoked once per newly
 * reconstructed picture, after the encode/flush call that produced it.
 * Planes are 10-bit native-endian uint16, tightly packed 4:2:0. */
typedef void (*vvenc_tpu_rec_cb)(void *ctx, int poc, const uint16_t *y,
                                 const uint16_t *u, const uint16_t *v,
                                 int width, int height);
int vvenc_tpu_set_rec_callback(vvenc_tpu_encoder *enc,
                               vvenc_tpu_rec_cb cb, void *ctx);

/* Two-pass rate control: switch to pass 0 (collect statistics into
 * stats_file) or pass 1 (consume them) — the vvenc_init_pass analog
 * (vvenc.h.in:306).  Call before the first picture of each pass. */
int vvenc_tpu_init_pass(vvenc_tpu_encoder *enc, int pass,
                        const char *stats_file);

/* Library version string (static storage). */
const char *vvenc_tpu_version(void);

#ifdef __cplusplus
}
#endif
#endif /* VVENC_TPU_CAPI_H */
