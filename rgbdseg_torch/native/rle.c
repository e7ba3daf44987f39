/* COCO RLE counts-string codec, the port's host accelerator
 * (a copy of the string codec of rgbdseg_tpu/native/rle.c: pycocotools'
 * signed base-32 varint with delta from the count two places back).
 *
 *   rle_encode_string: run counts -> compressed string
 *   rle_decode_string: compressed string -> run counts
 *
 * Built with `cc -O2 -shared -fPIC` at first use into <repo>/build/native/ and
 * called through ctypes from rgbdseg_torch.native; the numpy codec in
 * rgbdseg_torch.inference.rle is the plain version it must equal.
 */

#include <stdint.h>

/* counts -> compressed string. out must hold 13 * nc + 1 bytes (5 bits per
 * character: 13 characters carry any int64 delta). Returns the string's length. */
long rle_encode_string(const int64_t *counts, long nc, char *out) {
    long p = 0;
    for (long i = 0; i < nc; i++) {
        int64_t x = counts[i];
        if (i > 2) x -= counts[i - 2];
        int more = 1;
        while (more) {
            int c = (int)(x & 0x1f);
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            out[p++] = (char)(c + 48);
        }
    }
    out[p] = 0;
    return p;
}

/* string -> counts. counts must hold slen entries. Returns the number of
 * counts; a string cut inside a count ends that count where it stops. */
long rle_decode_string(const char *s, long slen, int64_t *counts) {
    long nc = 0;
    long i = 0;
    while (i < slen) {
        int64_t x = 0;
        int k = 0;
        int more = 1;
        int c = 0;
        while (more && i < slen) {
            c = s[i] - 48;
            x |= ((int64_t)(c & 0x1f)) << (5 * k);
            more = c & 0x20;
            i++;
            k++;
            if (!more && (c & 0x10)) x |= ((int64_t)-1) << (5 * k);
        }
        if (nc > 2) x += counts[nc - 2];
        counts[nc++] = x;
    }
    return nc;
}
