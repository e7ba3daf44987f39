/* Border following of a binary mask: OpenCV's
 * cv::findContours(mask, RETR_CCOMP, CHAIN_APPROX_SIMPLE) and cv::contourArea,
 * the port's stand-in for the two cv2 calls of the annotation converter's
 * polygon export.
 *
 * Suzuki & Abe's border following (CVGIP 30(1), 1985) as OpenCV's scanner
 * runs it (imgproc/src/contours.cpp: cvFindNextContour, icvFetchContourEx,
 * cvInsertNodeIntoTree, cvTreeToNodeSeq):
 *   - the mask is binarised (nonzero -> 1) and padded by one zero pixel on
 *     every side, so contours may touch the image border; points are given
 *     in the unpadded image's coordinates;
 *   - the raster scan starts an outer border at a 0 -> 1 step and a hole
 *     border at a step from a positive pixel to 0; border pixels are labelled
 *     with the border's number (from 2), right-bound pixels with its negative;
 *   - under RETR_CCOMP every outer border is a child of the frame and a hole
 *     a child of the outer border it lies in (the border of the last labelled
 *     pixel left of it, or that border's parent when it is a hole);
 *   - a new contour becomes its parent's first child, and the contours are
 *     listed depth first from the frame's first child, so siblings come out in
 *     the reverse of the order the scan found them;
 *   - CHAIN_APPROX_SIMPLE keeps a point where the chain code changes.
 * Labels are ints, so every border has its own (OpenCV's 8-bit labels wrap at
 * 127 and it tells borders of one label apart by their bounding boxes).
 *
 * Built with `cc -O2 -shared -fPIC` at first use into <repo>/build/native/ and
 * called through ctypes from rgbdseg_torch.native.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    int *pts;            /* x, y pairs of every contour, in output order */
    long n_pts, cap_pts;
    long *start;         /* per contour (discovery order): first point, count */
    long *count;
    int *parent;         /* discovery index, -1 for the frame */
    int *is_hole;
    int *first_child;    /* tree links by discovery index, -1 for none */
    int *h_next, *h_prev;
    long n_c, cap_c;
    int frame_child;     /* the frame's first child */
    int *order;          /* output position -> discovery index */
} contours_t;

static const int CODE_DX[8] = {1, 1, 0, -1, -1, -1, 0, 1};
static const int CODE_DY[8] = {0, -1, -1, -1, 0, 1, 1, 1};

static int grow(void **p, long n, size_t size) {
    void *q = realloc(*p, (size_t)n * size);
    if (!q) return -1;
    *p = q;
    return 0;
}

static int push_point(contours_t *r, int x, int y) {
    if (r->n_pts == r->cap_pts) {
        long cap = r->cap_pts ? 2 * r->cap_pts : 1024;
        if (grow((void **)&r->pts, 2 * cap, sizeof(int))) return -1;
        r->cap_pts = cap;
    }
    r->pts[2 * r->n_pts] = x;
    r->pts[2 * r->n_pts + 1] = y;
    r->n_pts++;
    return 0;
}

static int new_contour(contours_t *r) {
    if (r->n_c == r->cap_c) {
        long cap = r->cap_c ? 2 * r->cap_c : 64;
        if (grow((void **)&r->start, cap, sizeof(long)) || grow((void **)&r->count, cap, sizeof(long)) ||
            grow((void **)&r->parent, cap, sizeof(int)) || grow((void **)&r->is_hole, cap, sizeof(int)) ||
            grow((void **)&r->first_child, cap, sizeof(int)) || grow((void **)&r->h_next, cap, sizeof(int)) ||
            grow((void **)&r->h_prev, cap, sizeof(int)))
            return -1;
        r->cap_c = cap;
    }
    return (int)r->n_c++;
}

/* Follow the border that starts at img[i0] (icvFetchContourEx with
 * CHAIN_APPROX_SIMPLE); (x, y) is its first point in image coordinates. */
static int fetch(contours_t *r, int *img, long i0, long step, int x, int y, int hole, int nbd) {
    long deltas[16] = {1, -step + 1, -step, -step - 1, -1, step - 1, step, step + 1};
    memcpy(deltas + 8, deltas, 8 * sizeof(long));
    int s, s_end, prev_s;
    long i1, i3, i4 = 0;
    s_end = s = hole ? 0 : 4;
    do {
        s = (s - 1) & 7;
        i1 = i0 + deltas[s];
    } while (img[i1] == 0 && s != s_end);
    if (s == s_end) { /* a single pixel */
        img[i0] = -nbd;
        return push_point(r, x, y);
    }
    i3 = i0;
    prev_s = s ^ 4;
    for (;;) {
        s_end = s;
        while (s < 15) {
            i4 = i3 + deltas[++s];
            if (img[i4] != 0) break;
        }
        s &= 7;
        if ((unsigned)(s - 1) < (unsigned)s_end) img[i3] = -nbd; /* right bound */
        else if (img[i3] == 1) img[i3] = nbd;
        if (s != prev_s && push_point(r, x, y)) return -1;
        prev_s = s;
        x += CODE_DX[s];
        y += CODE_DY[s];
        if (i4 == i0 && i3 == i1) break;
        i3 = i4;
        s = (s + 4) & 7;
    }
    return 0;
}

/* The contours of an (h, w) mask, row-major, nonzero = foreground; NULL when
 * memory runs out. Free with contours_free. */
void *contours_find(const uint8_t *mask, long h, long w) {
    contours_t *r = calloc(1, sizeof(contours_t));
    long step = w + 2;
    int *img = calloc((size_t)(h + 2) * (size_t)step, sizeof(int));
    int *owner = NULL; /* label -> discovery index */
    long cap_owner = 0;
    if (!r || !img) goto fail;
    r->frame_child = -1;
    for (long y = 0; y < h; y++)
        for (long x = 0; x < w; x++) img[(y + 1) * step + x + 1] = mask[y * w + x] != 0;

    int nbd = 2;
    for (long y = 1; y <= h; y++) {
        int prev = 0;
        long lnbd_x = 0, lnbd_y = y;
        for (long x = 1; x <= w; x++) {
            int p = img[y * step + x];
            if (p == prev) continue;
            int hole = 0;
            if (!(prev == 0 && p == 1)) {
                if (p != 0 || prev < 1) goto resume;
                if (prev != 1) lnbd_x = x - 1;
                hole = 1;
            }
            {
                int par = -1;
                if (hole && lnbd_x > 0) {
                    int lval = img[lnbd_y * step + lnbd_x];
                    par = owner[lval < 0 ? -lval : lval];
                    if (r->is_hole[par] == hole) par = r->parent[par];
                }
                lnbd_x = x - hole;
                int c = new_contour(r);
                if (c < 0) goto fail;
                if (nbd >= cap_owner) {
                    cap_owner = cap_owner ? 2 * cap_owner : 256;
                    if (grow((void **)&owner, cap_owner, sizeof(int))) goto fail;
                }
                owner[nbd] = c;
                r->start[c] = r->n_pts;
                r->parent[c] = par;
                r->is_hole[c] = hole;
                r->first_child[c] = -1;
                r->h_prev[c] = -1;
                if (fetch(r, img, y * step + x - hole, step, (int)(x - hole - 1), (int)(y - 1), hole, nbd)) goto fail;
                r->count[c] = r->n_pts - r->start[c];
                /* the new contour becomes its parent's first child */
                int *head = par < 0 ? &r->frame_child : &r->first_child[par];
                r->h_next[c] = *head;
                if (*head >= 0) r->h_prev[*head] = c;
                *head = c;
                nbd++;
                p = img[y * step + x]; /* the scan resumes after the start pixel, as it now reads */
            }
        resume:
            prev = p;
            if (prev != 0 && prev != 1) lnbd_x = x;
        }
    }
    free(img);
    free(owner);
    img = NULL;
    owner = NULL;

    /* depth-first order from the frame's first child */
    r->order = malloc((size_t)(r->n_c ? r->n_c : 1) * sizeof(int));
    if (!r->order) goto fail;
    long k = 0;
    int node = r->frame_child;
    while (node >= 0) {
        r->order[k++] = node;
        if (r->first_child[node] >= 0) {
            node = r->first_child[node];
            continue;
        }
        while (node >= 0 && r->h_next[node] < 0) node = r->parent[node];
        node = node >= 0 ? r->h_next[node] : -1;
    }
    return r;

fail:
    free(img);
    free(owner);
    if (r) {
        free(r->pts); free(r->start); free(r->count); free(r->parent); free(r->is_hole);
        free(r->first_child); free(r->h_next); free(r->h_prev); free(r->order);
        free(r);
    }
    return NULL;
}

long contours_count(const void *handle) { return ((const contours_t *)handle)->n_c; }

long contours_points(const void *handle) { return ((const contours_t *)handle)->n_pts; }

/* Copy out, in cv2's order: pts (2 * contours_points ints), offsets
 * (contours_count + 1 longs into the point list) and hierarchy
 * (4 * contours_count ints: next, previous, first child, parent). */
void contours_copy(const void *handle, int *pts, long *offsets, int *hierarchy) {
    const contours_t *r = handle;
    int *pos = malloc((size_t)(r->n_c ? r->n_c : 1) * sizeof(int)); /* discovery index -> output position */
    long o = 0;
    for (long i = 0; i < r->n_c; i++) pos[r->order[i]] = (int)i;
    for (long i = 0; i < r->n_c; i++) {
        int c = r->order[i];
        offsets[i] = o;
        memcpy(pts + 2 * o, r->pts + 2 * r->start[c], (size_t)(2 * r->count[c]) * sizeof(int));
        o += r->count[c];
        hierarchy[4 * i] = r->h_next[c] >= 0 ? pos[r->h_next[c]] : -1;
        hierarchy[4 * i + 1] = r->h_prev[c] >= 0 ? pos[r->h_prev[c]] : -1;
        hierarchy[4 * i + 2] = r->first_child[c] >= 0 ? pos[r->first_child[c]] : -1;
        hierarchy[4 * i + 3] = r->parent[c] >= 0 ? pos[r->parent[c]] : -1;
    }
    offsets[r->n_c] = o;
    free(pos);
}

void contours_free(void *handle) {
    contours_t *r = handle;
    if (!r) return;
    free(r->pts); free(r->start); free(r->count); free(r->parent); free(r->is_hole);
    free(r->first_child); free(r->h_next); free(r->h_prev); free(r->order);
    free(r);
}

/* cv::contourArea(points, oriented=false): the shoelace sum in float64 from
 * the last point round, halved, unsigned. */
double contour_area(const int *pts, long n) {
    if (n <= 0) return 0.0;
    double a = 0.0;
    double px = (float)pts[2 * (n - 1)], py = (float)pts[2 * (n - 1) + 1];
    for (long i = 0; i < n; i++) {
        double x = (float)pts[2 * i], y = (float)pts[2 * i + 1];
        a += px * y - py * x;
        px = x;
        py = y;
    }
    a *= 0.5;
    return a < 0 ? -a : a;
}
