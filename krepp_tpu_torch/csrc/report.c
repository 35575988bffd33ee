/* Bulk jplace fragment emitter.
 *
 * The per-read jplace nesting (ref framing: src/krepp.cpp:410-432) costs
 * ~10 us/read in Python object string assembly — the dominant host cost of
 * the place pipeline once the device step is pipelined. This emits the
 * whole batch fragment into one caller-provided buffer: per emitted read
 *
 *   [,\n]\t\t\t{"n" : ["NAME"], "p" : [ROWS]}
 *
 * where ROWS is either one row (single-match or non-multi candidate)
 * rendered inline + "]}", or the multi form joining rows with
 * ",\n\t\t\t\t" and closing with "]\n\t\t\t}".  A row is
 *
 *   [edge_num, pendant, distal, likelihood, lwr, distance]
 *
 * with five %.5f fields (fixed 5-decimal precision, src/common.hpp:48);
 * NaN renders as "nan" to match the Python fmt5 helper.
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

static inline char *fmt5(char *p, double x) {
    if (isnan(x)) {
        memcpy(p, "nan", 3);
        return p + 3;
    }
    return p + sprintf(p, "%.5f", x);
}

/* one "[en, pend_adj, pend, -v, lwr, d]" row; q is the 1-based node id */
static inline char *row(char *p, int64_t q, double d, double v, double lwr,
                        const double *blen) {
    double bl = blen[q];
    double pend = isnan(bl) ? 0.0 : bl * 0.5;
    double jc = -0.75 * log(1.0 - (4.0 / 3.0) * d);
    *p++ = '[';
    p += sprintf(p, "%lld", (long long)(q - 1));
    *p++ = ','; *p++ = ' ';
    p = fmt5(p, jc - pend);
    *p++ = ','; *p++ = ' ';
    p = fmt5(p, pend);
    *p++ = ','; *p++ = ' ';
    p = fmt5(p, -v);
    *p++ = ','; *p++ = ' ';
    p = fmt5(p, lwr);
    *p++ = ','; *p++ = ' ';
    p = fmt5(p, d);
    *p++ = ']';
    return p;
}

/* Returns bytes written (< out_cap guaranteed by caller sizing), and sets
 * *emitted_out to the number of reads emitted. */
int64_t jplace_emit(
    int64_t B, int multi, int has_previous,
    const unsigned char *names, const int64_t *name_off, /* [B+1] */
    const unsigned char *kind,      /* per read: 0 skip, 1 single, 2 cand */
    const int64_t *s_of,            /* read -> single-row index */
    const int64_t *starts, const int64_t *ends, /* read -> cand row range */
    const int64_t *s_q, const double *s_d, const double *s_v,
    const int64_t *c_q, const double *c_d, const double *c_v,
    const double *c_w,
    const double *blen,
    char *out, int64_t *emitted_out) {
    char *p = out;
    int64_t emitted = 0;
    for (int64_t b = 0; b < B; b++) {
        if (kind[b] == 0) continue;
        if (has_previous || emitted) {
            *p++ = ','; *p++ = '\n';
        }
        memcpy(p, "\t\t\t{\"n\" : [\"", 12); p += 12;
        int64_t nl = name_off[b + 1] - name_off[b];
        memcpy(p, names + name_off[b], (size_t)nl); p += nl;
        memcpy(p, "\"], \"p\" : [", 11); p += 11;
        if (kind[b] == 1) {
            int64_t i = s_of[b];
            p = row(p, s_q[i], s_d[i], s_v[i], 1.0, blen);
            *p++ = ']'; *p++ = '}';
        } else if (multi) {
            for (int64_t i = starts[b]; i < ends[b]; i++) {
                if (i > starts[b]) *p++ = ',';
                *p++ = '\n'; *p++ = '\t'; *p++ = '\t'; *p++ = '\t';
                *p++ = '\t';
                p = row(p, c_q[i], c_d[i], c_v[i], c_w[i], blen);
            }
            memcpy(p, "]\n\t\t\t}", 6); p += 6;
        } else {
            int64_t i = starts[b];
            p = row(p, c_q[i], c_d[i], c_v[i], c_w[i], blen);
            *p++ = ']'; *p++ = '}';
        }
        emitted++;
    }
    *emitted_out = emitted;
    return (int64_t)(p - out);
}

/* dist/tabular helper: format n doubles as %.5f joined into rows
 * elsewhere; kept for the TSV emitters. Writes NUL-separated strings. */
int64_t fmt5_bulk(const double *x, int64_t n, char *out, int64_t stride) {
    for (int64_t i = 0; i < n; i++) {
        char *p = out + i * stride;
        if (isnan(x[i])) {
            memcpy(p, "nan", 4);
        } else {
            sprintf(p, "%.5f", x[i]);
        }
    }
    return n;
}
