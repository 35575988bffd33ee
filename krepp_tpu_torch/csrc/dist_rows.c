/* dist's TSV rows, a batch a call (ref: IBatch::report_distances,
 * src/query.cpp:158-196).
 *
 * One call writes every row of a batch into one buffer, in read-major,
 * slot-minor order: for each read b in 0..B-1, "name\tNA\tNaN\n" where
 * na[b] is set, else "name\tleaf\tdist\n" for each of its kept rows. The
 * kept rows come as (read, slot, dist) triples sorted by read: the kept
 * lanes in multi mode, the closest slot of each non-NA read otherwise.
 *
 * Names come as one block: name i is the bytes [off[i], off[i + 1] - 1),
 * each followed by one separator byte that is not written (the '\n' of a
 * '\n'-joined block). Bytes are copied as they are (UTF-8 stays UTF-8).
 *
 * A distance prints as Python's "%.5f" % d: correctly rounded, ties to
 * even on the double's exact value, "nan" for NaN. For 0 <= d < 1e6 (not
 * -0.0) the digits come from r = round(d * 1e5), corrected by two fused
 * multiply-adds; anything else goes through snprintf("%.5f").
 *
 * C ABI for ctypes:
 *   dist_rows(names, name_off, B, leaves, leaf_off, S, na, b, s, d, n,
 *             out, cap, rows)
 *     -> bytes written to out; *rows = rows written. -1: a triple's read
 *        is out of order or out of range, or its slot is out of range;
 *        -2: out holds fewer than a row's name + leaf + 333 bytes.
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#define NUM_MAX 330   /* snprintf("%.5f") of any double, with room */

/* "%.5f" of d at out; returns the bytes written. */
static int fmt5(double d, char *out)
{
    if (isnan(d)) {
        memcpy(out, "nan", 3);
        return 3;
    }
    if (!(d >= 0.0 && d < 1e6) || signbit(d))
        return snprintf(out, NUM_MAX, "%.5f", d);
    /* d * 1e5 < 2^37, so r +- 0.5 is exact and each fma gives the sign of
     * d * 1e5 - (r +- 0.5) exactly: r is off by at most one. An exact tie
     * is exact in d * 1e5 too, where nearbyint breaks it to even. */
    double r = nearbyint(d * 1e5);
    uint64_t v = (uint64_t)r;
    if (fma(d, 1e5, -(r - 0.5)) < 0.0)
        v -= 1;
    else if (fma(d, 1e5, -(r + 0.5)) > 0.0)
        v += 1;
    uint64_t ip = v / 100000, fp = v % 100000;
    char tmp[8];
    int n = 0;
    do {
        tmp[n++] = (char)('0' + ip % 10);
        ip /= 10;
    } while (ip);
    int len = 0;
    while (n)
        out[len++] = tmp[--n];
    out[len++] = '.';
    for (int i = 4; i >= 0; i--) {
        out[len + i] = (char)('0' + fp % 10);
        fp /= 10;
    }
    return len + 5;
}

int64_t dist_rows(const uint8_t *names, const int64_t *name_off, int64_t B,
                  const uint8_t *leaves, const int64_t *leaf_off, int64_t S,
                  const uint8_t *na, const int64_t *b, const int64_t *s,
                  const double *d, int64_t n, char *out, int64_t cap,
                  int64_t *rows)
{
    int64_t pos = 0, i = 0, nrows = 0;
    for (int64_t r = 0; r < B; r++) {
        const uint8_t *nm = names + name_off[r];
        int64_t nlen = name_off[r + 1] - name_off[r] - 1;
        if (na[r]) {
            if (cap - pos < nlen + 8)
                return -2;
            memcpy(out + pos, nm, nlen);
            memcpy(out + pos + nlen, "\tNA\tNaN\n", 8);
            pos += nlen + 8;
            nrows++;
        }
        for (; i < n && b[i] == r; i++) {
            if (s[i] < 0 || s[i] >= S)
                return -1;
            const uint8_t *lf = leaves + leaf_off[s[i]];
            int64_t llen = leaf_off[s[i] + 1] - leaf_off[s[i]] - 1;
            if (cap - pos < nlen + llen + 3 + NUM_MAX)
                return -2;
            memcpy(out + pos, nm, nlen);
            pos += nlen;
            out[pos++] = '\t';
            memcpy(out + pos, lf, llen);
            pos += llen;
            out[pos++] = '\t';
            pos += fmt5(d[i], out + pos);
            out[pos++] = '\n';
            nrows++;
        }
        if (i < n && b[i] < r)
            return -1;
    }
    if (i < n)
        return -1;
    *rows = nrows;
    return pos;
}
