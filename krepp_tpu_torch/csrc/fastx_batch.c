/* Batch-at-a-time FASTA/FASTQ reader (queries and genomes) and row padder
 * for query reads.
 *
 * One call parses records until a batch is complete: the batch closes after
 * the record that brings its cumulative bases to at least bp_limit, or at the
 * end of the input (the rule of QSeq::read_next_batch, ref:
 * src/rqseq.cpp:180-197). The batch's base codes (0..4) land in one arena
 * with record offsets, and its names in one block, each name followed by
 * '\n', so the caller decodes and splits the names once.
 *
 * Record semantics are those of krepp_tpu's csrc/fastx.c, line for line:
 * FASTA and FASTQ, gzip or plain (zlib reads both); multi-line FASTA bodies;
 * FASTQ sequence lines up to the '+' separator, then quality lines until
 * their total length reaches the sequence length (kseq, ref:
 * src/kseq.h:116-170); trailing '\r' stripped and empty lines skipped; a
 * name runs up to the first space, tab or NUL and at most 255 bytes; a line
 * where a header is expected ends the input. Input is read in blocks
 * (gzread, memchr for line ends); a line longer than the block buffer grows
 * it, and the arenas grow with the batch.
 *
 * C ABI for ctypes:
 *   fxb_open(path)                       -> handle, NULL if unreadable
 *   fxb_next(handle, bp_limit, info)     -> records in the batch; 0 at the
 *                                           end, -1 unknown format, -2 out
 *                                           of memory
 *   fxb_close(handle)
 *   fxb_pad(codes, off, n, width, out)   -> out[n, width] rows, padded with 4
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

#define BLOCK (1 << 20)
#define NAME_MAX_LEN 255

static const unsigned char NT4[256] = {
    [0 ... 255] = 4,
    ['A'] = 0, ['C'] = 1, ['G'] = 2, ['T'] = 3,
    ['a'] = 0, ['c'] = 1, ['g'] = 2, ['t'] = 3,
};

typedef struct {
    gzFile gz;
    int state;          /* 0 = start, 1 = fasta, 2 = fastq, 3 = eof */
    int eof;            /* the input is exhausted (buf may hold a last line) */
    char *buf;          /* input block: unread bytes are [pos, end) */
    size_t cap, pos, end, scan;   /* scan: bytes past pos known to hold no '\n' */
    int have_hdr;       /* hdr holds the name of the next record */
    char hdr[NAME_MAX_LEN];
    size_t hdr_len;
    uint8_t *codes;     /* the batch's arenas */
    size_t codes_cap;
    int64_t *off;
    size_t off_cap;
    char *names;
    size_t names_cap;
} fxb_t;

static int grow(void **p, size_t *cap, size_t need, size_t elem) {
    if (need <= *cap) return 0;
    size_t c = *cap ? *cap : 1;
    while (c < need) c <<= 1;
    void *q = realloc(*p, c * elem);
    if (!q) return -1;
    *p = q;
    *cap = c;
    return 0;
}

/* Next line as (*line, length) with trailing '\r' stripped; -1 at the end
 * of the input, -2 out of memory. A last line without '\n' counts. */
static long next_line(fxb_t *f, const char **line) {
    for (;;) {
        char *start = f->buf + f->pos;
        size_t avail = f->end - f->pos;
        char *nl = memchr(start + f->scan, '\n', avail - f->scan);
        size_t len;
        if (nl) {
            len = (size_t)(nl - start);
            f->pos += len + 1;
        } else if (f->eof) {
            if (avail == 0) return -1;
            len = avail;
            f->pos = f->end;
        } else {
            /* keep the partial line, then read more behind it */
            f->scan = avail;
            if (f->pos > 0) {
                memmove(f->buf, start, avail);
                f->pos = 0;
                f->end = avail;
            }
            if (f->end == f->cap &&
                grow((void **)&f->buf, &f->cap, f->cap * 2, 1))
                return -2;
            int n = gzread(f->gz, f->buf + f->end,
                           (unsigned)(f->cap - f->end > BLOCK * 64
                                      ? BLOCK * 64 : f->cap - f->end));
            if (n <= 0)
                f->eof = 1;
            else
                f->end += (size_t)n;
            continue;
        }
        f->scan = 0;
        while (len > 0 && start[len - 1] == '\r') len--;
        *line = start;
        return (long)len;
    }
}

/* the record name of a header line (its text after '>' or '@') */
static void set_hdr(fxb_t *f, const char *h, long len) {
    size_t n = 0;
    while (n < (size_t)len && n < NAME_MAX_LEN && h[n] != ' ' &&
           h[n] != '\t' && h[n] != '\0')
        n++;
    memcpy(f->hdr, h, n);
    f->hdr_len = n;
    f->have_hdr = 1;
}

/* After a FASTQ record: the next record's header, or the end. */
static int find_header(fxb_t *f) {
    const char *line;
    for (;;) {
        long len = next_line(f, &line);
        if (len == -2) return -2;
        if (len < 0) {
            f->state = 3;
            return 0;
        }
        if (len == 0) continue;
        if (line[0] == '@')
            set_hdr(f, line + 1, len - 1);
        else
            f->state = 3;
        return 0;
    }
}

static int put_codes(fxb_t *f, size_t *nb, const char *line, long len) {
    if (grow((void **)&f->codes, &f->codes_cap, *nb + (size_t)len, 1))
        return -2;
    uint8_t *dst = f->codes + *nb;
    for (long i = 0; i < len; i++) dst[i] = NT4[(unsigned char)line[i]];
    *nb += (size_t)len;
    return 0;
}

void *fxb_open(const char *path) {
    fxb_t *f = (fxb_t *)calloc(1, sizeof(fxb_t));
    if (!f) return NULL;
    f->gz = gzopen(path, "rb");
    f->cap = BLOCK;
    f->buf = (char *)malloc(f->cap);
    if (!f->gz || !f->buf) {
        if (f->gz) gzclose(f->gz);
        free(f->buf);
        free(f);
        return NULL;
    }
    gzbuffer(f->gz, BLOCK);
    return f;
}

void fxb_close(void *h) {
    fxb_t *f = (fxb_t *)h;
    if (!f) return;
    if (f->gz) gzclose(f->gz);
    free(f->buf);
    free(f->codes);
    free(f->off);
    free(f->names);
    free(f);
}

/* Parse the next batch. info receives [bases, name bytes, at end (1 when
 * the input holds no further record), codes arena, offsets (n + 1 int64),
 * names block], the three arenas as addresses valid until the next call. */
int64_t fxb_next(void *h, int64_t bp_limit, int64_t *info) {
    fxb_t *f = (fxb_t *)h;
    const char *line;
    long len;
    int64_t n = 0, bpc = 0;
    size_t nb = 0, nn = 0;
    memset(info, 0, 6 * sizeof(int64_t));
    info[2] = 1;
    if (!f || f->state == 3) return 0;
    if (f->state == 0) {
        do len = next_line(f, &line); while (len == 0);
        if (len == -2) return -2;
        if (len < 0) {
            f->state = 3;
            return 0;
        }
        if (line[0] == '>')
            f->state = 1;
        else if (line[0] == '@')
            f->state = 2;
        else {
            f->state = 3;
            return -1;
        }
        set_hdr(f, line + 1, len - 1);
    }
    if (grow((void **)&f->off, &f->off_cap, 1, sizeof(int64_t))) return -2;
    f->off[0] = 0;
    while (f->have_hdr) {
        if (grow((void **)&f->off, &f->off_cap, (size_t)n + 2,
                 sizeof(int64_t)) ||
            grow((void **)&f->names, &f->names_cap, nn + f->hdr_len + 1, 1))
            return -2;
        memcpy(f->names + nn, f->hdr, f->hdr_len);
        nn += f->hdr_len;
        f->names[nn++] = '\n';
        f->have_hdr = 0;
        if (f->state == 1) {
            /* FASTA: every line up to the next '>' or the end */
            for (;;) {
                len = next_line(f, &line);
                if (len == -2) return -2;
                if (len < 0) {
                    f->state = 3;
                    break;
                }
                if (len > 0 && line[0] == '>') {
                    set_hdr(f, line + 1, len - 1);
                    break;
                }
                if (put_codes(f, &nb, line, len)) return -2;
            }
        } else {
            /* FASTQ: sequence lines up to '+', then quality lines until
             * they hold as many bytes as the sequence */
            size_t seq_len = 0;
            for (;;) {
                len = next_line(f, &line);
                if (len == -2) return -2;
                if (len < 0) {
                    f->state = 3;
                    break;
                }
                if (len > 0 && line[0] == '+') break;
                if (put_codes(f, &nb, line, len)) return -2;
                seq_len += (size_t)len;
            }
            if (f->state != 3) {
                size_t qlen = 0;
                while (qlen < seq_len) {
                    len = next_line(f, &line);
                    if (len == -2) return -2;
                    if (len < 0) {
                        f->state = 3;
                        break;
                    }
                    qlen += (size_t)len;
                }
            }
            if (f->state != 3 && find_header(f)) return -2;
        }
        n++;
        f->off[n] = (int64_t)nb;
        bpc += f->off[n] - f->off[n - 1];
        if (bpc >= bp_limit) break;
    }
    info[0] = (int64_t)nb;
    info[1] = (int64_t)nn;
    info[2] = !f->have_hdr;
    info[3] = (int64_t)(intptr_t)f->codes;
    info[4] = (int64_t)(intptr_t)f->off;
    info[5] = (int64_t)(intptr_t)f->names;
    return n;
}

/* Row i of out[n, width] holds codes[off[i], off[i + 1]) and then 4s
 * (every row's length is at most width). */
void fxb_pad(const uint8_t *codes, const int64_t *off, int64_t n,
             int64_t width, uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        int64_t len = off[i + 1] - off[i];
        uint8_t *row = out + i * width;
        memcpy(row, codes + off[i], (size_t)len);
        memset(row + len, 4, (size_t)(width - len));
    }
}
