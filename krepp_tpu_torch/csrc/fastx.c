/* Native FASTA/FASTQ reader + base-code packer.
 *
 * Streaming parser with kseq-equivalent record semantics (record name up to
 * the first whitespace, multi-line FASTA bodies, gzip via zlib; cf. the
 * reference's vendored kseq.h) that emits 0..4 base codes directly into a
 * growing arena, so Python receives one contiguous uint8 buffer plus record
 * offsets — no per-record Python objects or string copies on the hot path.
 *
 * Exposed as a tiny C ABI consumed via ctypes (no pybind11 in this image):
 *   fastx_open(path)            -> handle
 *   fastx_read_chunk(handle, max_records, max_bases, ...) -> n records
 *   fastx_close(handle)
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

typedef struct {
    gzFile gz;
    int state;      /* 0 = start, 1 = fasta, 2 = fastq, 3 = eof */
    char *linebuf;
    size_t linecap;
    char *pending_hdr;  /* header of the next FASTA record */
} fastx_t;

static unsigned char NT4[256];
static int nt4_init_done = 0;

static void nt4_init(void) {
    if (nt4_init_done) return;
    memset(NT4, 4, sizeof(NT4));
    NT4['A'] = NT4['a'] = 0;
    NT4['C'] = NT4['c'] = 1;
    NT4['G'] = NT4['g'] = 2;
    NT4['T'] = NT4['t'] = 3;
    nt4_init_done = 1;
}

/* gz-aware getline; returns length or -1 at EOF; strips \r\n */
static long read_line(fastx_t *f) {
    size_t len = 0;
    if (!f->linebuf) {
        f->linecap = 1 << 16;
        f->linebuf = (char *)malloc(f->linecap);
    }
    for (;;) {
        if (len + 2 >= f->linecap) {
            f->linecap <<= 1;
            f->linebuf = (char *)realloc(f->linebuf, f->linecap);
        }
        int c = gzgetc(f->gz);
        if (c == -1) {
            if (len == 0) return -1;
            break;
        }
        if (c == '\n') break;
        f->linebuf[len++] = (char)c;
    }
    while (len > 0 && (f->linebuf[len - 1] == '\r')) len--;
    f->linebuf[len] = 0;
    return (long)len;
}

void *fastx_open(const char *path) {
    nt4_init();
    fastx_t *f = (fastx_t *)calloc(1, sizeof(fastx_t));
    f->gz = gzopen(path, "rb");
    if (!f->gz) {
        free(f);
        return NULL;
    }
    gzbuffer(f->gz, 1 << 20);
    return f;
}

void fastx_close(void *h) {
    fastx_t *f = (fastx_t *)h;
    if (!f) return;
    if (f->gz) gzclose(f->gz);
    free(f->linebuf);
    free(f->pending_hdr);
    free(f);
}

static void put_name(const char *hdr, char *names, int64_t *name_off,
                     int64_t *name_pos, int64_t rec) {
    /* name = up to first whitespace (kseq semantics), capped at 255 chars
     * so the caller's max_records*256 buffer can never overflow */
    const char *p = hdr;
    int n = 0;
    while (*p && *p != ' ' && *p != '\t' && n < 255) {
        names[(*name_pos)++] = *p++;
        n++;
    }
    name_off[rec + 1] = *name_pos;
}

/* Read up to max_records records or until ~max_bases bases are buffered.
 * codes:      caller buffer of size >= max_bases + 1<<20 (one extra record
 *             may overshoot max_bases)
 * seq_off:    caller buffer [max_records + 1]; seq_off[0] must be 0 on entry
 * names:      caller buffer (max_records * 256)
 * name_off:   caller buffer [max_records + 1]; name_off[0] = 0
 * Returns number of records read (0 => EOF). */
int64_t fastx_read_chunk(void *h, int64_t max_records, int64_t max_bases,
                         uint8_t *codes, int64_t *seq_off,
                         char *names, int64_t *name_off) {
    fastx_t *f = (fastx_t *)h;
    if (!f || f->state == 3) return 0;
    int64_t rec = 0;
    int64_t base_pos = seq_off[0];
    int64_t name_pos = name_off[0];
    long len;

    if (f->state == 0) {
        len = read_line(f);
        while (len == 0) len = read_line(f);
        if (len < 0) {
            f->state = 3;
            return 0;
        }
        if (f->linebuf[0] == '>') {
            f->state = 1;
            f->pending_hdr = strdup(f->linebuf + 1);
        } else if (f->linebuf[0] == '@') {
            f->state = 2;
            f->pending_hdr = strdup(f->linebuf + 1);
        } else {
            f->state = 3;
            return -1; /* unknown format */
        }
    }

    while (rec < max_records && base_pos - seq_off[0] < max_bases) {
        if (!f->pending_hdr) {
            len = read_line(f);
            if (len < 0) {
                f->state = 3;
                break;
            }
            if (len == 0) continue;
            if (f->state == 1 && f->linebuf[0] == '>')
                f->pending_hdr = strdup(f->linebuf + 1);
            else if (f->state == 2 && f->linebuf[0] == '@')
                f->pending_hdr = strdup(f->linebuf + 1);
            else {
                f->state = 3;
                break;
            }
        }
        put_name(f->pending_hdr, names, name_off, &name_pos, rec);
        free(f->pending_hdr);
        f->pending_hdr = NULL;

        if (f->state == 1) {
            /* FASTA: read until next '>' or EOF */
            for (;;) {
                len = read_line(f);
                if (len < 0) {
                    f->state = 3;
                    break;
                }
                if (len > 0 && f->linebuf[0] == '>') {
                    f->pending_hdr = strdup(f->linebuf + 1);
                    break;
                }
                for (long i = 0; i < len; i++)
                    codes[base_pos++] = NT4[(unsigned char)f->linebuf[i]];
            }
        } else {
            /* FASTQ (kseq semantics, ref src/kseq.h:116-170): the sequence
             * spans every line up to the '+' separator; quality lines then
             * accumulate until their total length reaches the sequence
             * length, so wrapped records parse exactly like kseq */
            int64_t seq_len = 0;
            for (;;) {
                len = read_line(f);
                if (len < 0) {
                    f->state = 3;
                    break;
                }
                if (len > 0 && f->linebuf[0] == '+')
                    break;
                for (long i = 0; i < len; i++)
                    codes[base_pos++] = NT4[(unsigned char)f->linebuf[i]];
                seq_len += len;
            }
            if (f->state != 3) {
                int64_t qlen = 0;
                while (qlen < seq_len) {
                    len = read_line(f);
                    if (len < 0) {
                        f->state = 3;
                        break;
                    }
                    qlen += len;
                }
            }
        }
        rec++;
        seq_off[rec] = base_pos;
        if (f->state == 3 && !f->pending_hdr) break;
    }
    return rec;
}
