/* Group -> color identification for the index build.
 *
 * After the global (row, residual) radix sort, every k-mer's (key, leaf)
 * tuples are contiguous. This pass walks the sorted groups once and
 * assigns each group either its single leaf id (uniform groups) or a
 * negative placeholder -(uid+1) naming the group's *unique leaf-set
 * bitmask*, deduplicated through an open-addressing hash table. It
 * replaces the reference's per-k-mer additive subset hashing + collision
 * rehash loop (ref: src/record.cpp:82-107, src/table.cpp:182-232) with a
 * deterministic set-dedup that the Python side maps onto color ids.
 *
 * Single-threaded: one memory-bound pass over the tuples (~100M tuples/s).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    int64_t nslots;     /* power of two */
    int64_t count;
    int32_t *slot_uid;  /* -1 empty, else uid */
    uint64_t *masks;    /* uid * W */
    int64_t mask_cap;   /* capacity in masks */
    int W;
} mask_table;

static uint64_t mask_hash(const uint64_t *m, int W)
{
    uint64_t h = 1469598103934665603ULL; /* FNV-1a 64 over words */
    for (int w = 0; w < W; w++) {
        h ^= m[w];
        h *= 1099511628211ULL;
    }
    h ^= h >> 33;
    return h;
}

static int table_grow(mask_table *t)
{
    int64_t ns = t->nslots * 2;
    int32_t *su = (int32_t *)malloc((size_t)ns * sizeof(int32_t));
    if (!su)
        return -1;
    memset(su, 0xFF, (size_t)ns * sizeof(int32_t));
    for (int64_t i = 0; i < t->nslots; i++) {
        int32_t uid = t->slot_uid[i];
        if (uid < 0)
            continue;
        uint64_t h = mask_hash(t->masks + (size_t)uid * t->W, t->W);
        int64_t j = (int64_t)(h & (uint64_t)(ns - 1));
        while (su[j] >= 0)
            j = (j + 1) & (ns - 1);
        su[j] = uid;
    }
    free(t->slot_uid);
    t->slot_uid = su;
    t->nslots = ns;
    return 0;
}

/* returns uid (>=0) or -1 on alloc failure */
static int64_t table_intern(mask_table *t, const uint64_t *m)
{
    uint64_t h = mask_hash(m, t->W);
    int64_t j = (int64_t)(h & (uint64_t)(t->nslots - 1));
    while (t->slot_uid[j] >= 0) {
        int32_t uid = t->slot_uid[j];
        if (memcmp(t->masks + (size_t)uid * t->W, m,
                   (size_t)t->W * sizeof(uint64_t)) == 0)
            return uid;
        j = (j + 1) & (t->nslots - 1);
    }
    if (t->count >= t->mask_cap) {
        int64_t nc = t->mask_cap * 2;
        uint64_t *nm = (uint64_t *)realloc(
            t->masks, (size_t)nc * t->W * sizeof(uint64_t));
        if (!nm)
            return -1;
        t->masks = nm;
        t->mask_cap = nc;
    }
    int64_t uid = t->count++;
    memcpy(t->masks + (size_t)uid * t->W, m,
           (size_t)t->W * sizeof(uint64_t));
    t->slot_uid[j] = (int32_t)uid;
    if (t->count * 4 > t->nslots * 3) {
        if (table_grow(t) != 0)
            return -1;
    }
    return uid;
}

static mask_table *g_result; /* held between the two calls (single build) */

/* starts: int64[ng + 1] tuple offsets of each sorted group (last = n).
 * leaf: int32[n] leaf ids per tuple. W: mask words.
 * se_out: int32[ng]; uniform groups get their leaf id, others -(uid+1).
 * Returns the number of unique masks, or -1 on failure. */
int64_t krepp_color_groups(const int64_t *starts, int64_t ng,
                           const int32_t *leaf, int W, int32_t *se_out)
{
    if (g_result) {
        free(g_result->slot_uid);
        free(g_result->masks);
        free(g_result);
        g_result = NULL;
    }
    mask_table *t = (mask_table *)calloc(1, sizeof(mask_table));
    if (!t)
        return -1;
    t->W = W;
    t->nslots = 1 << 12;
    t->mask_cap = 1 << 10;
    t->slot_uid = (int32_t *)malloc((size_t)t->nslots * sizeof(int32_t));
    t->masks = (uint64_t *)malloc((size_t)t->mask_cap * W
                                  * sizeof(uint64_t));
    uint64_t *scratch = (uint64_t *)malloc((size_t)W * sizeof(uint64_t));
    if (!t->slot_uid || !t->masks || !scratch)
        goto fail;
    memset(t->slot_uid, 0xFF, (size_t)t->nslots * sizeof(int32_t));

    for (int64_t g = 0; g < ng; g++) {
        int64_t lo = starts[g], hi = starts[g + 1];
        int32_t l0 = leaf[lo];
        int uniform = 1;
        for (int64_t i = lo + 1; i < hi; i++) {
            if (leaf[i] != l0) {
                uniform = 0;
                break;
            }
        }
        if (uniform) {
            se_out[g] = l0;
            continue;
        }
        memset(scratch, 0, (size_t)W * sizeof(uint64_t));
        for (int64_t i = lo; i < hi; i++) {
            int32_t l = leaf[i];
            scratch[l >> 6] |= 1ULL << (l & 63);
        }
        int64_t uid = table_intern(t, scratch);
        if (uid < 0)
            goto fail;
        se_out[g] = (int32_t)(-(uid + 1));
    }
    free(scratch);
    g_result = t;
    return t->count;

fail:
    free(scratch);
    free(t->slot_uid);
    free(t->masks);
    free(t);
    return -1;
}

/* Copy the unique masks from the last krepp_color_groups call
 * (first-encounter order) into out[n_unique * W] and release them. */
int64_t krepp_fetch_masks(uint64_t *out)
{
    if (!g_result)
        return -1;
    memcpy(out, g_result->masks,
           (size_t)g_result->count * g_result->W * sizeof(uint64_t));
    int64_t n = g_result->count;
    free(g_result->slot_uid);
    free(g_result->masks);
    free(g_result);
    g_result = NULL;
    return n;
}
