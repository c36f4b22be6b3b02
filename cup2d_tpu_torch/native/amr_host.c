/* AMR host-runtime kernels in C.
 *
 * The reference's regrid bookkeeping is C++ (state fixing + tree walks,
 * main.cpp:4717-4861 inside adapt()); this is its native equivalent for
 * the host-side hot loops that scale with block count. The port's copy of
 * cup2d_tpu/native/amr_host.c. AMRSim._fix_states_py in amr.py implements
 * identical semantics and is its twin in the tests, which assert equality
 * on randomized forests.
 *
 * Exposed via ctypes (no pybind11 in the image); compiled lazily by
 * cup2d_tpu_torch/native/__init__.py with `cc -O2 -shared -fPIC`.
 *
 * fix_states: the 2:1-balance sweeps over all active blocks, finest
 * level first. Blocks are given as parallel arrays (level, i, j) with a
 * state byte (1 = refine, 0 = leave, -1 = compress), mutated in place:
 *   - a block whose finer face/corner neighbor region contains a
 *     refining block must refine;
 *   - a compressing block next to a finer region stays;
 *   - a compressing block next to a same-level refining block stays.
 * The fixpoint is iteration-order independent (promotions only read
 * finalized finer-level states or are monotone), matching amr.py.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* open-addressing hash map: packed (level, i, j) -> block index */
typedef struct {
    uint64_t *keys;
    int64_t *vals;
    uint64_t mask;
} map_t;

#define EMPTY UINT64_MAX

static inline uint64_t pack(int64_t l, int64_t i, int64_t j)
{
    /* level < 32, i/j < 2^29 (levelMax 8 x bpd 2 needs 12 bits) */
    return ((uint64_t)l << 58)
        | (((uint64_t)i & ((1ULL << 29) - 1)) << 29)
        | ((uint64_t)j & ((1ULL << 29) - 1));
}

static inline uint64_t hash64(uint64_t x)
{
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

static int map_init(map_t *m, int64_t n)
{
    uint64_t cap = 16;
    while ((int64_t)cap < 2 * n + 8)
        cap <<= 1;
    m->keys = (uint64_t *)malloc(cap * sizeof(uint64_t));
    m->vals = (int64_t *)malloc(cap * sizeof(int64_t));
    if (!m->keys || !m->vals) {
        free(m->keys);
        free(m->vals);
        return -1;
    }
    memset(m->keys, 0xFF, cap * sizeof(uint64_t));  /* all EMPTY */
    m->mask = cap - 1;
    return 0;
}

static void map_free(map_t *m)
{
    free(m->keys);
    free(m->vals);
}

static void map_put(map_t *m, uint64_t key, int64_t val)
{
    uint64_t h = hash64(key) & m->mask;
    while (m->keys[h] != EMPTY)
        h = (h + 1) & m->mask;
    m->keys[h] = key;
    m->vals[h] = val;
}

static int64_t map_get(const map_t *m, uint64_t key)
{
    uint64_t h = hash64(key) & m->mask;
    while (m->keys[h] != EMPTY) {
        if (m->keys[h] == key)
            return m->vals[h];
        h = (h + 1) & m->mask;
    }
    return -1;
}

/* any child of (l, i, j) active => the region is refined (the forest's
 * owner_relation == -1 for positions not themselves active) */
static int region_refined(const map_t *m, int64_t l, int64_t i, int64_t j)
{
    return map_get(m, pack(l + 1, 2 * i, 2 * j)) >= 0
        || map_get(m, pack(l + 1, 2 * i + 1, 2 * j)) >= 0
        || map_get(m, pack(l + 1, 2 * i, 2 * j + 1)) >= 0
        || map_get(m, pack(l + 1, 2 * i + 1, 2 * j + 1)) >= 0;
}

int fix_states(int64_t n, const int32_t *lvl, const int32_t *bi,
               const int32_t *bj, int8_t *state, int32_t level_max,
               int32_t bpdx, int32_t bpdy)
{
    map_t m;
    if (map_init(&m, n) != 0)
        return -1;
    for (int64_t k = 0; k < n; ++k)
        map_put(&m, pack(lvl[k], bi[k], bj[k]), k);

    for (int32_t mlev = level_max - 1; mlev >= 0; --mlev) {
        /* sweep 1: refining finer neighbors force refinement;
         * compressing next to ANY finer region must stay */
        for (int64_t k = 0; k < n; ++k) {
            if (lvl[k] != mlev || state[k] == 1 || lvl[k] == level_max - 1)
                continue;
            int64_t l = lvl[k], i = bi[k], j = bj[k];
            int64_t nbx = (int64_t)bpdx << l, nby = (int64_t)bpdy << l;
            for (int cx = -1; cx <= 1 && state[k] != 1; ++cx) {
                for (int cy = -1; cy <= 1; ++cy) {
                    if (cx == 0 && cy == 0)
                        continue;
                    int64_t ni = i + cx, nj = j + cy;
                    if (ni < 0 || ni >= nbx || nj < 0 || nj >= nby)
                        continue;
                    if (map_get(&m, pack(l, ni, nj)) >= 0)
                        continue;            /* same-level active: rel 0 */
                    if (!region_refined(&m, l, ni, nj))
                        continue;            /* rel != -1 */
                    if (state[k] == -1)
                        state[k] = 0;
                    for (int a = 0; a < 2 && state[k] != 1; ++a)
                        for (int b = 0; b < 2; ++b) {
                            int64_t ck = map_get(
                                &m, pack(l + 1, 2 * ni + a, 2 * nj + b));
                            if (ck >= 0 && state[ck] == 1) {
                                state[k] = 1;
                                break;
                            }
                        }
                    if (state[k] == 1)
                        break;
                }
            }
        }
        /* sweep 2: compressing next to a same-level refining block */
        for (int64_t k = 0; k < n; ++k) {
            if (lvl[k] != mlev || state[k] != -1)
                continue;
            int64_t l = lvl[k], i = bi[k], j = bj[k];
            int done = 0;
            for (int cx = -1; cx <= 1 && !done; ++cx)
                for (int cy = -1; cy <= 1; ++cy) {
                    if (cx == 0 && cy == 0)
                        continue;
                    int64_t ck = map_get(&m, pack(l, i + cx, j + cy));
                    if (ck >= 0 && state[ck] == 1) {
                        state[k] = 0;
                        done = 1;
                        break;
                    }
                }
        }
    }
    map_free(&m);
    return 0;
}
