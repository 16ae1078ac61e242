/* groupsweep.c — sequential halo-construction sweep for pinocchio-tpu.
 *
 * Native (C) implementation of the fragmentation group builder: the strictly
 * sequential-in-collapse-time sweep that turns per-particle collapse times
 * Fmax + LPT displacements into halos, merger trees and catalogs.
 *
 * Math contract follows the reference build_groups.c (see repo SURVEY.md):
 *   - peak / accretion / merging decision rules (build_groups.c:184-934)
 *   - capture radius "virial" (build_groups.c:1023-1108)
 *   - mass-weighted PBC-aware center updates (build_groups.c:1670-1728)
 *   - merger-tree bookkeeping (update_history, build_groups.c:1186-1240)
 *   - catalog capture at output redshifts (write_catalog, write_halos.c)
 *
 * Design differences from the reference (fresh implementation):
 *   - struct-of-arrays group state instead of group_data structs
 *   - O(1) dense grid->particle lookup instead of bsearch on sorted_pos
 *   - union-find with path halving for particle->group resolution instead
 *     of relabeling every particle of the absorbed group at merge time
 *   - growth-factor interpolation via caller-provided log10(F) tables
 *     instead of GSL splines (tables are dense enough to be exact at fp32)
 *
 * Compiled as a plain shared library; driven through ctypes.
 */

/* nanosleep and clock_gettime (the watermark's wait) */
#define _POSIX_C_SOURCE 199309L
#define _USE_MATH_DEFINES
#include <math.h>

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <stdio.h>
#include <time.h>

#define FILAMENT 1
#define SHIFT 0.5
#define PREFETCH_DIST 12
#define ORDER_FOR_GROUPS 2
#define ORDER_FOR_CATALOG 3

/* ------------------------------------------------------------------ */
/* configuration handed over from Python (all pointers borrowed)      */
/* ------------------------------------------------------------------ */

typedef struct {
    /* sorted particle data (descending Fmax) */
    int64_t n;              /* number of stored collapsed particles */
    const float *Fmax;      /* [n] */
    const int32_t *pos;     /* [n] linear cell index, z fastest */
    const float *v1;        /* [n*3] interleaved xyz */
    const float *v2;        /* [n*3] or NULL */
    const float *v31;       /* [n*3] or NULL */
    const float *v32;       /* [n*3] or NULL */
    const int32_t *loc;     /* [Lx*Ly*Lz] cell -> particle index or -1 */
    /* when non-NULL, particle ip's row in the v and seg_v tables is
     * rowmap[ip]: the sweep reads the host's full sparse-product tables
     * directly instead of per-sub-box gathered copies (saves one
     * ~GB-scale gather per displacement table per sub-box) */
    const int32_t *rowmap;

    /* geometry */
    int32_t L[3];           /* local grid-with-boundary dims */
    int32_t pbc[3];
    int32_t safe[3];
    int32_t stabl[3];       /* offset of local grid in the global grid */
    int32_t G[3];           /* global grid dims */

    /* fragmentation parameters (set_fragment_parameters, fragment.c:48) */
    double f_m, f_rm, espo, f_a, f_ra, f_200, sigmaD0;
    double sigma_grid;      /* sqrt(TrueVariance[Nsmooth-1]) */
    int32_t min_halo_mass;
    int32_t lpt_order;      /* 1, 2 or 3: fields available */

    /* growth tables on a uniform log10(F) grid */
    int32_t tab_n;
    double tab_lo, tab_dlog;
    const double *tab_w1, *tab_w2, *tab_w31, *tab_w32; /* D_i(z)/D_i(zlast) */
    const double *tab_dv1, *tab_dv2, *tab_dv31, *tab_dv32; /* vel factors */
    const double *tab_D1;   /* D(z) for sigmaD in virial() */

    /* outputs */
    int32_t nout;
    const double *outF;     /* 1+z of each output, descending F order */

    int32_t maxg;           /* capacity of group arrays (Npeaks + 3) */

    /* scale-dependent growth (SCALE_DEPENDENT): 2D weight tables over
     * (log10 k on the NkBINS grid) x (log10 F); groups evaluate them at a
     * mass-dependent effective scale (set_obj, build_groups.c:1361-1375),
     * particles at k_GM_displ of the last radius. sd_nk = 0 -> off. */
    int32_t sd_nk;
    double sd_logk_lo, sd_dlogk;         /* NkBINS log10 k grid */
    const double *sd_w1, *sd_w2, *sd_w31, *sd_w32;     /* [nk*tab_n] */
    const double *sd_dv1, *sd_dv2, *sd_dv31, *sd_dv32; /* [nk*tab_n] */
    double sd_rad_gm0;                   /* Rad_GM[0], Mpc */
    int32_t sd_nsmooth;
    const double *sd_logk_displ;         /* [nsmooth] log10 k_GM_displ */
    double sd_logk_part;                 /* particles' log10 k */
    double sd_ipd;                       /* InterPartDist */

    /* RECOMPUTE_DISPLACEMENTS: segmented fragmentation.  Segment s covers
     * F >= segF[s]; within segment s >= 1 positions interpolate between
     * the displacement sets computed at the bracketing output redshifts
     * (set_weight else-branch, build_groups.c:1427-1442; q2x,
     * build_groups.c:1578-1592).  nseg = 0 -> single-segment mode using
     * v1..v32 above. */
    int32_t nseg;
    const double *segF;                  /* [nseg] 1+z_s, descending */
    const float **seg_v1, **seg_v2, **seg_v31, **seg_v32;  /* [nseg] */
    /* per-segment weight tables, [nseg * tab_n] (or [nseg*sd_nk*tab_n]
     * when sd_nk > 0) */
    const double *seg_w1, *seg_w2, *seg_w31, *seg_w32;

    /* streaming watermark: when non-NULL, rows [0, *rows_ready) of every
     * v/seg table are delivered (they cross the device->host link DURING
     * the sweep, in sweep order); the sweep spin-waits before touching a
     * row at or past the watermark.  All table reads are at prow(ip) of
     * the current or an earlier-processed particle, and rowmap is
     * monotonic in sweep order, so the prefix condition is sufficient
     * (streamed analog of the reference's 50k-particle chunked
     * redistribution, distribute.c:300-534). */
    const volatile int64_t *rows_ready;
    /* with rows_ready: the nanoseconds the sweep waited on the watermark
     * are added here */
    int64_t *rows_wait_ns;
} sweep_input;

/* group state (struct of arrays), allocated by the sweep */
typedef struct {
    int32_t *mass;
    float *q;               /* [maxg*3] Lagrangian CM, local grid coords */
    float *gv1, *gv2, *gv31, *gv32;   /* [maxg*3] mass-weighted mean */
    float *pv1, *pv2, *pv31, *pv32;   /* [maxg*3] previous-segment mean */
    uint64_t *name;
    float *t_peak, *t_appear, *t_merge;
    int32_t *mass_at_merger, *merged_with;
    int32_t *halo_app, *ll;
    uint8_t *good, *alive;
    int32_t *parent;        /* union-find over group ids */
    float *Flast;           /* last F at which the PLC condition was seen */
    int32_t ngroups;
} group_state;

/* catalog capture buffers (provided by Python, capacity nout*maxg) */
typedef struct {
    uint64_t *name;
    int32_t *mass;
    float *q, *x, *v;       /* [cap*3] */
    int32_t *count;         /* [nout] rows per output */
} capture_buffers;

/* past-light-cone configuration (borrowed pointers; enabled=0 -> off)
 * geometry from plc.py: replications + F windows (set_plc,
 * initialization.c:543-776) */
typedef struct {
    int32_t enabled;
    double Fstart, Fstop;
    double center[3];          /* grid units */
    double zvers[3];
    double ipd;                /* InterPartDist, Mpc per grid unit */
    double aperture;           /* degrees */
    double brent_err;
    int32_t nrepl;
    const int32_t *repl_ijk;   /* [nrepl*3] */
    const double *repl_F1;     /* [nrepl] */
    const double *repl_F2;
    const double *tab_rF;      /* comoving distance (grid units) vs log10F */
    int32_t nzbins;
    double delta_z, z_last;
    int64_t cap;               /* capacity of the output halo buffers */
} plc_input;

typedef struct {
    uint64_t *name;
    float *zred;
    int32_t *mass;
    float *x, *v;              /* [cap*3], x in true Mpc */
    double *nz;                /* [nzbins] */
    int64_t *count;
    int32_t *overflow;
} plc_output;

/* final per-group output (provided by Python, capacity maxg) */
typedef struct {
    int32_t *mass;
    uint64_t *name;
    int32_t *halo_app, *ll, *merged_with, *mass_at_merger;
    float *t_appear, *t_peak, *t_merge;
    uint8_t *good, *alive;
    int32_t *ngroups;
    uint64_t *counters;     /* [16] event counters */
    int32_t *group_of_particle;  /* [n] final group id per particle, or 0/1 */
    float *zacc;            /* [n] accretion redshift (SNAPSHOT products) */
    float *gq;              /* [maxg*3] final Lagrangian CM per group in
                             * local sub-box coords, or NULL (used by the
                             * two-turn update_map, build_groups.c:2246) */
} sweep_output;

/* ------------------------------------------------------------------ */

/* per-sweep state: thread-local so concurrent sub-box sweeps (driven from
 * a Python thread pool; the ctypes call releases the GIL) are isolated */
static _Thread_local const sweep_input *I;
static _Thread_local const plc_input *PLC;
static _Thread_local const plc_output *PLCOUT;
static _Thread_local group_state G;

static inline double tab_interp(const double *tab, double F)
{
    double t = (log10(F) - I->tab_lo) / I->tab_dlog;
    if (t <= 0.0) return tab[0];
    int i = (int)t;
    if (i >= I->tab_n - 1) return tab[I->tab_n - 1];
    double w = t - i;
    return tab[i] * (1.0 - w) + tab[i + 1] * w;
}

static inline int64_t prow(int64_t ip)
{
    return I->rowmap ? (int64_t)I->rowmap[ip] : ip;
}

static inline int32_t uf_find(int32_t g)
{
    while (G.parent[g] != g) {
        G.parent[g] = G.parent[G.parent[g]];   /* path halving */
        g = G.parent[g];
    }
    return g;
}

/* weights for moving objects to redshift z = F-1 (set_weight,
 * build_groups.c:1411-1444, first-segment branch) */
typedef struct { double w1, w2, w31, w32; } weights_t;

/* bilinear lookup in a [nk x tab_n] table over (log10 k, log10 F);
 * linear interpolation in log k mirrors InterpolateGrowth
 * (cosmo.c:1742-1749) */
static inline double tab2_interp(const double *tab, double logk, double F)
{
    double t = (log10(F) - I->tab_lo) / I->tab_dlog;
    if (t < 0.0) t = 0.0;
    int i = (int)t;
    if (i >= I->tab_n - 1) { i = I->tab_n - 2; t = (double)(i + 1); }
    double wf = t - i;
    double u = (logk - I->sd_logk_lo) / I->sd_dlogk;
    if (u < 0.0) u = 0.0;
    int j = (int)u;
    if (j >= I->sd_nk - 1) { j = I->sd_nk - 2; u = (double)(j + 1); }
    double wk = u - j;
    const double *r0 = tab + (int64_t)j * I->tab_n;
    const double *r1 = r0 + I->tab_n;
    double lo = r0[i] * (1.0 - wf) + r0[i + 1] * wf;
    double hi = r1[i] * (1.0 - wf) + r1[i + 1] * wf;
    return lo * (1.0 - wk) + hi * wk;
}

static inline weights_t weights_at(double F, double logk)
{
    weights_t w;
    if (I->sd_nk) {
        w.w1 = tab2_interp(I->sd_w1, logk, F);
        w.w2 = I->lpt_order >= 2 ? tab2_interp(I->sd_w2, logk, F) : 0.0;
        w.w31 = I->lpt_order >= 3 ? tab2_interp(I->sd_w31, logk, F) : 0.0;
        w.w32 = I->lpt_order >= 3 ? tab2_interp(I->sd_w32, logk, F) : 0.0;
    } else {
        w.w1 = tab_interp(I->tab_w1, F);
        w.w2 = I->lpt_order >= 2 ? tab_interp(I->tab_w2, F) : 0.0;
        w.w31 = I->lpt_order >= 3 ? tab_interp(I->tab_w31, F) : 0.0;
        w.w32 = I->lpt_order >= 3 ? tab_interp(I->tab_w32, F) : 0.0;
    }
    return w;
}

static _Thread_local int cur_seg = 0;     /* current fragmentation segment */

/* per-segment weight lookup: row cur_seg of the segment tables */
static inline double seg_tab_interp(const double *tab, double logk,
                                    double F)
{
    if (I->sd_nk)   /* segment tables are [nseg][sd_nk][tab_n] slabs */
        return tab2_interp(tab + (int64_t)cur_seg * I->sd_nk * I->tab_n,
                           logk, F);
    return tab_interp(tab + (int64_t)cur_seg * I->tab_n, F);
}

static inline weights_t weights_at_seg(double F, double logk)
{
    if (!I->nseg)
        return weights_at(F, logk);
    weights_t w;
    w.w1 = seg_tab_interp(I->seg_w1, logk, F);
    w.w2 = I->lpt_order >= 2 ? seg_tab_interp(I->seg_w2, logk, F) : 0.0;
    w.w31 = I->lpt_order >= 3 ? seg_tab_interp(I->seg_w31, logk, F) : 0.0;
    w.w32 = I->lpt_order >= 3 ? seg_tab_interp(I->seg_w32, logk, F) : 0.0;
    return w;
}

/* the sweep evaluates the particle-side weights and the F-dependent
 * growth many times per particle at the SAME F: memoize on F */
static _Thread_local double memo_F = -1.0;
static _Thread_local weights_t memo_w;
static _Thread_local double memo_D1;

static inline weights_t get_weights(double F)
{
    if (F != memo_F) {
        memo_w = weights_at_seg(F, I->sd_nk ? I->sd_logk_part : 0.0);
        memo_D1 = tab_interp(I->tab_D1, F);
        memo_F = F;
    }
    return memo_w;
}

/* cached mass powers for virial(): cbrt(m) and cbrt(m)^espo (masses are
 * small integers with heavy reuse) */
#define MPOW_CACHE 65536
static _Thread_local float *mpow_rlag = NULL;   /* cbrt(m) */
static _Thread_local float *mpow_espo = NULL;   /* cbrt(m)^espo */

static inline void mpow_init(void)
{
    mpow_rlag = malloc(MPOW_CACHE * sizeof(float));
    mpow_espo = malloc(MPOW_CACHE * sizeof(float));
    for (int m = 1; m < MPOW_CACHE; m++) {
        double r = cbrt((double)m);
        mpow_rlag[m] = (float)r;
        mpow_espo[m] = (float)pow(r, I->espo);
    }
    mpow_rlag[0] = 0.f;
    mpow_espo[0] = 0.f;
}

/* velocity arrays of the current (and previous) segment */
static inline const float *seg_arr(const float **seg, const float *flat)
{
    return I->nseg ? seg[cur_seg] : flat;
}
static inline const float *seg_arr_prev(const float **seg)
{
    return (I->nseg && cur_seg > 0) ? seg[cur_seg - 1] : NULL;
}

/* mass-dependent effective scale of a group (set_obj,
 * build_groups.c:1361-1375): linear interpolation of log k over the
 * Rad_GM ladder by the group's Lagrangian radius */
static inline double group_logk(int32_t g)
{
    if (!I->sd_nk)
        return 0.0;
    double R = cbrt((double)G.mass[g] * 3.0 / 4.0 / M_PI) * I->sd_ipd;
    double interp = (1.0 - R / I->sd_rad_gm0)
                    * (double)(I->sd_nsmooth - 1);
    if (interp < 0.0) interp = 0.0;
    int idx = (int)interp;
    if (idx >= I->sd_nsmooth - 1) idx = I->sd_nsmooth - 2;
    double w = interp - idx;
    return I->sd_logk_displ[idx] * (1.0 - w)
         + I->sd_logk_displ[idx + 1] * w;
}

/* Eulerian position of a group along dim i at weights w, order `order`
 * (q2x, build_groups.c:1554-1603) */
static inline double q2x_group(int i, int32_t g, const weights_t *w,
                               int order, int wrap)
{
    double p;
    if (I->nseg && cur_seg > 0) {
        /* interpolate between the two segments' displacement sets
         * (q2x, build_groups.c:1578-1592) */
        p = G.q[3 * g + i] + (1.0 - w->w1) * G.pv1[3 * g + i]
            + w->w1 * G.gv1[3 * g + i];
        if (order > 1 && I->lpt_order >= 2)
            p += (1.0 - w->w2) * G.pv2[3 * g + i]
                + w->w2 * G.gv2[3 * g + i];
        if (order > 2 && I->lpt_order >= 3)
            p += (1.0 - w->w31) * G.pv31[3 * g + i]
                + w->w31 * G.gv31[3 * g + i]
                + (1.0 - w->w32) * G.pv32[3 * g + i]
                + w->w32 * G.gv32[3 * g + i];
    } else {
        p = G.q[3 * g + i] + w->w1 * G.gv1[3 * g + i];
        if (order > 1 && I->lpt_order >= 2)
            p += w->w2 * G.gv2[3 * g + i];
        if (order > 2 && I->lpt_order >= 3)
            p += w->w31 * G.gv31[3 * g + i] + w->w32 * G.gv32[3 * g + i];
    }
    if (wrap && I->pbc[i]) {
        double L = (double)I->L[i];
        if (p >= L) p -= L;
        if (p < 0.0) p += L;
    }
    return p;
}

static inline double q2x_point(int i, const double *q, int64_t ip0,
                               const weights_t *w, int order, int wrap)
{
    const int64_t ip = prow(ip0);
    const float *v1 = seg_arr(I->seg_v1, I->v1) + 3 * ip;
    const float *v2 = I->v2 || I->nseg
        ? seg_arr(I->seg_v2, I->v2) + 3 * ip : NULL;
    const float *v31 = (I->v31 || I->nseg) && I->lpt_order >= 3
        ? seg_arr(I->seg_v31, I->v31) + 3 * ip : NULL;
    const float *v32 = v31 ? seg_arr(I->seg_v32, I->v32) + 3 * ip : NULL;
    double p;
    if (I->nseg && cur_seg > 0) {
        const float *p1 = seg_arr_prev(I->seg_v1) + 3 * ip;
        const float *p2 = seg_arr_prev(I->seg_v2) + 3 * ip;
        p = q[i] + (1.0 - w->w1) * p1[i] + w->w1 * v1[i];
        if (order > 1 && I->lpt_order >= 2)
            p += (1.0 - w->w2) * p2[i] + w->w2 * v2[i];
        if (order > 2 && v31) {
            const float *p31 = seg_arr_prev(I->seg_v31) + 3 * ip;
            const float *p32 = seg_arr_prev(I->seg_v32) + 3 * ip;
            p += (1.0 - w->w31) * p31[i] + w->w31 * v31[i]
               + (1.0 - w->w32) * p32[i] + w->w32 * v32[i];
        }
    } else {
        p = q[i] + w->w1 * v1[i];
        if (order > 1 && I->lpt_order >= 2 && v2)
            p += w->w2 * v2[i];
        if (order > 2 && v31)
            p += w->w31 * v31[i] + w->w32 * v32[i];
    }
    if (wrap && I->pbc[i]) {
        double L = (double)I->L[i];
        if (p >= L) p -= L;
        if (p < 0.0) p += L;
    }
    return p;
}

/* capture radius squared (virial, build_groups.c:1023-1108) */
static inline double virial2(int32_t mass, double F, int accretion_flag)
{
    double rlag, rlag_e;
    if (mass < MPOW_CACHE) {
        rlag = mpow_rlag[mass];
        rlag_e = mpow_espo[mass];
    } else {
        rlag = pow((double)mass, 0.333333333333333);
        rlag_e = pow(rlag, I->espo);
    }
    if (F != memo_F)
        (void)get_weights(F);        /* refresh memo_D1 */
    double sigmaD = I->sigma_grid * memo_D1;
    double r;
    if (!accretion_flag)
        r = I->f_m * rlag_e *
            (sigmaD > I->sigmaD0 ? 1.0 + (sigmaD - I->sigmaD0) * I->f_rm : 1.0);
    else
        r = I->f_a * rlag_e *
            (sigmaD > I->sigmaD0 ? 1.0 + (sigmaD - I->sigmaD0) * I->f_ra : 1.0);
    double r200 = I->f_200 * rlag;
    return r * r + r200 * r200;
}

static inline double wrap_d(int i, double d)
{
    if (I->pbc[i]) {
        double halfL = (double)I->L[i] / 2.0;
        if (d > halfL) d -= (double)I->L[i];
        if (d < -halfL) d += (double)I->L[i];
    }
    return d;
}

/* distance^2 between particle (cell ix,iy,iz, data index ip) and group g
 * at time F, early-exiting dim by dim (condition_for_accretion,
 * build_groups.c:1286-1317). Returns d2 if below r2, else a large value. */
static inline void cond_accretion(int ix, int iy, int iz, int64_t ip,
                                  double F, int32_t g,
                                  double *dd, double *rr)
{
    weights_t w = get_weights(F);
    weights_t wg = I->sd_nk ? weights_at_seg(F, group_logk(g)) : w;
    double q[3] = { ix + SHIFT, iy + SHIFT, iz + SHIFT };

    *rr = virial2(G.mass[g], F, 1);
    *dd = 100.0 * (*rr);

    double d = wrap_d(0, q2x_point(0, q, ip, &w, ORDER_FOR_GROUPS, 1)
                      - q2x_group(0, g, &wg, ORDER_FOR_GROUPS, 1));
    double d2 = d * d;
    if (d2 < *rr) {
        d = wrap_d(1, q2x_point(1, q, ip, &w, ORDER_FOR_GROUPS, 1)
                   - q2x_group(1, g, &wg, ORDER_FOR_GROUPS, 1));
        d2 += d * d;
        if (d2 < *rr) {
            d = wrap_d(2, q2x_point(2, q, ip, &w, ORDER_FOR_GROUPS, 1)
                       - q2x_group(2, g, &wg, ORDER_FOR_GROUPS, 1));
            d2 += d * d;
            if (d2 <= *rr)
                *dd = d2;
        }
    }
}

/* condition_for_merging (build_groups.c:1320-1348) */
static inline int cond_merging(double F, int32_t g1, int32_t g2)
{
    double r1 = virial2(G.mass[g1], F, 0);
    double r2 = virial2(G.mass[g2], F, 0);
    double rr = r1 > r2 ? r1 : r2;
    weights_t w1 = I->sd_nk ? weights_at_seg(F, group_logk(g1))
                            : get_weights(F);
    weights_t w2 = I->sd_nk ? weights_at_seg(F, group_logk(g2)) : w1;

    double d = wrap_d(0, q2x_group(0, g2, &w2, ORDER_FOR_GROUPS, 1)
                      - q2x_group(0, g1, &w1, ORDER_FOR_GROUPS, 1));
    double dd = d * d;
    if (dd < rr) {
        d = wrap_d(1, q2x_group(1, g2, &w2, ORDER_FOR_GROUPS, 1)
                   - q2x_group(1, g1, &w1, ORDER_FOR_GROUPS, 1));
        dd += d * d;
        if (dd < rr) {
            d = wrap_d(2, q2x_group(2, g2, &w2, ORDER_FOR_GROUPS, 1)
                       - q2x_group(2, g1, &w1, ORDER_FOR_GROUPS, 1));
            dd += d * d;
            if (dd <= rr)
                return 1;
        }
    }
    return 0;
}

/* mass-weighted PBC-aware merge of Lagrangian CM and mean velocities
 * (update, build_groups.c:1670-1728); b is merged into a */
static void state_update(int32_t M1, double q1[3], float *vs1[4],
                         int32_t M2, const double q2[3],
                         const float *vs2[4])
{
    double Mtot = (double)M1 + (double)M2;
    for (int i = 0; i < 3; i++) {
        double a = q1[i], b = q2[i];
        if (!I->pbc[i]) {
            q1[i] = (a * M1 + b * M2) / Mtot;
        } else {
            double L = (double)I->L[i], halfL = L / 2.0;
            double d = fabs(a - b);
            if (d <= halfL)
                q1[i] = (a * M1 + b * M2) / Mtot;
            else if (a > halfL)
                q1[i] = (a * M1 + (b + L) * M2) / Mtot;
            else
                q1[i] = (a * M1 + (b - L) * M2) / Mtot;
            if (q1[i] > L) q1[i] -= L;
            if (q1[i] < 0.0) q1[i] += L;
        }
        for (int o = 0; o < 8; o++)
            if (vs1[o])
                vs1[o][i] = (float)((vs1[o][i] * M1 + vs2[o][i] * M2) / Mtot);
    }
}

/* accrete particle (cell ix,iy,iz, index ip) onto group g at time F
 * (accretion, build_groups.c:1243-1281) */
static _Thread_local int32_t *group_of_particle_arr;   /* [n] */
static _Thread_local float *join_F_arr;  /* [n] F at which it joined */

static void do_accretion(int32_t g, int ix, int iy, int iz, int64_t ip0,
                         double F)
{
    const int64_t ip = prow(ip0);   /* row in the v/seg tables */
    int has2 = I->v2 || I->nseg, has3 = (I->v31 != NULL)
        || (I->nseg && I->lpt_order >= 3);
    double q1[3] = { G.q[3 * g], G.q[3 * g + 1], G.q[3 * g + 2] };
    float *vs1[8] = { G.gv1 + 3 * g,
                      has2 ? G.gv2 + 3 * g : NULL,
                      has3 ? G.gv31 + 3 * g : NULL,
                      has3 ? G.gv32 + 3 * g : NULL,
                      G.pv1 ? G.pv1 + 3 * g : NULL,
                      G.pv1 && has2 ? G.pv2 + 3 * g : NULL,
                      G.pv1 && has3 ? G.pv31 + 3 * g : NULL,
                      G.pv1 && has3 ? G.pv32 + 3 * g : NULL };
    double q2[3] = { ix + SHIFT, iy + SHIFT, iz + SHIFT };
    const float *zero3 = (const float[3]){0.f, 0.f, 0.f};
    int prev_ok = I->nseg && cur_seg > 0;
    const float *vs2[8] = {
        seg_arr(I->seg_v1, I->v1) + 3 * ip,
        has2 ? seg_arr(I->seg_v2, I->v2) + 3 * ip : NULL,
        has3 ? seg_arr(I->seg_v31, I->v31) + 3 * ip : NULL,
        has3 ? seg_arr(I->seg_v32, I->v32) + 3 * ip : NULL,
        G.pv1 ? (prev_ok ? seg_arr_prev(I->seg_v1) + 3 * ip : zero3)
              : NULL,
        G.pv1 && has2
            ? (prev_ok ? seg_arr_prev(I->seg_v2) + 3 * ip : zero3) : NULL,
        G.pv1 && has3
            ? (prev_ok ? seg_arr_prev(I->seg_v31) + 3 * ip : zero3) : NULL,
        G.pv1 && has3
            ? (prev_ok ? seg_arr_prev(I->seg_v32) + 3 * ip : zero3)
            : NULL };
    state_update(G.mass[g], q1, vs1, 1, q2, vs2);
    for (int i = 0; i < 3; i++)
        G.q[3 * g + i] = (float)q1[i];
    G.mass[g] += 1;

    if (G.mass[g] >= I->min_halo_mass && G.t_appear[g] == -1.0f)
        G.t_appear[g] = (float)F;

    group_of_particle_arr[ip0] = g;
    join_F_arr[ip0] = (float)F;
}

/* merger-tree linked-list bookkeeping (update_history,
 * build_groups.c:1186-1240): g2 flows into g1 */
static void update_history(int32_t g1, int32_t g2, double F)
{
    int32_t old_i;
    if (G.ll[g1] == g1 && G.ll[g2] == g2) {
        G.ll[g1] = g2;
        G.ll[g2] = g1;
    } else if (G.ll[g1] != g1 && G.ll[g2] == g2) {
        G.ll[g2] = g1;
        old_i = g1;
        while (G.ll[old_i] != g1)
            old_i = G.ll[old_i];
        G.ll[old_i] = g2;
    } else if (G.ll[g1] == g1 && G.ll[g2] != g2) {
        old_i = g2;
        while (G.ll[old_i] != g2) {
            old_i = G.ll[old_i];
            G.halo_app[old_i] = g1;
        }
        G.halo_app[g2] = g1;
        G.ll[g1] = G.ll[g2];
        G.ll[g2] = g1;
    } else {
        old_i = g2;
        while (G.ll[old_i] != g2) {
            old_i = G.ll[old_i];
            G.halo_app[old_i] = g1;
        }
        old_i = g1;
        while (G.ll[old_i] != g1)
            old_i = G.ll[old_i];
        G.ll[old_i] = G.ll[g2];
        G.ll[g2] = g1;
    }
    G.halo_app[g2] = g1;
    G.t_merge[g2] = (float)F;
    G.mass_at_merger[g2] = G.mass[g1];
    G.merged_with[g2] = g1;
}

/* merge grp2 into grp1 (merge_groups, build_groups.c:1115-1183) */
static void do_merge(int32_t g1, int32_t g2, double F)
{
    G.parent[g2] = g1;                       /* union-find relabel */

    if (G.mass[g1] >= I->min_halo_mass && G.mass[g2] >= I->min_halo_mass)
        update_history(g1, g2, F);

    int has2 = I->v2 || I->nseg, has3 = (I->v31 != NULL)
        || (I->nseg && I->lpt_order >= 3);
    double q1[3] = { G.q[3 * g1], G.q[3 * g1 + 1], G.q[3 * g1 + 2] };
    float *vs1[8] = { G.gv1 + 3 * g1,
                      has2 ? G.gv2 + 3 * g1 : NULL,
                      has3 ? G.gv31 + 3 * g1 : NULL,
                      has3 ? G.gv32 + 3 * g1 : NULL,
                      G.pv1 ? G.pv1 + 3 * g1 : NULL,
                      G.pv1 && has2 ? G.pv2 + 3 * g1 : NULL,
                      G.pv1 && has3 ? G.pv31 + 3 * g1 : NULL,
                      G.pv1 && has3 ? G.pv32 + 3 * g1 : NULL };
    double q2[3] = { G.q[3 * g2], G.q[3 * g2 + 1], G.q[3 * g2 + 2] };
    const float *vs2[8] = { G.gv1 + 3 * g2,
                            has2 ? G.gv2 + 3 * g2 : NULL,
                            has3 ? G.gv31 + 3 * g2 : NULL,
                            has3 ? G.gv32 + 3 * g2 : NULL,
                            G.pv1 ? G.pv1 + 3 * g2 : NULL,
                            G.pv1 && has2 ? G.pv2 + 3 * g2 : NULL,
                            G.pv1 && has3 ? G.pv31 + 3 * g2 : NULL,
                            G.pv1 && has3 ? G.pv32 + 3 * g2 : NULL };
    state_update(G.mass[g1], q1, vs1, G.mass[g2], q2, vs2);
    for (int i = 0; i < 3; i++)
        G.q[3 * g1 + i] = (float)q1[i];
    G.mass[g1] += G.mass[g2];
    G.alive[g2] = 0;

    if (G.mass[g1] >= I->min_halo_mass && G.t_appear[g1] == -1.0f)
        G.t_appear[g1] = (float)F;
}

/* write a catalog snapshot for output iout (write_catalog,
 * write_halos.c:267-318, reduced to the capture step: unit conversion is
 * done by the Python caller) */
static void capture_catalog(int iout, const capture_buffers *cap)
{
    double Fout = I->outF[iout];
    weights_t w = get_weights(Fout);
    double dv1 = tab_interp(I->tab_dv1, Fout);
    double dv2 = I->lpt_order >= 2 ? tab_interp(I->tab_dv2, Fout) : 0.0;
    double dv31 = I->lpt_order >= 3 ? tab_interp(I->tab_dv31, Fout) : 0.0;
    double dv32 = I->lpt_order >= 3 ? tab_interp(I->tab_dv32, Fout) : 0.0;

    int64_t base = (int64_t)iout * I->maxg;
    int32_t cnt = 0;
    for (int32_t g = FILAMENT + 1; g <= G.ngroups; g++) {
        if (!G.alive[g] || !G.good[g] || G.mass[g] < I->min_halo_mass)
            continue;
        if (I->sd_nk) {
            double lk = group_logk(g);
            w = weights_at_seg(Fout, lk);
            dv1 = tab2_interp(I->sd_dv1, lk, Fout);
            dv2 = I->lpt_order >= 2 ? tab2_interp(I->sd_dv2, lk, Fout)
                                    : 0.0;
            dv31 = I->lpt_order >= 3 ? tab2_interp(I->sd_dv31, lk, Fout)
                                     : 0.0;
            dv32 = I->lpt_order >= 3 ? tab2_interp(I->sd_dv32, lk, Fout)
                                     : 0.0;
        }
        int64_t row = base + cnt;
        cap->name[row] = G.name[g];
        cap->mass[row] = G.mass[g];
        for (int i = 0; i < 3; i++) {
            cap->q[3 * row + i] = G.q[3 * g + i];
            cap->x[3 * row + i] =
                (float)q2x_group(i, g, &w, ORDER_FOR_CATALOG, 1);
            double vv;
            if (I->nseg && cur_seg > 0) {
                /* vel, build_groups.c:1627-1639 */
                vv = (G.pv1[3 * g + i] * (1.0 - w.w1)
                      + G.gv1[3 * g + i] * w.w1) * dv1;
                if (I->lpt_order >= 2)
                    vv += (G.pv2[3 * g + i] * (1.0 - w.w2)
                           + G.gv2[3 * g + i] * w.w2) * dv2;
                if (I->lpt_order >= 3)
                    vv += (G.pv31[3 * g + i] * (1.0 - w.w31)
                           + G.gv31[3 * g + i] * w.w31) * dv31
                        + (G.pv32[3 * g + i] * (1.0 - w.w32)
                           + G.gv32[3 * g + i] * w.w32) * dv32;
            } else {
                vv = G.gv1[3 * g + i] * dv1 * w.w1;
                if (I->lpt_order >= 2)
                    vv += G.gv2[3 * g + i] * dv2 * w.w2;
                if (I->lpt_order >= 3)
                    vv += G.gv31[3 * g + i] * dv31 * w.w31
                        + G.gv32[3 * g + i] * dv32 * w.w32;
            }
            cap->v[3 * row + i] = (float)vv;
        }
        cnt++;
    }
    cap->count[iout] = cnt;
}

/* ------------------------------------------------------------------ */
/* past light cone: on-the-fly crossing detection                     */
/* (condition_PLC / store_PLC / find_brent, build_groups.c:1730-1877) */
/* ------------------------------------------------------------------ */

/* signed distance of group g (displaced to time F, ORDER_FOR_CATALOG,
 * PBC wrap off) from the light cone, for replication ir: positive means
 * outside the cone shell */
static double cond_plc(int32_t g, double F, int ir)
{
    weights_t w = I->sd_nk ? weights_at_seg(F, group_logk(g))
                           : get_weights(F);
    double s = 0.0;
    for (int i = 0; i < 3; i++) {
        double d = q2x_group(i, g, &w, ORDER_FOR_CATALOG, 0)
            + (double)I->stabl[i]
            - (PLC->center[i]
               - (double)I->G[i] * (double)PLC->repl_ijk[3 * ir + i]);
        s += d * d;
    }
    return sqrt(s) - tab_interp(PLC->tab_rF, F);
}

/* bracketed root of cond_plc in [F_out, F_in] with cond(F_out) > 0 >
 * cond(F_in); bisection to |cond| < brent_err like find_brent */
static double solve_plc_crossing(int32_t g, int ir, double F_out,
                                 double F_in)
{
    double lo = F_out, hi = F_in;   /* cond(lo) > 0, cond(hi) < 0 */
    for (int it = 0; it < 100; it++) {
        double mid = 0.5 * (lo + hi);
        double c = cond_plc(g, mid, ir);
        if (fabs(c) < PLC->brent_err)
            return mid;
        if (c > 0.0)
            lo = mid;
        else
            hi = mid;
    }
    return 0.5 * (lo + hi);
}

static void store_plc(int32_t g, double F, int ir)
{
    if (*PLCOUT->count >= PLC->cap) {
        *PLCOUT->overflow = 1;
        return;
    }
    double lk = I->sd_nk ? group_logk(g) : 0.0;
    weights_t w = I->sd_nk ? weights_at_seg(F, lk) : get_weights(F);
    double dv1, dv2 = 0.0, dv31 = 0.0, dv32 = 0.0;
    if (I->sd_nk) {
        dv1 = tab2_interp(I->sd_dv1, lk, F);
        if (I->lpt_order >= 2) dv2 = tab2_interp(I->sd_dv2, lk, F);
        if (I->lpt_order >= 3) {
            dv31 = tab2_interp(I->sd_dv31, lk, F);
            dv32 = tab2_interp(I->sd_dv32, lk, F);
        }
    } else {
        dv1 = tab_interp(I->tab_dv1, F);
        if (I->lpt_order >= 2) dv2 = tab_interp(I->tab_dv2, F);
        if (I->lpt_order >= 3) {
            dv31 = tab_interp(I->tab_dv31, F);
            dv32 = tab_interp(I->tab_dv32, F);
        }
    }

    double x[3], vv[3];
    for (int i = 0; i < 3; i++) {
        x[i] = PLC->ipd *
            (q2x_group(i, g, &w, ORDER_FOR_CATALOG, 0)
             + (double)I->stabl[i]
             - (PLC->center[i]
                - (double)I->G[i] * (double)PLC->repl_ijk[3 * ir + i]));
        if (I->nseg && cur_seg > 0) {
            vv[i] = (G.pv1[3 * g + i] * (1.0 - w.w1)
                     + G.gv1[3 * g + i] * w.w1) * dv1;
            if (I->lpt_order >= 2)
                vv[i] += (G.pv2[3 * g + i] * (1.0 - w.w2)
                          + G.gv2[3 * g + i] * w.w2) * dv2;
            if (I->lpt_order >= 3)
                vv[i] += (G.pv31[3 * g + i] * (1.0 - w.w31)
                          + G.gv31[3 * g + i] * w.w31) * dv31
                       + (G.pv32[3 * g + i] * (1.0 - w.w32)
                          + G.gv32[3 * g + i] * w.w32) * dv32;
        } else {
            vv[i] = G.gv1[3 * g + i] * dv1 * w.w1;
            if (I->lpt_order >= 2)
                vv[i] += G.gv2[3 * g + i] * dv2 * w.w2;
            if (I->lpt_order >= 3)
                vv[i] += G.gv31[3 * g + i] * dv31 * w.w31
                    + G.gv32[3 * g + i] * dv32 * w.w32;
        }
    }
    double rho = sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
    double angle_deg = 90.0;
    if (rho > 0.0) {
        double ca = (x[0] * PLC->zvers[0] + x[1] * PLC->zvers[1]
                     + x[2] * PLC->zvers[2]) / rho;
        if (ca > 1.0) ca = 1.0;
        if (ca < -1.0) ca = -1.0;
        angle_deg = acos(ca) * 180.0 / M_PI;
    }
    /* aperture cut: 90 - theta < aperture (store_PLC,
     * build_groups.c:1795) */
    if (angle_deg >= PLC->aperture)
        return;

    int64_t row = *PLCOUT->count;
    PLCOUT->name[row] = G.name[g];
    PLCOUT->zred[row] = (float)(F - 1.0);
    PLCOUT->mass[row] = G.mass[g];
    for (int i = 0; i < 3; i++) {
        PLCOUT->x[3 * row + i] = (float)x[i];
        PLCOUT->v[3 * row + i] = (float)vv[i];
    }
    int iz = (int)(((F - 1.0) - PLC->z_last) / PLC->delta_z);
    if (iz >= PLC->nzbins)
        iz = PLC->nzbins - 1;
    if (iz < 0)
        iz = 0;
    PLCOUT->nz[iz] += 1.0;
    *PLCOUT->count = row + 1;
}

/* per-particle check on the neighbour groups (build_groups.c:356-450) */
static void plc_check_groups(const int32_t *neigh, int neigrp, double F)
{
    for (int a = 0; a < neigrp; a++) {
        int32_t g = neigh[a];
        if (g > FILAMENT && G.good[g] && G.mass[g] >= I->min_halo_mass) {
            for (int ir = 0; ir < PLC->nrepl; ir++) {
                if (F > PLC->repl_F1[ir]
                    || (double)G.Flast[g] < PLC->repl_F2[ir])
                    continue;
                double bb = cond_plc(g, F, ir);
                if (bb == 0.0) {
                    store_plc(g, F, ir);
                } else if (bb > 0.0) {
                    double aa = cond_plc(g, (double)G.Flast[g], ir);
                    if (aa < 0.0)
                        store_plc(g, solve_plc_crossing(
                                      g, ir, F, (double)G.Flast[g]), ir);
                }
            }
        }
        G.Flast[g] = (float)F;
    }
}

/* final sweep over all groups at Fstop (build_groups.c:783-869) */
static void plc_final_check(void)
{
    double F = PLC->Fstop;
    for (int32_t g = FILAMENT + 1; g <= G.ngroups; g++) {
        if (!G.alive[g] || !G.good[g] || G.mass[g] < I->min_halo_mass)
            continue;
        for (int ir = 0; ir < PLC->nrepl; ir++) {
            if ((double)G.Flast[g] <= PLC->repl_F2[ir])
                continue;
            double bb = cond_plc(g, F, ir);
            if (bb == 0.0) {
                store_plc(g, F, ir);
            } else if (bb > 0.0) {
                double aa = cond_plc(g, (double)G.Flast[g], ir);
                if (aa < 0.0)
                    store_plc(g, solve_plc_crossing(
                                  g, ir, F, (double)G.Flast[g]), ir);
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* the sweep itself                                                   */
/* ------------------------------------------------------------------ */

int sweep(const sweep_input *in, const capture_buffers *cap,
          const sweep_output *out, const plc_input *plc_in,
          const plc_output *plc_out)
{
    I = in;
    PLC = plc_in;
    PLCOUT = plc_out;
    const int plc_on = (plc_in != NULL && plc_in->enabled);
    int plc_started = 0, plc_last_check_done = 0;
    const int32_t Lx = in->L[0], Ly = in->L[1], Lz = in->L[2];
    const int32_t maxg = in->maxg;

    /* allocate group state */
    memset(&G, 0, sizeof(G));
    G.mass = calloc(maxg, sizeof(int32_t));
    G.q = calloc(maxg * 3, sizeof(float));
    G.gv1 = calloc(maxg * 3, sizeof(float));
    {
        int has2 = (in->v2 != NULL) || in->nseg;
        int has3 = (in->v31 != NULL)
            || (in->nseg && in->lpt_order >= 3);
        G.gv2 = has2 ? calloc(maxg * 3, sizeof(float)) : NULL;
        G.gv31 = has3 ? calloc(maxg * 3, sizeof(float)) : NULL;
        G.gv32 = has3 ? calloc(maxg * 3, sizeof(float)) : NULL;
        if (in->nseg) {
            G.pv1 = calloc(maxg * 3, sizeof(float));
            G.pv2 = has2 ? calloc(maxg * 3, sizeof(float)) : NULL;
            G.pv31 = has3 ? calloc(maxg * 3, sizeof(float)) : NULL;
            G.pv32 = has3 ? calloc(maxg * 3, sizeof(float)) : NULL;
        }
    }
    G.name = calloc(maxg, sizeof(uint64_t));
    G.t_peak = calloc(maxg, sizeof(float));
    G.t_appear = calloc(maxg, sizeof(float));
    G.t_merge = calloc(maxg, sizeof(float));
    G.mass_at_merger = calloc(maxg, sizeof(int32_t));
    G.merged_with = calloc(maxg, sizeof(int32_t));
    G.halo_app = calloc(maxg, sizeof(int32_t));
    G.ll = calloc(maxg, sizeof(int32_t));
    G.good = calloc(maxg, sizeof(uint8_t));
    G.alive = calloc(maxg, sizeof(uint8_t));
    G.parent = calloc(maxg, sizeof(int32_t));
    G.Flast = calloc(maxg, sizeof(float));
    if (!G.mass || !G.q || !G.gv1 || !G.name || !G.parent || !G.Flast)
        return -1;
    for (int32_t g = 0; g < maxg; g++) {
        G.parent[g] = g;
        G.merged_with[g] = -1;
        G.t_appear[g] = G.t_merge[g] = -1.0f;
    }
    G.ngroups = FILAMENT;
    cur_seg = 0;
    memo_F = -1.0;
    mpow_init();

    group_of_particle_arr = out->group_of_particle;
    join_F_arr = calloc(in->n, sizeof(float));
    if (!join_F_arr)
        return -1;

    uint64_t *ctr = out->counters;   /* [16] */
    memset(ctr, 0, 16 * sizeof(uint64_t));

    int iout = 0;
    int32_t neigh[6];
    int64_t fil_idx[6];
    int fil_xyz[6][3];

    for (int64_t this_z = 0; this_z < in->n; this_z++) {
        /* streaming watermark: block until this particle's table row has
         * crossed the link (all later reads are at earlier rows) */
        if (in->rows_ready) {
            const int64_t need = in->rowmap
                ? (int64_t)in->rowmap[this_z] : this_z;
            if (__atomic_load_n(in->rows_ready, __ATOMIC_ACQUIRE)
                    <= need) {
                struct timespec ts = { 0, 200000 };   /* 200 us */
                struct timespec w0, w1;
                clock_gettime(CLOCK_MONOTONIC, &w0);
                do {
                    nanosleep(&ts, NULL);
                } while (__atomic_load_n(in->rows_ready,
                                         __ATOMIC_ACQUIRE) <= need);
                clock_gettime(CLOCK_MONOTONIC, &w1);
                if (in->rows_wait_ns)
                    *in->rows_wait_ns +=
                        (int64_t)(w1.tv_sec - w0.tv_sec) * 1000000000LL
                        + (w1.tv_nsec - w0.tv_nsec);
            }
        }
        /* particles arrive in collapse-time order, i.e. spatially random:
         * the 6-neighbour loc[] lookups are cache misses on a grid far
         * larger than LLC.  Prefetch the next few particles' neighbour
         * cells (their positions are known from pos[]) to overlap the
         * miss latency with this particle's work. */
        if (this_z + PREFETCH_DIST < in->n) {
            const int32_t pp = in->pos[this_z + PREFETCH_DIST];
            const int pz = pp % Lz;
            const int32_t pk = pp / Lz;
            const int py = pk % Ly;
            const int px = pk / Ly;
            const int64_t c0 =
                (int64_t)pz + (int64_t)Lz * (py + (int64_t)Ly * px);
            __builtin_prefetch(&in->loc[c0], 0, 1);
            if (px > 0)
                __builtin_prefetch(&in->loc[c0 - (int64_t)Lz * Ly], 0, 1);
            if (px < Lx - 1)
                __builtin_prefetch(&in->loc[c0 + (int64_t)Lz * Ly], 0, 1);
            if (py > 0)
                __builtin_prefetch(&in->loc[c0 - Lz], 0, 1);
            if (py < Ly - 1)
                __builtin_prefetch(&in->loc[c0 + Lz], 0, 1);
            /* z neighbours share c0's cache line almost always */
        }
        /* stage 2: loc[] for this distance is cached by now — chase it
         * to prefetch the second-level per-particle loads */
        if (this_z + PREFETCH_DIST / 3 < in->n) {
            const int32_t pp = in->pos[this_z + PREFETCH_DIST / 3];
            const int pz = pp % Lz;
            const int32_t pk = pp / Lz;
            const int py = pk % Ly;
            const int px = pk / Ly;
            const int64_t c0 =
                (int64_t)pz + (int64_t)Lz * (py + (int64_t)Ly * px);
            const int64_t cs[4] = {
                px > 0 ? c0 - (int64_t)Lz * Ly : c0,
                px < Lx - 1 ? c0 + (int64_t)Lz * Ly : c0,
                py > 0 ? c0 - Lz : c0,
                py < Ly - 1 ? c0 + Lz : c0 };
            for (int t = 0; t < 4; t++) {
                const int32_t q = in->loc[cs[t]];
                if (q >= 0) {
                    __builtin_prefetch(&group_of_particle_arr[q], 0, 1);
                    __builtin_prefetch(&in->Fmax[q], 0, 1);
                }
            }
        }
        const double F = (double)in->Fmax[this_z];
        const int32_t p = in->pos[this_z];

        /* cell coordinates, z fastest */
        const int iz = p % Lz;
        const int32_t kk = p / Lz;
        const int iy = kk % Ly;
        const int ix = kk / Ly;

        int skip = 0;
        if (!in->pbc[0] && (ix == 0 || ix == Lx - 1)) skip++;
        if (!in->pbc[1] && (iy == 0 || iy == Ly - 1)) skip++;
        if (!in->pbc[2] && (iz == 0 || iz == Lz - 1)) skip++;

        const int gx = (ix + in->stabl[0] + in->G[0]) % in->G[0];
        const int gy = (iy + in->stabl[1] + in->G[1]) % in->G[1];
        const int gz = (iz + in->stabl[2] + in->G[2]) % in->G[2];
        const uint64_t particle_name =
            (uint64_t)gz + (uint64_t)in->G[2] *
            ((uint64_t)gy + (uint64_t)in->G[1] * (uint64_t)gx);

        const int good_particle =
            (ix >= in->safe[0] && ix < Lx - in->safe[0] &&
             iy >= in->safe[1] && iy < Ly - in->safe[1] &&
             iz >= in->safe[2] && iz < Lz - in->safe[2]);

        int peak_cond = 1;
        int neigrp = 0, nf = 0;

        if (!skip) {
            /* 6-neighbor lookup */
            for (int nn = 0; nn < 6; nn++) {
                int x1 = ix, y1 = iy, z1 = iz;
                switch (nn) {
                case 0: x1 = (in->pbc[0] && ix == 0 ? Lx - 1 : ix - 1); break;
                case 1: x1 = (in->pbc[0] && ix == Lx - 1 ? 0 : ix + 1); break;
                case 2: y1 = (in->pbc[1] && iy == 0 ? Ly - 1 : iy - 1); break;
                case 3: y1 = (in->pbc[1] && iy == Ly - 1 ? 0 : iy + 1); break;
                case 4: z1 = (in->pbc[2] && iz == 0 ? Lz - 1 : iz - 1); break;
                case 5: z1 = (in->pbc[2] && iz == Lz - 1 ? 0 : iz + 1); break;
                }
                const int64_t cell =
                    (int64_t)z1 + (int64_t)Lz * (y1 + (int64_t)Ly * x1);
                const int32_t q = in->loc[cell];
                int32_t ng = 0;
                if (q >= 0) {
                    int32_t gid = group_of_particle_arr[q];
                    ng = gid > FILAMENT ? uf_find(gid) : gid;
                    if (!(F > (double)in->Fmax[q]))
                        peak_cond = 0;
                }
                if (ng == FILAMENT) {
                    fil_xyz[nf][0] = x1;
                    fil_xyz[nf][1] = y1;
                    fil_xyz[nf][2] = z1;
                    fil_idx[nf] = q;
                    nf++;
                    ng = 0;
                }
                neigh[nn] = ng;
            }

            /* dedup neighbour groups, compacting to the front */
            for (int a = 0; a < 6; a++) {
                if (neigh[a] <= FILAMENT) continue;
                int dupl = 0;
                for (int b = 0; b < neigrp; b++)
                    if (neigh[b] == neigh[a]) { dupl = 1; break; }
                if (!dupl)
                    neigh[neigrp++] = neigh[a];
            }
            for (int a = neigrp; a < 6; a++)
                neigh[a] = 0;

            if (neigrp > 0 && good_particle)
                ctr[neigrp]++;

            /* past light cone: check neighbour groups for cone crossing
             * since their last update (build_groups.c:356-450) */
            if (plc_on) {
                if (F < PLC->Fstart && F >= PLC->Fstop) {
                    plc_started = 1;
                    plc_check_groups(neigh, neigrp, F);
                } else if (PLC->Fstart > 0.0 && F < PLC->Fstart) {
                    for (int a = 0; a < neigrp; a++)
                        G.Flast[neigh[a]] = (float)F;
                }
            }
        } else {
            peak_cond = 0;
        }

        int accrflag = 0;
        int32_t to_group = -1;

        if (peak_cond) {
            /* ---------------- case: peak -> new group ---------------- */
            if (good_particle) ctr[0]++;
            G.ngroups++;
            if (G.ngroups >= maxg)
                return -2;           /* PredNpeaks overflow */
            const int32_t g = G.ngroups;
            G.t_peak[g] = (float)F;
            G.q[3 * g] = ix + SHIFT;
            G.q[3 * g + 1] = iy + SHIFT;
            G.q[3 * g + 2] = iz + SHIFT;
            {
                const float *a1 = seg_arr(in->seg_v1, in->v1);
                const float *a2 = G.gv2 ? seg_arr(in->seg_v2, in->v2)
                                        : NULL;
                const float *a31 = G.gv31 ? seg_arr(in->seg_v31, in->v31)
                                          : NULL;
                const float *a32 = G.gv32 ? seg_arr(in->seg_v32, in->v32)
                                          : NULL;
                const float *p1 = seg_arr_prev(in->seg_v1);
                const float *p2 = seg_arr_prev(in->seg_v2);
                const float *p31 = seg_arr_prev(in->seg_v31);
                const float *p32 = seg_arr_prev(in->seg_v32);
                const int64_t rz = prow(this_z);
                for (int i = 0; i < 3; i++) {
                    G.gv1[3 * g + i] = a1[3 * rz + i];
                    if (a2) G.gv2[3 * g + i] = a2[3 * rz + i];
                    if (a31) G.gv31[3 * g + i] = a31[3 * rz + i];
                    if (a32) G.gv32[3 * g + i] = a32[3 * rz + i];
                    if (G.pv1)
                        G.pv1[3 * g + i] = p1 ? p1[3 * rz + i] : 0.f;
                    if (G.pv2)
                        G.pv2[3 * g + i] = p2 ? p2[3 * rz + i] : 0.f;
                    if (G.pv31)
                        G.pv31[3 * g + i] = p31 ? p31[3 * rz + i] : 0.f;
                    if (G.pv32)
                        G.pv32[3 * g + i] = p32 ? p32[3 * rz + i] : 0.f;
                }
            }
            G.mass[g] = 1;
            G.name[g] = particle_name;
            G.good[g] = (uint8_t)good_particle;
            G.alive[g] = 1;
            G.ll[g] = g;
            G.halo_app[g] = g;
            group_of_particle_arr[this_z] = g;
            join_F_arr[this_z] = (float)F;
            if (plc_on)
                G.Flast[g] = (float)(F > PLC->Fstart ? PLC->Fstart : F);
            if (I->min_halo_mass == 1)
                G.t_appear[g] = (float)F;
        } else if (neigrp == 1) {
            /* ---------------- case: one group ---------------- */
            double d2, r2;
            cond_accretion(ix, iy, iz, this_z, F, neigh[0], &d2, &r2);
            if (d2 < r2) {
                if (good_particle) ctr[7]++;
                accrflag = 1;
                to_group = neigh[0];
                do_accretion(to_group, ix, iy, iz, this_z, F);
            } else {
                if (good_particle) ctr[12]++;
                G.mass[FILAMENT]++;
                group_of_particle_arr[this_z] = FILAMENT;
            }
        } else if (neigrp > 1) {
            /* ---------------- case: >1 group ---------------- */
            double best_ratio = 1e20;
            int accgrp = -1;
            for (int a = 0; a < neigrp; a++) {
                double d2, r2;
                cond_accretion(ix, iy, iz, this_z, F, neigh[a], &d2, &r2);
                double ratio = d2 / r2;
                if (ratio < 1.0 && ratio < best_ratio) {
                    best_ratio = ratio;
                    accgrp = a;
                }
            }
            if (accgrp >= 0) {
                if (good_particle) { ctr[7]++; ctr[8]++; }
                accrflag = 1;
                to_group = neigh[accgrp];
                do_accretion(to_group, ix, iy, iz, this_z, F);
            }

            /* pairwise merging; larger keeps the id */
            int nmerge = 0;
            char merge[6][6];
            for (int a = 0; a < neigrp; a++)
                for (int b = 0; b < a; b++) {
                    merge[a][b] = (char)cond_merging(F, neigh[a], neigh[b]);
                    nmerge += merge[a][b];
                }
            if (nmerge > 0) {
                for (int a = 0; a < neigrp; a++)
                    for (int b = 0; b < a; b++)
                        if (merge[a][b] && neigh[a] != neigh[b]) {
                            if (good_particle) ctr[10]++;
                            int32_t large, small;
                            if (G.mass[neigh[a]] > G.mass[neigh[b]]) {
                                large = neigh[a]; small = neigh[b];
                            } else {
                                large = neigh[b]; small = neigh[a];
                            }
                            do_merge(large, small, F);
                            /* major merger counted on the post-merge mass
                             * (build_groups.c:669-670) */
                            if (G.mass[large] < 5 * G.mass[small]
                                && good_particle)
                                ctr[11]++;
                            if (to_group == small)
                                to_group = large;
                            for (int c = 0; c < neigrp; c++)
                                if (neigh[c] == small)
                                    neigh[c] = large;
                        }
            }

            if (accgrp == -1) {
                /* dedup again and retry accretion (build_groups.c:676-723) */
                int m = 0;
                for (int a = 0; a < neigrp; a++) {
                    if (neigh[a] <= FILAMENT) continue;
                    int dupl = 0;
                    for (int b = 0; b < m; b++)
                        if (neigh[b] == neigh[a]) { dupl = 1; break; }
                    if (!dupl)
                        neigh[m++] = neigh[a];
                }
                neigrp = m;
                best_ratio = 1e20;
                accgrp = -1;
                for (int a = 0; a < neigrp; a++) {
                    double d2, r2;
                    cond_accretion(ix, iy, iz, this_z, F, neigh[a], &d2, &r2);
                    double ratio = d2 / r2;
                    if (ratio < best_ratio) {
                        best_ratio = ratio;
                        accgrp = a;
                    }
                }
                if (best_ratio < 1.0) {
                    if (good_particle) { ctr[7]++; ctr[9]++; }
                    accrflag = 1;
                    to_group = neigh[accgrp];
                    do_accretion(to_group, ix, iy, iz, this_z, F);
                } else {
                    if (good_particle) ctr[12]++;
                    G.mass[FILAMENT]++;
                    group_of_particle_arr[this_z] = FILAMENT;
                }
            }
        } else {
            /* ---------------- case: filament ---------------- */
            if (good_particle) ctr[12]++;
            G.mass[FILAMENT]++;
            group_of_particle_arr[this_z] = FILAMENT;
        }

        /* filament re-accretion around the accreting halo
         * (build_groups.c:747-781): first test all, then accrete marked */
        if (accrflag && nf && !skip) {
            char take[6];
            for (int f = 0; f < nf; f++) {
                double d2, r2;
                cond_accretion(fil_xyz[f][0], fil_xyz[f][1], fil_xyz[f][2],
                               fil_idx[f], F, to_group, &d2, &r2);
                take[f] = (char)(d2 < r2);
            }
            for (int f = 0; f < nf; f++)
                if (take[f]) {
                    do_accretion(to_group, fil_xyz[f][0], fil_xyz[f][1],
                                 fil_xyz[f][2], fil_idx[f], F);
                    G.mass[FILAMENT]--;
                    if (fil_xyz[f][0] >= in->safe[0] &&
                        fil_xyz[f][0] < Lx - in->safe[0] &&
                        fil_xyz[f][1] >= in->safe[1] &&
                        fil_xyz[f][1] < Ly - in->safe[1] &&
                        fil_xyz[f][2] >= in->safe[2] &&
                        fil_xyz[f][2] < Lz - in->safe[2]) {
                        ctr[7]++;
                        ctr[13]++;
                        ctr[12]--;
                    }
                }
        }

        /* RECOMPUTE_DISPLACEMENTS: advance to the next segment when F
         * drops below its boundary (fragment.c:394-442) and rebuild the
         * group velocity means from the member particles with the new
         * displacement sets (recompute_group_velocities,
         * fragment.c:832-909) */
        while (I->nseg && cur_seg < I->nseg - 1
               && F < I->segF[cur_seg + 1]) {
            cur_seg++;
            memo_F = -1.0;
            const float *a1 = I->seg_v1[cur_seg];
            const float *a2 = I->lpt_order >= 2 ? I->seg_v2[cur_seg]
                                                : NULL;
            const float *a31 = I->lpt_order >= 3 ? I->seg_v31[cur_seg]
                                                 : NULL;
            const float *a32 = I->lpt_order >= 3 ? I->seg_v32[cur_seg]
                                                 : NULL;
            const float *p1 = I->seg_v1[cur_seg - 1];
            const float *p2 = I->lpt_order >= 2 ? I->seg_v2[cur_seg - 1]
                                                : NULL;
            const float *p31 = I->lpt_order >= 3 ? I->seg_v31[cur_seg - 1]
                                                 : NULL;
            const float *p32 = I->lpt_order >= 3 ? I->seg_v32[cur_seg - 1]
                                                 : NULL;
            memset(G.gv1, 0, (size_t)maxg * 3 * sizeof(float));
            if (G.gv2) memset(G.gv2, 0, (size_t)maxg * 3 * sizeof(float));
            if (G.gv31) memset(G.gv31, 0, (size_t)maxg * 3 * sizeof(float));
            if (G.gv32) memset(G.gv32, 0, (size_t)maxg * 3 * sizeof(float));
            memset(G.pv1, 0, (size_t)maxg * 3 * sizeof(float));
            if (G.pv2) memset(G.pv2, 0, (size_t)maxg * 3 * sizeof(float));
            if (G.pv31) memset(G.pv31, 0, (size_t)maxg * 3 * sizeof(float));
            if (G.pv32) memset(G.pv32, 0, (size_t)maxg * 3 * sizeof(float));
            /* accumulate sums per root group */
            for (int64_t jz = 0; jz < this_z; jz++) {
                int32_t g = group_of_particle_arr[jz];
                if (g <= FILAMENT)
                    continue;
                g = uf_find(g);
                const int64_t rj = prow(jz);
                for (int i = 0; i < 3; i++) {
                    G.gv1[3 * g + i] += a1[3 * rj + i];
                    if (a2) G.gv2[3 * g + i] += a2[3 * rj + i];
                    if (a31) G.gv31[3 * g + i] += a31[3 * rj + i];
                    if (a32) G.gv32[3 * g + i] += a32[3 * rj + i];
                    G.pv1[3 * g + i] += p1[3 * rj + i];
                    if (p2) G.pv2[3 * g + i] += p2[3 * rj + i];
                    if (p31) G.pv31[3 * g + i] += p31[3 * rj + i];
                    if (p32) G.pv32[3 * g + i] += p32[3 * rj + i];
                }
            }
            for (int32_t g = FILAMENT + 1; g <= G.ngroups; g++) {
                if (!G.alive[g] || G.mass[g] == 0)
                    continue;
                float inv = 1.0f / (float)G.mass[g];
                for (int i = 0; i < 3; i++) {
                    G.gv1[3 * g + i] *= inv;
                    if (G.gv2) G.gv2[3 * g + i] *= inv;
                    if (G.gv31) G.gv31[3 * g + i] *= inv;
                    if (G.gv32) G.gv32[3 * g + i] *= inv;
                    G.pv1[3 * g + i] *= inv;
                    if (G.pv2) G.pv2[3 * g + i] *= inv;
                    if (G.pv31) G.pv31[3 * g + i] *= inv;
                    if (G.pv32) G.pv32[3 * g + i] *= inv;
                }
            }
        }

        /* PLC: final sweep on all halos once the cycle passes Fstop
         * (build_groups.c:783-869) */
        if (plc_on && PLC->Fstart > 0.0 && !plc_last_check_done &&
            (this_z == in->n - 1 || F < PLC->Fstop)) {
            plc_last_check_done = 1;
            plc_final_check();
        }

        /* output captures (build_groups.c:888-920) */
        while (iout < in->nout &&
               (this_z == in->n - 1 || F < in->outF[iout])) {
            capture_catalog(iout, cap);
            iout++;
        }
    }

    /* flush any output never reached (no particle below its F) */
    while (iout < in->nout) {
        capture_catalog(iout, cap);
        iout++;
    }

    /* good-halo counter */
    for (int32_t g = FILAMENT + 1; g <= G.ngroups; g++)
        if (G.alive[g] && G.good[g])
            ctr[14]++;

    /* accretion redshifts (SNAPSHOT zacc): instead of walking particle
     * lists at threshold crossings (merge_groups/accretion,
     * build_groups.c:1121-1149,1256-1266), reconstruct zacc from the merge
     * chain: a particle that joined group g0 at F_join got its zacc at the
     * first threshold crossing of its containing group after joining */
    if (out->zacc) {
        for (int64_t ip = 0; ip < in->n; ip++) {
            int32_t g = group_of_particle_arr[ip];
            float zacc = -1.0f;
            if (g > FILAMENT) {
                float F_enter = join_F_arr[ip];
                while (1) {
                    float crossed = G.t_appear[g];
                    if (crossed != -1.0f) {
                        zacc = (crossed < F_enter ? crossed : F_enter)
                               - 1.0f;
                        break;
                    }
                    if (G.merged_with[g] <= FILAMENT)
                        break;
                    F_enter = G.t_merge[g];
                    g = G.merged_with[g];
                }
            }
            out->zacc[ip] = zacc;
        }
    }

    /* resolve particle labels to the final (root) group id, matching the
     * reference's group_ID relabeling at merge time */
    for (int64_t ip = 0; ip < in->n; ip++) {
        int32_t g = group_of_particle_arr[ip];
        if (g > FILAMENT)
            group_of_particle_arr[ip] = uf_find(g);
    }
    free(join_F_arr);

    /* export final group state */
    int32_t ng = G.ngroups;
    *out->ngroups = ng;
    memcpy(out->mass, G.mass, (ng + 1) * sizeof(int32_t));
    memcpy(out->name, G.name, (ng + 1) * sizeof(uint64_t));
    memcpy(out->halo_app, G.halo_app, (ng + 1) * sizeof(int32_t));
    memcpy(out->ll, G.ll, (ng + 1) * sizeof(int32_t));
    memcpy(out->merged_with, G.merged_with, (ng + 1) * sizeof(int32_t));
    memcpy(out->mass_at_merger, G.mass_at_merger, (ng + 1) * sizeof(int32_t));
    memcpy(out->t_appear, G.t_appear, (ng + 1) * sizeof(float));
    memcpy(out->t_peak, G.t_peak, (ng + 1) * sizeof(float));
    memcpy(out->t_merge, G.t_merge, (ng + 1) * sizeof(float));
    memcpy(out->good, G.good, (ng + 1) * sizeof(uint8_t));
    memcpy(out->alive, G.alive, (ng + 1) * sizeof(uint8_t));
    if (out->gq)
        memcpy(out->gq, G.q, (ng + 1) * 3 * sizeof(float));

    (void)plc_started;
    free(mpow_rlag); free(mpow_espo);
    mpow_rlag = mpow_espo = NULL;
    free(G.Flast);
    free(G.mass); free(G.q); free(G.gv1);
    free(G.gv2); free(G.gv31); free(G.gv32);
    free(G.pv1); free(G.pv2); free(G.pv31); free(G.pv32);
    free(G.name); free(G.t_peak); free(G.t_appear); free(G.t_merge);
    free(G.mass_at_merger); free(G.merged_with);
    free(G.halo_app); free(G.ll); free(G.good); free(G.alive);
    free(G.parent);
    return 0;
}

/* ------------------------------------------------------------------ */
/* two-turn needed-particle scheme: boundary-sphere map update         */
/* (update_map, build_groups.c:2246-2318).  After the quick sweep,     */
/* each group requests a sphere of radius blf * R_Lagrangian(mass)     */
/* around its Lagrangian CM; cells outside the already-mapped          */
/* resolved+rim box [r1, r2) are added to add_map.  counts[0] = cells  */
/* added, counts[1] = requested cells beyond the boundary layer (the   */
/* reference's 'some halos may be inaccurate' warning).                */
/* ------------------------------------------------------------------ */

int map_update(int32_t ngroups, const int32_t *mass, const float *gq,
               const int32_t *L, const int32_t *pbc,
               const int32_t *r1, const int32_t *r2,
               uint8_t *add_map, double blf, int64_t *counts)
{
    const int32_t Lx = L[0], Ly = L[1], Lz = L[2];
    counts[0] = counts[1] = 0;
    for (int32_t g = FILAMENT + 1; g <= ngroups; g++) {
        if (mass[g] <= 0)
            continue;
        const int ig = (int)gq[3 * g];
        const int jg = (int)gq[3 * g + 1];
        const int kg = (int)gq[3 * g + 2];
        const int size = (int)(blf * cbrt((double)mass[g]
                                          / 4.188790205) + 0.5);
        if (size <= 0)
            continue;
        /* fast path: the whole request cube lies inside the resolved+rim
         * box already shipped in turn 0 (the reference instead tests the
         * map bit per cell) */
        if ((pbc[0] || (ig - size >= r1[0] && ig + size < r2[0])) &&
            (pbc[1] || (jg - size >= r1[1] && jg + size < r2[1])) &&
            (pbc[2] || (kg - size >= r1[2] && kg + size < r2[2])))
            continue;
        const int size2 = size * size;
        for (int i1 = ig - size; i1 < ig + size; i1++) {
            int i = i1;
            if (i1 < 0 || i1 >= Lx)
                i = pbc[0] ? (i1 < 0 ? i1 + Lx : i1 - Lx) : -1;
            for (int j1 = jg - size; j1 < jg + size; j1++) {
                int j = j1;
                if (j1 < 0 || j1 >= Ly)
                    j = pbc[1] ? (j1 < 0 ? j1 + Ly : j1 - Ly) : -1;
                for (int k1 = kg - size; k1 < kg + size; k1++) {
                    int k = k1;
                    if (k1 < 0 || k1 >= Lz)
                        k = pbc[2] ? (k1 < 0 ? k1 + Lz : k1 - Lz) : -1;
                    if (i < 0 || j < 0 || k < 0) {
                        counts[1]++;
                        continue;
                    }
                    /* skip cells inside the turn-0 map */
                    if ((pbc[0] || (i >= r1[0] && i < r2[0])) &&
                        (pbc[1] || (j >= r1[1] && j < r2[1])) &&
                        (pbc[2] || (k >= r1[2] && k < r2[2])))
                        continue;
                    const int rr = (i1 - ig) * (i1 - ig)
                        + (j1 - jg) * (j1 - jg) + (k1 - kg) * (k1 - kg);
                    if (rr <= size2) {
                        const int64_t cell =
                            (int64_t)k + (int64_t)Lz * (j + (int64_t)Ly * i);
                        if (!add_map[cell]) {
                            add_map[cell] = 1;
                            counts[0]++;
                        }
                    }
                }
            }
        }
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Sub-box loading helpers: the numpy implementations of the member-  */
/* ship test and row gathers were allocation-bound at 512^3 (each     */
/* int64 vector op materializes a ~0.8 GB temporary; 135 s for what   */
/* is one streaming pass).  One C pass runs at memory speed.          */
/* (distribute.c's belongs_to / local-index math, distribute.c:280-   */
/* 367, fused with the V5 needed-particle selection.)                 */

/* select the sparse-product rows inside the wrapped sub-box volume;
 * rows[] gets the row index, lin[] the local linear cell (z fastest).
 * Returns the count. */
int64_t subbox_select(const int64_t *ci, int64_t n, int32_t N,
                      const int32_t *L, const int32_t *stabl,
                      const int32_t *G,
                      int32_t *rows, int32_t *lin)
{
    const int64_t NN = (int64_t)N * N;
    const int32_t L0 = L[0], L1 = L[1], L2 = L[2];
    const int32_t G0 = G[0], G1 = G[1], G2 = G[2];
    /* normalized non-negative offsets so one conditional subtract
     * replaces the modulo */
    const int32_t o0 = ((stabl[0] % G0) + G0) % G0;
    const int32_t o1 = ((stabl[1] % G1) + G1) % G1;
    const int32_t o2 = ((stabl[2] % G2) + G2) % G2;
    int64_t m = 0;
    for (int64_t i = 0; i < n; i++) {
        const int64_t c = ci[i];
        int32_t z = (int32_t)(c % N);
        int32_t y = (int32_t)((c / N) % N);
        int32_t x = (int32_t)(c / NN);
        x -= o0; if (x < 0) x += G0;
        y -= o1; if (y < 0) y += G1;
        z -= o2; if (z < 0) z += G2;
        if (x < L0 && y < L1 && z < L2) {
            rows[m] = (int32_t)i;
            lin[m] = ((int64_t)x * L1 + y) * L2 + z;
            m++;
        }
    }
    return m;
}

/* dst[i,:] = src[rows[i],:] for [*,3] float32 row tables */
void gather_rows3(const float *src, const int32_t *rows, int64_t m,
                  float *dst)
{
    for (int64_t i = 0; i < m; i++) {
        const float *s = src + 3 * (int64_t)rows[i];
        float *d = dst + 3 * i;
        d[0] = s[0]; d[1] = s[1]; d[2] = s[2];
    }
}

/* gather float32 / int64 vectors by row index */
void gather_f32(const float *src, const int32_t *rows, int64_t m,
                float *dst)
{
    for (int64_t i = 0; i < m; i++)
        dst[i] = src[rows[i]];
}

void gather_i64(const int64_t *src, const int32_t *rows, int64_t m,
                int64_t *dst)
{
    for (int64_t i = 0; i < m; i++)
        dst[i] = src[rows[i]];
}

/* loc[lin[i]] = i over a pre-filled(-1) grid */
void fill_loc(const int32_t *lin, int64_t m, int32_t *loc)
{
    for (int64_t i = 0; i < m; i++)
        loc[lin[i]] = (int32_t)i;
}
