/* Native ascii formatters + merger-tree walk for the output writers.
 *
 * The reference writes catalogs with per-row fprintf from C
 * (write_catalog / write_PLC / write_histories, write_halos.c:227-991);
 * formatting half a million rows per redshift through the Python '%'
 * operator dominated I/O time, so the row loops live here.  Layouts match
 * io/catalogs.py and plc.py byte for byte.
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

/* append catalog rows (write_catalog ascii layout, write_halos.c:283-318) */
int catalog_rows(const char *path, int64_t n, const uint64_t *name,
                 const float *M, const float *q, const float *x,
                 const float *v, const int32_t *npart)
{
    FILE *fd = fopen(path, "a");
    if (!fd)
        return -1;
    for (int64_t i = 0; i < n; i++)
        fprintf(fd, " %12llu %13.6e %10.2f %10.2f %10.2f %10.2f %10.2f "
                "%10.2f %10.2f %10.2f %10.2f %12d\n",
                (unsigned long long)name[i], M[i],
                q[3 * i], q[3 * i + 1], q[3 * i + 2],
                x[3 * i], x[3 * i + 1], x[3 * i + 2],
                v[3 * i], v[3 * i + 1], v[3 * i + 2], npart[i]);
    fclose(fd);
    return 0;
}

/* glibc's %f/%e conversions cost ~1 us per field, which dominates
 * million-row light-cone catalogs; these scaled-integer formatters are
 * ~20x faster and agree with printf except for values whose binary
 * expansion lands exactly on a decimal rounding tie (never produced by
 * measured float data at 6 decimals). */

static inline char *fmt_u64(char *p, uint64_t v, int width)
{
    char tmp[24];
    int k = 0;
    do {
        tmp[k++] = '0' + (int)(v % 10u);
        v /= 10u;
    } while (v);
    for (int pad = width - k; pad > 0; pad--)
        *p++ = ' ';
    while (k)
        *p++ = tmp[--k];
    return p;
}

/* " %*.*f" with a leading space, width w, prec d */
static inline char *fmt_fixed(char *p, double v, int w, int d)
{
    static const double pow10[] = {1, 10, 100, 1000, 10000, 100000,
                                   1000000, 10000000, 100000000};
    if (v != v || v * pow10[d] > 9.0e18 || v * pow10[d] < -9.0e18) {
        return p + sprintf(p, " %*.*f", w, d, v);    /* NaN/overflow */
    }
    int neg = signbit(v) != 0;
    int64_t s = (int64_t)(v * pow10[d] + (neg ? -0.5 : 0.5));
    if (neg)
        s = -s;
    char tmp[32];
    int k = 0;
    for (int i = 0; i < d; i++) {
        tmp[k++] = '0' + (int)(s % 10);
        s /= 10;
    }
    tmp[k++] = '.';
    do {
        tmp[k++] = '0' + (int)(s % 10);
        s /= 10;
    } while (s);
    if (neg)
        tmp[k++] = '-';
    *p++ = ' ';
    for (int pad = w - k; pad > 0; pad--)
        *p++ = ' ';
    while (k)
        *p++ = tmp[--k];
    return p;
}

/* " %15.8e" */
static inline char *fmt_exp8(char *p, double v)
{
    if (v != v || (v != 0.0 && (v > 1e300 || v < -1e300)))
        return p + sprintf(p, " %15.8e", v);
    int neg = v < 0.0;
    double a = neg ? -v : v;
    int e = 0;
    if (a > 0.0) {
        while (a >= 10.0) { a *= 0.1; e++; }
        while (a < 1.0)  { a *= 10.0; e--; }
    }
    int64_t m = (int64_t)(a * 100000000.0 + 0.5);
    if (m >= 1000000000LL) { m /= 10; e++; }
    char buf[24];
    char *q = buf;
    *q++ = ' ';
    *q++ = neg ? '-' : ' ';
    /* m has 9 digits: d.dddddddd */
    char dig[12];
    for (int i = 0; i < 9; i++) { dig[i] = '0' + (int)(m % 10); m /= 10; }
    *q++ = dig[8];
    *q++ = '.';
    for (int i = 7; i >= 0; i--)
        *q++ = dig[i];
    *q++ = 'e';
    *q++ = e < 0 ? '-' : '+';
    int ea = e < 0 ? -e : e;
    if (ea >= 100) {
        *q++ = '0' + ea / 100;
        ea %= 100;
    }
    *q++ = '0' + ea / 10;
    *q++ = '0' + ea % 10;
    int len = (int)(q - buf);
    /* right-align in width 16 (leading space + 15) */
    for (int pad = 16 - len; pad > 0; pad--)
        *p++ = ' ';
    memcpy(p, buf, len);
    return p + len;
}

#include <pthread.h>
#include <stdlib.h>
#include <unistd.h>

#define PLC_ROW_CAP 260

static char *plc_format_row(char *p, uint64_t name, const double *c)
{
    *p++ = ' ';
    p = fmt_u64(p, name, 12);
    for (int j = 0; j < 7; j++)
        p = fmt_fixed(p, c[j], 16, 6);
    p = fmt_exp8(p, c[7]);
    for (int j = 8; j < 12; j++)
        p = fmt_fixed(p, c[j], 16, 6);
    *p++ = '\n';
    return p;
}

struct plc_job {
    const uint64_t *name;
    const double *cols;
    int64_t lo, hi;
    char *buf;
    size_t len;
};

static void *plc_worker(void *arg)
{
    struct plc_job *j = (struct plc_job *)arg;
    char *p = j->buf;
    for (int64_t i = j->lo; i < j->hi; i++)
        p = plc_format_row(p, j->name[i], j->cols + 12 * i);
    j->len = (size_t)(p - j->buf);
    return NULL;
}

/* append PLC rows; cols is [n,12] float64 in output order
 * (write_PLC ascii layout, write_halos.c:575-620).  Rows are formatted by
 * all cores in chunks, then streamed out in order. */
int plc_rows(const char *path, int64_t n, const uint64_t *name,
             const double *cols)
{
    FILE *fd = fopen(path, "a");
    if (!fd)
        return -1;
    long nth = sysconf(_SC_NPROCESSORS_ONLN);
    if (nth < 1)
        nth = 1;
    if (nth > 16)
        nth = 16;
    const int64_t chunk = 65536;
    struct plc_job *jobs = malloc((size_t)nth * sizeof *jobs);
    pthread_t *tids = malloc((size_t)nth * sizeof *tids);
    for (long t = 0; t < nth; t++)
        jobs[t].buf = malloc((size_t)chunk * PLC_ROW_CAP);
    for (int64_t base = 0; base < n; base += nth * chunk) {
        long used = 0;
        for (long t = 0; t < nth; t++) {
            int64_t lo = base + t * chunk;
            if (lo >= n)
                break;
            int64_t hi = lo + chunk < n ? lo + chunk : n;
            jobs[t].name = name;
            jobs[t].cols = cols;
            jobs[t].lo = lo;
            jobs[t].hi = hi;
            used++;
        }
        for (long t = 1; t < used; t++)
            pthread_create(&tids[t], NULL, plc_worker, &jobs[t]);
        if (used > 0)
            plc_worker(&jobs[0]);
        for (long t = 1; t < used; t++)
            pthread_join(tids[t], NULL);
        for (long t = 0; t < used; t++)
            fwrite(jobs[t].buf, 1, jobs[t].len, fd);
    }
    for (long t = 0; t < nth; t++)
        free(jobs[t].buf);
    free(jobs);
    free(tids);
    fclose(fd);
    return 0;
}

/* merger-tree walk (write_histories, write_halos.c:897-966): trees start
 * at each good main halo (halo_app == self) and follow the circular ll
 * list; nicknames are per-tree indices with the main halo labelled by the
 * branch count.  Fills flat branch arrays + per-tree lengths; returns the
 * number of trees, total branches via *nbranch_out.  Buffers must hold
 * ng entries.  FILAMENT groups (id <= 1) are never tree members. */
int64_t histories_build(int64_t ng, int32_t min_mass,
                        const int32_t *mass, const uint64_t *name,
                        const int32_t *halo_app, const int32_t *ll,
                        const int32_t *merged_with,
                        const int32_t *mass_at_merger,
                        const float *t_appear, const float *t_peak,
                        const float *t_merge, const uint8_t *good,
                        /* outputs: */
                        uint64_t *o_name, int32_t *o_nick, int32_t *o_ll,
                        int32_t *o_mw, int32_t *o_mass, int32_t *o_mam,
                        float *o_zme, float *o_zpe, float *o_zap,
                        int32_t *treelen, int32_t *trackC,
                        int64_t *nbranch_out)
{
    int64_t ntrees = 0, nb_tot = 0;
    for (int64_t i = 2; i <= ng; i++) {
        if (halo_app[i] != i || !good[i] || mass[i] < min_mass)
            continue;
        /* count branches */
        int32_t nb = 0;
        int64_t nxt = i;
        do {
            nb++;
            nxt = ll[nxt];
        } while (nxt != i);
        /* fill */
        int64_t base = nb_tot;
        int32_t ib = 0;
        nxt = i;
        do {
            int32_t nick = ib ? ib : nb;
            trackC[nxt] = nick;
            o_name[base + ib] = name[nxt];
            o_nick[base + ib] = nick;
            o_ll[base + ib] = ib + 1;
            o_mass[base + ib] = mass[nxt];
            o_mam[base + ib] = mass_at_merger[nxt];
            o_zme[base + ib] = t_merge[nxt] > 0.f ? t_merge[nxt] - 1.f
                                                  : t_merge[nxt];
            o_zpe[base + ib] = t_peak[nxt] > 0.f ? t_peak[nxt] - 1.f
                                                 : t_peak[nxt];
            o_zap[base + ib] = t_appear[nxt] > 0.f ? t_appear[nxt] - 1.f
                                                   : t_appear[nxt];
            ib++;
            nxt = ll[nxt];
        } while (nxt != i);
        /* second pass: remap merged_with to in-tree nicknames */
        ib = 0;
        nxt = i;
        do {
            int32_t mw = merged_with[nxt];
            o_mw[base + ib] = (mw > 1) ? trackC[mw] : -1;
            ib++;
            nxt = ll[nxt];
        } while (nxt != i);
        treelen[ntrees++] = nb;
        nb_tot += nb;
    }
    *nbranch_out = nb_tot;
    return ntrees;
}

/* append history rows grouped per tree (ascii layout) */
int histories_rows(const char *path, int64_t ntrees, const int32_t *treelen,
                   const uint64_t *name, const int32_t *nick,
                   const int32_t *ll, const int32_t *mw,
                   const int32_t *mass, const int32_t *mam,
                   const float *zme, const float *zpe, const float *zap)
{
    FILE *fd = fopen(path, "a");
    if (!fd)
        return -1;
    int64_t base = 0;
    for (int64_t t = 0; t < ntrees; t++) {
        fprintf(fd, "#Tree %lld, Nbranches=%d\n", (long long)t, treelen[t]);
        for (int32_t ib = 0; ib < treelen[t]; ib++) {
            int64_t i = base + ib;
            fprintf(fd, " %12llu %6d %6d %6d %9d %9d %9.4f %9.4f %9.4f\n",
                    (unsigned long long)name[i], nick[i], ll[i], mw[i],
                    mass[i], mam[i], zme[i], zpe[i], zap[i]);
        }
        base += treelen[t];
    }
    fclose(fd);
    return 0;
}
