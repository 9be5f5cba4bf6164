/* Host-side grid utilities of the port's planners: the max per-cell
 * count of a binning (capacity planning) and the exact band audit of
 * the h-tier frames (propagator/ve_tiered.audit_tiers). From the JAX
 * package's csrc/hostgrid.c (reference: the host-side cstone
 * helpers, domain/include/cstone/domain/domaindecomp.hpp,
 * findneighbors.hpp:96).
 *
 * Built with cc at first use into build/sphexa_tpu_torch/ and bound
 * through ctypes (sphexa_tpu_torch/util/native.py). A failed build
 * raises there: the port has no silent numpy fallback on its main path.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline int64_t clampi(int64_t v, int64_t lo, int64_t hi)
{
    return v < lo ? lo : (v > hi ? hi : v);
}

/* Max per-cell particle count when binning positions into an
 * (nx, ny, nz) grid over the box (cellmajor.max_cell_count), on the
 * coordinates mapped to the unit cube, u = (x - xmin) / lx (and v, w),
 * in double by the caller: the bins are those of the JAX package's
 * hg_max_cell_count, (int64_t)((x - xmin) / lx * nx), and a scan over
 * many resolutions maps the coordinates once. Returns -1 on allocation
 * failure. */
int64_t hg_max_cell_count_unit(const double* u, const double* v,
                               const double* w, int64_t n,
                               int64_t nx, int64_t ny, int64_t nz)
{
    int64_t ncell = nx * ny * nz;
    int32_t* cnt = (int32_t*)calloc((size_t)ncell, sizeof(int32_t));
    if (!cnt) return -1;
    for (int64_t i = 0; i < n; i++) {
        int64_t ix = clampi((int64_t)(u[i] * (double)nx), 0, nx - 1);
        int64_t iy = clampi((int64_t)(v[i] * (double)ny), 0, ny - 1);
        int64_t iz = clampi((int64_t)(w[i] * (double)nz), 0, nz - 1);
        cnt[(ix * ny + iy) * nz + iz]++;
    }
    int64_t mx = 0;
    for (int64_t c = 0; c < ncell; c++)
        if (cnt[c] > mx) mx = cnt[c];
    free(cnt);
    return mx;
}

/* Exact band audit (ve_tiered.audit_tiers inner loop): count excluded
 * particles j that lie inside the 2*h support of any in-tier particle
 * i. The i set is bucketed on an (nx, ny, nz) grid whose cell edge is
 * >= max(2 h_i), so only the 27-neighborhood needs scanning.
 * per[0..2]: periodic flags. Returns -1 on allocation failure. */
int64_t hg_band_audit(const double* xi, const double* yi, const double* zi,
                      const double* hi, int64_t ni,
                      const double* xj, const double* yj, const double* zj,
                      int64_t nj,
                      double xmin, double ymin, double zmin,
                      double lx, double ly, double lz,
                      int32_t perx, int32_t pery, int32_t perz,
                      int64_t nx, int64_t ny, int64_t nz)
{
    int64_t ncell = nx * ny * nz;
    int32_t* cnt = (int32_t*)calloc((size_t)ncell + 1, sizeof(int32_t));
    int32_t* start = (int32_t*)calloc((size_t)ncell + 1, sizeof(int32_t));
    int32_t* order = (int32_t*)malloc((size_t)ni * sizeof(int32_t));
    if (!cnt || !start || !order) {
        free(cnt); free(start); free(order);
        return -1;
    }

#define CELLID(px, py, pz, ox, oy, oz)                                      \
    ((clampi((int64_t)(((px) - xmin) / lx * (double)nx), 0, nx - 1) + (ox)) * \
         ny * nz +                                                          \
     (clampi((int64_t)(((py) - ymin) / ly * (double)ny), 0, ny - 1) + (oy)) * \
         nz +                                                               \
     (clampi((int64_t)(((pz) - zmin) / lz * (double)nz), 0, nz - 1) + (oz)))

    for (int64_t i = 0; i < ni; i++)
        cnt[CELLID(xi[i], yi[i], zi[i], 0, 0, 0)]++;
    int64_t acc = 0;
    for (int64_t c = 0; c <= ncell; c++) {
        start[c] = (int32_t)acc;
        if (c < ncell) acc += cnt[c];
    }
    int32_t* fill = (int32_t*)calloc((size_t)ncell, sizeof(int32_t));
    if (!fill) { free(cnt); free(start); free(order); return -1; }
    for (int64_t i = 0; i < ni; i++) {
        int64_t c = CELLID(xi[i], yi[i], zi[i], 0, 0, 0);
        order[start[c] + fill[c]] = (int32_t)i;
        fill[c]++;
    }

    int64_t violations = 0;
    for (int64_t j = 0; j < nj; j++) {
        int64_t cx = clampi((int64_t)((xj[j] - xmin) / lx * (double)nx), 0, nx - 1);
        int64_t cy = clampi((int64_t)((yj[j] - ymin) / ly * (double)ny), 0, ny - 1);
        int64_t cz = clampi((int64_t)((zj[j] - zmin) / lz * (double)nz), 0, nz - 1);
        int hit = 0;
        for (int64_t dx = -1; dx <= 1 && !hit; dx++)
            for (int64_t dy = -1; dy <= 1 && !hit; dy++)
                for (int64_t dz = -1; dz <= 1 && !hit; dz++) {
                    int64_t qx = cx + dx, qy = cy + dy, qz = cz + dz;
                    if (perx) qx = (qx + nx) % nx;
                    if (pery) qy = (qy + ny) % ny;
                    if (perz) qz = (qz + nz) % nz;
                    if (qx < 0 || qx >= nx || qy < 0 || qy >= ny ||
                        qz < 0 || qz >= nz)
                        continue;
                    int64_t c = (qx * ny + qy) * nz + qz;
                    for (int32_t k = start[c]; k < start[c + 1]; k++) {
                        int32_t i = order[k];
                        double ddx = xj[j] - xi[i];
                        double ddy = yj[j] - yi[i];
                        double ddz = zj[j] - zi[i];
                        if (perx) ddx -= round(ddx / lx) * lx;
                        if (pery) ddy -= round(ddy / ly) * ly;
                        if (perz) ddz -= round(ddz / lz) * lz;
                        double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                        double r = 2.0 * hi[i];
                        if (d2 < r * r) { hit = 1; break; }
                    }
                }
        violations += hit;
    }
#undef CELLID
    free(cnt);
    free(start);
    free(order);
    free(fill);
    return violations;
}
