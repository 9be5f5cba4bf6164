// K1 and K1z: ghost refresh of a cell-major row stack, in place.
//
// Replaces make_ghost_refresh (sphexa_tpu/ops/pallas_ve.py:349, call
// :435). The stack is [nrows, n_slots] float32, n_slots = padded cells *
// cap, padded cell id = (cx * npd + cy) * npz + cz.
//
// K1 (refresh_z=True): every ghost cell (a cell of a ghost column, or a
// z-ghost cell of an interior column) is re-derived from its source: the
// column wrapped to the opposite interior column (srcmap, pallas_ve.py:
// 385-390), the z cell wrapped to the opposite interior cell (:397-401).
// With coordinate rows (ix >= 0), periodic axes add +-L to the
// coordinate row, and ghosts across an open axis become FILL_POS in the
// coordinate rows and 0 elsewhere. Sources are always interior slots,
// which this kernel never writes, so the in-place update has no
// read/write race.
//
// K1z (refresh_z=False; the slab-sharded engines): the table lists only
// the cells of the x-y ghost columns, every z of them. Each copies the
// wrapped column at the same z: the z index is not wrapped (out = v,
// pallas_ve.py:403), so a ghost column's z-ghost lanes take the source
// column's z-ghost lanes, which the z-plane exchange has just filled;
// that is how the corner images compose. No z shift (:419), and the z
// planes never count as open (:430). K1z writes only ghost columns and
// reads only interior columns (at any z), so the in-place update is
// again free of races.
//
// Both forms read one host-built table (GhostRefresh, ops/pair_ve.py:
// _ghost_maps) of one int4 a ghost cell: {destination cell, source
// cell, code, 0}, code = (sx+1) | (sy+1) << 2 | (sz+1) << 4 | open << 6
// with s the cell's side (-1, 0, +1) on each periodic axis whose shift
// applies (0 elsewhere) and open set where a ghost crosses an open
// axis. So the kernel does no division to decode a cell, and K1 and K1z
// differ only in their tables.
//
// Bound: a memory pass. Each ghost value is read once and written once:
// 2 * 4 bytes * nrows * ghost slots over the card's 3.35 TB/s.
// Design: one flat grid over (ghost cell, group of slots), 256 threads a
// block. A thread reads its cell's table entry once, then moves one
// float4 (4 consecutive slots) of every row, four rows in flight. The
// float4 form needs 16-byte aligned rows: cap % 4 == 0 and a 16-byte
// aligned base (n_slots is a multiple of cap). Other stacks take the
// scalar form, a float a thread, chosen by the wrapper from the shape
// and the pointer.

#include <cuda_runtime.h>

// the fixed arguments of one table (ops/_cuda.py GhostArgs)
struct GhostArgs {
    const int4* table;   // [n_ghost] {dst cell, src cell, code, 0}
    int n_ghost, cap;
    float lx, ly, lz;
    int periodic;        // bit k: box axis k is periodic
    float fill_pos;
};

namespace {

constexpr int THREADS = 256;

template <int W>
struct Vec;
template <>
struct Vec<4> {
    using T = float4;
    __device__ static T add(T v, float s)
    {
        return make_float4(v.x + s, v.y + s, v.z + s, v.w + s);
    }
    __device__ static T fill(float s) { return make_float4(s, s, s, s); }
};
template <>
struct Vec<1> {
    using T = float;
    __device__ static T add(T v, float s) { return v + s; }
    __device__ static T fill(float s) { return s; }
};

template <int W>
__global__ void __launch_bounds__(THREADS)
ghost_refresh_kernel(float* __restrict__ J, int nrows, long long n_slots,
                     GhostArgs a, int ix, int iy, int iz)
{
    using V = Vec<W>;
    using T = typename V::T;
    const int groups = a.cap / W;
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (t >= (long long)a.n_ghost * groups) return;
    const int c = (int)(t / groups);
    const int grp = (int)(t - (long long)c * groups);
    const int4 e = a.table[c];
    const long long dst = (long long)e.x * a.cap + grp * W;
    const long long src = (long long)e.y * a.cap + grp * W;
    const bool open = ix >= 0 && (e.z & 64);
    // +-L on a periodic axis' coordinate row; rows that are no periodic
    // coordinate row add nothing (as the plain version)
    auto shift = [&](int k, float L) {
        const int s = ((e.z >> (2 * k)) & 3) - 1;
        return s < 0 ? -L : (s > 0 ? L : 0.0f);
    };
    const float sx = shift(0, a.lx), sy = shift(1, a.ly), sz = shift(2, a.lz);
    const bool px = a.periodic & 1, py = a.periodic & 2, pz = a.periodic & 4;
#pragma unroll 4
    for (int r = 0; r < nrows; ++r) {
        float* row = J + (long long)r * n_slots;
        const bool rx = r == ix, ry = r == iy, rz = r == iz;
        T v;
        if (open) {
            v = V::fill(rx || ry || rz ? a.fill_pos : 0.0f);
        } else {
            v = *reinterpret_cast<const T*>(row + src);
            if (rx && px) v = V::add(v, sx);
            else if (ry && py) v = V::add(v, sy);
            else if (rz && pz) v = V::add(v, sz);
        }
        *reinterpret_cast<T*>(row + dst) = v;
    }
}

}  // namespace

// vec != 0: the float4 form (the caller has checked cap % 4 == 0 and a
// 16-byte aligned J); ix, iy, iz: the coordinate rows, or -1 for none
extern "C" int ghost_refresh(float* J, int nrows, long long n_slots, int ix,
                             int iy, int iz, int vec, const GhostArgs* a,
                             void* stream)
{
    if (vec && (a->cap % 4 || reinterpret_cast<size_t>(J) % 16))
        return (int)cudaErrorInvalidValue;
    const long long work = (long long)a->n_ghost * (vec ? a->cap / 4 : a->cap);
    if (work > 0 && nrows > 0) {
        const unsigned blocks = (unsigned)((work + THREADS - 1) / THREADS);
        if (vec)
            ghost_refresh_kernel<4><<<blocks, THREADS, 0,
                                      (cudaStream_t)stream>>>(
                J, nrows, n_slots, *a, ix, iy, iz);
        else
            ghost_refresh_kernel<1><<<blocks, THREADS, 0,
                                      (cudaStream_t)stream>>>(
                J, nrows, n_slots, *a, ix, iy, iz);
    }
    return (int)cudaGetLastError();
}
