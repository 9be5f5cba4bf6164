// K1 and K1z: ghost refresh of a cell-major row stack, in place.
//
// Replaces make_ghost_refresh (sphexa_tpu/ops/pallas_ve.py:349, call
// :435). The stack is [nrows, n_slots] float32, n_slots = padded cells *
// cap, padded cell id = (cx * npd + cy) * npz + cz.
//
// K1 (rz = 1, refresh_z=True): every ghost cell (a cell of a ghost
// column, or a z-ghost cell of an interior column) is re-derived from
// its source: the column wrapped to the opposite interior column
// (srcmap, pallas_ve.py:385-390), the z cell wrapped to the opposite
// interior cell (pallas_ve.py:397-401). With coordinate rows (ix >= 0),
// periodic axes add +-L to the coordinate row, and ghosts across an open
// axis become FILL_POS in the coordinate rows and 0 elsewhere. Sources
// are always interior slots, which this kernel never writes, so the
// in-place update has no read/write race.
//
// K1z (rz = 0, refresh_z=False; the slab-sharded engines): the caller
// lists only the cells of the x-y ghost columns, every z of them. Each
// copies the wrapped column at the same z: the z index is not wrapped
// (out = v, pallas_ve.py:403), so a ghost column's z-ghost lanes take
// the source column's z-ghost lanes, which the z-plane exchange has
// just filled; that is how the corner images compose. No z shift
// (:419), and the z planes never count as open (:430): the engines pass
// a box whose z is open, and its z-ghost lanes hold the neighbour
// shard's planes, not a boundary. K1z writes only ghost columns and
// reads only interior columns (at any z), so the in-place update is
// again free of races.
//
// Bound: a memory pass. Each ghost value is read once and written once:
// 2 * 4 bytes * nrows * ghost slots over the card's 3.35 TB/s.
// Design: one block per (ghost cell, row), one thread per slot of the
// cell, so a warp reads and writes 32 consecutive floats.

#include <cuda_runtime.h>

#include "sph_consts.h"

namespace {

__global__ void ghost_refresh_kernel(float* __restrict__ J, long long n_slots,
                                     const int* __restrict__ cells, int cap,
                                     int nx, int n, int nz, int px, int py,
                                     int pz, float lx, float ly, float lz,
                                     int ix, int iy, int iz, float fill_pos,
                                     int rz)
{
    const int row = blockIdx.y;
    const int cell = cells[blockIdx.x];
    const int npd = n + 2, npz = nz + 2, npx = nx + 2;
    const int cz = cell % npz;
    const int cy = (cell / npz) % npd;
    const int cx = cell / (npz * npd);
    const int wx = cx == 0 ? nx : (cx == npx - 1 ? 1 : cx);
    const int wy = cy == 0 ? n : (cy == npd - 1 ? 1 : cy);
    const int wz = !rz ? cz : (cz == 0 ? nz : (cz == npz - 1 ? 1 : cz));
    const long long src = ((long long)(wx * npd + wy) * npz + wz) * cap;
    const long long dst = (long long)cell * cap;
    float* r = J + (long long)row * n_slots;

    bool bad = false;
    float shift = 0.0f;
    const bool coord = row == ix || row == iy || row == iz;
    if (ix >= 0) {
        bad = (!px && (cx == 0 || cx == npx - 1))
            || (!py && (cy == 0 || cy == npd - 1))
            || (rz && !pz && (cz == 0 || cz == npz - 1));
        if (row == ix && px)
            shift = cx == 0 ? -lx : (cx == npx - 1 ? lx : 0.0f);
        else if (row == iy && py)
            shift = cy == 0 ? -ly : (cy == npd - 1 ? ly : 0.0f);
        else if (row == iz && pz && rz)
            shift = cz == 0 ? -lz : (cz == npz - 1 ? lz : 0.0f);
    }
    for (int lane = threadIdx.x; lane < cap; lane += blockDim.x) {
        float v;
        if (bad)
            v = coord ? fill_pos : 0.0f;
        else
            v = r[src + lane] + shift;
        r[dst + lane] = v;
    }
}

}  // namespace

extern "C" int ghost_refresh(float* J, int nrows, long long n_slots,
                             const int* cells, int n_ghost, int cap, int nx,
                             int n, int nz, int px, int py, int pz, float lx,
                             float ly, float lz, int ix, int iy, int iz,
                             float fill_pos, int rz, void* stream)
{
    if (n_ghost > 0 && nrows > 0) {
        dim3 grid(n_ghost, nrows);
        int threads = cap < 256 ? cap : 256;
        ghost_refresh_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
            J, n_slots, cells, cap, nx, n, nz, px, py, pz, lx, ly, lz, ix,
            iy, iz, fill_pos, rz);
    }
    return (int)cudaGetLastError();
}
