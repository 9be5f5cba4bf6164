// K2 with K3-K10: the VE pair stages over the cell-major layout.
//
// Replaces the Pallas driver make_cell_pair_call (sphexa_tpu/ops/
// pallas_ve.py:103, call :260) and its stage bodies:
//   stage 0  K3   xh::xh_cell     <- _xh_body          (pallas_ve.py:537)
//   stage 1  K4   tile::GradhStage <- _gradh_body      (pallas_ve.py:622)
//   stage 2  K5   tile::IadStage  <- _iad_direct_body  (pallas_ve.py:704)
//   stage 3  K6   tile::AvStage   <- _av_direct_body   (pallas_ve.py:900,
//                                    :865, :884)
//   stage 4  K7   tile::MomStage<false> <- _momentum_body (pallas_ve.py:
//                                    1022), avClean off
//   stage 5  K8   tile::IadMmStage <- _iad_hybrid_body (pallas_ve.py:769)
//   stage 6  K9   tile::AvMmStage <- _av_mm_body       (pallas_ve.py:949)
//   stage 7  K10  mm::mm_cell     <- _momentum_mm_body (pallas_ve.py:1190)
//   stage 8  K7c  tile::MomStage<true> <- _momentum_body, avClean branch
//                                    (pallas_ve.py:1031-1033, :1057-1060,
//                                    :1094-1116)
//
// Launch skeletons. Stages 1-6 and 8 (tile::pair_cell): blocks of
// min(cap, 128) threads a cell's i-tile, occupied slots only,
// double-buffered cp.async staging; K7's in-support pairs compacted
// across lanes, K4's, K5's, K6's, K8's and K9's evaluated by their own
// lanes. Stage 0 (xh::xh_cell): the same blocks, the occupied slots of
// the 27 cells in one flat run, walked again only where the h
// controller moved h. Stage 7 (mm::mm_cell): the pair weights on the
// float32 cores, their contraction with the moment columns on the
// tensor cores (mma.sync).
//
// Frame contract (as the Pallas kernels): invalid slots carry FILL_POS
// positions and drop out through the distance overflow; self-pairs are
// included and absorbed analytically; every output is masked with
// x < 0.5 * FILL_POS. Pairs outside the i-support contribute exact zeros
// in the Pallas bodies, so the loops here skip them. Squared distances
// and the support test use round-to-nearest intrinsics (no FMA
// contraction), so neighbour counts equal the plain version's exactly.
//
// Bound: arithmetic. Each stage does tens to ~180 float operations per
// pair candidate inside the support and reads each input row once from
// device memory per neighbouring cell (27 * FJ * 4 bytes per slot, most
// from L2), so its floor is pair work over the card's fp32 rate.
//
// K2g, the gated form (make_cell_pair_call(gated=True), pallas_ve.py:
// 162-172 and :242-251), is two launches. The gate pass (gate_pass
// below) reduces the activity row per z-supercell and lists the interior
// cells of the active supercells in a device list with a device count.
// The stage's kernel then runs the cell launch's grid: block x of an
// i-tile computes listed cell x through the cell launch's routine while
// x is below the device count, and every block writes its share of the
// rest of the output (gate_copy): prev on the interior slots of the
// inactive supercells, 0 outside the interior cells. No block computes
// an inactive cell, and nothing reads the count on the host. The gated
// stage is bounded by the pair work of the active supercells plus the
// act read and the copy's bytes.
//
// K11, the column launch (make_column_pair_call, pallas_ve.py:273, call
// :330; PallasVE(kernel_mode="column")), runs the same bodies with a
// block per z-segment of zseg consecutive cells of one interior (x, y)
// column, walking z (pair_launch_column): each stage calls the cell
// launch's routine for each cell (xh::xh_cell, tile::cell_tile,
// mm::cell_mm). So each thread visits the 27 cells in the cell launch's
// order, its sums, and the outputs on interior slots, are those of the
// cell launch bit for bit; the output rows are written on interior slots
// only.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sph_consts.h"

struct PairGeom {
    int nx, n, nz, npd, npz, cap;
    long long n_slots;
};

struct PairParams {
    float K3d;
    int n_w;
    float ngmin, ngmax, h_cap;
    int h_iter;
    float alphamin, alphamax, decay_constant, atmin, atmax, ramp;
    int uniform_mass;
    float hcoef;   // 1023 * ng0 of the nc -> h controller
    int mxu_bf16;  // K10: round both contraction operands to bf16
    // K3: walk counts (xh::xh_cell); K10: issued and staged mma blocks
    // (mm::mm_cell); or null
    unsigned long long* stats;
};

// K2g's gate: ws, the workspace its gate pass filled (gate_pass), or null
// for the ungated stage. ws[0] is the count of listed cells,
// ws[SPH_GATE_HDR + q] the padded id of listed cell q, ws[gate_flags(g) +
// sc] supercell sc's flag. out and prev are 16-byte aligned (pair_ve.py
// checks it).
struct PairGate {
    const int* ws;
    const float* prev;   // [FO, n_slots] outputs kept by inactive supercells
    int Z;               // the z-supercell size
};

namespace {

constexpr float HALF_FILL = 0.5f * SPH_FILL_POS;

// x**n by binary multiplication, the same product order as _pow_int
__device__ __forceinline__ float pow_int(float x, int n)
{
    float result = 1.0f, base = x;
    bool first = true;
    while (n > 0) {
        if (n & 1) {
            result = first ? base : result * base;
            first = false;
        }
        base = base * base;
        n >>= 1;
    }
    return result;
}

// pow_int without the loop at the default sinc index 6 (and at 5, K4's
// n_w - 1): the same products
__device__ __forceinline__ float pow_nw(float x, int n)
{
    if (n == 6) {
        const float x2 = x * x;
        return x2 * (x2 * x2);
    }
    if (n == 5) {
        const float x2 = x * x;
        return x * (x2 * x2);
    }
    return pow_int(x, n);
}

// squared distance without FMA contraction
__device__ __forceinline__ float dist2(float rx, float ry, float rz)
{
    return __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                     __fmul_rn(rz, rz));
}

__device__ __forceinline__ float w_v2(float v2, int n_w)
{
    return v2 < 4.0f ? pow_int(sinc_poly(v2), n_w) : 0.0f;
}

// --------------------------------------------------------------------------
// stage 2 (K5) and stage 5 (K8), tile::IadStage and tile::IadMmStage
// below: the IAD inverse of the h-scaled tau and the outputs
// --------------------------------------------------------------------------

// the IAD inverse of the h-scaled tau (_iad_tail, pallas_ve.py:672)
__device__ void iad_tail(float t11, float t12, float t13, float t22,
                         float t23, float t33, float hi, float (&C)[3][3])
{
    float det = t11 * t22 * t33 + 2.0f * t12 * t23 * t13
        - t11 * t23 * t23 - t22 * t13 * t13 - t33 * t12 * t12;
    float fac = 1.0f / (det * hi * hi);
    C[0][0] = (t22 * t33 - t23 * t23) * fac;
    C[0][1] = C[1][0] = (t13 * t23 - t33 * t12) * fac;
    C[0][2] = C[2][0] = (t12 * t23 - t22 * t13) * fac;
    C[1][1] = (t11 * t33 - t13 * t13) * fac;
    C[1][2] = C[2][1] = (t13 * t12 - t11 * t23) * fac;
    C[2][2] = (t11 * t22 - t12 * t12) * fac;
}

// cij, divv, curlv and the six gradv rows (_iad_outputs, :684)
__device__ void iad_store(const float (&C)[3][3], const float (&dV)[3][3],
                          float nk, bool ok, float* out, long long islot,
                          long long ns)
{
    float cx = dV[2][1] - dV[1][2], cy = dV[0][2] - dV[2][0],
          cz = dV[1][0] - dV[0][1];
    const float o[14] = {
        C[0][0], C[0][1], C[0][2], C[1][1], C[1][2], C[2][2],
        nk * (dV[0][0] + dV[1][1] + dV[2][2]),
        nk * sqrtf(cx * cx + cy * cy + cz * cz),
        nk * dV[0][0], nk * (dV[0][1] + dV[1][0]),
        nk * (dV[0][2] + dV[2][0]), nk * dV[1][1],
        nk * (dV[1][2] + dV[2][1]), nk * dV[2][2]};
#pragma unroll
    for (int r = 0; r < 14; ++r) out[r * ns + islot] = ok ? o[r] : 0.0f;
}

// Cullen-Dehnen alpha evolution of stages 3 and 6 (_av_alpha_tail,
// pallas_ve.py:865); I2 rows 6 and 7 are alpha_i and dt
__device__ float alpha_tail(const float* I2, long long islot, long long ns,
                            const PairParams& p, float graddivv,
                            float vijsignal, float divvi, float hi, float ci)
{
    const float alpha_i = I2[6 * ns + islot], dt = I2[7 * ns + islot];
    float a_const = hi * hi * graddivv;
    float alphaloc = divvi < 0.0f
        ? p.alphamax * a_const / (a_const + hi * fabsf(divvi) + 0.05f * ci)
        : 0.0f;
    float decay = hi / (p.decay_constant * vijsignal);
    float alphadot = alphaloc >= p.alphamin
        ? (alphaloc - alpha_i) / decay : (p.alphamin - alpha_i) / decay;
    return alphaloc >= alpha_i ? alphaloc : alpha_i + alphadot * dt;
}

// --------------------------------------------------------------------------
// stage 4: momentum and energy
// --------------------------------------------------------------------------
__device__ __forceinline__ void exp_pair(float x, float& ep, float& em)
{
    float x2 = x * x;
    float even = 1.0f + x2 * (0.5f + x2 * ((float)(1.0 / 24.0)
                                           + x2 * (float)(1.0 / 720.0)));
    float odd = x * (1.0f + x2 * ((float)(1.0 / 6.0) + x2 * (float)(1.0 / 120.0)));
    ep = even + odd;
    em = even - odd;
}

// --------------------------------------------------------------------------
// launch skeletons
// --------------------------------------------------------------------------

__device__ __forceinline__ long long own_cell(const PairGeom& g)
{
    const int c = blockIdx.x;
    const int cz = c % g.nz, cy = (c / g.nz) % g.n, cx = c / (g.nz * g.n);
    return ((long long)(cx + 1) * g.npd + (cy + 1)) * g.npz + (cz + 1);
}

__device__ __forceinline__ long long nbr_cell(const PairGeom& g,
                                              long long own, int nb)
{
    const int dx = nb / 9 - 1, dy = (nb / 3) % 3 - 1, dz = nb % 3 - 1;
    return own + ((long long)dx * g.npd + dy) * g.npz + dz;
}

// The cells a block computes: one interior cell (the cell launch), or
// for K11 (Column) the z-segment blockIdx.x % nseg of interior column
// blockIdx.x / nseg, nseg = ceil(nz / zseg), columns in (cx, cy) order.
struct Walk {
    long long own0;   // padded id of the first cell; the others follow in z
    int ncell;
};

template <bool Column>
__device__ __forceinline__ Walk block_walk(const PairGeom& g, int zseg)
{
    if constexpr (!Column) {
        return {own_cell(g), 1};
    } else {
        const int nseg = (g.nz + zseg - 1) / zseg;
        const int col = blockIdx.x / nseg, z0 = (blockIdx.x % nseg) * zseg;
        const int cx = col / g.n, cy = col % g.n;
        return {((long long)(cx + 1) * g.npd + (cy + 1)) * g.npz + z0 + 1,
                min(zseg, g.nz - z0)};
    }
}

// --------------------------------------------------------------------------
// K2g, the gated launch: replaces make_cell_pair_call's gate (pallas_ve.py:
// 162-172, :242-251: a program computes its z-supercell only where
// max(act) > 0.5 over the supercell's Z * cap slots, else copies prev).
// A z-supercell is padded z-cells [t Z, (t + 1) Z) of one (x, y) column of
// the padded grid, numbered sc = column * (npz / Z) + t.
// The gate pass (gate_pass) gives a warp to each supercell: it reduces the
// act slots of an interior column's supercell, records the supercell's
// flag, and where one slot is above 0.5 adds the supercell's interior
// cells to the list (an atomicAdd on the count reserves their entries, so
// the list is in no fixed order). An inactive cell inside an active
// supercell is listed and recomputed, as on the TPU (its fresh outputs
// are what its active neighbours read in the next stage).
// The stage's kernel then runs the cell launch's grid, a block a (cell,
// i-tile): block x computes listed cell x if x is below the device count
// and skips the routine otherwise, and every block then copies its share
// of the supercells (gate_copy): prev on the interior slots of an
// inactive one, 0 on every slot outside the interior cells, so out needs
// no zero fill. The copy is taken from the end of the grid, so at a
// skipping substep the blocks past the count do it while the listed
// cells compute. Chosen by measurement (Sedov 100^3 substep-1 inputs,
// the five direct stages, chip_smoke.py --compare, three runs each in
// one call on an NVIDIA H100 80GB HBM3 at 700 W): 0.932-0.937 ms of
// device time, against 1.333-1.342 for an occupancy-sized persistent
// grid taking cells and then supercells from atomic counters.
// The pass runs once a gated launch, so each stage reduces act again: a
// read of the interior columns' supercells, beside the FO rows each
// stage copies anyway (chip_smoke.py times the pass alone at a skipping
// substep's inputs). Bound: bytes, that read and the list and flags
// written; the copy's bytes are the stage's.
// --------------------------------------------------------------------------
constexpr int GATE_WARPS = 8;            // supercells a gate-pass block

// the flags of the supercells follow the list of interior cells
__host__ __device__ constexpr long long gate_flags(const PairGeom& g)
{
    return SPH_GATE_HDR + (long long)g.nx * g.n * g.nz;
}

// supercell sc of size Z: its (x, y) column is interior (icol); its
// interior cells are padded z-cells [z0, z1) of padded column col; its
// slots start at `first`, and slots [lo, hi) of it are interior
struct Supercell {
    bool icol;
    int col, z0, z1, lo, hi;
    long long first;

    __device__ Supercell(const PairGeom& g, int Z, int sc)
    {
        const int nsc = g.npz / Z, t = sc % nsc;
        col = sc / nsc;
        const int cx = col / g.npd, cy = col - cx * g.npd;
        icol = cx >= 1 && cx <= g.nx && cy >= 1 && cy <= g.n;
        z0 = max(t * Z, 1);
        z1 = icol ? max(min(t * Z + Z, g.nz + 1), z0) : z0;
        lo = (z0 - t * Z) * g.cap;
        hi = (z1 - t * Z) * g.cap;
        first = ((long long)col * g.npz + t * Z) * g.cap;
    }
};

__global__ void __launch_bounds__(32 * GATE_WARPS)
gate_pass(const float* __restrict__ act, PairGeom g, int Z,
          int* __restrict__ ws)
{
    const int nslot = Z * g.cap;
    const int sc = blockIdx.x * GATE_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (sc >= (g.nx + 2) * g.npd * (g.npz / Z)) return;
    const Supercell u(g, Z, sc);
    const float* a = act + u.first;
    bool any = false;
    if (u.icol) {
        for (int s = 4 * lane; s < nslot; s += 128) {
            const float4 v = *reinterpret_cast<const float4*>(a + s);
            any |= v.x > 0.5f || v.y > 0.5f || v.z > 0.5f || v.w > 0.5f;
        }
    }
    const bool on = __any_sync(0xffffffffu, any);
    if (lane == 0) {
        ws[gate_flags(g) + sc] = on;
        if (on && u.z1 > u.z0) {
            const int base = atomicAdd(ws, u.z1 - u.z0);
            for (int z = u.z0; z < u.z1; ++z)
                ws[SPH_GATE_HDR + base + z - u.z0] =
                    (int)((long long)u.col * g.npz + z);
        }
    }
}

// out of supercell sc: prev on its interior slots if it is inactive, 0 on
// its other slots; coalesced 16-byte accesses
template <int FO>
__device__ __forceinline__ void gate_fill(const PairGate& gt,
                                          const PairGeom& g, int sc,
                                          float* __restrict__ out)
{
    const Supercell u(g, gt.Z, sc);
    const bool on = gt.ws[gate_flags(g) + sc] != 0;
#pragma unroll 1
    for (int r = 0; r < FO; ++r) {
        const long long row = r * g.n_slots + u.first;
        for (int s = 4 * threadIdx.x; s < gt.Z * g.cap; s += 4 * blockDim.x) {
            float4* o = reinterpret_cast<float4*>(out + row + s);
            if (s < u.lo || s >= u.hi)
                *o = make_float4(0.f, 0.f, 0.f, 0.f);
            else if (!on)
                *o = *reinterpret_cast<const float4*>(gt.prev + row + s);
        }
    }
}

// K2g's listed cell for block x of an i-tile, or -1 past the count
__device__ __forceinline__ long long gate_cell(const PairGate& gt)
{
    return blockIdx.x < (unsigned)gt.ws[0] ? gt.ws[SPH_GATE_HDR + blockIdx.x]
                                           : -1;
}

// then the block's share of the supercells, counted from the grid's last
// block, so that at a skipping substep the blocks past the count copy
template <int FO>
__device__ void gate_copy(const PairGate& gt, const PairGeom& g,
                          float* __restrict__ out)
{
    const long long nsc = (long long)(g.nx + 2) * g.npd * (g.npz / gt.Z);
    const long long nb = (long long)gridDim.x * gridDim.y;
    for (long long sc = nb - 1 - (blockIdx.y * (long long)gridDim.x
                                  + blockIdx.x);
         sc < nsc; sc += nb)
        gate_fill<FO>(gt, g, (int)sc, out);
}

// The expansion origin of the moment bodies (_cell_means, pallas_ve.py:
// 522): per row orow(r), the mean over the own cell's valid slots
// (gid >= 0). One thread sums each row in slot order; the block then
// reads the NORIGIN means from shared memory.
template <class Rows>
__device__ void cell_means(const float* J, long long first, int cap,
                           long long ns, float* origin)
{
    const int r = threadIdx.x;
    if (r < Rows::NORIGIN) {
        const long long row = Rows::orow(r);
        float s = 0.0f, nv = 0.0f;
        for (int k = 0; k < cap; ++k)
            if (J[4 * ns + first + k] >= 0.0f) {      // gid row
                s += J[row * ns + first + k];
                nv += 1.0f;
            }
        origin[r] = s / fmaxf(nv, 1.0f);
    }
    __syncthreads();
}

// --------------------------------------------------------------------------
// The tiled pair routine: stage 1 (K4, grad-h), stage 2 (K5, IAD),
// stage 3 (K6, AV switches), stage 4 (K7, momentum and energy), stage 5
// (K8, hybrid IAD), stage 6 (K9, moment AV switches) and stage 8 (K7c,
// AvClean).
// K4 replaces _gradh_body (pallas_ve.py:622): per i-slot the sums kx,
// whomega and wrho0 of W and its h-derivative term over the in-support
// pairs, then the VE normalisation kx and grad-h (1.0 on invalid
// slots: kx is a divisor downstream, pallas_ve.py:667).
// K5 replaces _iad_direct_body (pallas_ve.py:704): per i-slot the
// h-scaled IAD tau (six sums) and the velocity-gradient sums Q_ab =
// sum_j w xm_j (v_j - v_i)_a r_b (nine) over the in-support pairs of its
// 27 neighbour cells, then the 3x3 inverse and the 14 outputs
// (iad_tail, iad_store).
// K6 replaces _av_direct_body (pallas_ve.py:900, _av_vsig_term :884,
// _av_alpha_tail :865): per i-slot graddivv's three sums over the
// in-support pairs and the max approaching signal speed, then the
// Cullen-Dehnen alpha update (alpha_tail).
// K7 replaces _momentum_body (pallas_ve.py:1022; avClean branch
// :1031-1033, :1057-1060, :1094-1116, momentum_energy_kern.hpp:44-63):
// per i-slot the pair sums of the momentum, energy, AV heating and max
// signal velocity, with the Atwood-ramped VE terms; K7c adds the
// avClean rv correction on six more j-rows (the symmetrised gradv) and
// eta_crit on the i side.
// K8 replaces _iad_hybrid_body (pallas_ve.py:769, dot :832): K5's tau,
// and the velocity gradients from 16 sums of w_ij times the j-moments
// xm_j (1, x_jc) and u_a (1, x_jc), u_a = xm_j (v_a,j - o_va), centred
// on the own cell's mean o (cell_means, before the walk: the Stage's
// NORIGIN); each moment product is formed per pair from the staged
// j-only terms in the order the JAX body forms its columns, so each
// column keeps its float32 rounding; the epilogue contracts the sums
// with the i-side offsets and cij.
// K9 replaces _av_mm_body (pallas_ve.py:949, dot :991): K6's signal-speed
// max per pair (a max is no sum), and graddivv from 8 sums of W_ij times
// the cell-centred j-columns vol_j (1, x_jc) and vd_j (1, x_jc), vol_j =
// xm_j / kx_j, vd_j = vol_j (divv_j - o_divv), centred on the own cell's
// means of x, y, z, divv (NORIGIN 4); the columns are j-only terms,
// written once a staged slot with the JAX body's expressions, so a pair
// costs the test, rv, the signal-speed term, W and 8 FMAs; the epilogue
// forms G_b, contracts it with cij and scales by K3d h^-3, as the JAX
// body does, then alpha_tail. The float32 cores and not the tensor
// cores: the contraction is 8 columns, 16 of K9's 47 flops a pair, while
// the test, the signal-speed max and W run per pair on the float32 cores
// anyway (K10's 49 columns x 5 families on mma.sync stay latency-bound,
// 60x their bound), so the tiled routine's occupied groups, cp.async
// staging and per-lane masks are K9's design.
//
// Bound: arithmetic, the 9-flop distance test of every candidate plus,
// a pair inside the i-support, ~40 flops (K4), ~62 (K5), ~55 (K6), ~170
// (K7), ~220 (K7c), ~72 and 16 products (K8), ~47 (K9).
//
// One device routine, pair_cell<Stage>, computes one interior cell for
// every launch form: the cell launch, K2g's gated form (stages 1-6) and
// K11's stream form (cell_tile below). It is __noinline__, so every
// form calls one compiled routine of the same arithmetic (ptxas
// allocates its registers per kernel), and K11 and K2g equal the cell
// launch bit for bit on the card. A Stage (GradhStage, IadStage,
// AvStage, MomStage, IadMmStage, AvMmStage) names its staged j-rows, its
// j-only terms, its i-terms, the NC contributions of a pair, how its
// pairs are evaluated (COMPACT), the store and the values of invalid
// slots (fill).
//
// A block of T = min(cap, 128) threads takes the T i-slots of one i-tile
// of its cell (cap > 128: ceil(cap / 128) blocks a cell, blockIdx.y);
// a tile with no valid i-slot stores its Stage's fill values and
// returns before staging (at cap 256 the second i-tile of most cells).
// From cap 128 a block has 4 warps; at cap 64 the cell's i-slots fill
// only 2, and the latency is hidden by the ~10 blocks an SM instead.
// The 27 neighbour cells are walked in the cell launch's order as units
// of one j-tile (T slots) each:
//  1. Occupied slots only. Warp w stages the 32 slots [32w, 32w+32) of
//     a j-tile only where its ballot on x < HALF_FILL finds a valid
//     slot, and records the tile's last valid slot; the support tests
//     then run over slots [0, last valid + 1) only. The layout fills a
//     cell's valid slots as a prefix (ops/cellmajor.build_layout), so
//     this stages exactly the occupied 32-slot groups; a slot left
//     invalid inside the range fails the support test (FILL_POS) as
//     before. Warps whose i-slots are all invalid run no tests.
//  2. j-only terms once per staged slot, written as extra rows when a
//     slot is staged, with the expressions and association the pair
//     body used: K5 and K6 vol_j = xm_j / kx_j; K7 1/h, 1/h^2, 1/h^3,
//     logf(xm), m / rho and m * prho; K8 vol_j, x_j - o and xm_j (v_j -
//     o_v); K9 its 8 columns; K4 has none.
//  3. The support tests, per warp and chunk of 32 staged j-slots: each
//     lane tests its own i against the chunk (dist2 and __fmul_rn(d2,
//     hinv2) < 4, unchanged) into a 32-bit mask. Then the in-support
//     pairs:
//     K7, K7c (COMPACT): compacted across lanes. A warp scan of the
//     popcounts places each lane's in-support (i, k) pairs in (i, k)
//     order; the warp evaluates the body 64 pairs at a time, two rounds
//     of full lanes: lane q takes pairs p0 + q and p0 + 32 + q, finds
//     each one's owner lane and j-slot by binary search over the
//     offsets and the owner's mask, reads the owner's i-terms from
//     shared memory and writes the pair's six contributions (mx, my, mz,
//     energy, avisc, vsig) to shared memory. Each owner lane then adds
//     its own pairs in k order (four entries' loads in flight). Two
//     rounds a batch took K7 from 5.26 to 4.89 ms at Sedov 100^3 (one
//     round a batch, or four, were slower); a lane evaluating only its
//     own pairs took K7 6.19 ms (4.87 compacted).
//     K4, K5, K6, K8, K9: each lane evaluates its own in-support pairs,
//     walking its mask's set bits, and adds each pair's terms as it
//     goes. The cross-lane compaction took K5 4.60 ms (the rounds' search,
//     i-term loads and 15 shared stores a pair ~2.8 ms of it, the
//     owners' adds ~0.4) against 2.61 this way (2.86 with the tests
//     unrolled by 2, see IadStage) and 3.61 for the former
//     thread-a-slot kernel: a 62-flop body does not repay it, nor do
//     K4's 40 flops (3 sums) and K6's 55 (3 sums and a max).
//     Either way every per-i sum takes its pairs one at a time in the
//     order of the cell launch before it (nb, then slot).
//     (chip_smoke.py --compare and trial variants of this file, NVIDIA
//     H100 80GB HBM3, 700 W.)
//  4. Staging overlaps compute: two j-tile buffers; the next unit is
//     copied with 16-byte cp.async (4-byte where J is not 16-byte
//     aligned) while the current one is computed, its x row read two
//     units ahead, its j-only terms written from registers after the
//     compute, so one barrier a unit suffices.
// Shared memory: 2 * NROW * T floats of tiles (NROW: K4 5, K5 8, K6 9,
// K7 23, K7c 29, K8 11, K9 15), the NI i-terms of the block's T i-slots
// (NI 5, 9, 16, 21, 29, 12, 20), K8's and K9's origin and, for K7 and
// K7c, 6 * 64 contributions a warp: at cap 64 K4 3.9 KB, K5 6.4 KB, K6
// 8.7 KB, K7 20.2 KB, K7c 25.4 KB, K8 8.7 KB, K9 12.8 KB; from cap 128
// twice those of K4-K6, K8 and K9, 40.5 and 50.7 KB for K7 and K7c.
// Keeping the i-terms there rather than in registers (shuffled to the
// evaluating lane) cut K7's register count by about 40 and K7 from 5.90
// to 5.24 ms.
// --------------------------------------------------------------------------
namespace tile {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 128;

__device__ __forceinline__ unsigned smem_u32(const void* p)
{
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A Stage's interface (GradhStage, IadStage, AvStage, MomStage,
// IadMmStage, AvMmStage):
//   staged rows: X, Y, Z = 0, 1, 2, NCOPY rows copied from J (J row
//     jrow(r)), NROW in all with the j-only terms;
//   i-terms: NI of them, I_X, I_Y, I_Z, I_HINV2 = 0, 1, 2, 3 first
//     (the support test's, kept in registers too), from J and I2
//     (load_i);
//   NE J values a staged slot reads for its j-only terms (load_e), which
//     finish writes (neither is called at NE 0); NC contributions a pair
//     (terms), added into the lane's sums (add); COMPACT: pairs
//     compacted across lanes, NLOAD entries in flight when an owner
//     adds; TEST_UNROLL: the support tests' unroll; FO output rows
//     (store), fill(r) those of an invalid slot;
//   NORIGIN, where a Stage has it (K8's, K9's): the own cell's means of its
//     rows orow(r) before the walk (cell_means), an origin that load_i
//     and finish then take as their last argument.
#define JI(r) J[(long long)(r) * ns + islot]
#define S(r) sb[(r) * T + k]
#define A(q) a[(q) * T]

// stage 1 (K4): VE normalization kx and grad-h
struct GradhStage {
    // x y z m xm (J rows 0-2, 5, 6); no j-only term
    static constexpr int X = 0, Y = 1, Z = 2, M = 3, XM = 4;
    static constexpr int NCOPY = 5, NROW = 5;
    __device__ static int jrow(int r) { return r < 3 ? r : r + 2; }
    enum : int { I_X, I_Y, I_Z, I_HINV2, I_HINV, NI };
    // each lane evaluates its own in-support pairs; kx, whomega, wrho0.
    // The support tests unrolled by 4: 2.10-2.13 ms at 63 registers, no
    // spill; by 2 2.21, by 8 2.09-2.10 (93 registers in the K11 form)
    // (chip_smoke.py --compare, Sedov 100^3, H100)
    static constexpr bool COMPACT = false;
    static constexpr int NE = 0, NC = 3, NLOAD = 0, FO = 2,
                         TEST_UNROLL = 4;

    // kx and gradh of an invalid slot: kx is a divisor downstream
    __device__ static float fill(int) { return 1.0f; }

    __device__ static void load_i(const float* J, const float*, long long ns,
                                  long long islot, bool ihas,
                                  const PairParams&, float (&iv)[NI])
    {
        const float hinv = __fdiv_rn(1.0f, JI(3));
        iv[I_X] = ihas ? JI(0) : SPH_FILL_POS;
        iv[I_Y] = JI(1);
        iv[I_Z] = JI(2);
        iv[I_HINV2] = __fmul_rn(hinv, hinv);
        iv[I_HINV] = hinv;
    }

    __device__ static void init(float (&acc)[NC])
    {
#pragma unroll
        for (int q = 0; q < NC; ++q) acc[q] = 0.0f;
    }

    __device__ static void add(float (&acc)[NC], const float (&v)[NC])
    {
#pragma unroll
        for (int q = 0; q < NC; ++q) acc[q] += v[q];
    }

    // kx, whomega, wrho0 (the expressions of _gradh_body)
    __device__ static void terms(const float* a, const float* sb, int T,
                                 int k, const PairParams& p,
                                 float (&c)[NC])
    {
        const float d2 = dist2(__fsub_rn(A(I_X), S(X)),
                               __fsub_rn(A(I_Y), S(Y)),
                               __fsub_rn(A(I_Z), S(Z)));
        const float v2 = __fmul_rn(d2, A(I_HINV2));
        const float sinc = sinc_poly(v2);
        const float wnm1 = pow_nw(sinc, p.n_w - 1);
        const float w = wnm1 * sinc;
        const float vdw = (float)p.n_w * wnm1 * (v2 * dsinc_over_v_poly(v2));
        const float dterh = -(3.0f * w + vdw);
        c[0] = w * S(XM);
        c[1] = dterh * S(XM);
        c[2] = dterh * S(M);
    }

    __device__ static void store(const float* J, const float*, long long ns,
                                 long long islot, const float* mine, int T,
                                 const float (&acc)[NC], bool ok,
                                 const PairParams& p, float* out)
    {
        const float hi = JI(3), mi = JI(5), xmi = JI(6);
        const float hinv = mine[I_HINV * T], hinv2 = mine[I_HINV2 * T];
        const float K3d = p.K3d;
        const float h3inv = hinv * hinv2;
        const float kxs = acc[0] * K3d * h3inv;
        float who = acc[1] * K3d * h3inv * hinv;
        const float wr0 = acc[2] * K3d * h3inv * hinv;
        who = who * mi / xmi + (kxs - K3d * xmi * h3inv) * wr0;
        const float rho = kxs * mi / xmi;
        const float gradh = 1.0f + hi / (rho * 3.0f) * who;
        out[0 * ns + islot] = ok ? kxs : fill(0);
        out[1 * ns + islot] = ok ? gradh : fill(1);
    }
};

// stage 2 (K5): IAD tau, divv, curlv, velocity gradients
struct IadStage {
    // x y z xm vx vy vz (J rows 0-2, 6-9), then vol_j
    static constexpr int X = 0, Y = 1, Z = 2, XM = 3, VX = 4, VY = 5,
                         VZ = 6;
    static constexpr int NCOPY = 7, VOLJ = 7, NROW = 8;
    __device__ static int jrow(int r) { return r < 3 ? r : r + 3; }
    enum : int { I_X, I_Y, I_Z, I_HINV2, I_HINV, I_KFAC, I_VX, I_VY, I_VZ,
                 NI };
    // each lane evaluates its own in-support pairs (COMPACT false); the
    // support tests unrolled by 2: by 4 (K7's) the cell launch spilled
    // 8 bytes at 96 registers (2.62 ms), by 2 it takes 115 registers and
    // no spill (2.86 ms; ptxas -v and chip_smoke.py's timing, H100)
    static constexpr bool COMPACT = false;
    static constexpr int NE = 2, NC = 15, NLOAD = 0, FO = 14,
                         TEST_UNROLL = 2;

    __device__ static float fill(int) { return 0.0f; }

    __device__ static void load_i(const float* J, const float*, long long ns,
                                  long long islot, bool ihas,
                                  const PairParams& p, float (&iv)[NI])
    {
        const float hinv = __fdiv_rn(1.0f, JI(3));
        const float hinv2 = __fmul_rn(hinv, hinv);
        iv[I_X] = ihas ? JI(0) : SPH_FILL_POS;
        iv[I_Y] = JI(1);
        iv[I_Z] = JI(2);
        iv[I_HINV2] = hinv2;
        iv[I_HINV] = hinv;
        iv[I_KFAC] = p.K3d * (hinv * hinv2);
        iv[I_VX] = JI(7);
        iv[I_VY] = JI(8);
        iv[I_VZ] = JI(9);
    }

    __device__ static void load_e(const float* J, long long ns, long long s,
                                  float (&e)[NE])
    {
        e[0] = J[5 * ns + s];        // kx
        e[1] = J[6 * ns + s];        // xm
    }

    __device__ static void finish(float* d, int T, const float (&e)[NE])
    {
        d[VOLJ * T] = e[1] / e[0];
    }

    __device__ static void init(float (&acc)[NC])
    {
#pragma unroll
        for (int q = 0; q < NC; ++q) acc[q] = 0.0f;
    }

    __device__ static void add(float (&acc)[NC], const float (&v)[NC])
    {
#pragma unroll
        for (int q = 0; q < NC; ++q) acc[q] += v[q];
    }

    // t11 t12 t13 t22 t23 t33, then Q[a][b] at 6 + 3a + b
    __device__ static void terms(const float* a, const float* sb, int T,
                                 int k, const PairParams& p,
                                 float (&c)[NC])
    {
        const float rx = __fsub_rn(A(I_X), S(X)),
                    ry = __fsub_rn(A(I_Y), S(Y)),
                    rz = __fsub_rn(A(I_Z), S(Z));
        const float v2 = __fmul_rn(dist2(rx, ry, rz), A(I_HINV2));
        const float w = pow_nw(sinc_poly(v2), p.n_w);
        const float wn = (S(VOLJ) * w) * A(I_KFAC);
        const float hinv = A(I_HINV);
        const float sx = rx * hinv, sy = ry * hinv, sz = rz * hinv;
        c[0] = sx * sx * wn; c[1] = sx * sy * wn; c[2] = sx * sz * wn;
        c[3] = sy * sy * wn; c[4] = sy * sz * wn; c[5] = sz * sz * wn;
        const float wxm = w * S(XM);
        const float vji[3] = {S(VX) - A(I_VX), S(VY) - A(I_VY),
                              S(VZ) - A(I_VZ)};
        const float rr[3] = {rx, ry, rz};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const float va = wxm * vji[q];
#pragma unroll
            for (int b = 0; b < 3; ++b) c[6 + 3 * q + b] = va * rr[b];
        }
    }

    // mine: this slot's i-terms (stride T)
    __device__ static void store(const float* J, const float*, long long ns,
                                 long long islot, const float* mine, int T,
                                 const float (&acc)[NC], bool ok,
                                 const PairParams&, float* out)
    {
        float C[3][3];
        iad_tail(acc[0], acc[1], acc[2], acc[3], acc[4], acc[5], JI(3), C);
        float dV[3][3];   // dV[a][b] = -(C Q_a)_b
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int b = 0; b < 3; ++b)
                dV[q][b] = -(C[b][0] * acc[6 + 3 * q]
                             + C[b][1] * acc[6 + 3 * q + 1]
                             + C[b][2] * acc[6 + 3 * q + 2]);
        iad_store(C, dV, mine[I_KFAC * T] / JI(5), ok, out, islot, ns);
    }
};

// stage 5 (K8): K5's tau, the velocity gradients from 16 cell-centred
// j-moments (_iad_hybrid_body's contraction, summed per lane)
struct IadMmStage {
    // x y z xm (J rows 0-2, 6), then the j-only terms vol_j = xm / kx,
    // the centred x_j - o (three) and u_a = xm_j (v_a,j - o_va) (three)
    static constexpr int X = 0, Y = 1, Z = 2, XM = 3;
    static constexpr int NCOPY = 4, VOLJ = 4, XC = 5, UX = 8, NROW = 11;
    __device__ static int jrow(int r) { return r < 3 ? r : 6; }
    // the expansion origin (cell_means): the mean x y z vx vy vz
    static constexpr int NORIGIN = 6;
    __device__ static int orow(int r) { return r < 3 ? r : r + 4; }
    enum : int { I_X, I_Y, I_Z, I_HINV2, I_HINV, I_KFAC, I_XIB,
                 I_VIC = I_XIB + 3, NI = I_VIC + 3 };
    // each lane evaluates its own in-support pairs: six tau sums, then
    // the 16 moment sums S0, S_b, and per a U0_a, U_ab; the support tests
    // unrolled by 2 (K5's)
    static constexpr bool COMPACT = false;
    static constexpr int NE = 8, NC = 22, NLOAD = 0, FO = 14,
                         TEST_UNROLL = 2;

    __device__ static float fill(int) { return 0.0f; }

    __device__ static void load_i(const float* J, const float*, long long ns,
                                  long long islot, bool ihas,
                                  const PairParams& p, float (&iv)[NI],
                                  const float* org)
    {
        const float hinv = __fdiv_rn(1.0f, JI(3));
        const float hinv2 = __fmul_rn(hinv, hinv);
        iv[I_X] = ihas ? JI(0) : SPH_FILL_POS;
        iv[I_Y] = JI(1);
        iv[I_Z] = JI(2);
        iv[I_HINV2] = hinv2;
        iv[I_HINV] = hinv;
        iv[I_KFAC] = p.K3d * (hinv * hinv2);
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            iv[I_XIB + b] = JI(b) - org[b];
            iv[I_VIC + b] = JI(7 + b) - org[3 + b];
        }
    }

    __device__ static void load_e(const float* J, long long ns, long long s,
                                  float (&e)[NE])
    {
        e[0] = J[5 * ns + s];        // kx
        e[1] = J[6 * ns + s];        // xm
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            e[2 + b] = J[b * ns + s];           // x y z
            e[5 + b] = J[(7 + b) * ns + s];     // vx vy vz
        }
    }

    __device__ static void finish(float* d, int T, const float (&e)[NE],
                                  const float* org)
    {
        d[VOLJ * T] = e[1] / e[0];
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            d[(XC + b) * T] = e[2 + b] - org[b];
            d[(UX + b) * T] = e[1] * (e[5 + b] - org[3 + b]);
        }
    }

    __device__ static void init(float (&acc)[NC])
    {
#pragma unroll
        for (int q = 0; q < NC; ++q) acc[q] = 0.0f;
    }

    __device__ static void add(float (&acc)[NC], const float (&v)[NC])
    {
#pragma unroll
        for (int q = 0; q < NC; ++q) acc[q] += v[q];
    }

    // t11 t12 t13 t22 t23 t33, then the moments at 6 + 4a (+ 1 + b):
    // w u_a and w (u_a x_jc,b), u_0 = xm_j
    __device__ static void terms(const float* a, const float* sb, int T,
                                 int k, const PairParams& p,
                                 float (&c)[NC])
    {
        const float rx = __fsub_rn(A(I_X), S(X)),
                    ry = __fsub_rn(A(I_Y), S(Y)),
                    rz = __fsub_rn(A(I_Z), S(Z));
        const float v2 = __fmul_rn(dist2(rx, ry, rz), A(I_HINV2));
        const float w = pow_nw(sinc_poly(v2), p.n_w);
        const float wn = (S(VOLJ) * w) * A(I_KFAC);
        const float hinv = A(I_HINV);
        const float sx = rx * hinv, sy = ry * hinv, sz = rz * hinv;
        c[0] = sx * sx * wn; c[1] = sx * sy * wn; c[2] = sx * sz * wn;
        c[3] = sy * sy * wn; c[4] = sy * sz * wn; c[5] = sz * sz * wn;
        const float u[4] = {S(XM), S(UX), S(UX + 1), S(UX + 2)};
        const float xc[3] = {S(XC), S(XC + 1), S(XC + 2)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            c[6 + 4 * q] = w * u[q];
#pragma unroll
            for (int b = 0; b < 3; ++b)
                c[6 + 4 * q + 1 + b] = w * (u[q] * xc[b]);
        }
    }

    // F_b = xi_b (U0 - v_i S0) - (U_b - v_i S_b); dV[a][b] = -(C F_a)_b
    __device__ static void store(const float* J, const float*, long long ns,
                                 long long islot, const float* mine, int T,
                                 const float (&acc)[NC], bool ok,
                                 const PairParams&, float* out)
    {
        float C[3][3];
        iad_tail(acc[0], acc[1], acc[2], acc[3], acc[4], acc[5], JI(3), C);
        const float* mom = acc + 6;
        const float S0 = mom[0];
        float dV[3][3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const float vi = mine[(I_VIC + q) * T];
            const float U0 = mom[4 * (q + 1)];
            float F[3];
#pragma unroll
            for (int b = 0; b < 3; ++b)
                F[b] = mine[(I_XIB + b) * T] * (U0 - vi * S0)
                    - (mom[4 * (q + 1) + 1 + b] - vi * mom[1 + b]);
#pragma unroll
            for (int b = 0; b < 3; ++b)
                dV[q][b] = -(C[b][0] * F[0] + C[b][1] * F[1]
                             + C[b][2] * F[2]);
        }
        iad_store(C, dV, mine[I_KFAC * T] / JI(5), ok, out, islot, ns);
    }
};

// stage 3 (K6): AV switches (signal speed, graddivv, alpha update)
struct AvStage {
    // x y z c divv vx vy vz (J rows 0-2, 5, 8-11), then vol_j
    static constexpr int X = 0, Y = 1, Z = 2, C = 3, DIVV = 4, VX = 5,
                         VY = 6, VZ = 7;
    static constexpr int NCOPY = 8, VOLJ = 8, NROW = 9;
    __device__ static int jrow(int r)
    {
        return r < 3 ? r : (r == 3 ? 5 : r + 4);
    }
    enum : int { I_X, I_Y, I_Z, I_HINV2, I_KFAC, I_C, I_DIVV, I_VX, I_VY,
                 I_VZ, I_C11, NI = I_C11 + 6 };
    // each lane evaluates its own in-support pairs; gx gy gz (sums),
    // vsig (a max). The support tests unrolled by 4: 2.65-2.66 ms at 96
    // registers, no spill; by 2 2.67-2.70, by 1 2.76-2.79 (as K4's)
    static constexpr bool COMPACT = false;
    static constexpr int NE = 2, NC = 4, NLOAD = 0, FO = 1,
                         TEST_UNROLL = 4;

    __device__ static float fill(int) { return 0.0f; }

    __device__ static void load_i(const float* J, const float* I2,
                                  long long ns, long long islot, bool ihas,
                                  const PairParams& p, float (&iv)[NI])
    {
        const float hinv = __fdiv_rn(1.0f, JI(3));
        const float hinv2 = __fmul_rn(hinv, hinv);
        iv[I_X] = ihas ? JI(0) : SPH_FILL_POS;
        iv[I_Y] = JI(1);
        iv[I_Z] = JI(2);
        iv[I_HINV2] = hinv2;
        iv[I_KFAC] = p.K3d * (hinv * hinv2);
        iv[I_C] = JI(5);
        iv[I_DIVV] = JI(8);
        iv[I_VX] = JI(9);
        iv[I_VY] = JI(10);
        iv[I_VZ] = JI(11);
#pragma unroll
        for (int r = 0; r < 6; ++r) iv[I_C11 + r] = I2[r * ns + islot];
    }

    __device__ static void load_e(const float* J, long long ns, long long s,
                                  float (&e)[NE])
    {
        e[0] = J[6 * ns + s];        // kx
        e[1] = J[7 * ns + s];        // xm
    }

    __device__ static void finish(float* d, int T, const float (&e)[NE])
    {
        d[VOLJ * T] = e[1] / e[0];
    }

    __device__ static void init(float (&acc)[NC])
    {
        acc[0] = acc[1] = acc[2] = 0.0f;
        acc[3] = SPH_NEG;
    }

    __device__ static void add(float (&acc)[NC], const float (&v)[NC])
    {
#pragma unroll
        for (int q = 0; q < 3; ++q) acc[q] += v[q];
        acc[3] = fmaxf(acc[3], v[3]);
    }

    // graddivv's three terms and the pair's approaching signal speed
    // (SPH_NEG where the pair recedes: no term of the max)
    __device__ static void terms(const float* a, const float* sb, int T,
                                 int k, const PairParams& p,
                                 float (&c)[NC])
    {
        const float rx = __fsub_rn(A(I_X), S(X)),
                    ry = __fsub_rn(A(I_Y), S(Y)),
                    rz = __fsub_rn(A(I_Z), S(Z));
        const float d2 = dist2(rx, ry, rz);
        const float v2 = __fmul_rn(d2, A(I_HINV2));
        const float rv = rx * (A(I_VX) - S(VX)) + ry * (A(I_VY) - S(VY))
            + rz * (A(I_VZ) - S(VZ));
        c[3] = rv < 0.0f
            ? A(I_C) + S(C) - 3.0f * rv * rsqrtf(fmaxf(d2, 1e-30f))
            : SPH_NEG;
        const float w = pow_nw(sinc_poly(v2), p.n_w) * A(I_KFAC);
        const float c11 = A(I_C11), c12 = A(I_C11 + 1), c13 = A(I_C11 + 2),
                    c22 = A(I_C11 + 3), c23 = A(I_C11 + 4),
                    c33 = A(I_C11 + 5);
        const float tA1 = -(c11 * rx + c12 * ry + c13 * rz) * w;
        const float tA2 = -(c12 * rx + c22 * ry + c23 * rz) * w;
        const float tA3 = -(c13 * rx + c23 * ry + c33 * rz) * w;
        const float factor = S(VOLJ) * (A(I_DIVV) - S(DIVV));
        c[0] = factor * tA1;
        c[1] = factor * tA2;
        c[2] = factor * tA3;
    }

    __device__ static void store(const float* J, const float* I2,
                                 long long ns, long long islot,
                                 const float* mine, int T,
                                 const float (&acc)[NC], bool ok,
                                 const PairParams& p, float* out)
    {
        const float ci = mine[I_C * T];
        const float alpha = alpha_tail(
            I2, islot, ns, p,
            sqrtf(acc[0] * acc[0] + acc[1] * acc[1] + acc[2] * acc[2]),
            fmaxf(acc[3], 1e-30f * ci), mine[I_DIVV * T], JI(3), ci);
        out[islot] = ok ? alpha : fill(0);
    }
};

// stage 6 (K9): AV switches with graddivv from 8 cell-centred
// j-moments (_av_mm_body's contraction, summed per lane)
struct AvMmStage {
    // x y z c vx vy vz (J rows 0-2, 5, 9-11), then the j-only columns
    // vol_j, vol_j x_jc (three), vd_j, vd_j x_jc (three)
    static constexpr int X = 0, Y = 1, Z = 2, C = 3, VX = 4, VY = 5,
                         VZ = 6;
    static constexpr int NCOPY = 7, COL = 7, NM = 8, NROW = NCOPY + NM;
    __device__ static int jrow(int r)
    {
        return r < 3 ? r : (r == 3 ? 5 : r + 5);
    }
    // the expansion origin (cell_means): the mean x y z divv
    static constexpr int NORIGIN = 4;
    __device__ static int orow(int r) { return r < 3 ? r : 8; }
    enum : int { I_X, I_Y, I_Z, I_HINV2, I_KFAC, I_C, I_DIVV, I_VX, I_VY,
                 I_VZ, I_XIB, I_DVIC = I_XIB + 3, I_C11, NI = I_C11 + 6 };
    // each lane evaluates its own in-support pairs: the 8 moment sums,
    // then vsig (a max); the support tests unrolled by 4 (K6's)
    static constexpr bool COMPACT = false;
    static constexpr int NE = 6, NC = NM + 1, NLOAD = 0, FO = 1,
                         TEST_UNROLL = 4;

    __device__ static float fill(int) { return 0.0f; }

    __device__ static void load_i(const float* J, const float* I2,
                                  long long ns, long long islot, bool ihas,
                                  const PairParams& p, float (&iv)[NI],
                                  const float* org)
    {
        const float hinv = __fdiv_rn(1.0f, JI(3));
        const float hinv2 = __fmul_rn(hinv, hinv);
        iv[I_X] = ihas ? JI(0) : SPH_FILL_POS;
        iv[I_Y] = JI(1);
        iv[I_Z] = JI(2);
        iv[I_HINV2] = hinv2;
        iv[I_KFAC] = p.K3d * (hinv * hinv2);
        iv[I_C] = JI(5);
        iv[I_DIVV] = JI(8);
        iv[I_VX] = JI(9);
        iv[I_VY] = JI(10);
        iv[I_VZ] = JI(11);
#pragma unroll
        for (int b = 0; b < 3; ++b) iv[I_XIB + b] = JI(b) - org[b];
        iv[I_DVIC] = JI(8) - org[3];
#pragma unroll
        for (int r = 0; r < 6; ++r) iv[I_C11 + r] = I2[r * ns + islot];
    }

    __device__ static void load_e(const float* J, long long ns, long long s,
                                  float (&e)[NE])
    {
        e[0] = J[6 * ns + s];        // kx
        e[1] = J[7 * ns + s];        // xm
        e[2] = J[8 * ns + s];        // divv
#pragma unroll
        for (int b = 0; b < 3; ++b) e[3 + b] = J[b * ns + s];   // x y z
    }

    // the JAX body's cols: volj, volj * xjc, ..., vd, vd * xjc, ...
    __device__ static void finish(float* d, int T, const float (&e)[NE],
                                  const float* org)
    {
        const float volj = e[1] / e[0];
        const float vd = volj * (e[2] - org[3]);
        d[COL * T] = volj;
        d[(COL + 4) * T] = vd;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            const float xc = e[3 + b] - org[b];
            d[(COL + 1 + b) * T] = volj * xc;
            d[(COL + 5 + b) * T] = vd * xc;
        }
    }

    __device__ static void init(float (&acc)[NC])
    {
#pragma unroll
        for (int q = 0; q < NM; ++q) acc[q] = 0.0f;
        acc[NM] = SPH_NEG;
    }

    __device__ static void add(float (&acc)[NC], const float (&v)[NC])
    {
#pragma unroll
        for (int q = 0; q < NM; ++q) acc[q] += v[q];
        acc[NM] = fmaxf(acc[NM], v[NM]);
    }

    // W_ij times the 8 columns, and the pair's approaching signal speed
    // (SPH_NEG where the pair recedes)
    __device__ static void terms(const float* a, const float* sb, int T,
                                 int k, const PairParams& p,
                                 float (&c)[NC])
    {
        const float rx = __fsub_rn(A(I_X), S(X)),
                    ry = __fsub_rn(A(I_Y), S(Y)),
                    rz = __fsub_rn(A(I_Z), S(Z));
        const float d2 = dist2(rx, ry, rz);
        const float v2 = __fmul_rn(d2, A(I_HINV2));
        const float rv = rx * (A(I_VX) - S(VX)) + ry * (A(I_VY) - S(VY))
            + rz * (A(I_VZ) - S(VZ));
        c[NM] = rv < 0.0f
            ? A(I_C) + S(C) - 3.0f * rv * rsqrtf(fmaxf(d2, 1e-30f))
            : SPH_NEG;
        const float w = pow_nw(sinc_poly(v2), p.n_w);
#pragma unroll
        for (int m = 0; m < NM; ++m) c[m] = w * S(COL + m);
    }

    // G_b = xi_b (dvic S0 - D0) - (dvic S_b - D_b), graddivv = |-(C G)|
    // K3d h^-3, then the alpha update
    __device__ static void store(const float* J, const float* I2,
                                 long long ns, long long islot,
                                 const float* mine, int T,
                                 const float (&acc)[NC], bool ok,
                                 const PairParams& p, float* out)
    {
        const float dvic = mine[I_DVIC * T];
        float G[3], c[6];
#pragma unroll
        for (int b = 0; b < 3; ++b)
            G[b] = mine[(I_XIB + b) * T] * (dvic * acc[0] - acc[4])
                - (dvic * acc[1 + b] - acc[5 + b]);
#pragma unroll
        for (int r = 0; r < 6; ++r) c[r] = mine[(I_C11 + r) * T];
        const float scale = mine[I_KFAC * T];
        const float gx = -(c[0] * G[0] + c[1] * G[1] + c[2] * G[2]) * scale;
        const float gy = -(c[1] * G[0] + c[3] * G[1] + c[4] * G[2]) * scale;
        const float gz = -(c[2] * G[0] + c[4] * G[1] + c[5] * G[2]) * scale;
        const float ci = mine[I_C * T];
        const float alpha = alpha_tail(
            I2, islot, ns, p, sqrtf(gx * gx + gy * gy + gz * gz),
            fmaxf(acc[NM], 1e-30f * ci), mine[I_DIVV * T], JI(3), ci);
        out[islot] = ok ? alpha : fill(0);
    }
};

// stages 4 and 8 (K7, K7c): momentum and energy
template <bool AvClean>
struct MomStage {
    // x y z vx vy vz c rho xm alpha m c11..c33 [d11..d33], then the
    // j-only terms
    static constexpr int X = 0, Y = 1, Z = 2, VX = 3, VY = 4, VZ = 5, C = 6,
                         RHO = 7, XM = 8, AL = 9, M = 10, C11 = 11, D11 = 17;
    static constexpr int NCOPY = AvClean ? 23 : 17;
    static constexpr int HINV = NCOPY, HINV2 = NCOPY + 1, HINV3 = NCOPY + 2,
                         LXM = NCOPY + 3, MRHO = NCOPY + 4,
                         MPRHO = NCOPY + 5;
    static constexpr int NROW = NCOPY + 6;
    __device__ static int jrow(int r)
    {
        return r < 3 ? r : (r < 6 ? r + 2 : (r == 6 ? 8 : r + 3));
    }
    enum : int {
        I_X, I_Y, I_Z, I_HINV2, I_HI3, I_C, I_AL, I_RHO, I_RHOINV, I_PRHO,
        I_XM, I_LXM, I_VX, I_VY, I_VZ, I_C11, I_HINV = I_C11 + 6, I_D11,
        I_ETA = I_D11 + 6
    };
    static constexpr int NI = AvClean ? I_ETA + 1 : I_HINV;
    // pairs compacted across lanes; mx my mz energy avisc (sums), vsig
    // (a max)
    static constexpr bool COMPACT = true;
    static constexpr int NE = 5, NC = 6, NLOAD = 4, FO = 5, TEST_UNROLL = 4;

    __device__ static float fill(int) { return 0.0f; }

    __device__ static void load_i(const float* J, const float*, long long ns,
                                  long long islot, bool ihas,
                                  const PairParams&, float (&iv)[NI])
    {
        const float hi = JI(3);
        const float hinv = __fdiv_rn(1.0f, hi);
        const float hinv2 = __fmul_rn(hinv, hinv);
        iv[I_X] = ihas ? JI(0) : SPH_FILL_POS;
        iv[I_Y] = JI(1);
        iv[I_Z] = JI(2);
        iv[I_HINV2] = hinv2;
        iv[I_HI3] = hinv * hinv2;
        iv[I_C] = JI(8);
        iv[I_AL] = JI(12);
        iv[I_RHO] = JI(10);
        iv[I_RHOINV] = 1.0f / iv[I_RHO];
        iv[I_PRHO] = JI(9);
        iv[I_XM] = JI(11);
        iv[I_LXM] = logf(iv[I_XM]);
        iv[I_VX] = JI(5);
        iv[I_VY] = JI(6);
        iv[I_VZ] = JI(7);
#pragma unroll
        for (int r = 0; r < 6; ++r) iv[I_C11 + r] = JI(14 + r);
        if constexpr (AvClean) {
            iv[I_HINV] = hinv;
#pragma unroll
            for (int r = 0; r < 6; ++r) iv[I_D11 + r] = JI(20 + r);
            iv[I_ETA] = JI(26);
        }
    }

    __device__ static void load_e(const float* J, long long ns, long long s,
                                  float (&e)[NE])
    {
        e[0] = J[3 * ns + s];        // h
        e[1] = J[9 * ns + s];        // prho
        e[2] = J[11 * ns + s];       // xm
        e[3] = J[13 * ns + s];       // m
        e[4] = J[10 * ns + s];       // rho
    }

    __device__ static void finish(float* d, int T, const float (&e)[NE])
    {
        const float hj_inv = 1.0f / e[0];
        d[HINV * T] = hj_inv;
        d[HINV2 * T] = hj_inv * hj_inv;
        d[HINV3 * T] = hj_inv * hj_inv * hj_inv;
        d[LXM * T] = logf(e[2]);
        d[MRHO * T] = e[3] / e[4];
        d[MPRHO * T] = e[3] * e[1];
    }

    __device__ static void init(float (&acc)[NC])
    {
#pragma unroll
        for (int q = 0; q < 5; ++q) acc[q] = 0.0f;
        acc[5] = SPH_NEG;
    }

    __device__ static void add(float (&acc)[NC], const float (&v)[NC])
    {
#pragma unroll
        for (int q = 0; q < 5; ++q) acc[q] += v[q];
        acc[5] = fmaxf(acc[5], v[5]);
    }

    // the six contributions of pair (i, k): mx, my, mz, energy, avisc,
    // vsig (arithmetic of the former per-pair body, on the staged j-only
    // terms)
    __device__ static void terms(const float* a, const float* sb, int T,
                                 int k, const PairParams& p,
                                 float (&c)[NC])
    {
        const float rx = __fsub_rn(A(I_X), S(X)),
                    ry = __fsub_rn(A(I_Y), S(Y)),
                    rz = __fsub_rn(A(I_Z), S(Z));
        const float d2 = dist2(rx, ry, rz);
        const float v2i = __fmul_rn(d2, A(I_HINV2));
        const float hj_inv = S(HINV);
        const float v2j = d2 * S(HINV2);
        const float Wi = w_v2(v2i, p.n_w) * A(I_HI3);
        const float Wj = w_v2(v2j, p.n_w) * S(HINV3);

        const float tAi0 = -(A(I_C11 + 0) * rx + A(I_C11 + 1) * ry
                             + A(I_C11 + 2) * rz) * Wi;
        const float tAi1 = -(A(I_C11 + 1) * rx + A(I_C11 + 3) * ry
                             + A(I_C11 + 4) * rz) * Wi;
        const float tAi2 = -(A(I_C11 + 2) * rx + A(I_C11 + 4) * ry
                             + A(I_C11 + 5) * rz) * Wi;
        const float tAj0 = -(S(C11) * rx + S(C11 + 1) * ry
                             + S(C11 + 2) * rz) * Wj;
        const float tAj1 = -(S(C11 + 1) * rx + S(C11 + 3) * ry
                             + S(C11 + 4) * rz) * Wj;
        const float tAj2 = -(S(C11 + 2) * rx + S(C11 + 4) * ry
                             + S(C11 + 5) * rz) * Wj;

        const float vx_ij = A(I_VX) - S(VX), vy_ij = A(I_VY) - S(VY),
                    vz_ij = A(I_VZ) - S(VZ);
        float rv = rx * vx_ij + ry * vy_ij + rz * vz_ij;
        const float inv_d = rsqrtf(fmaxf(d2, 1e-30f));
        if constexpr (AvClean) {
            // the quadratic forms as the JAX body writes them: the gradv
            // off-diagonals are symmetrised sums (q2 = d22 ry + d23 rz,
            // q3 = d33 rz)
            auto quad = [&](float d11, float d12, float d13, float d22,
                            float d23, float d33) {
                float q1 = d11 * rx + d12 * ry + d13 * rz;
                float q2 = d22 * ry + d23 * rz;
                float q3 = d33 * rz;
                return rx * q1 + ry * q2 + rz * q3;
            };
            float dmy1 = quad(A(I_D11), A(I_D11 + 1), A(I_D11 + 2),
                              A(I_D11 + 3), A(I_D11 + 4), A(I_D11 + 5));
            float dmy2 = quad(S(D11), S(D11 + 1), S(D11 + 2), S(D11 + 3),
                              S(D11 + 4), S(D11 + 5));
            float dist = d2 * inv_d;
            float eta_ab = dist * fminf(A(I_HINV), hj_inv);
            float eta_diff = 5.0f * (eta_ab - A(I_ETA));
            float dmy3 = eta_ab < A(I_ETA) ? expf(-eta_diff * eta_diff)
                                           : 1.0f;
            float A_ab = dmy2 != 0.0f ? dmy1 / dmy2 : 0.0f;
            float A_abp1 = 1.0f + A_ab;
            float phi = 0.5f * dmy3
                * fminf(fmaxf(4.0f * A_ab / (A_abp1 * A_abp1), 0.0f), 1.0f);
            rv = rv - phi * (dmy1 + dmy2);
        }
        const float wij = rv * inv_d;
        const float ci = A(I_C), csum = ci + S(C);
        const float vij_signal =
            (A(I_AL) + S(AL)) * 0.25f * csum - 2.0f * wij;
        const float visc = wij < 0.0f ? -vij_signal * wij : 0.0f;
        c[5] = d2 > 0.0f ? 0.5f * csum - 2.0f * wij : SPH_NEG;

        const float rhoi = A(I_RHO), xmi = A(I_XM);
        const float mj = S(M), xmj = S(XM), rhoj = S(RHO);
        const float drho = fabsf(rhoi - rhoj);
        const float srho = rhoi + rhoj;
        const float sigma = p.ramp * (drho / srho - p.atmin);
        const float lxmj = S(LXM), lxmi = A(I_LXM);
        const float prod = xmi * xmj;
        float a_mom, b_mom;
        if (p.uniform_mass) {
            float sc = fminf(fmaxf(sigma, 0.0f), 1.0f);
            float ep, em;
            exp_pair((1.0f - sc) * (lxmj - lxmi), ep, em);
            a_mom = prod * em;
            b_mom = prod * ep;
        } else {
            bool is_lo = drho < p.atmin * srho;
            bool is_hi = drho > p.atmax * srho;
            float t = expf((sigma - 1.0f) * (lxmj - lxmi));
            a_mom = is_lo ? xmi * xmi : (is_hi ? prod : prod * t);
            b_mom = is_lo ? xmj * xmj : (is_hi ? prod : prod / t);
        }

        const float a_visc = (mj * A(I_RHOINV)) * visc;
        const float b_visc = S(MRHO) * visc;
        const float avx = 0.5f * (a_visc * tAi0 + b_visc * tAj0);
        const float avy = 0.5f * (a_visc * tAi1 + b_visc * tAj1);
        const float avz = 0.5f * (a_visc * tAi2 + b_visc * tAj2);
        c[4] = avx * vx_ij + avy * vy_ij + avz * vz_ij;
        c[3] = mj * a_mom * (vx_ij * tAi0 + vy_ij * tAi1 + vz_ij * tAi2);
        const float mom_i = mj * A(I_PRHO) * a_mom;
        const float mom_j = S(MPRHO) * b_mom;
        c[0] = mom_i * tAi0 + mom_j * tAj0 + avx;
        c[1] = mom_i * tAi1 + mom_j * tAj1 + avy;
        c[2] = mom_i * tAi2 + mom_j * tAj2 + avz;
    }

    __device__ static void store(const float*, const float*, long long ns,
                                 long long islot, const float* mine, int T,
                                 const float (&acc)[NC], bool ok,
                                 const PairParams& p, float* out)
    {
        const float K3d = p.K3d;
        const float du = K3d * (mine[I_PRHO * T] * acc[3]
                                + 0.5f * fmaxf(acc[4], 0.0f));
        const float o[5] = {-K3d * acc[0], -K3d * acc[1], -K3d * acc[2], du,
                            fmaxf(acc[5], 0.0f)};
#pragma unroll
        for (int r = 0; r < 5; ++r) out[r * ns + islot] = ok ? o[r] : fill(r);
    }
};
#undef S
#undef A

// a Stage's origin floats: NORIGIN where it has one, else 0
template <class St, class = void>
struct Origin {
    static constexpr int N = 0;
};
template <class St>
struct Origin<St, std::void_t<decltype(St::NORIGIN)>> {
    static constexpr int N = St::NORIGIN;
};

// floats of shared memory a block of T threads takes
template <class St>
__host__ __device__ constexpr int smem_floats(int T)
{
    return 2 * St::NROW * T + (T / 32) * (St::COMPACT ? St::NC * 64 : 0)
        + 2 * (T / 32) + St::NI * T + Origin<St>::N;
}

// one interior cell `own`, the i-tile blockIdx.y, blockDim.x == T
template <class St>
__device__ __noinline__ void pair_cell(const float* __restrict__ J,
                                       const float* __restrict__ I2,
                                       float* __restrict__ out,
                                       const PairGeom g, const PairParams p,
                                       const long long own, const int vec)
{
    constexpr int NROW = St::NROW, NI = St::NI, NC = St::NC;
    constexpr int NE = St::NE > 0 ? St::NE : 1;      // j-only sources
    constexpr int NCS = St::COMPACT ? NC * 64 : 0;   // contributions a warp
    extern __shared__ __align__(16) float msm[];
    const int cap = g.cap;
    const long long ns = g.n_slots;
    const int T = cap < TILE ? cap : TILE;
    const int nt = (cap + T - 1) / T;
    const int t = threadIdx.x, lane = t & 31, w = t >> 5, nw = T >> 5;
    float* const tiles = msm;                             // [2][NROW][T]
    float* const C = msm + 2 * NROW * T + w * NCS;        // [NC][64]
    int* const lastv = reinterpret_cast<int*>(msm + 2 * NROW * T
                                              + nw * NCS);       // [2][nw]
    float* const ist = msm + 2 * NROW * T + nw * NCS + 2 * nw;
    float* const org = ist + NI * T;              // [Origin<St>::N]
    constexpr bool ORG = Origin<St>::N > 0;

    // the own cell's origin (K8's; with a barrier)
    if constexpr (ORG) cell_means<St>(J, own * cap, cap, ns, org);
    // the i side
    const int ti = blockIdx.y * T + t;
    const bool ihas = ti < cap;
    const long long islot = own * cap + (ihas ? ti : 0);
    float iv[NI];
    if constexpr (ORG)
        St::load_i(J, I2, ns, islot, ihas, p, iv, org);
    else
        St::load_i(J, I2, ns, islot, ihas, p, iv);
    // the i-terms to shared memory ([NI][T]; a warp reads only its own
    // lanes' columns, so the next cell of K11 may overwrite them before
    // the barrier), the support test's kept in registers
#pragma unroll
    for (int q = 0; q < NI; ++q) ist[q * T + t] = iv[q];
    const float xi = iv[0], yi = iv[1], zi = iv[2], hinv2 = iv[3];
    const bool ivalid = xi < HALF_FILL;
    // also the barrier after the previous cell's last unit (K11)
    if (!__syncthreads_or(ivalid)) {
        if (ihas)
            for (int r = 0; r < St::FO; ++r) out[r * ns + islot] = St::fill(r);
        return;
    }
    const bool wactive = __ballot_sync(FULL, ivalid) != 0;

    // the units: neighbour cell nb = v / nt, its j-tile q = v % nt
    const int U = 27 * nt;
    auto tile_base = [&](int v) {
        const int nb = v / nt, q = v - nb * nt;
        return nbr_cell(g, own, nb) * cap + q * T;
    };
    auto tile_len = [&](int v) {
        const int q = v % nt;
        return min(T, cap - q * T);
    };
    auto xload = [&](int v) {
        return t < tile_len(v) ? J[tile_base(v) + t] : SPH_FILL_POS;
    };
    // stage unit v into its buffer: warp w's slot group, if occupied
    // (cp.async, committed as one group), and the sources of its j-only
    // terms into e; returns the warp's validity ballot
    auto issue = [&](int v, float xv, float (&e)[NE]) {
        const unsigned vm = __ballot_sync(FULL, xv < HALF_FILL);
        if (lane == 0)
            lastv[(v & 1) * nw + w] = vm ? 32 * w + 31 - __clz(vm) : -1;
        if (vm) {
            const long long b = tile_base(v) + 32 * w;
            float* dst = tiles + (v & 1) * NROW * T + 32 * w;
            if (vec) {
                const int seg = (lane & 7) * 4;
                for (int r = lane >> 3; r < St::NCOPY; r += 4)
                    cp_async16(dst + r * T + seg,
                               J + (long long)St::jrow(r) * ns + b + seg);
            } else {
                for (int r = 0; r < St::NCOPY; ++r)
                    cp_async4(dst + r * T + lane,
                              J + (long long)St::jrow(r) * ns + b + lane);
            }
            if constexpr (St::NE > 0) St::load_e(J, ns, b + lane, e);
        }
        cp_async_commit();
        return vm;
    };
    // the j-only terms of unit v
    auto finish = [&](int v, unsigned vm, const float (&e)[NE]) {
        float* const d = tiles + (v & 1) * NROW * T + 32 * w + lane;
        if constexpr (ORG) {
            if (vm) St::finish(d, T, e, org);
        } else if constexpr (St::NE > 0) {
            if (vm) St::finish(d, T, e);
        }
    };

    float acc[NC];
    St::init(acc);
    float e[NE];
    {
        const float x0 = xload(0);
        finish(0, issue(0, x0, e), e);
    }
    float xn1 = U > 1 ? xload(1) : SPH_FILL_POS;
    for (int v = 0; v < U; ++v) {
        cp_async_wait_all();
        __syncthreads();
        unsigned vmn = 0;
        if (v + 1 < U) vmn = issue(v + 1, xn1, e);
        const float xn2 = v + 2 < U ? xload(v + 2) : SPH_FILL_POS;
        const float* sb = tiles + (v & 1) * NROW * T;
        int kmax = -1;
        for (int q = 0; q < nw; ++q) kmax = max(kmax, lastv[(v & 1) * nw + q]);
        ++kmax;
        for (int k0 = 0; wactive && k0 < kmax; k0 += 32) {
            const int kn = min(32, kmax - k0);
            unsigned m = 0;
            if (ivalid) {
                constexpr int UT = St::TEST_UNROLL;
#pragma unroll UT
                for (int b = 0; b < kn; ++b) {
                    const int k = k0 + b;
                    const float d2 = dist2(__fsub_rn(xi, sb[St::X * T + k]),
                                           __fsub_rn(yi, sb[St::Y * T + k]),
                                           __fsub_rn(zi, sb[St::Z * T + k]));
                    if (__fmul_rn(d2, hinv2) < 4.0f) m |= 1u << b;
                }
            }
            if constexpr (!St::COMPACT) {
                // the lane's own pairs, in k order
                for (unsigned mm = m; mm; mm &= mm - 1) {
                    float c[NC];
                    St::terms(ist + t, sb, T, k0 + __ffs(mm) - 1, p, c);
                    St::add(acc, c);
                }
            } else {
                const int cnt = __popc(m);
                int incl = cnt;
#pragma unroll
                for (int s = 1; s < 32; s <<= 1) {
                    const int y = __shfl_up_sync(FULL, incl, s);
                    if (lane >= s) incl += y;
                }
                const int total = __shfl_sync(FULL, incl, 31);
                const int off = incl - cnt;
                for (int p0 = 0; p0 < total; p0 += 64) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int pi = p0 + 32 * h + lane;
                        int l = 0;        // owner: last lane with off <= pi
#pragma unroll
                        for (int s = 16; s > 0; s >>= 1) {
                            const int o = __shfl_sync(FULL, off, l + s);
                            if (o <= pi) l += s;
                        }
                        const int r = pi - __shfl_sync(FULL, off, l);
                        const unsigned mm = __shfl_sync(FULL, m, l);
                        int bit = 0;          // the r-th set bit of mm
#pragma unroll
                        for (int s = 16; s > 0; s >>= 1)
                            if (__popc(mm & ((1u << (bit + s)) - 1u)) <= r)
                                bit += s;
                        if (pi < total) {
                            float c[NC];
                            St::terms(ist + 32 * w + l, sb, T, k0 + bit, p, c);
#pragma unroll
                            for (int q = 0; q < NC; ++q)
                                C[q * 64 + 32 * h + lane] = c[q];
                        }
                    }
                    __syncwarp();
                    const int lo = max(off, p0) - p0;
                    const int hi = min(off + cnt, p0 + 64) - p0;
                    // NLOAD entries' loads in flight, then their adds in
                    // order
                    for (int s = lo; s < hi; s += St::NLOAD) {
                        float vv[St::NLOAD][NC];
#pragma unroll
                        for (int u = 0; u < St::NLOAD; ++u)
#pragma unroll
                            for (int q = 0; q < NC; ++q)
                                vv[u][q] = s + u < hi ? C[q * 64 + s + u]
                                                      : 0.0f;
#pragma unroll
                        for (int u = 0; u < St::NLOAD; ++u)
                            if (s + u < hi) St::add(acc, vv[u]);
                    }
                    __syncwarp();
                }
            }
        }
        if (v + 1 < U) finish(v + 1, vmn, e);
        xn1 = xn2;
    }

    if (ihas) St::store(J, I2, ns, islot, ist + t, T, acc, ivalid, p, out);
}

// the cell launch, K2g (Gated: the cells of the gate pass's list) and
// K11's stream form (Column); blockIdx.y is the i-tile
template <class St, bool Gated, bool Column>
__global__ void __launch_bounds__(TILE)
cell_tile(const float* __restrict__ J, const float* __restrict__ I2,
          float* __restrict__ out, PairGeom g, PairParams p, PairGate gt,
          int zseg, int vec)
{
    if constexpr (Gated) {
        const long long own = gate_cell(gt);
        if (own >= 0) pair_cell<St>(J, I2, out, g, p, own, vec);
        gate_copy<St::FO>(gt, g, out);
    } else {
        const Walk w = block_walk<Column>(g, zseg);
        for (int q = 0; q < w.ncell; ++q)
            pair_cell<St>(J, I2, out, g, p, w.own0 + q, vec);
    }
}

}  // namespace tile

// --------------------------------------------------------------------------
// stage 0 (K3): neighbour count, the nc -> h controller, xmass.
// Replaces _xh_body (pallas_ve.py:537): per i-slot the count of
// candidates inside its support, h_iter rounds of the controller (a
// slot outside [ng0/4, ngmax] takes h 0.5 (1 + 1023 ng0 / nc)^0.1, capped
// at h_cap), a count at each new h but the last, and the final count and
// xmass sum (W(v)^n_w m_j over the support) at the last h.
//
// Bound: arithmetic, 9 flops a candidate for the distance and the
// support test, 18 more inside the support; a recount at a new h is one
// multiply and a compare a candidate where d2 is kept (the bound of
// chip_smoke.py counts one distance pass and the recounts).
//
// One device routine, xh_cell, computes the interior cells of a block
// for every launch form (the cell launch and K2g one cell, K11 a
// z-segment), so those equal each other bit for bit. A block of T =
// min(cap, 128) threads takes one i-tile of the cell (blockIdx.y):
//  1. Occupied slots, one flat run. Each warp ballots x < HALF_FILL over
//     the 32-slot groups of the 27 neighbour cells; warp 0 lists the
//     occupied groups in nb-then-slot order, and the block stages their
//     x, y, z, m as float4 into one run in shared memory, a window of 27
//     groups (13.8 KB) at a time: a run that fits stays resident across
//     the walks, a longer one is staged and walked window after window,
//     in order. At Sedov 100^3 (cap 64, ~2 groups a cell) the run takes
//     two windows; a window of 54 groups (the whole run, 27.6 KB a
//     block) took K3 2.13 ms against 1.46 (half the blocks an SM), one
//     of 18 groups 1.42 (trial variants, chip_smoke.py's timing on
//     NVIDIA H100 80GB HBM3, 700 W). A slot left invalid in a staged
//     group fails the support test (FILL_POS).
//  2. Walks only where h moved. A walk computes a lane's count and its
//     xmass sum (in run order, the cell launch's nb-then-slot order) at
//     its current h. The count depends only on the bits of 1/h^2, and a
//     lane whose `need` is false keeps its h, so a lane walks at the
//     first count and then only at the count after a round that changed
//     the bits of its h; the final pass is the last walk's count and
//     sum. A warp with no such lane skips the walk. With no h moving
//     (the Sedov 100^3 main path) each lane walks once, not 1 + h_iter
//     times. The xmass body stays a branch on the support test: testing
//     a chunk of 32 into a mask and then walking the mask's bits took
//     1.61 ms against 1.46 (same runs).
//  3. Invalid i-slots walk nothing. The frame puts every invalid slot at
//     FILL_POS (a periodic image's shift under 4 rounds back to it in
//     float32), so an invalid i counts exactly the invalid slots of its
//     27 cells at any h, 27 cap minus the ballots' valid slots; its h
//     follows the controller on that count, as in the plain version
//     (the engines keep their own h on invalid slots; xm, nc and nonconv
//     are masked there). A tile with no valid i-slot stages nothing.
// With p.stats set, each warp adds its lanes' walks, its warp walks and
// the candidates those walked (chip_smoke.py's count of the card's
// walks against xh_recounts).
// --------------------------------------------------------------------------
namespace xh {

using tile::FULL;
using tile::TILE;

constexpr int WIN_GROUPS = 27;   // 32-slot groups a window holds

__host__ __device__ constexpr int smem_bytes(int cap)
{
    return 16 * 32 * WIN_GROUPS + 4 * 2 * 27 * (cap / 32) + 4 * (1 + 4);
}

// one interior cell `own`, the i-tile blockIdx.y, blockDim.x == T
__device__ __forceinline__ void xh_one(const float* __restrict__ J,
                                       float* __restrict__ out,
                                       const PairGeom& g, const PairParams& p,
                                       const long long own)
{
    extern __shared__ __align__(16) float xsm[];
    const int cap = g.cap;
    const long long ns = g.n_slots;
    const int T = cap < TILE ? cap : TILE;
    const int t = threadIdx.x, lane = t & 31, w = t >> 5, nw = T >> 5;
    const int G = cap >> 5, NG = 27 * G;
    float4* const run = reinterpret_cast<float4*>(xsm);  // [32 WIN_GROUPS]
    unsigned* const vm = reinterpret_cast<unsigned*>(xsm + 4 * 32
                                                     * WIN_GROUPS);  // [NG]
    int* const list = reinterpret_cast<int*>(vm + NG);   // [NG]
    int* const cnt = list + NG;    // occupied groups, valid slots a warp

    const int ti = blockIdx.y * T + t;
    const bool ihas = ti < cap;
    const long long islot = own * cap + (ihas ? ti : 0);
    const float xi = ihas ? JI(0) : SPH_FILL_POS, yi = JI(1), zi = JI(2),
                mi = JI(5);
    float hi = JI(3);
    const bool ivalid = xi < HALF_FILL;

    // 1. ballots, the list of occupied groups, the run
    __syncthreads();             // K11: the previous cell is done
    int nv = 0;
    for (int q = w; q < NG; q += nw) {
        const int nb = q / G;
        const unsigned m = __ballot_sync(
            FULL, J[nbr_cell(g, own, nb) * cap + 32 * (q - nb * G) + lane]
                      < HALF_FILL);
        if (lane == 0) vm[q] = m;
        nv += __popc(m);
    }
    if (lane == 0) cnt[1 + w] = nv;
    const bool anyi = __syncthreads_or(ivalid);
    if (anyi && w == 0) {
        int base = 0;
        for (int c0 = 0; c0 < NG; c0 += 32) {
            const int q = c0 + lane;
            const bool f = q < NG && vm[q] != 0u;
            const unsigned b = __ballot_sync(FULL, f);
            if (f) list[base + __popc(b & ((1u << lane) - 1u))] = q;
            base += __popc(b);
        }
        if (lane == 0) cnt[0] = base;
    }
    __syncthreads();
    const int nocc = cnt[0];
    int nvalid = 0;
    for (int u = 0; u < nw; ++u) nvalid += cnt[1 + u];
    const float ninv = (float)(27 * cap - nvalid);

    // groups [o0, o1) of the list into run[0, 32 (o1 - o0))
    auto stage = [&](int o0, int o1) {
        for (int o = o0 + w; o < o1; o += nw) {
            const int q = list[o], nb = q / G;
            const long long s = nbr_cell(g, own, nb) * cap
                + 32 * (q - nb * G) + lane;
            run[32 * (o - o0) + lane] =
                make_float4(J[s], J[ns + s], J[2 * ns + s], J[5 * ns + s]);
        }
    };
    const bool resident = nocc <= WIN_GROUPS;
    if (anyi && resident) {
        stage(0, nocc);
        __syncthreads();
    }

    // 2. the walks: count and xmass sum over run[0, n) at hinv2
    auto walk_run = [&](int n, float hinv2, float& nc, float& acc) {
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
            const float4 c = run[k];
            const float v2 = __fmul_rn(dist2(__fsub_rn(xi, c.x),
                                             __fsub_rn(yi, c.y),
                                             __fsub_rn(zi, c.z)), hinv2);
            if (v2 < 4.0f) {
                acc += pow_nw(sinc_poly(v2), p.n_w) * c.w;
                nc += 1.0f;
            }
        }
    };
    float ncnt = ninv, acc = 0.0f;     // valid lanes: their last walk's
    bool stale = ivalid;               // h moved since the last walk
    int nwalk = 0;
    unsigned long long wwalk = 0, wtests = 0;
    auto walk = [&](float hinv2) {
        if (!anyi) return;
        if (resident) {
            if (__any_sync(FULL, stale)) {
                ++wwalk;
                wtests += 32ull * nocc;
                if (stale) {
                    float c = 0.0f, a = 0.0f;
                    walk_run(32 * nocc, hinv2, c, a);
                    ncnt = c;
                    acc = a;
                    ++nwalk;
                }
            }
        } else if (__syncthreads_or(stale)) {
            if (__any_sync(FULL, stale)) {
                ++wwalk;
                wtests += 32ull * nocc;
            }
            float c = 0.0f, a = 0.0f;
            for (int o0 = 0; o0 < nocc; o0 += WIN_GROUPS) {
                const int o1 = min(nocc, o0 + WIN_GROUPS);
                stage(o0, o1);
                __syncthreads();
                if (stale) walk_run(32 * (o1 - o0), hinv2, c, a);
                __syncthreads();
            }
            if (stale) {
                ncnt = c;
                acc = a;
                ++nwalk;
            }
        }
        stale = false;
    };

    float hinv = __fdiv_rn(1.0f, hi);
    walk(__fmul_rn(hinv, hinv));
    float nc_sph = ncnt;
    for (int it = 0; it < p.h_iter; ++it) {
        const bool need = nc_sph < p.ngmin || nc_sph - 1.0f > p.ngmax;
        float h_new = __fmul_rn(
            __fmul_rn(hi, 0.5f),
            powf(__fadd_rn(1.0f, __fdiv_rn(p.hcoef, fmaxf(nc_sph, 1.0f))),
                 0.1f));
        if (p.h_cap > 0.0f) h_new = fminf(h_new, p.h_cap);
        const float h_old = hi;
        hi = need ? h_new : hi;
        hinv = __fdiv_rn(1.0f, hi);
        if (__float_as_uint(hi) != __float_as_uint(h_old)) stale = ivalid;
        if (it < p.h_iter - 1) {
            walk(__fmul_rn(hinv, hinv));
            nc_sph = ncnt;
        }
    }
    walk(__fmul_rn(hinv, hinv));       // lanes whose h moved last round
    const float nc = ncnt - 1.0f;                   // self excluded
    const float xm = mi * (hi * hi * hi) / (p.K3d * acc);
    const bool nonconv = nc + 1.0f < p.ngmin || nc > p.ngmax;
    if (ihas) {
        out[0 * ns + islot] = ivalid ? xm : 1.0f;
        out[1 * ns + islot] = hi;
        out[2 * ns + islot] = ivalid ? nc : 0.0f;
        out[3 * ns + islot] = ivalid && nonconv ? 1.0f : 0.0f;
    }
    if (p.stats != nullptr) {
        const unsigned lw = __reduce_add_sync(FULL, (unsigned)nwalk);
        if (lane == 0) {
            atomicAdd(p.stats, (unsigned long long)lw);
            atomicAdd(p.stats + 1, wwalk);
            atomicAdd(p.stats + 2, wtests);
        }
    }
}

// cells own0 .. own0 + ncell - 1 of a z-column (the cell launch and K2g
// one cell); the loop is inside the routine, so K11 keeps nothing live
// across the call
__device__ __noinline__ void xh_cell(const float* __restrict__ J,
                                     float* __restrict__ out,
                                     const PairGeom g, const PairParams p,
                                     const long long own0, const int ncell)
{
    for (int q = 0; q < ncell; ++q) xh_one(J, out, g, p, own0 + q);
}

// the cell launch, K2g (Gated) and K11 (Column); blockIdx.y is the
// i-tile
template <bool Gated, bool Column>
__global__ void __launch_bounds__(TILE)
cell_xh(const float* __restrict__ J, float* __restrict__ out, PairGeom g,
        PairParams p, PairGate gt, int zseg)
{
    if constexpr (Gated) {
        const long long own = gate_cell(gt);
        if (own >= 0) xh_cell(J, out, g, p, own, 1);
        gate_copy<4>(gt, g, out);
    } else {
        const Walk w = block_walk<Column>(g, zseg);
        xh_cell(J, out, g, p, w.own0, w.ncell);
    }
}

}  // namespace xh
#undef JI

// --------------------------------------------------------------------------
// stage 7 (K10): the momentum stage as five pair-weight families
// contracted with 49 cell-centred j-moment columns. Replaces
// _momentum_mm_body (pallas_ve.py:1190, dot :1326), with its own
// arithmetic (not K7's): exp with is_lo/is_hi for the Atwood ramp, visc
// masked by the support, i and j rows sanitised by validity, and with
// mxu_bf16 both operands rounded to bf16 (nearest even) before a float32
// accumulation (:1321-1325).
//
// Per i-slot the 5 x 49 sums S_f,k = sum_j L_f(i, j) M_k(j) are a matrix
// product [5 * cap, 27 cap] x [27 cap, 49] per cell, as the TPU body puts
// it on its matrix unit; here it runs on the tensor cores (mma.sync):
//   float32: m16n8k8 TF32 in the 3xTF32 split, a = a_hi + a_lo with each
//     part cvt.rna.tf32.f32, a_lo b_hi + a_hi b_lo + a_hi b_hi from a
//     zeroed accumulator, then added to the float32 sums (a single TF32
//     pass keeps about three digits, and the epilogue's centred moments
//     cancel; accumulating on the tensor core in place put the outputs
//     at up to 9.7e-5 of their scale from the plain version at Sedov
//     100^3, against 5.1e-5 this way, for 0.8 ms);
//   mxu_bf16: m16n8k16 bf16, one pass (a product of two bf16 values is
//     exact in float32).
// A block of 4 warps (128 threads) takes IB = 64 i-slots of one cell,
// warp w the 16-row i-tile w with all five families (cap > 64:
// ceil(cap / 64) blocks a cell, blockIdx.y; an i-block with no valid
// slot stores zeros and returns). It walks the occupied 32-slot groups
// of the 27 neighbour cells (a ballot each, listed in nb-then-slot
// order), a unit each, with one barrier a unit: the 20 J rows of unit
// v + 2 are copied with cp.async and the columns of unit v + 1 built
// while unit v is computed. Per unit and warp:
//   columns (float32 cores): warp w builds a quarter of the 49 columns
//     of the unit's 32 j-slots (padded to 56, seven n8 tiles) into the
//     next B buffer, TF32 hi and lo parts or bf16 values, once for all
//     five families; warp 3 also the slots' 1 / h and log(xm);
//   A (float32 cores): each lane tests the 16 (i, j) pairs of its
//     A-fragment positions (rows g, g + 8; columns t + 4m in float32,
//     2t (+1) and 2t + 8 (+1) a k-step in bf16) up to the unit's last
//     valid slot; the fragments of k-steps with an in-support pair are
//     zeroed, and the tile's in-support pairs, compacted across lanes
//     (K7's scan), each get their five weights (pair_weights)
//     written to their fragment positions, the signal speed max(vsig,
//     0) by a shared atomicMax on its row, and a bit per (k-step,
//     family) with a nonzero weight (warp vote);
//   B (tensor cores): for each k-step and family whose bit is set, the
//     A fragment (split into hi and lo in float32) against the seven B
//     tiles, into 5 x 7 x 4 accumulators that stay in registers across
//     the 27 cells. Blocks whose weights are all zero are skipped (at
//     Sedov 100^3 71% of the float32 blocks, 60% of the bf16); with
//     p.stats set the block adds its issued (i-tile, k-step, family)
//     blocks and the blocks of its staged k-steps (chip_smoke.py's
//     count against the count its inputs predict).
// The A fragments are the warp's own, so only the B columns and the
// staged rows are shared. The epilogue writes the fragments to shared
// memory, and mm::partial and EpiI contract each family with the i-side
// offsets and cij. One routine, mm_cell (__noinline__), serves the cell
// launch, K2g and K11, so they equal each other bit for bit.
// Bound: the pair work on the float32 cores. At Sedov 100^3 (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py --compare from trial copies of this
// file, one call) the float32 kernel took 20.6-21.1 ms with the tensor
// core accumulating in place: dropping the pair weights' arithmetic
// saved 4.5 ms, the tensor-core phase 8.5 (two of its three mma 4.0),
// the support tests 2.1 and the columns 1.5, so each phase costs
// several times its instruction count at the 8 warps an SM that the
// 5 x 28 accumulators (230-255 registers) leave. Measured against it in
// the same call: five warps a block, one a family, two barriers a unit
// (168 registers, 256 bytes spilled: 27.1 ms); bounding-box culling of
// (i-tile, k-step) blocks before the tests (22.1); producer and
// consumer warps (26.5); the compacted-pair float32-core variant, each
// lane owning (family, column) sums of the tile's rows (38.7).
// --------------------------------------------------------------------------
namespace mm {

using tile::FULL;

constexpr int NC = 49;             // moment columns
constexpr int NCP = 56;            // padded: seven n8 tiles
constexpr int NT = NCP / 8;
constexpr int NF = 5;              // pair-weight families
constexpr int IB = 64;             // i-slots a block
constexpr int NIT = IB / 16;       // 16-row i-tiles
constexpr int THREADS = 32 * NIT;  // warp w takes i-tile w
constexpr int UJ = 32;             // j-slots a unit
constexpr int NJR = 20;            // J rows staged (all of K10's)
// the i-terms of the pair weights (the JAX body's sanitised i columns),
// [NI][IB]
enum { IX, IY, IZ, IHINV2, IHI3, IVX, IVY, IVZ, IC, IAL, IRHO, IRHOINV,
       IPRHO, IXM, ILXM, NI };

// shared memory of a block, in 4-byte words: the main loop's A
// fragments (a warp's own), two B column buffers and three units of raw
// rows, which the epilogue's [NF][IB][NC] sums overlay; then the
// i-terms, the families' output shares, the signal speeds, the origin,
// a counter, and the ballots and list of the 27 * cap / 32 units
template <bool BF16>
struct Shape {
    static constexpr int KS = BF16 ? 16 : 8;        // j-slots a k-step
    static constexpr int NKS = UJ / KS;
    static constexpr int BPK = 16 / NKS;            // a lane's pairs a k-step
    static constexpr int LS = NIT * NF * NKS * 128;
    // float32: {hi, lo} pairs at [col][36]; bf16: [col][40] halves;
    // then the unit's j-only terms [2][UJ]
    static constexpr int BC = BF16 ? NCP * 20 : NCP * 72;
    static constexpr int BS = BC + 2 * UJ;
    static constexpr int MAIN = LS + 2 * BS + 3 * NJR * UJ;
    static constexpr int EPI = NF * IB * NC;
    static constexpr int UNION = MAIN > EPI ? MAIN : EPI;
    static constexpr int FIXED = NI * IB + 9 * IB + IB + 8 + 8;
};

template <bool BF16>
__host__ __device__ constexpr int smem_words(int cap)
{
    return Shape<BF16>::UNION + Shape<BF16>::FIXED + 2 * 27 * (cap / UJ);
}

// J rows of the origin: x y z vx vy vz
struct Rows {
    static constexpr int NORIGIN = 6;
    __device__ static int orow(int r) { return r < 3 ? r : r + 2; }
};

// the symmetric cij row of (a, b) (_momentum_mm_body's C6)
__host__ __device__ constexpr int c6(int a, int b)
{
    return a <= b ? (a == 0 ? b : a == 1 ? 2 + b : 5)
                  : (b == 0 ? a : b == 1 ? 2 + a : 5);
}

__device__ __forceinline__ uint32_t tf32(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x ~ hi + lo to about 2^-22 relative (3xTF32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo)
{
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A-fragment position e of a lane (g, t) in k-step ks: its row (0 or 8
// added to g) and its column in the unit. float32 (m16n8k8): a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); bf16 (m16n8k16),
// halves of a0..a3: (g, 2t + h), (g + 8, 2t + h), (g, 2t + 8 + h),
// (g + 8, 2t + 8 + h)
template <bool BF16>
__device__ __forceinline__ void frag_pos(int ks, int e, int t, int& dr,
                                         int& col)
{
    if constexpr (BF16) {
        const int k = e >> 1;
        dr = 8 * (k & 1);
        col = 16 * ks + 2 * t + (e & 1) + 8 * (k >> 1);
    } else {
        dr = 8 * (e & 1);
        col = 8 * ks + t + 4 * (e >> 1);
    }
}

// the i side of phase A (the JAX body's sanitised i columns) into
// IT[q * IB + r]
__device__ __forceinline__ void load_i(const float* J, long long islot,
                                       long long ns, bool ihas, float* IT,
                                       int r)
{
#define JI(q) J[(long long)(q) * ns + islot]
    const float xi = ihas ? JI(0) : SPH_FILL_POS;
    const float hinv = __fdiv_rn(1.0f, JI(3));
    const float hinv2 = __fmul_rn(hinv, hinv);
    const bool oki = xi < HALF_FILL;
    const float rhoi = oki ? JI(10) : 1.0f, xmi = oki ? JI(11) : 1.0f;
    const float v[NI] = {xi, JI(1), JI(2), hinv2, hinv * hinv2, JI(5),
                         JI(6), JI(7), oki ? JI(8) : 1.0f,
                         oki ? JI(12) : 0.0f, rhoi, 1.0f / rhoi,
                         oki ? JI(9) : 0.0f, xmi, logf(xmi)};
#undef JI
#pragma unroll
    for (int q = 0; q < NI; ++q) IT[q * IB + r] = v[q];
}

// the five weights of in-support pair (i-row r, unit slot c) and its
// signal speed (valid where d2 > 0); j rows sanitised by validity
__device__ __forceinline__ void pair_weights(const float* IT, int r,
                                             const float* Rb, int c,
                                             const float* JT,
                                             const PairParams& p,
                                             float (&l)[NF], float& vs,
                                             float& d2)
{
#define I(q) IT[(q) * IB + r]
#define S(q) Rb[(q) * UJ + c]
    const float rx = __fsub_rn(I(IX), S(0)), ry = __fsub_rn(I(IY), S(1)),
                rz = __fsub_rn(I(IZ), S(2));
    d2 = dist2(rx, ry, rz);
    const float v2i = __fmul_rn(d2, I(IHINV2));
    const float hj_inv = JT[c];                    // 1 / h_j
    const float v2j = d2 * (hj_inv * hj_inv);
    const float Wi = w_v2(v2i, p.n_w) * I(IHI3);
    const float Wj = w_v2(v2j, p.n_w) * (hj_inv * hj_inv * hj_inv);
    const float rv = rx * (I(IVX) - S(5)) + ry * (I(IVY) - S(6))
        + rz * (I(IVZ) - S(7));
    const float wij = rv * rsqrtf(fmaxf(d2, 1e-30f));
    const float csum = I(IC) + S(8);
    const float vij_signal = (I(IAL) + S(12)) * 0.25f * csum - 2.0f * wij;
    const float visc = wij < 0.0f ? -vij_signal * wij : 0.0f;
    vs = 0.5f * csum - 2.0f * wij;

    const bool ok = S(4) >= 0.0f;                  // gid
    const float mj = ok ? S(13) : 0.0f, xmj = ok ? S(11) : 1.0f,
                rhoj = ok ? S(10) : 1.0f, prhoj = ok ? S(9) : 0.0f;
    const float rhoi = I(IRHO), xmi = I(IXM);
    const float drho = fabsf(rhoi - rhoj);
    const float srho = rhoi + rhoj;
    const bool is_lo = drho < p.atmin * srho;
    const bool is_hi = drho > p.atmax * srho;
    const float sigma = p.ramp * (drho / srho - p.atmin);
    const float t = expf((sigma - 1.0f) * (JT[UJ + c] - I(ILXM)));
    const float prod = xmi * xmj;
    const float a_mom = is_lo ? xmi * xmi : (is_hi ? prod : prod * t);
    const float b_mom = is_lo ? xmj * xmj : (is_hi ? prod : prod / t);
    const float av2 = (0.5f * mj) * visc;
    const float Vi = av2 * I(IRHOINV), Vj = av2 / rhoj;
    const float Ei = mj * a_mom;
    const float Pi = I(IPRHO) * Ei + Vi;
    const float Pj = (prhoj * b_mom) * mj + Vj;
    l[0] = Pi * Wi;
    l[1] = Pj * Wj;
    l[2] = Ei * Wi;
    l[3] = Vi * Wi;
    l[4] = Vj * Wj;
#undef S
#undef I
}

// the 49 columns of unit slot j (sanitised: zero on an invalid slot)
__device__ __forceinline__ void columns(const float* Rb, int j,
                                        const float* o, float (&col)[NC])
{
    const bool ok = Rb[4 * UJ + j] >= 0.0f;
    float bj[3], vj[3], cj[6];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        bj[b] = ok ? Rb[b * UJ + j] - o[b] : 0.0f;
        vj[b] = ok ? Rb[(5 + b) * UJ + j] - o[3 + b] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) cj[r] = ok ? Rb[(14 + r) * UJ + j] : 0.0f;
    col[0] = ok ? 1.0f : 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        col[1 + b] = bj[b];
        col[4 + b] = vj[b];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) col[16 + r] = cj[r];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            const float c = cj[c6(a, b)];
            col[7 + 3 * a + b] = vj[a] * bj[b];
            col[22 + 3 * a + b] = c * bj[b];
            col[31 + 3 * a + b] = c * vj[a];
            col[40 + 3 * a + b] = c * vj[a] * bj[b];
        }
}

// the i-side offsets and cij of the epilogue (zero on invalid slots)
struct EpiI {
    float bic[3], vic[3], cii[6];

    __device__ EpiI(const float* J, long long islot, long long ns,
                    const float* o)
    {
        const bool oki = J[islot] < HALF_FILL;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            bic[b] = oki ? J[b * ns + islot] - o[b] : 0.0f;
            vic[b] = oki ? J[(5 + b) * ns + islot] - o[3 + b] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 6; ++r)
            cii[r] = oki ? J[(14 + r) * ns + islot] : 0.0f;
    }

    // -sum_ab c_ab,i (v_a b_b S0 - v_a S_{1+b} - b_b S_{4+a} + S_{7+3a+b})
    __device__ float qi(const float (&S)[NC]) const
    {
        float acc = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) {
                float q = vic[a] * bic[b] * S[0] - vic[a] * S[1 + b]
                    - bic[b] * S[4 + a] + S[7 + 3 * a + b];
                acc = acc + cii[c6(a, b)] * q;
            }
        return -acc;
    }
};

// family f's share of the outputs into part[r * stride]: momA (rows
// 0-2), momB (3-5), energy (6), i-side and j-side visc energy (7, 8)
__device__ __forceinline__ void partial(int f, const float (&S)[NC],
                                        const EpiI& e, float* part,
                                        int stride)
{
    switch (f) {
    case 0: {
        float RA[3];
#pragma unroll
        for (int b = 0; b < 3; ++b) RA[b] = e.bic[b] * S[0] - S[1 + b];
#pragma unroll
        for (int a = 0; a < 3; ++a)
            part[a * stride] = -(e.cii[c6(a, 0)] * RA[0]
                                 + e.cii[c6(a, 1)] * RA[1]
                                 + e.cii[c6(a, 2)] * RA[2]);
        break;
    }
    case 1:
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            float acc = 0.0f;
#pragma unroll
            for (int b = 0; b < 3; ++b)
                acc = acc + e.bic[b] * S[16 + c6(a, b)] - S[22 + 3 * a + b];
            part[(3 + a) * stride] = -acc;
        }
        break;
    case 2: part[6 * stride] = e.qi(S); break;
    case 3: part[7 * stride] = e.qi(S); break;
    default: {
        float acc = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
                acc = acc - (e.vic[a] * e.bic[b] * S[16 + c6(a, b)]
                             - e.vic[a] * S[22 + 3 * a + b]
                             - e.bic[b] * S[31 + 3 * a + b]
                             + S[40 + 3 * a + b]);
        part[8 * stride] = acc;
    }
    }
}

// the columns [LO, HI) of unit slot `lane` into B buffer Bb: TF32 hi and
// lo parts ({hi, lo} at [k][36] float2), or bf16 values ([k][40])
template <bool BF16, int LO, int HI, bool TERMS>
__device__ __forceinline__ void store_cols(const float* Rb, int lane,
                                           const float* o, float* Bb)
{
    if constexpr (TERMS) {
        float* JT = Bb + Shape<BF16>::BC;
        const bool ok = Rb[4 * UJ + lane] >= 0.0f;
        JT[lane] = 1.0f / Rb[3 * UJ + lane];
        JT[UJ + lane] = logf(ok ? Rb[11 * UJ + lane] : 1.0f);
    }
    float col[NC];
    columns(Rb, lane, o, col);
#pragma unroll
    for (int k = LO; k < HI; ++k) {
        if constexpr (BF16) {
            reinterpret_cast<__nv_bfloat16*>(Bb)[k * 40 + lane] =
                __float2bfloat16_rn(col[k]);
        } else {
            uint32_t hi, lo;
            split_tf32(col[k], hi, lo);
            reinterpret_cast<float2*>(Bb)[k * 36 + lane] =
                make_float2(__uint_as_float(hi), __uint_as_float(lo));
        }
    }
}

// one interior cell `own`, the i-block blockIdx.y, blockDim.x == THREADS
template <bool BF16>
__device__ __noinline__ void mm_cell(const float* __restrict__ J,
                                     float* __restrict__ out,
                                     const PairGeom g, const PairParams p,
                                     const long long own, const int vec)
{
    using Sh = Shape<BF16>;
    constexpr int KS = Sh::KS, NKS = Sh::NKS, BPK = Sh::BPK;
    constexpr int LSW = NF * NKS * 128;           // A fragments a warp
    extern __shared__ __align__(16) float msm[];
    const int cap = g.cap, G = cap / UJ, NU = 27 * G;
    const long long ns = g.n_slots;
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int gq = lane >> 2, tq = lane & 3;
    float* const Ls = msm + w * LSW;              // this warp's i-tile
    float* const Bs = msm + Sh::LS;               // [2][BS] B columns
    float* const R = Bs + 2 * Sh::BS;             // [3][NJR][UJ] raw j rows
    float* const Se = msm;                        // epilogue [NF][IB][NC]
    float* const IT = msm + Sh::UNION;            // [NI][IB]
    float* const part = IT + NI * IB;             // [9][IB]
    int* const vsm = reinterpret_cast<int*>(part + 9 * IB);   // [IB]
    float* const origin = reinterpret_cast<float*>(vsm + IB);
    int* const cnt = reinterpret_cast<int*>(origin + 8);
    int* const vm = cnt + 8;                      // [NU] last valid slot
    int* const list = vm + NU;                    // [NU] occupied units

    __syncthreads();               // K11: the previous cell's epilogue
    cell_means<Rows>(J, own * cap, cap, ns, origin);
    const int i0 = blockIdx.y * IB;
    bool ivalid = false;
    for (int r = t; r < IB; r += THREADS) {
        const bool ihas = i0 + r < cap;
        load_i(J, own * cap + (ihas ? i0 + r : 0), ns, ihas, IT, r);
        ivalid |= IT[IX * IB + r] < HALF_FILL;
        vsm[r] = 0;                // +0.0f: the signal speed's floor
    }
    for (int u = w; u < NU; u += NIT) {
        const int nb = u / G;
        const unsigned b = __ballot_sync(
            FULL, J[nbr_cell(g, own, nb) * cap + UJ * (u - nb * G) + lane]
                      < HALF_FILL);
        if (lane == 0) vm[u] = b ? 31 - __clz(b) : -1;
    }
    // the zero pad columns of both B buffers
    for (int e = t; e < 2 * (NCP - NC) * UJ; e += THREADS) {
        const int bb = e / ((NCP - NC) * UJ), q = e % ((NCP - NC) * UJ);
        const int k = NC + q / UJ, j = q % UJ;
        float* Bb = Bs + bb * Sh::BS;
        if constexpr (BF16)
            reinterpret_cast<__nv_bfloat16*>(Bb)[k * 40 + j] =
                __float2bfloat16_rn(0.0f);
        else
            reinterpret_cast<float2*>(Bb)[k * 36 + j] =
                make_float2(0.0f, 0.0f);
    }
    if (!__syncthreads_or(ivalid)) {
        for (int r = t; r < IB && i0 + r < cap; r += THREADS)
            for (int q = 0; q < 5; ++q)
                out[q * ns + own * cap + i0 + r] = 0.0f;
        return;
    }
    if (w == 0) {
        int base = 0;
        for (int c0 = 0; c0 < NU; c0 += 32) {
            const int q = c0 + lane;
            const bool f = q < NU && vm[q] >= 0;
            const unsigned b = __ballot_sync(FULL, f);
            if (f)
                list[base + __popc(b & ((1u << lane) - 1u))] =
                    (q << 5) | vm[q];
            base += __popc(b);
        }
        if (lane == 0) cnt[0] = base;
    }
    __syncthreads();
    const int nocc = cnt[0];

    // phase A's i side: rows gq and gq + 8 of i-tile w, in registers for
    // the support tests
    float xi[2], yi[2], zi[2], hi2[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int r = 16 * w + gq + 8 * s;
        xi[s] = IT[IX * IB + r];
        yi[s] = IT[IY * IB + r];
        zi[s] = IT[IZ * IB + r];
        hi2[s] = IT[IHINV2 * IB + r];
    }
    const bool wtests =
        __any_sync(FULL, xi[0] < HALF_FILL || xi[1] < HALF_FILL);

    // stage unit v's rows into R[v % 3] (one cp.async group, committed
    // also when empty)
    auto issue = [&](int v) {
        if (v < nocc) {
            const int u = list[v] >> 5, nb = u / G;
            const long long b =
                nbr_cell(g, own, nb) * cap + UJ * (u - nb * G);
            float* dst = R + (v % 3) * NJR * UJ;
            if (vec) {
                for (int e = t; e < NJR * UJ / 4; e += THREADS) {
                    const int r = e >> 3, seg = (e & 7) * 4;
                    tile::cp_async16(dst + r * UJ + seg,
                                     J + r * ns + b + seg);
                }
            } else {
                for (int e = t; e < NJR * UJ; e += THREADS)
                    tile::cp_async4(dst + e, J + (e / UJ) * ns + b + e % UJ);
            }
        }
        tile::cp_async_commit();
    };
    // unit v's columns into B buffer v & 1, warp w a quarter of them
    auto build = [&](int v) {
        const float* Rb = R + (v % 3) * NJR * UJ;
        float* Bb = Bs + (v & 1) * Sh::BS;
        switch (w) {
        case 0: store_cols<BF16, 0, 14, false>(Rb, lane, origin, Bb); break;
        case 1: store_cols<BF16, 14, 28, false>(Rb, lane, origin, Bb); break;
        case 2: store_cols<BF16, 28, 40, false>(Rb, lane, origin, Bb); break;
        default: store_cols<BF16, 40, NC, true>(Rb, lane, origin, Bb);
        }
    };

    float acc[NF][NT][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[f][n][q] = 0.0f;
    unsigned long long issued = 0, staged = 0;

    issue(0);
    issue(1);
    for (int v = 0; v < nocc; ++v) {
        // unit v + 1's rows landed (unit v's with them), unit v's columns
        // built, the last unit's phase B done
        tile::cp_async_wait_all();
        __syncthreads();
        issue(v + 2);
        if (v == 0) {
            build(0);
            __syncthreads();
        }
        if (v + 1 < nocc) build(v + 1);
        const int nks = (list[v] & 31) / KS + 1;
        const float* Rb = R + (v % 3) * NJR * UJ;
        const float* Bb = Bs + (v & 1) * Sh::BS;
        const float* JT = Bb + Sh::BC;

        // A. the pair weights of i-tile w (float32 cores)
        unsigned m = 0;
        if (wtests) {
#pragma unroll
            for (int b = 0; b < 16; ++b) {
                const int ks = b / BPK;
                int dr, col;
                frag_pos<BF16>(ks, b % BPK, tq, dr, col);
                const int s = dr ? 1 : 0;
                if (ks < nks) {
                    const float d2 = dist2(
                        __fsub_rn(xi[s], Rb[0 * UJ + col]),
                        __fsub_rn(yi[s], Rb[1 * UJ + col]),
                        __fsub_rn(zi[s], Rb[2 * UJ + col]));
                    if (__fmul_rn(d2, hi2[s]) < 4.0f) m |= 1u << b;
                }
            }
        }
        const unsigned wm = __reduce_or_sync(FULL, m);
        for (int ks = 0; ks < NKS; ++ks)
            if ((wm >> (ks * BPK)) & ((1u << BPK) - 1u))
#pragma unroll
                for (int f = 0; f < NF; ++f)
                    *reinterpret_cast<float4*>(
                        Ls + (f * NKS + ks) * 128 + 4 * lane) =
                        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        __syncwarp();
        // the warp's in-support pairs, compacted: lane q of a round takes
        // pair p0 + q, its owner lane and fragment position
        const int cn = __popc(m);
        int incl = cn;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, s);
            if (lane >= s) incl += y;
        }
        const int total = __shfl_sync(FULL, incl, 31);
        const int off = incl - cn;
        unsigned fam = 0;          // bit ks * NF + f: a nonzero weight
        for (int p0 = 0; p0 < total; p0 += 32) {
            const int pi = p0 + lane;
            int l = 0;                  // owner: last lane with off <= pi
#pragma unroll
            for (int s = 16; s > 0; s >>= 1) {
                const int o = __shfl_sync(FULL, off, l + s);
                if (o <= pi) l += s;
            }
            const int r = pi - __shfl_sync(FULL, off, l);
            const unsigned mm = __shfl_sync(FULL, m, l);
            int bit = 0;                // the r-th set bit of mm
#pragma unroll
            for (int s = 8; s > 0; s >>= 1)
                if (__popc(mm & ((1u << (bit + s)) - 1u)) <= r) bit += s;
            if (pi < total) {
                const int ks = bit / BPK, e = bit % BPK;
                int dr, col;
                frag_pos<BF16>(ks, e, l & 3, dr, col);
                const int row = 16 * w + (l >> 2) + dr;
                float lw[NF], vs, d2;
                pair_weights(IT, row, Rb, col, JT, p, lw, vs, d2);
                float* at = Ls + ks * 128 + 4 * l;
#pragma unroll
                for (int f = 0; f < NF; ++f) {
                    if constexpr (BF16) {
                        const __nv_bfloat16 h = __float2bfloat16_rn(lw[f]);
                        if (__bfloat162float(h) != 0.0f) {
                            reinterpret_cast<__nv_bfloat16*>(
                                at + f * NKS * 128)[e] = h;
                            fam |= 1u << (ks * NF + f);
                        }
                    } else if (lw[f] != 0.0f) {
                        at[f * NKS * 128 + e] = lw[f];
                        fam |= 1u << (ks * NF + f);
                    }
                }
                if (d2 > 0.0f)
                    atomicMax(vsm + row, __float_as_int(fmaxf(vs, 0.0f)));
            }
        }
        fam = __reduce_or_sync(FULL, fam);
        __syncwarp();

        // B. the nonzero blocks of i-tile w on the tensor cores
        if (p.stats != nullptr && t == 0) staged += NF * NIT * nks;
        for (int ks = 0; ks < nks; ++ks) {
            const unsigned act = (fam >> (ks * NF)) & ((1u << NF) - 1u);
            if (!act) continue;
            issued += __popc(act);
#pragma unroll
            for (int f = 0; f < NF; ++f) {
                if (!(act >> f & 1)) continue;
                const float* af = Ls + (f * NKS + ks) * 128 + 4 * lane;
                if constexpr (BF16) {
                    const uint4 q = *reinterpret_cast<const uint4*>(af);
                    const uint32_t a[4] = {q.x, q.y, q.z, q.w};
                    const uint32_t* Bw = reinterpret_cast<const uint32_t*>(Bb);
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        const int at = (8 * n + gq) * 20 + 8 * ks + tq;
                        mma_bf16(acc[f][n], a, Bw[at], Bw[at + 4]);
                    }
                } else {
                    const float4 q = *reinterpret_cast<const float4*>(af);
                    uint32_t ah[4], al[4];
                    split_tf32(q.x, ah[0], al[0]);
                    split_tf32(q.y, ah[1], al[1]);
                    split_tf32(q.z, ah[2], al[2]);
                    split_tf32(q.w, ah[3], al[3]);
                    const float2* B2 = reinterpret_cast<const float2*>(Bb);
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        const int at = (8 * n + gq) * 36 + 8 * ks + tq;
                        const float2 b0 = B2[at], b1 = B2[at + 4];
                        const uint32_t h0 = __float_as_uint(b0.x),
                                       l0 = __float_as_uint(b0.y),
                                       h1 = __float_as_uint(b1.x),
                                       l1 = __float_as_uint(b1.y);
                        // from zero, then added in float32: accumulating
                        // in place on the tensor core doubled the error
                        float tmp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                        mma_tf32(tmp, al, h0, h1);
                        mma_tf32(tmp, ah, l0, l1);
                        mma_tf32(tmp, ah, h0, h1);
#pragma unroll
                        for (int q = 0; q < 4; ++q) acc[f][n][q] += tmp[q];
                    }
                }
            }
        }
    }

    // the epilogue: the sums through shared memory, each family's share,
    // then the outputs
    tile::cp_async_wait_all();
    __syncthreads();               // the last unit's phase B is done
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int row = 16 * w + gq + 8 * (q >> 1);
                const int col = 8 * n + 2 * tq + (q & 1);
                if (col < NC) Se[(f * IB + row) * NC + col] = acc[f][n][q];
            }
    if (p.stats != nullptr) {
        if (lane == 0) atomicAdd(p.stats, issued);
        if (t == 0) atomicAdd(p.stats + 1, staged);
    }
    __syncthreads();
    for (int task = t; task < NF * IB; task += THREADS) {
        const int f = task / IB, r = task % IB;
        if (i0 + r >= cap) continue;
        float S[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) S[k] = Se[(f * IB + r) * NC + k];
        partial(f, S, EpiI(J, own * cap + i0 + r, ns, origin), part + r, IB);
    }
    __syncthreads();
    for (int r = t; r < IB; r += THREADS) {
        if (i0 + r >= cap) break;
        const long long islot = own * cap + i0 + r;
        const float prhoi = J[islot] < HALF_FILL ? J[9 * ns + islot] : 0.0f;
        const float K3d = p.K3d;
        const float ae = fmaxf(part[7 * IB + r] + part[8 * IB + r], 0.0f);
        const float o[5] = {
            -K3d * (part[0 * IB + r] + part[3 * IB + r]),
            -K3d * (part[1 * IB + r] + part[4 * IB + r]),
            -K3d * (part[2 * IB + r] + part[5 * IB + r]),
            K3d * (prhoi * part[6 * IB + r] + 0.5f * ae),
            __int_as_float(vsm[r])};
#pragma unroll
        for (int q = 0; q < 5; ++q) out[q * ns + islot] = o[q];
    }
}

// the cell launch, K2g (Gated) and K11's stream form (Column);
// blockIdx.y is the i-block
template <bool BF16, bool Gated, bool Column>
__global__ void __launch_bounds__(THREADS, 2)
cell_mm(const float* __restrict__ J, float* __restrict__ out, PairGeom g,
        PairParams p, PairGate gt, int zseg, int vec)
{
    if constexpr (Gated) {
        const long long own = gate_cell(gt);
        if (own >= 0) mm_cell<BF16>(J, out, g, p, own, vec);
        gate_copy<NF>(gt, g, out);
    } else {
        const Walk w = block_walk<Column>(g, zseg);
        for (int q = 0; q < w.ncell; ++q)
            mm_cell<BF16>(J, out, g, p, w.own0 + q, vec);
    }
}

}  // namespace mm

constexpr size_t SMEM_MAX = 232448;   // 227 KB a block may opt into

// opts kern into `smem` bytes of dynamic shared memory and launches it
template <class Kern, class... Args>
cudaError_t start(Kern kern, dim3 grid, int nthr, size_t smem,
                  cudaStream_t st, Args... args)
{
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    if (grid.x && grid.y) kern<<<grid, nthr, smem, st>>>(args...);
    return cudaSuccess;
}

// one block per interior cell, or (K11, zseg > 0) per z-segment of an
// interior column
unsigned n_blocks(const PairGeom& g, int zseg)
{
    const int per_col = zseg ? (g.nz + zseg - 1) / zseg : g.nz;
    return (unsigned)g.nx * g.n * per_col;
}

// the cap ceiling is pair_ve.MAX_CAP (the generated header's SPH_MAX_CAP);
// pair_smem gives each stage's shared memory at a cap
bool bad_launch(const PairGeom& g, const PairGate& gt, int zseg)
{
    return g.cap < 32 || g.cap > SPH_MAX_CAP || g.cap % 32 || zseg < 0
        || (gt.ws != nullptr && zseg);
}

// Dynamic shared memory of a block, in bytes; every launch form of a
// stage (cell, K2g, K11) takes its stage's. K4-K9 and K7c: fixed by
// T = min(cap, 128), the same past cap 128. K3: the 27-group window and
// the ballots and list of 27 cap / 32 groups (21,620 bytes at cap 1152,
// 41,492 at 4096). K10: its fixed 87,872 bytes (float32; bf16 69,184)
// and the ballots and list of 27 cap / 32 units (115,520 bytes at cap
// 4096, bf16 96,832), within SMEM_MAX at every cap to SPH_MAX_CAP.
template <class St>
size_t tile_smem(int cap)
{
    const int T = cap < tile::TILE ? cap : tile::TILE;
    return sizeof(float) * tile::smem_floats<St>(T);
}

size_t mm_smem(int cap, bool bf16)
{
    return sizeof(float) * (bf16 ? mm::smem_words<true>(cap)
                                 : mm::smem_words<false>(cap));
}

// K4-K9 and K7c (stages 1-6, 8): blocks of T = min(cap, 128) threads,
// one a (cell, i-tile); the cell launch, K2g when gt.ws is set, or
// K11's stream form (zseg > 0)
template <class St>
cudaError_t launch_tile(const float* J, const float* I2, float* out,
                        const PairGeom& g, const PairParams& p,
                        const PairGate& gt, int zseg, cudaStream_t st)
{
    if (bad_launch(g, gt, zseg)) return cudaErrorInvalidValue;
    const int T = g.cap < tile::TILE ? g.cap : tile::TILE;
    const size_t smem = tile_smem<St>(g.cap);
    const dim3 grid(n_blocks(g, zseg), (g.cap + T - 1) / T);
    const int vec = reinterpret_cast<size_t>(J) % 16 == 0;
    auto kern = zseg ? tile::cell_tile<St, false, true>
        : gt.ws ? tile::cell_tile<St, true, false>
                : tile::cell_tile<St, false, false>;
    return start(kern, grid, T, smem, st, J, I2, out, g, p, gt, zseg, vec);
}

// K3 (stage 0): the same blocks
cudaError_t launch_xh(const float* J, float* out, const PairGeom& g,
                      const PairParams& p, const PairGate& gt, int zseg,
                      cudaStream_t st)
{
    if (bad_launch(g, gt, zseg)) return cudaErrorInvalidValue;
    const int T = g.cap < xh::TILE ? g.cap : xh::TILE;
    const dim3 grid(n_blocks(g, zseg), (g.cap + T - 1) / T);
    auto kern = zseg ? xh::cell_xh<false, true>
        : gt.ws ? xh::cell_xh<true, false> : xh::cell_xh<false, false>;
    return start(kern, grid, T, xh::smem_bytes(g.cap), st, J, out, g, p, gt,
                 zseg);
}

// K10: blocks of mm::THREADS threads, one a (cell, i-block of 64 slots)
cudaError_t launch_mm(const float* J, float* out, const PairGeom& g,
                      const PairParams& p, const PairGate& gt, int zseg,
                      cudaStream_t st)
{
    if (bad_launch(g, gt, zseg)) return cudaErrorInvalidValue;
    const bool bf = p.mxu_bf16 != 0;
    const size_t smem = mm_smem(g.cap, bf);
    const dim3 grid(n_blocks(g, zseg), (g.cap + mm::IB - 1) / mm::IB);
    const int vec = reinterpret_cast<size_t>(J) % 16 == 0;
    auto kern = bf ? (zseg ? mm::cell_mm<true, false, true>
                      : gt.ws ? mm::cell_mm<true, true, false>
                              : mm::cell_mm<true, false, false>)
                   : (zseg ? mm::cell_mm<false, false, true>
                      : gt.ws ? mm::cell_mm<false, true, false>
                              : mm::cell_mm<false, false, false>);
    return start(kern, grid, mm::THREADS, smem, st, J, out, g, p, gt, zseg,
                 vec);
}

cudaError_t stage_launch(int stage, const float* J, const float* I2,
                         float* out, const PairGeom& g, const PairParams& p,
                         const PairGate& gt, int zseg, cudaStream_t st)
{
#define TILED(S) launch_tile<S>(J, I2, out, g, p, gt, zseg, st)
    switch (stage) {
    case 0: return launch_xh(J, out, g, p, gt, zseg, st);
    case 1: return TILED(tile::GradhStage);
    case 2: return TILED(tile::IadStage);
    case 3: return TILED(tile::AvStage);
    case 4: return TILED(tile::MomStage<false>);
    case 5: return TILED(tile::IadMmStage);
    case 6: return TILED(tile::AvMmStage);
    case 7: return launch_mm(J, out, g, p, gt, zseg, st);
    case 8:
        if (gt.ws != nullptr) return cudaErrorInvalidValue;   // no K2g form
        return TILED(tile::MomStage<true>);
    default: return cudaErrorInvalidValue;
    }
#undef TILED
}

// stage_launch's shared memory per block, or -1 for no such stage
long long stage_smem(int stage, int cap, bool bf16)
{
    switch (stage) {
    case 0: return xh::smem_bytes(cap);
    case 1: return tile_smem<tile::GradhStage>(cap);
    case 2: return tile_smem<tile::IadStage>(cap);
    case 3: return tile_smem<tile::AvStage>(cap);
    case 4: return tile_smem<tile::MomStage<false>>(cap);
    case 5: return tile_smem<tile::IadMmStage>(cap);
    case 6: return tile_smem<tile::AvMmStage>(cap);
    case 7: return mm_smem(cap, bf16);
    case 8: return tile_smem<tile::MomStage<true>>(cap);
    default: return -1;
    }
}

}  // namespace

// bytes of dynamic shared memory a block of `stage` takes at cap (K10
// under mxu_bf16 with bf16 set); -1 for an unknown stage
extern "C" int pair_smem(int stage, int cap, int bf16)
{
    return (int)stage_smem(stage, cap, bf16 != 0);
}

// the cell launch. gt.ws == nullptr: the ungated stage (K2); else K2g
// over the list that pair_gate wrote into gt.ws
extern "C" int pair_launch(int stage, const float* J, const float* I2,
                           float* out, PairGeom g, PairParams p, PairGate gt,
                           void* stream)
{
    cudaError_t e = stage_launch(stage, J, I2, out, g, p, gt, 0,
                                 (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// K2g's gate pass at supercell size Z into ws (gate_flags(g) + the
// supercells' count of ints), its header zeroed first
extern "C" int pair_gate(const float* act, PairGeom g, int Z, int* ws,
                         void* stream)
{
    if (Z < 1 || g.npz % Z || g.cap % 32) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(ws, 0, SPH_GATE_HDR * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    const int nsc = (g.nx + 2) * g.npd * (g.npz / Z);
    const unsigned nb = (nsc + GATE_WARPS - 1) / GATE_WARPS;
    gate_pass<<<nb, 32 * GATE_WARPS, 0, st>>>(act, g, Z, ws);
    return (int)cudaGetLastError();
}

// K11, the column launch: segments of zseg >= 1 cells
extern "C" int pair_launch_column(int stage, const float* J, const float* I2,
                                  float* out, PairGeom g, PairParams p,
                                  int zseg, void* stream)
{
    if (zseg < 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = stage_launch(stage, J, I2, out, g, p,
                                 PairGate{nullptr, nullptr, 0}, zseg,
                                 (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
