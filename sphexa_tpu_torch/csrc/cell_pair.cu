// K2 with K3-K7: the VE pair stages over the cell-major layout.
//
// Replaces the Pallas driver make_cell_pair_call (sphexa_tpu/ops/
// pallas_ve.py:103, call :260) and its five stage bodies:
//   stage 0  XhBody        <- _xh_body          (pallas_ve.py:537)
//   stage 1  GradhBody     <- _gradh_body       (pallas_ve.py:622)
//   stage 2  IadBody       <- _iad_direct_body  (pallas_ve.py:704)
//   stage 3  AvBody        <- _av_direct_body   (pallas_ve.py:900, :865, :884)
//   stage 4  MomentumBody  <- _momentum_body    (pallas_ve.py:1022), avClean off
//
// Launch skeleton: one thread block per interior cell, one thread per
// i-slot (blockDim = cap). The block walks the 27 neighbour cells,
// stages each cell's [FJ, cap] j-rows in shared memory, and every thread
// accumulates its pair sums in registers; all threads read the same j
// value at once (a shared-memory broadcast). The xmass stage iterates
// its h controller over the same candidates several times, so it stages
// all 27 cells' x, y, z, m at once (27 * 4 * cap floats of dynamic
// shared memory) and loops there.
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
// 162-172 and :242-251), launches the same five bodies with an activity
// row and the previous outputs (PairGate below). A block whose
// z-supercell is inactive only copies FO rows of its cap slots, so the
// gated stage is bounded by the pair work of the active supercells plus
// that copy (bytes). It still launches a block for every interior cell:
// inactive blocks cost a launch slot and one read of Z*cap act values.

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
};

// K2g's gate (see gate_closed); act == nullptr for the ungated stage
struct PairGate {
    const float* act;    // [n_slots] 0/1 activity (row 0 of the TPU's act)
    const float* prev;   // [FO, n_slots] outputs kept by inactive supercells
    int Z;               // z-supercell size; divides npz
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

// staged j-row s of the current candidate k
#define SJ(s) sj[(s) * stride + k]
// J row r of this block's i-slot
#define JI(r) J[(long long)(r) * ns + islot]

// --------------------------------------------------------------------------
// stage 0: neighbour count, h iteration, xmass (resident candidates)
// --------------------------------------------------------------------------
struct XhBody {
    static constexpr int FJ = 4;                       // x y z m
    static constexpr int FO = 4;
    __device__ static int jrow(int s) { return s < 3 ? s : 5; }

    __device__ static void run(const float* J, const float*, float* out,
                               const float* sj, int stride, int W,
                               long long islot, long long ns,
                               const PairParams& p)
    {
        const float xi = JI(0), yi = JI(1), zi = JI(2), mi = JI(5);
        float hi = JI(3);
        auto count = [&](float hinv2) {
            float nc = 0.0f;
            for (int k = 0; k < W; ++k) {
                float d2 = dist2(__fsub_rn(xi, SJ(0)), __fsub_rn(yi, SJ(1)),
                                 __fsub_rn(zi, SJ(2)));
                if (__fmul_rn(d2, hinv2) < 4.0f) nc += 1.0f;
            }
            return nc;
        };
        float hinv = __fdiv_rn(1.0f, hi);
        float nc_sph = count(__fmul_rn(hinv, hinv));
        for (int it = 0; it < p.h_iter; ++it) {
            bool need = nc_sph < p.ngmin || nc_sph - 1.0f > p.ngmax;
            float h_new = __fmul_rn(
                __fmul_rn(hi, 0.5f),
                powf(__fadd_rn(1.0f, __fdiv_rn(p.hcoef, fmaxf(nc_sph, 1.0f))),
                     0.1f));
            if (p.h_cap > 0.0f) h_new = fminf(h_new, p.h_cap);
            hi = need ? h_new : hi;
            hinv = __fdiv_rn(1.0f, hi);
            if (it < p.h_iter - 1) nc_sph = count(__fmul_rn(hinv, hinv));
        }
        const float hinv2 = __fmul_rn(hinv, hinv);
        float ncm = 0.0f, acc = 0.0f;
        for (int k = 0; k < W; ++k) {
            float d2 = dist2(__fsub_rn(xi, SJ(0)), __fsub_rn(yi, SJ(1)),
                             __fsub_rn(zi, SJ(2)));
            float v2 = __fmul_rn(d2, hinv2);
            if (v2 < 4.0f) {
                acc += pow_int(sinc_poly(v2), p.n_w) * SJ(3);
                ncm += 1.0f;
            }
        }
        const float nc = ncm - 1.0f;                    // self excluded
        const float xm = mi * (hi * hi * hi) / (p.K3d * acc);
        const bool nonconv = nc + 1.0f < p.ngmin || nc > p.ngmax;
        const bool ok = xi < HALF_FILL;
        out[0 * ns + islot] = ok ? xm : 1.0f;
        out[1 * ns + islot] = hi;
        out[2 * ns + islot] = ok ? nc : 0.0f;
        out[3 * ns + islot] = ok && nonconv ? 1.0f : 0.0f;
    }
};

// --------------------------------------------------------------------------
// stage 1: VE normalization kx and grad-h
// --------------------------------------------------------------------------
struct GradhBody {
    static constexpr int FJ = 5;                       // x y z m xm
    static constexpr int FO = 2;
    __device__ static int jrow(int s) { return s < 3 ? s : s + 2; }

    float xi, yi, zi, hi, hinv, hinv2, kx, whomega, wrho0;
    int n_w;

    __device__ void load_i(const float* J, const float*, long long islot,
                           long long ns, const PairParams& p)
    {
        xi = JI(0); yi = JI(1); zi = JI(2); hi = JI(3);
        hinv = __fdiv_rn(1.0f, hi);
        hinv2 = __fmul_rn(hinv, hinv);
        kx = whomega = wrho0 = 0.0f;
        n_w = p.n_w;
    }

    __device__ void pair(const float* sj, int k, int stride)
    {
        float d2 = dist2(__fsub_rn(xi, SJ(0)), __fsub_rn(yi, SJ(1)),
                         __fsub_rn(zi, SJ(2)));
        float v2 = __fmul_rn(d2, hinv2);
        if (!(v2 < 4.0f)) return;
        float sinc = sinc_poly(v2);
        float wnm1 = pow_int(sinc, n_w - 1);
        float w = wnm1 * sinc;
        float vdw = (float)n_w * wnm1 * (v2 * dsinc_over_v_poly(v2));
        float dterh = -(3.0f * w + vdw);
        kx += w * SJ(4);
        whomega += dterh * SJ(4);
        wrho0 += dterh * SJ(3);
    }

    __device__ void store(const float* J, const float*, float* out,
                          long long islot, long long ns, const PairParams& p)
    {
        const float mi = JI(5), xmi = JI(6);
        const float K3d = p.K3d;
        const float h3inv = hinv * hinv2;
        float kxs = kx * K3d * h3inv;
        float who = whomega * K3d * h3inv * hinv;
        float wr0 = wrho0 * K3d * h3inv * hinv;
        who = who * mi / xmi + (kxs - K3d * xmi * h3inv) * wr0;
        float rho = kxs * mi / xmi;
        float gradh = 1.0f + hi / (rho * 3.0f) * who;
        const bool ok = xi < HALF_FILL;
        out[0 * ns + islot] = ok ? kxs : 1.0f;
        out[1 * ns + islot] = ok ? gradh : 1.0f;
    }
};

// --------------------------------------------------------------------------
// stage 2: IAD tau and inverse, divv, curlv, velocity gradients
// --------------------------------------------------------------------------
struct IadBody {
    static constexpr int FJ = 8;        // x y z kx xm vx vy vz
    static constexpr int FO = 14;
    __device__ static int jrow(int s) { return s < 3 ? s : s + 2; }

    float xi, yi, zi, hi, hinv, hinv2, kfac, vxi, vyi, vzi;
    float t11, t12, t13, t22, t23, t33;
    float Q[3][3];
    int n_w;

    __device__ void load_i(const float* J, const float*, long long islot,
                           long long ns, const PairParams& p)
    {
        xi = JI(0); yi = JI(1); zi = JI(2); hi = JI(3);
        vxi = JI(7); vyi = JI(8); vzi = JI(9);
        hinv = __fdiv_rn(1.0f, hi);
        hinv2 = __fmul_rn(hinv, hinv);
        kfac = p.K3d * (hinv * hinv2);
        t11 = t12 = t13 = t22 = t23 = t33 = 0.0f;
        for (int a = 0; a < 3; ++a)
            for (int b = 0; b < 3; ++b) Q[a][b] = 0.0f;
        n_w = p.n_w;
    }

    __device__ void pair(const float* sj, int k, int stride)
    {
        float rx = __fsub_rn(xi, SJ(0)), ry = __fsub_rn(yi, SJ(1)),
              rz = __fsub_rn(zi, SJ(2));
        float v2 = __fmul_rn(dist2(rx, ry, rz), hinv2);
        if (!(v2 < 4.0f)) return;
        float w = pow_int(sinc_poly(v2), n_w);
        float wn = (SJ(4) / SJ(3) * w) * kfac;
        float sx = rx * hinv, sy = ry * hinv, sz = rz * hinv;
        t11 += sx * sx * wn; t12 += sx * sy * wn; t13 += sx * sz * wn;
        t22 += sy * sy * wn; t23 += sy * sz * wn; t33 += sz * sz * wn;
        float wxm = w * SJ(4);
        float vji[3] = {SJ(5) - vxi, SJ(6) - vyi, SJ(7) - vzi};
        float rr[3] = {rx, ry, rz};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            float va = wxm * vji[a];
#pragma unroll
            for (int b = 0; b < 3; ++b) Q[a][b] += va * rr[b];
        }
    }

    __device__ void store(const float* J, const float*, float* out,
                          long long islot, long long ns, const PairParams& p)
    {
        float det = t11 * t22 * t33 + 2.0f * t12 * t23 * t13
            - t11 * t23 * t23 - t22 * t13 * t13 - t33 * t12 * t12;
        float fac = 1.0f / (det * hi * hi);
        float c11 = (t22 * t33 - t23 * t23) * fac;
        float c12 = (t13 * t23 - t33 * t12) * fac;
        float c13 = (t12 * t23 - t22 * t13) * fac;
        float c22 = (t11 * t33 - t13 * t13) * fac;
        float c23 = (t13 * t12 - t11 * t23) * fac;
        float c33 = (t11 * t22 - t12 * t12) * fac;
        const float C[3][3] = {{c11, c12, c13}, {c12, c22, c23},
                               {c13, c23, c33}};
        float dV[3][3];   // dV[a][b] = -(C Q_a)_b
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
                dV[a][b] = -(C[b][0] * Q[a][0] + C[b][1] * Q[a][1]
                             + C[b][2] * Q[a][2]);
        const float nk = kfac / JI(5);
        float cx = dV[2][1] - dV[1][2], cy = dV[0][2] - dV[2][0],
              cz = dV[1][0] - dV[0][1];
        const float o[14] = {
            c11, c12, c13, c22, c23, c33,
            nk * (dV[0][0] + dV[1][1] + dV[2][2]),
            nk * sqrtf(cx * cx + cy * cy + cz * cz),
            nk * dV[0][0], nk * (dV[0][1] + dV[1][0]),
            nk * (dV[0][2] + dV[2][0]), nk * dV[1][1],
            nk * (dV[1][2] + dV[2][1]), nk * dV[2][2]};
        const bool ok = xi < HALF_FILL;
#pragma unroll
        for (int r = 0; r < 14; ++r) out[r * ns + islot] = ok ? o[r] : 0.0f;
    }
};

// --------------------------------------------------------------------------
// stage 3: AV switches (signal speed, graddivv, alpha update)
// --------------------------------------------------------------------------
struct AvBody {
    static constexpr int FJ = 10;   // x y z c kx xm divv vx vy vz
    static constexpr int FO = 1;
    __device__ static int jrow(int s) { return s < 3 ? s : s + 2; }

    float xi, yi, zi, hi, hinv2, kfac, ci, divvi, vxi, vyi, vzi;
    float c11, c12, c13, c22, c23, c33;
    float vsig, gx, gy, gz;
    int n_w;

    __device__ void load_i(const float* J, const float* I2, long long islot,
                           long long ns, const PairParams& p)
    {
        xi = JI(0); yi = JI(1); zi = JI(2); hi = JI(3);
        ci = JI(5); divvi = JI(8); vxi = JI(9); vyi = JI(10); vzi = JI(11);
        c11 = I2[0 * ns + islot]; c12 = I2[1 * ns + islot];
        c13 = I2[2 * ns + islot]; c22 = I2[3 * ns + islot];
        c23 = I2[4 * ns + islot]; c33 = I2[5 * ns + islot];
        float hinv = __fdiv_rn(1.0f, hi);
        hinv2 = __fmul_rn(hinv, hinv);
        kfac = p.K3d * (hinv * hinv2);
        vsig = SPH_NEG;
        gx = gy = gz = 0.0f;
        n_w = p.n_w;
    }

    __device__ void pair(const float* sj, int k, int stride)
    {
        float rx = __fsub_rn(xi, SJ(0)), ry = __fsub_rn(yi, SJ(1)),
              rz = __fsub_rn(zi, SJ(2));
        float d2 = dist2(rx, ry, rz);
        float v2 = __fmul_rn(d2, hinv2);
        if (!(v2 < 4.0f)) return;
        float rv = rx * (vxi - SJ(7)) + ry * (vyi - SJ(8)) + rz * (vzi - SJ(9));
        if (rv < 0.0f)
            vsig = fmaxf(vsig, ci + SJ(3) - 3.0f * rv * rsqrtf(fmaxf(d2, 1e-30f)));
        float w = pow_int(sinc_poly(v2), n_w) * kfac;
        float tA1 = -(c11 * rx + c12 * ry + c13 * rz) * w;
        float tA2 = -(c12 * rx + c22 * ry + c23 * rz) * w;
        float tA3 = -(c13 * rx + c23 * ry + c33 * rz) * w;
        float factor = (SJ(5) / SJ(4)) * (divvi - SJ(6));
        gx += factor * tA1;
        gy += factor * tA2;
        gz += factor * tA3;
    }

    __device__ void store(const float* J, const float* I2, float* out,
                          long long islot, long long ns, const PairParams& p)
    {
        const float alpha_i = I2[6 * ns + islot], dt = I2[7 * ns + islot];
        float vijsignal = fmaxf(vsig, 1e-30f * ci);
        float graddivv = sqrtf(gx * gx + gy * gy + gz * gz);
        float a_const = hi * hi * graddivv;
        float alphaloc = divvi < 0.0f
            ? p.alphamax * a_const / (a_const + hi * fabsf(divvi) + 0.05f * ci)
            : 0.0f;
        float decay = hi / (p.decay_constant * vijsignal);
        float alphadot = alphaloc >= p.alphamin
            ? (alphaloc - alpha_i) / decay : (p.alphamin - alpha_i) / decay;
        float alpha = alphaloc >= alpha_i ? alphaloc : alpha_i + alphadot * dt;
        out[islot] = xi < HALF_FILL ? alpha : 0.0f;
    }
};

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

struct MomentumBody {
    // x y z h vx vy vz c prho rho xm alpha m c11 c12 c13 c22 c23 c33
    static constexpr int FJ = 19;
    static constexpr int FO = 5;
    __device__ static int jrow(int s) { return s < 4 ? s : s + 1; }

    float xi, yi, zi, hinv2, hi3inv, ci, alphai, rhoi, rhoi_inv, prhoi,
        xmi, lxmi, vxi, vyi, vzi;
    float ic[6];
    float mx, my, mz, energy, avisc, vsig;
    int n_w;
    bool uniform;
    float ramp, atmin, atmax;

    __device__ void load_i(const float* J, const float*, long long islot,
                           long long ns, const PairParams& p)
    {
        xi = JI(0); yi = JI(1); zi = JI(2);
        float hi = JI(3);
        vxi = JI(5); vyi = JI(6); vzi = JI(7); ci = JI(8); prhoi = JI(9);
        rhoi = JI(10); xmi = JI(11); alphai = JI(12);
        for (int r = 0; r < 6; ++r) ic[r] = JI(14 + r);
        float hinv = __fdiv_rn(1.0f, hi);
        hinv2 = __fmul_rn(hinv, hinv);
        hi3inv = hinv * hinv2;
        rhoi_inv = 1.0f / rhoi;
        lxmi = logf(xmi);
        mx = my = mz = energy = avisc = 0.0f;
        vsig = SPH_NEG;
        n_w = p.n_w;
        uniform = p.uniform_mass != 0;
        ramp = p.ramp; atmin = p.atmin; atmax = p.atmax;
    }

    __device__ void pair(const float* sj, int k, int stride)
    {
        float rx = __fsub_rn(xi, SJ(0)), ry = __fsub_rn(yi, SJ(1)),
              rz = __fsub_rn(zi, SJ(2));
        float d2 = dist2(rx, ry, rz);
        float v2i = __fmul_rn(d2, hinv2);
        if (!(v2i < 4.0f)) return;
        float hj_inv = 1.0f / SJ(3);
        float v2j = d2 * (hj_inv * hj_inv);
        float Wi = w_v2(v2i, n_w) * hi3inv;
        float Wj = w_v2(v2j, n_w) * (hj_inv * hj_inv * hj_inv);

        float tAi0 = -(ic[0] * rx + ic[1] * ry + ic[2] * rz) * Wi;
        float tAi1 = -(ic[1] * rx + ic[3] * ry + ic[4] * rz) * Wi;
        float tAi2 = -(ic[2] * rx + ic[4] * ry + ic[5] * rz) * Wi;
        float tAj0 = -(SJ(13) * rx + SJ(14) * ry + SJ(15) * rz) * Wj;
        float tAj1 = -(SJ(14) * rx + SJ(16) * ry + SJ(17) * rz) * Wj;
        float tAj2 = -(SJ(15) * rx + SJ(17) * ry + SJ(18) * rz) * Wj;

        float vx_ij = vxi - SJ(4), vy_ij = vyi - SJ(5), vz_ij = vzi - SJ(6);
        float rv = rx * vx_ij + ry * vy_ij + rz * vz_ij;
        float wij = rv * rsqrtf(fmaxf(d2, 1e-30f));
        float csum = ci + SJ(7);
        float vij_signal = (alphai + SJ(11)) * 0.25f * csum - 2.0f * wij;
        float visc = wij < 0.0f ? -vij_signal * wij : 0.0f;
        if (d2 > 0.0f) vsig = fmaxf(vsig, 0.5f * csum - 2.0f * wij);

        float mj = SJ(12), xmj = SJ(10), rhoj = SJ(9);
        float drho = fabsf(rhoi - rhoj);
        float srho = rhoi + rhoj;
        float sigma = ramp * (drho / srho - atmin);
        float lxmj = logf(xmj);
        float prod = xmi * xmj;
        float a_mom, b_mom;
        if (uniform) {
            float sc = fminf(fmaxf(sigma, 0.0f), 1.0f);
            float ep, em;
            exp_pair((1.0f - sc) * (lxmj - lxmi), ep, em);
            a_mom = prod * em;
            b_mom = prod * ep;
        } else {
            bool is_lo = drho < atmin * srho;
            bool is_hi = drho > atmax * srho;
            float t = expf((sigma - 1.0f) * (lxmj - lxmi));
            a_mom = is_lo ? xmi * xmi : (is_hi ? prod : prod * t);
            b_mom = is_lo ? xmj * xmj : (is_hi ? prod : prod / t);
        }

        float a_visc = (mj * rhoi_inv) * visc;
        float b_visc = (mj / rhoj) * visc;
        float avx = 0.5f * (a_visc * tAi0 + b_visc * tAj0);
        float avy = 0.5f * (a_visc * tAi1 + b_visc * tAj1);
        float avz = 0.5f * (a_visc * tAi2 + b_visc * tAj2);
        avisc += avx * vx_ij + avy * vy_ij + avz * vz_ij;
        energy += mj * a_mom * (vx_ij * tAi0 + vy_ij * tAi1 + vz_ij * tAi2);
        float mom_i = mj * prhoi * a_mom;
        float mom_j = mj * SJ(8) * b_mom;
        mx += mom_i * tAi0 + mom_j * tAj0 + avx;
        my += mom_i * tAi1 + mom_j * tAj1 + avy;
        mz += mom_i * tAi2 + mom_j * tAj2 + avz;
    }

    __device__ void store(const float* J, const float*, float* out,
                          long long islot, long long ns, const PairParams& p)
    {
        const float K3d = p.K3d;
        float du = K3d * (prhoi * energy + 0.5f * fmaxf(avisc, 0.0f));
        const float o[5] = {-K3d * mx, -K3d * my, -K3d * mz, du,
                            fmaxf(vsig, 0.0f)};
        const bool ok = xi < HALF_FILL;
#pragma unroll
        for (int r = 0; r < 5; ++r) out[r * ns + islot] = ok ? o[r] : 0.0f;
    }
};

#undef SJ
#undef JI

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

// K2g, the gate of the block-time-step pipeline: the block of interior
// cell c belongs to the z-supercell of padded z-cells [t*Z, (t+1)*Z) of
// its (x, y) column, t = cz / Z (make_cell_pair_call's program unit).
// When no slot of the supercell has act > 0.5, the block copies prev
// into out for its own cap slots and returns before staging any j-cell.
// The flag is read over the whole supercell, so an inactive cell inside
// an active supercell is recomputed, as on the TPU (its fresh outputs
// are what its active neighbours read in the next stage).
template <int FO>
__device__ __forceinline__ bool gate_closed(const PairGate& gt,
                                            const PairGeom& g,
                                            long long own, float* out)
{
    const int cap = g.cap, i = threadIdx.x;
    const int cz = (int)(own % g.npz);
    const long long first = (own - cz % gt.Z) * cap + i;
    int any = 0;
    for (int k = 0; k < gt.Z; ++k)
        any |= gt.act[first + (long long)k * cap] > 0.5f;
    if (__syncthreads_or(any)) return false;
    const long long islot = own * cap + i;
#pragma unroll
    for (int r = 0; r < FO; ++r)
        out[r * g.n_slots + islot] = gt.prev[r * g.n_slots + islot];
    return true;
}

// streams the 27 neighbour cells one at a time through shared memory
template <class Body, bool Gated>
__global__ void
cell_pair_stream(const float* __restrict__ J, const float* __restrict__ I2,
                 float* __restrict__ out, PairGeom g, PairParams p,
                 PairGate gt)
{
    extern __shared__ float sj[];                  // [FJ][cap]
    const int cap = g.cap, i = threadIdx.x;
    const long long own = own_cell(g);
    if constexpr (Gated)
        if (gate_closed<Body::FO>(gt, g, own, out)) return;
    const long long islot = own * cap + i;
    Body b;
    b.load_i(J, I2, islot, g.n_slots, p);
    for (int nb = 0; nb < 27; ++nb) {
        const long long jslot = nbr_cell(g, own, nb) * cap + i;
        __syncthreads();
#pragma unroll
        for (int s = 0; s < Body::FJ; ++s)
            sj[s * cap + i] = J[(long long)Body::jrow(s) * g.n_slots + jslot];
        __syncthreads();
        for (int k = 0; k < cap; ++k) b.pair(sj, k, cap);
    }
    b.store(J, I2, out, islot, g.n_slots, p);
}

// stages all 27 neighbour cells at once, for bodies that iterate
template <class Body, bool Gated>
__global__ void
cell_pair_resident(const float* __restrict__ J, const float* __restrict__ I2,
                   float* __restrict__ out, PairGeom g, PairParams p,
                   PairGate gt)
{
    extern __shared__ float sj[];                  // [FJ][27 * cap]
    const int cap = g.cap, i = threadIdx.x;
    const int W = 27 * cap;
    const long long own = own_cell(g);
    if constexpr (Gated)
        if (gate_closed<Body::FO>(gt, g, own, out)) return;
    for (int nb = 0; nb < 27; ++nb) {
        const long long jslot = nbr_cell(g, own, nb) * cap + i;
#pragma unroll
        for (int s = 0; s < Body::FJ; ++s)
            sj[s * W + nb * cap + i] =
                J[(long long)Body::jrow(s) * g.n_slots + jslot];
    }
    __syncthreads();
    Body::run(J, I2, out, sj, W, W, own * cap + i, g.n_slots, p);
}

constexpr size_t SMEM_MAX = 232448;   // 227 KB a block may opt into

template <class Body, bool Resident>
cudaError_t launch(const float* J, const float* I2, float* out,
                   const PairGeom& g, const PairParams& p, const PairGate& gt,
                   cudaStream_t st)
{
    using Kern = void (*)(const float*, const float*, float*, PairGeom,
                          PairParams, PairGate);
    const bool gated = gt.act != nullptr;
    Kern kern;
    if constexpr (Resident)
        kern = gated ? cell_pair_resident<Body, true>
                     : cell_pair_resident<Body, false>;
    else
        kern = gated ? cell_pair_stream<Body, true>
                     : cell_pair_stream<Body, false>;
    const size_t smem = sizeof(float) * Body::FJ * g.cap * (Resident ? 27 : 1);
    if (smem > SMEM_MAX || g.cap > 1024 || g.cap % 32) return cudaErrorInvalidValue;
    if (gated && (gt.prev == nullptr || gt.Z < 1 || g.npz % gt.Z))
        return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const unsigned ncell = (unsigned)g.nx * g.n * g.nz;
    if (ncell) kern<<<ncell, g.cap, smem, st>>>(J, I2, out, g, p, gt);
    return cudaSuccess;
}

}  // namespace

// gt.act == nullptr: the ungated stage (K2); else K2g with gt.prev, gt.Z
extern "C" int pair_launch(int stage, const float* J, const float* I2,
                           float* out, PairGeom g, PairParams p, PairGate gt,
                           void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e;
    switch (stage) {
    case 0: e = launch<XhBody, true>(J, I2, out, g, p, gt, st); break;
    case 1: e = launch<GradhBody, false>(J, I2, out, g, p, gt, st); break;
    case 2: e = launch<IadBody, false>(J, I2, out, g, p, gt, st); break;
    case 3: e = launch<AvBody, false>(J, I2, out, g, p, gt, st); break;
    case 4: e = launch<MomentumBody, false>(J, I2, out, g, p, gt, st); break;
    default: e = cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
