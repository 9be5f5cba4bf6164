// P1-P5: the H100 counterparts of the TPU hardware probes in scripts/.
// Each asks the TPU script's question of this card, on the script's own
// function: the outputs equal the JAX functions' (the plain versions in
// sphexa_tpu_torch/probes/ hold them), the costs are the card's.
//
//   P1 fma_ceiling  <- make       scripts/vpu_ceiling.py:26 (call :40)
//   P2 staging many <- make_many  scripts/dma_lab.py:61    (call :96)
//   P3 staging few  <- make_few   scripts/dma_lab.py:111   (call :140)
//   P4 staging pipe <- make_pipe  scripts/dma_lab.py:155   (call :175)
//   P5 mma_micro    <- make       scripts/mxu_micro.py:30  (call :64)
//
// P1: one thread per element runs nchain independent chains
// acc = fmaf(acc * acc, 1e-6f, base) of length 256 / nchain in
// registers, then sums them: an FMUL and an FFMA a step, so the card's
// fp32 pipe (bound: operations) is full once enough chains hide the FMA
// latency. The plateau over nchain is the sustained fp32 rate.
//
// P2-P4: a block per program stages K windows src[:, s:s+128] of the
// [F, NS] source in shared memory and folds rows 0-15 of each into an
// [8, 128] block (the TPU's stand-in for a stage body), adding it into
// out: reps calls sum as the JAX run does. Bound: bytes (the windows are
// read once from device memory or L2; the fold is 6 flops a lane-row).
// Variants, one per staging design:
//   0 plain   ordinary loads into shared memory, the baseline
//   1 many    K independent cp.async groups (4-byte: the window offsets
//             are arbitrary elements), each folded once it lands
//   2 manyTMA one TMA tiled load per window, each on its own mbarrier
//   3 fewTMA  make_few's contiguous span as a few TMA boxes (<= 256
//             lanes each), one mbarrier
//   4 pipe    make_pipe's static 128-aligned windows through a 3-stage
//             16-byte cp.async ring
// A TMA box must start on 16 bytes in the row (on the card, a start at
// an odd element faults with an illegal instruction), so the TMA
// variants fetch each window, or the span, from its start rounded down
// to 4 lanes and 4 lanes wider, and fold from the offset.
// The tensor maps (__grid_constant__ parameters) need
// cuTensorMapEncodeTiled, a driver API call: it is reached through the
// runtime's driver entry point, or (built with -DPROBES_LINK_LIBCUDA
// -lcuda) linked directly.
//
// P5: a block per cell (4 warps, 16 rows each) runs the script's 9 dots
// [64, 192] x [192, 16] of w_g = (x[0, :] + row) * (1 + g) after
// vpu_flops elementwise steps w = w * 1.000001 + 0.5 (rounded as the
// plain version: no contraction), on the tensor cores with mma.sync:
//   mode 0 none    no product: acc += w[:, :16]
//   mode 1 f32     TF32 m16n8k8 (a float32 product at TF32 precision)
//   mode 2 f32_highest  3xTF32 (hi*hi + hi*lo + lo*hi), float32 accuracy
//   mode 3 bf16    bf16 m16n8k16, float32 accumulation
// Every block computes the same [64, 16] result and writes it (the TPU
// program writes one out block); the other 176 columns stay zero.
// Bound: the tensor-core operations of the mode, or the fp32 elementwise
// work, whichever is larger.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --------------------------------------------------------------------------
// P1
// --------------------------------------------------------------------------

template <int NCHAIN>
__global__ void __launch_bounds__(256)
fma_chains(const float* __restrict__ x, float* __restrict__ out, long long n,
           int length)
{
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const float base = x[e];
    float acc[NCHAIN];
#pragma unroll
    for (int c = 0; c < NCHAIN; ++c) acc[c] = base * (float)(1.0 + 0.1 * c);
#pragma unroll 4
    for (int it = 0; it < length; ++it) {
#pragma unroll
        for (int c = 0; c < NCHAIN; ++c)
            acc[c] = fmaf(acc[c] * acc[c], 1e-6f, base);
    }
    float o = acc[0];
#pragma unroll
    for (int c = 1; c < NCHAIN; ++c) o = o + acc[c];
    out[e] = o;
}

// --------------------------------------------------------------------------
// P2-P4
// --------------------------------------------------------------------------

constexpr int LANES = 128;        // window width (one TPU lane tile)
constexpr int TMA_ALIGN = 4;      // lanes a TMA box start is a multiple of
constexpr int MANY_BOX = LANES + TMA_ALIGN;
constexpr int ST_THREADS = 256;   // lane l = t % 128, rows t / 128 + 2 j
constexpr int PIPE_STAGES = 3;
constexpr size_t SMEM_MAX = 232448;

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled; *how = 1 through the runtime's driver entry
// point, 2 linked against libcuda, 0 not found
EncodeTiled encoder(int* how)
{
#ifdef PROBES_LINK_LIBCUDA
    *how = 2;
    return &cuTensorMapEncodeTiled;
#else
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = (EncodeTiled)p;
    }
    *how = fn != nullptr ? 1 : 0;
    return fn;
#endif
}

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase)
{
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(phase) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)),
           "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most min(n, N) cp.async groups of this thread are
// pending (the count is an immediate)
template <int N>
__device__ __forceinline__ void cp_async_wait(int n)
{
    if constexpr (N == 0) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    } else {
        if (n >= N)
            asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
        else
            cp_async_wait<N - 1>(n);
    }
}

// the window fold of dma_lab.py, acc + a * b + a * 1.5 + b * 0.5 in the
// expression's order, every product and sum rounded
__device__ __forceinline__ float fold(float acc, float a, float b)
{
    acc = __fadd_rn(acc, __fmul_rn(a, b));
    acc = __fadd_rn(acc, __fmul_rn(a, 1.5f));
    return __fadd_rn(acc, __fmul_rn(b, 0.5f));
}

// one window into the thread's four accumulators: rows r of w at
// w[r * ld] (w points at the thread's lane)
__device__ __forceinline__ void fold_window(float (&acc)[4], const float* w,
                                            int ld)
{
    const int r0 = threadIdx.x / LANES;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int r = r0 + 2 * j;
        acc[j] = fold(acc[j], w[r * ld], w[(8 + r) * ld]);
    }
}

__device__ __forceinline__ void add_out(const float (&acc)[4], float* out)
{
    const int l = threadIdx.x % LANES, r0 = threadIdx.x / LANES;
    float* o = out + (long long)blockIdx.x * 8 * LANES + l;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int r = r0 + 2 * j;
        o[r * LANES] = __fadd_rn(o[r * LANES], acc[j]);
    }
}

struct Src {
    const float* src;
    const int* starts;    // [nprog, ld] window offsets
    int ld, F, K;
    long long NS;
};

// variants 0 and 1: every thread copies its share of the K [F, 128]
// windows; Async: one cp.async group per window, each folded once all
// threads' copies of it have landed
template <bool Async>
__global__ void __launch_bounds__(ST_THREADS)
staging_many(Src s, float* __restrict__ out)
{
    extern __shared__ __align__(128) float win[];   // [K][F][128]
    const int t = threadIdx.x, wsize = s.F * LANES;
    const int* st = s.starts + (long long)blockIdx.x * s.ld;
    for (int k = 0; k < s.K; ++k) {
        const float* from = s.src + st[k];
        for (int e = t; e < wsize; e += ST_THREADS) {
            const int r = e / LANES, l = e % LANES;
            if constexpr (Async)
                cp_async4(win + k * wsize + e, from + r * s.NS + l);
            else
                win[k * wsize + e] = from[r * s.NS + l];
        }
        if constexpr (Async) cp_async_commit();
    }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (!Async) __syncthreads();
    for (int k = 0; k < s.K; ++k) {
        if constexpr (Async) {
            cp_async_wait<16>(s.K - 1 - k);
            __syncthreads();
        }
        fold_window(acc, win + k * wsize + t % LANES, LANES);
    }
    add_out(acc, out);
}

// variant 2: one TMA load a window ([F, MANY_BOX] from the start rounded
// down to TMA_ALIGN lanes), each on its own mbarrier
__global__ void __launch_bounds__(ST_THREADS)
staging_many_tma(const __grid_constant__ CUtensorMap map, Src s,
                 float* __restrict__ out)
{
    extern __shared__ __align__(128) float win[];   // [K][F][MANY_BOX], bars
    const int t = threadIdx.x, wsize = s.F * MANY_BOX;
    const int* st = s.starts + (long long)blockIdx.x * s.ld;
    uint64_t* bar = reinterpret_cast<uint64_t*>(win + s.K * wsize);
    if (t == 0) {
        for (int k = 0; k < s.K; ++k) mbar_init(bar + k);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (t == 0) {
        for (int k = 0; k < s.K; ++k) {
            mbar_expect(bar + k, wsize * sizeof(float));
            tma_load(win + k * wsize, &map, bar + k,
                     st[k] & ~(TMA_ALIGN - 1), 0);
        }
    }
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < s.K; ++k) {
        const int off = st[k] & (TMA_ALIGN - 1);
        mbar_wait(bar + k, 0);
        fold_window(acc, win + k * wsize + off + t % LANES, MANY_BOX);
    }
    add_out(acc, out);
}

// variant 3: make_few's span as nbox boxes of bw lanes from its start
// rounded down to TMA_ALIGN lanes, one mbarrier for all; lane p of the
// fetched run is box p / bw, column p % bw
__global__ void __launch_bounds__(ST_THREADS)
staging_few_tma(const __grid_constant__ CUtensorMap map, Src s, int nbox,
                int bw, float* __restrict__ out)
{
    extern __shared__ __align__(128) float win[];   // [nbox][F][bw], bar
    const int t = threadIdx.x;
    const int s0 = s.starts[(long long)blockIdx.x * s.ld];
    const int off = s0 & (TMA_ALIGN - 1);
    uint64_t* bar = reinterpret_cast<uint64_t*>(win + nbox * s.F * bw);
    if (t == 0) {
        mbar_init(bar);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (t == 0) {
        mbar_expect(bar, nbox * s.F * bw * sizeof(float));
        for (int b = 0; b < nbox; ++b)
            tma_load(win + b * s.F * bw, &map, bar, s0 - off + b * bw, 0);
    }
    mbar_wait(bar, 0);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < s.K; ++k) {
        const int p = off + k * LANES + t % LANES;
        fold_window(acc, win + (p / bw) * s.F * bw + p % bw, bw);
    }
    add_out(acc, out);
}

// variant 4: make_pipe's windows, 128-lane block (pid*7 + k*13) %
// (NS/128 - 1), through a PIPE_STAGES-deep ring of 16-byte cp.async
__global__ void __launch_bounds__(ST_THREADS)
staging_pipe(Src s, float* __restrict__ out)
{
    extern __shared__ __align__(128) float win[];   // [STAGES][F][128]
    const int t = threadIdx.x, wsize = s.F * LANES;
    const long long nsb = s.NS / LANES;
    auto issue = [&](int k) {
        if (k < s.K) {
            const long long blk = ((long long)blockIdx.x * 7 + k * 13)
                % (nsb - 1);
            const float* from = s.src + blk * LANES;
            float* to = win + (k % PIPE_STAGES) * wsize;
            for (int c = t; c < s.F * LANES / 4; c += ST_THREADS) {
                const int r = c / (LANES / 4), q = c % (LANES / 4);
                cp_async16(to + r * LANES + 4 * q, from + r * s.NS + 4 * q);
            }
        }
        cp_async_commit();                   // empty groups keep the count
    };
    for (int k = 0; k < PIPE_STAGES; ++k) issue(k);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < s.K; ++k) {
        cp_async_wait<PIPE_STAGES - 1>(PIPE_STAGES - 1);
        __syncthreads();
        fold_window(acc, win + (k % PIPE_STAGES) * wsize + t % LANES, LANES);
        __syncthreads();                     // the slot is read no more
        issue(k + PIPE_STAGES);
    }
    add_out(acc, out);
}

template <class Kern, class... Args>
cudaError_t start(Kern kern, unsigned nblk, size_t smem, cudaStream_t st,
                  Args... args)
{
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    if (nblk) kern<<<nblk, ST_THREADS, smem, st>>>(args...);
    return cudaSuccess;
}

// a 2-D tensor map over src [F, NS] float32 with boxes of [F, bw]
cudaError_t tensor_map(CUtensorMap* map, const Src& s, int bw)
{
    int how;
    EncodeTiled fn = encoder(&how);
    if (fn == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)s.NS, (cuuint64_t)s.F};
    const cuuint64_t strides[1] = {(cuuint64_t)s.NS * sizeof(float)};
    const cuuint32_t box[2] = {(cuuint32_t)bw, (cuuint32_t)s.F};
    const cuuint32_t estr[2] = {1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                    (void*)s.src, dims, strides, box, estr,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// make_few's fetch: the fewest boxes of at most 256 lanes, of equal
// width (a multiple of TMA_ALIGN), that cover the span and its offset
void few_boxes(int K, int* nbox, int* bw)
{
    const int run = K * LANES + TMA_ALIGN - 1;
    *nbox = (run + 255) / 256;
    *bw = ((run + *nbox - 1) / *nbox + TMA_ALIGN - 1)
        / TMA_ALIGN * TMA_ALIGN;
}

// a TMA variant's tensor map over src; false where TMA cannot take the
// shapes (16-byte source and row stride, 128-byte box starts in shared
// memory)
bool tma_map(CUtensorMap* map, const Src& s, int bw)
{
    if ((uintptr_t)s.src % 16 || s.NS % 4 || (s.F * bw * 4) % 128)
        return false;
    return tensor_map(map, s, bw) == cudaSuccess;
}

cudaError_t staging_launch(int variant, const Src& s, float* out, int nprog,
                           cudaStream_t st)
{
    const size_t wbytes = sizeof(float) * s.F * LANES;
    if (s.F < 16 || s.F > 256 || s.K < 1 || nprog < 0)
        return cudaErrorInvalidValue;
    CUtensorMap map;
    switch (variant) {
    case 0:
        return start(staging_many<false>, nprog, s.K * wbytes, st, s, out);
    case 1:
        return start(staging_many<true>, nprog, s.K * wbytes, st, s, out);
    case 2: {
        const size_t wtma = sizeof(float) * s.F * MANY_BOX;
        if (!tma_map(&map, s, MANY_BOX)) return cudaErrorInvalidValue;
        return start(staging_many_tma, nprog,
                     s.K * (wtma + sizeof(uint64_t)), st, map, s, out);
    }
    case 3: {
        int nbox, bw;
        few_boxes(s.K, &nbox, &bw);
        if (!tma_map(&map, s, bw)) return cudaErrorInvalidValue;
        return start(staging_few_tma, nprog,
                     sizeof(float) * nbox * s.F * bw + sizeof(uint64_t), st,
                     map, s, nbox, bw, out);
    }
    case 4:
        if ((uintptr_t)s.src % 16 || s.NS % 4 || s.NS < 2 * LANES)
            return cudaErrorInvalidValue;
        return start(staging_pipe, nprog, PIPE_STAGES * wbytes, st, s, out);
    default:
        return cudaErrorInvalidValue;
    }
}

// --------------------------------------------------------------------------
// P5
// --------------------------------------------------------------------------

constexpr int MM_RUNW = 192, MM_N = 16, MM_FJ = 16;   // 64 rows

__device__ __forceinline__ uint32_t tf32(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
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

// two floats as a bf16 pair, lo in the low half (nearest even)
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi)
{
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// the hi and lo TF32 parts of x: x ~ hi + lo to about 2^-22 relative
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo)
{
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

// fragment layouts of mma.sync (lane = 4 * gq + tq): C of m16n8 holds
// rows gq, gq + 8 and columns 2 tq, 2 tq + 1; A of m16n8k8 (tf32) rows
// gq, gq + 8, columns tq, tq + 4, B columns (k) tq, tq + 4 at n = gq;
// A of m16n8k16 (bf16) columns 2 tq (+1) and 2 tq + 8 (+1), B likewise
template <int MODE>
__global__ void __launch_bounds__(128)
mma_micro_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int vpu_flops, int sink)
{
    __shared__ float xs[MM_FJ * MM_RUNW];
    const int t = threadIdx.x;
    for (int e = t; e < MM_FJ * MM_RUNW; e += blockDim.x) xs[e] = x[e];
    __syncthreads();
    const int lane = t % 32, gq = lane / 4, tq = lane % 4;
    const int row0 = 16 * (t / 32);
    float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    float junk = 0.0f;
    for (int g = 0; g < 9; ++g) {
        const float scale = (float)(1 + g);
        // w[row, col] of dot g: v = x[0, col] + row, times 1 + g, then
        // vpu_flops steps w * 1.000001 + 0.5
        auto w = [&](int dr, int col) {
            float v = __fmul_rn(__fadd_rn(xs[col], (float)(row0 + dr)),
                                scale);
            for (int f = 0; f < vpu_flops; ++f)
                v = __fadd_rn(__fmul_rn(v, 1.000001f), 0.5f);
            return v;
        };
        if constexpr (MODE == 0) {
            for (int cb = 0; cb < MM_RUNW / 8; ++cb) {
                const int col = cb * 8 + 2 * tq;
                const float v[4] = {w(gq, col), w(gq, col + 1),
                                    w(gq + 8, col), w(gq + 8, col + 1)};
                if (cb < MM_N / 8) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) c[cb][q] = c[cb][q] + v[q];
                } else {
                    junk += v[0] + v[1] + v[2] + v[3];
                }
            }
        } else if constexpr (MODE == 3) {
            for (int kk = 0; kk < MM_RUNW / 16; ++kk) {
                const int col = kk * 16 + 2 * tq;
                const uint32_t a[4] = {
                    bf16x2(w(gq, col), w(gq, col + 1)),
                    bf16x2(w(gq + 8, col), w(gq + 8, col + 1)),
                    bf16x2(w(gq, col + 8), w(gq, col + 9)),
                    bf16x2(w(gq + 8, col + 8), w(gq + 8, col + 9))};
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    const float* b = xs + (nt * 8 + gq) * MM_RUNW + col;
                    mma_bf16(c[nt], a, bf16x2(b[0], b[1]),
                             bf16x2(b[8], b[9]));
                }
            }
        } else {
            for (int kk = 0; kk < MM_RUNW / 8; ++kk) {
                const int col = kk * 8 + tq;
                const float av[4] = {w(gq, col), w(gq + 8, col),
                                     w(gq, col + 4), w(gq + 8, col + 4)};
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    const float* b = xs + (nt * 8 + gq) * MM_RUNW + col;
                    if constexpr (MODE == 1) {
                        const uint32_t a[4] = {tf32(av[0]), tf32(av[1]),
                                               tf32(av[2]), tf32(av[3])};
                        mma_tf32(c[nt], a, tf32(b[0]), tf32(b[4]));
                    } else {
                        uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            split_tf32(av[q], ah[q], al[q]);
                        split_tf32(b[0], bh0, bl0);
                        split_tf32(b[4], bh1, bl1);
                        mma_tf32(c[nt], al, bh0, bh1);
                        mma_tf32(c[nt], ah, bl0, bl1);
                        mma_tf32(c[nt], ah, bh0, bh1);
                    }
                }
            }
        }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
        float* o = out + (row0 + gq) * MM_RUNW + nt * 8 + 2 * tq;
        o[0] = c[nt][0];
        o[1] = c[nt][1];
        o[8 * MM_RUNW] = c[nt][2];
        o[8 * MM_RUNW + 1] = c[nt][3];
    }
    if (sink) out[t] = junk;          // keeps mode 0's other columns live
}

}  // namespace

extern "C" int fma_ceiling(const float* x, float* out, long long n,
                           int nchain, int length, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned nblk = (unsigned)((n + 255) / 256);
    if (n < 0 || length < 0) return (int)cudaErrorInvalidValue;
    if (nblk == 0) return 0;
    switch (nchain) {
    case 1: fma_chains<1><<<nblk, 256, 0, st>>>(x, out, n, length); break;
    case 2: fma_chains<2><<<nblk, 256, 0, st>>>(x, out, n, length); break;
    case 4: fma_chains<4><<<nblk, 256, 0, st>>>(x, out, n, length); break;
    case 8: fma_chains<8><<<nblk, 256, 0, st>>>(x, out, n, length); break;
    case 16: fma_chains<16><<<nblk, 256, 0, st>>>(x, out, n, length); break;
    case 32: fma_chains<32><<<nblk, 256, 0, st>>>(x, out, n, length); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// variant: 0 loads, 1 many (cp.async), 2 many (TMA), 3 few (TMA),
// 4 pipe (cp.async ring); adds one call's fold into out [nprog * 8, 128]
extern "C" int staging(int variant, const float* src, const int* starts,
                       int starts_ld, float* out, int F, long long NS,
                       int nprog, int K, void* stream)
{
    const Src s{src, starts, starts_ld, F, K, NS};
    cudaError_t e = staging_launch(variant, s, out, nprog,
                                   (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// mode: 0 none, 1 f32 (TF32), 2 f32_highest (3xTF32), 3 bf16; x [16, 192]
// and out [64, 192] float32, out zeroed by the caller
extern "C" int mma_micro(int mode, const float* x, float* out, int ncell,
                         int vpu_flops, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    if (ncell < 0 || vpu_flops < 0) return (int)cudaErrorInvalidValue;
    if (ncell == 0) return 0;
    switch (mode) {
    case 0: mma_micro_kernel<0><<<ncell, 128, 0, st>>>(x, out, vpu_flops, 0);
        break;
    case 1: mma_micro_kernel<1><<<ncell, 128, 0, st>>>(x, out, vpu_flops, 0);
        break;
    case 2: mma_micro_kernel<2><<<ncell, 128, 0, st>>>(x, out, vpu_flops, 0);
        break;
    case 3: mma_micro_kernel<3><<<ncell, 128, 0, st>>>(x, out, vpu_flops, 0);
        break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// 1: cuTensorMapEncodeTiled through the runtime's driver entry point;
// 2: linked against libcuda; 0: not reachable (the TMA variants fail)
extern "C" int tma_encoder(void)
{
    int how;
    encoder(&how);
    return how;
}
