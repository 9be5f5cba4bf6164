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
// P5: every cell runs the script's 9 dots [64, 192] x [192, 16] of
// w_g = (x[0, :] + row) * (1 + g) after vpu_flops elementwise steps
// w = w * 1.000001 + 0.5 (rounded as the plain version: no contraction)
// against B = x[0:16, :]^T, summed into acc [64, 16]:
//   mode 0 none    no product: acc += w[:, :16]
//   mode 1 f32     TF32 (a float32 product at TF32 precision)
//   mode 2 f32_highest  3xTF32 (lo*hi + hi*lo + hi*hi), float32 accuracy
//   mode 3 bf16    bf16 operands, float32 accumulation
// Every cell computes the same [64, 16] result and it is written into
// columns 0-15 of out (the TPU program writes one out block); the other
// 176 columns stay zero. Bound: the tensor-core operations of the mode,
// or the fp32 elementwise work, whichever is larger. Two designs:
//   mma_sync  a block per cell (4 warps, 16 rows each), mma.sync m16n8k8
//             (TF32) or m16n8k16 (bf16), B reloaded from shared memory
//             at every step; mode 0's loop serves both designs
//   wgmma     modes 1-3: persistent warpgroups (see mma_micro_wgmma)

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

// --------------------------------------------------------------------------
// P5, wgmma design
// --------------------------------------------------------------------------
//
// A block is one warpgroup (128 threads; warp w holds rows 16 w to
// 16 w + 15) and walks the cells blockIdx.x, + gridDim.x, ...; the grid
// is the SM count times the blocks an SM holds. What the mma_sync design
// repeats at every step is done once a block here:
//   - B is staged once in shared memory in wgmma's K-major canonical
//     layout without swizzle: 8 x 16-byte core matrices of 128 contiguous
//     bytes, core (kc, nb) (16-byte K chunk kc, rows 8 nb to 8 nb + 7 of
//     B^T) at byte 128 (2 kc + nb), so LBO (the next core along K) is 256
//     bytes and SBO (the next 8 rows) 128; a k-step (32 bytes of K)
//     starts 512 bytes further. A warpgroup reads whole 128-byte cores,
//     which span the 32 banks once. Mode 1 holds B rounded to TF32,
//     mode 2 its hi and lo parts (split once), mode 3 B in bf16. The
//     descriptors are built once.
//   - x[0, :] is staged permuted, so a thread reads the columns of 16
//     w columns for its two rows with one 16-byte load.
// A is the w tile in registers (wgmma's register-A form, which TF32 and
// bf16 both take): each thread computes its fragment elementwise, as
// the mma_sync design does, and the tensor cores read it from the
// registers, so the [64, 192] tile never goes through shared memory
// (at n16 a shared-memory A would be read at 4x the bytes of B a step).
// A chunk is 96 of a dot's 192 columns (12 k8 steps of TF32, 6 k16
// steps of bf16; 3xTF32 32 columns, 4 k8 steps, so that its hi and lo
// parts fit twice in the registers at 3 blocks an SM), 48 floats a
// thread (3xTF32 16); a cell is 18 chunks (54). Longer chunks mean fewer
// commit/wait rounds and longer chains at fewer blocks an SM; 96 columns
// are the longest whose two buffers TF32 keeps in registers at 2 blocks
// an SM. Two chunk buffers alternate: the chain of chunk q is
// issued (wgmma.fence, the steps, commit_group), then chunk q + 1's w
// and its vpu_flops chain are computed while the tensor cores run q,
// and only then wait_group 1 frees q's buffer for q + 2. With OVERLAP
// false, wait_group 0 follows every commit (the chain and the
// elementwise work of one warpgroup in turn, for measuring the
// overlap). A cell's first step starts the accumulator afresh (scale-d
// 0), so the registers that the last cell leaves are its sum, as every
// cell's. The rows enter the w of each chunk through an empty asm, so
// the compiler can neither hoist a chunk's elementwise work out of the
// cell loop nor merge it across cells.
// Rounding, as the mma_sync design's: B is rounded to TF32 (cvt.rna) or
// split (hi = cvt.rna(x), lo = cvt.rna(x - hi)) once, A in each chunk
// the same way but by integer operations (mw_tf32, bit-equal to
// cvt.rna); the chains run lo*hi, hi*lo, hi*hi a step into the one
// accumulator. So the two designs differ only in the order of the sums.
//
// Built with -DMW_PART=1 or 2 (ops/_cuda.py's VARIANTS probes_product
// and probes_elementwise), the kernel loses one of its two parts, so
// that probes/mma_parts.py can time each alone:
//   1 product      no elementwise work: w's columns and rows go to the
//                  conversion as loaded (no add, multiply or vpu_flops
//                  steps)
//   2 elementwise  no product: each wgmma becomes two lop3 that fold its
//                  A registers into the accumulator (half an instruction
//                  an element, so that nothing is dead)

#ifndef MW_PART
#define MW_PART 0
#endif

constexpr int MW_GROUPS = MM_RUNW / 16;       // 16-column groups a row
constexpr int MW_B_WORDS = MM_N * MM_RUNW;    // 32-bit words of TF32 B

// the K-major, no-swizzle shared-memory matrix descriptor at p: start
// address, LBO 256 bytes, SBO 128 bytes (16-byte units), layout type 0
__device__ __forceinline__ uint64_t mw_desc(const void* p)
{
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
        | ((uint64_t)(256 >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

// the word of element (n, k) of B^T [16, 192] with `per` elements in 16
// bytes (TF32 4, bf16 8) in the layout above, in units of an element
__device__ __forceinline__ int mw_core_index(int n, int k, int per)
{
    return (((k / per) * 2 + n / 8) * 8 + n % 8) * per + k % per;
}

__device__ __forceinline__ void wg_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// cvt.rna.tf32.f32 by an integer add and a mask (nearest, ties away
// from zero: the carry out of the 13 dropped bits rounds the
// magnitude), bit-equal for finite x and cheaper than the cvt here
// (PERF.md, P5).
__device__ __forceinline__ uint32_t mw_tf32(float x)
{
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

#if MW_PART == 2
// MW_PART 2's stand-in for a wgmma
__device__ __forceinline__ void mw_fold(float (&d)[8], const uint32_t* a)
{
    asm volatile("lop3.b32 %0, %0, %2, %3, 0x96;\n"
                 "lop3.b32 %1, %1, %4, %5, 0x96;\n"
                 : "+f"(d[0]), "+f"(d[1])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]));
}
#endif

// d += (or = with acc 0) A [64, 8] (registers) x B [8, 16] (desc)
__device__ __forceinline__ void wg_tf32(float (&d)[8], const uint32_t* a,
                                        uint64_t desc, int acc)
{
#if MW_PART == 2
    mw_fold(d, a);
#else
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
        "p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
#endif
}

// d += (or = with acc 0) A [64, 16] (registers) x B [16, 16] (desc)
__device__ __forceinline__ void wg_bf16(float (&d)[8], const uint32_t* a,
                                        uint64_t desc, int acc)
{
#if MW_PART == 2
    mw_fold(d, a);
#else
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
        "p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
#endif
}

// the chunk of mode MODE: COLS of the 192 w columns, NV floats of them a
// thread (2 rows x COLS / 4), STEPS k-steps, NA fragment registers
template <int MODE>
struct MwChunk {
    static constexpr int COLS = MODE == 2 ? 32 : 96;
    static constexpr int CHUNKS = MM_RUNW / COLS;        // a dot
    static constexpr int PER_CELL = 9 * CHUNKS;
    static constexpr int NV = COLS / 2;
    static constexpr int STEPS = COLS / (MODE == 3 ? 16 : 8);
    static constexpr int NA = MODE == 2 ? 2 * NV : MODE == 3 ? NV / 2 : NV;
};

// one chunk's A fragment: mode 1 a[NV] (4 a k8 step), mode 2 a[0:NV] hi
// and a[NV:2 NV] lo, mode 3 a[NV / 2] (4 bf16 pairs a k16 step)
template <int MODE>
struct MwFrag {
    uint32_t a[MwChunk<MODE>::NA];
};

// chunk q of the walk (cell q / PER_CELL, dot g, chunk c of the dot)
// into f: the thread's rows ra, ra + 8 and, for each of the chunk's
// 16-column groups, the four columns p of its permuted x, in the order
// v = {w(ra, p0), w(rb, p0), w(ra, p1), w(rb, p1), ...}. The empty asm
// at the end keeps the fragment's definitions ahead of the chain in the
// compiler's order (CUTLASS's warpgroup_fence_operand). ptxas still
// moves bf16's packing and TF32's rounding next to each wgmma and then
// serializes those chains (its C7513 note in the build log); 3xTF32's
// is not.
template <int MODE>
__device__ __forceinline__ void mw_compute(MwFrag<MODE>& f,
                                           const float4* xq, int q,
                                           float ra, float rb, int tq,
                                           int vpu_flops)
{
    using C = MwChunk<MODE>;
    const int qq = q % C::PER_CELL, g = qq / C::CHUNKS, c = qq % C::CHUNKS;
    asm volatile("" : "+f"(ra), "+f"(rb));
    [[maybe_unused]] const float scale = (float)(1 + g);
    float v[C::NV];
#pragma unroll
    for (int j = 0; j < C::NV / 8; ++j) {
        const float4 p = xq[(C::NV / 8 * c + j) * 4 + tq];
        const float pc[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#if MW_PART == 1
            v[8 * j + 2 * i] = pc[i];
            v[8 * j + 2 * i + 1] = rb;
#else
            v[8 * j + 2 * i] = __fmul_rn(__fadd_rn(pc[i], ra), scale);
            v[8 * j + 2 * i + 1] = __fmul_rn(__fadd_rn(pc[i], rb), scale);
#endif
        }
    }
    for (int s = 0; s < (MW_PART == 1 ? 0 : vpu_flops); ++s) {
#pragma unroll
        for (int e = 0; e < C::NV; ++e)
            v[e] = __fadd_rn(__fmul_rn(v[e], 1.000001f), 0.5f);
    }
    if constexpr (MODE == 1) {
#pragma unroll
        for (int e = 0; e < C::NV; ++e) f.a[e] = mw_tf32(v[e]);
    } else if constexpr (MODE == 2) {
#pragma unroll
        for (int e = 0; e < C::NV; ++e) {
            f.a[e] = mw_tf32(v[e]);
            f.a[C::NV + e] = mw_tf32(v[e] - __uint_as_float(f.a[e]));
        }
    } else {
#pragma unroll
        for (int s = 0; s < C::STEPS; ++s) {
            const float* w = v + 8 * s;
            f.a[4 * s] = bf16x2(w[0], w[2]);
            f.a[4 * s + 1] = bf16x2(w[1], w[3]);
            f.a[4 * s + 2] = bf16x2(w[4], w[6]);
            f.a[4 * s + 3] = bf16x2(w[5], w[7]);
        }
    }
#pragma unroll
    for (int e = 0; e < C::NA; ++e) asm volatile("" : "+r"(f.a[e]));
}

// chunk q's chain, committed as one group
template <int MODE>
__device__ __forceinline__ void mw_issue(float (&d)[8], const MwFrag<MODE>& f,
                                         int q, uint64_t dhi, uint64_t dlo)
{
    using C = MwChunk<MODE>;
    const int qq = q % C::PER_CELL, c = qq % C::CHUNKS;
    const int acc0 = qq != 0;
    wg_fence();
#pragma unroll
    for (int s = 0; s < C::STEPS; ++s) {
        const uint64_t off = 32 * (C::STEPS * c + s);   // 512 bytes a step
        const int acc = s == 0 ? acc0 : 1;
        if constexpr (MODE == 1) {
            wg_tf32(d, f.a + 4 * s, dhi + off, acc);
        } else if constexpr (MODE == 2) {
            wg_tf32(d, f.a + C::NV + 4 * s, dhi + off, acc);
            wg_tf32(d, f.a + 4 * s, dlo + off, 1);
            wg_tf32(d, f.a + 4 * s, dhi + off, 1);
        } else {
            wg_bf16(d, f.a + 4 * s, dhi + off, acc);
        }
    }
    wg_commit();
}

template <int MODE, bool OVERLAP>
__global__ void __launch_bounds__(128)
mma_micro_wgmma(const float* __restrict__ x, float* __restrict__ out,
                int ncell, int vpu_flops)
{
    static_assert(MODE >= 1 && MODE <= 3, "modes 1-3 take a product");
    constexpr int NB = MODE == 3 ? MW_B_WORDS / 2 : MW_B_WORDS;
    __shared__ __align__(128) uint32_t bs[MODE == 2 ? 2 * NB : NB];
    __shared__ __align__(16) float4 xq[MW_GROUPS * 4];
    const int t = threadIdx.x;
    if constexpr (MODE == 3) {
        for (int e = t; e < MW_B_WORDS / 2; e += 128) {
            const int n = e / (MM_RUNW / 2), k = 2 * (e % (MM_RUNW / 2));
            const float* b = x + n * MM_RUNW + k;
            bs[mw_core_index(n, k, 8) / 2] = bf16x2(b[0], b[1]);
        }
    } else {
        for (int e = t; e < MW_B_WORDS; e += 128) {
            const int n = e / MM_RUNW, k = e % MM_RUNW;
            const int i = mw_core_index(n, k, 4);
            if constexpr (MODE == 1) {
                bs[i] = tf32(x[e]);
            } else {
                split_tf32(x[e], bs[i], bs[NB + i]);
            }
        }
    }
    if (t < MW_GROUPS * 4) {
        const int j = t / 4, q = t % 4;
        const float* r = x + 16 * j;
        xq[t] = MODE == 3
            ? make_float4(r[2 * q], r[2 * q + 1], r[2 * q + 8], r[2 * q + 9])
            : make_float4(r[q], r[q + 4], r[q + 8], r[q + 12]);
    }
    // the generic proxy's stores are made visible to wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint64_t dhi = mw_desc(bs), dlo = mw_desc(bs + NB);

    const int lane = t % 32, gq = lane / 4, tq = lane % 4;
    const int row = 16 * (t / 32) + gq;
    const float ra = (float)row, rb = (float)(row + 8);
    const int nmine = (int)blockIdx.x < ncell
        ? (ncell - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    const int total = nmine * MwChunk<MODE>::PER_CELL;
    if (total == 0) return;
    float d[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    MwFrag<MODE> fa, fb;
    mw_compute(fa, xq, 0, ra, rb, tq, vpu_flops);
    for (int q = 0;; q += 2) {
        mw_issue(d, fa, q, dhi, dlo);
        if (q + 1 == total) break;
        wg_wait<OVERLAP ? 1 : 0>();                // fb's last chain done
        mw_compute(fb, xq, q + 1, ra, rb, tq, vpu_flops);
        mw_issue(d, fb, q + 1, dhi, dlo);
        if (q + 2 == total) break;
        wg_wait<OVERLAP ? 1 : 0>();                // fa's last chain done
        mw_compute(fa, xq, q + 2, ra, rb, tq, vpu_flops);
    }
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
    // d[i]: row (i / 2) % 2 * 8 + row, column 8 (i / 4) + 2 tq + i % 2
    float* o = out + row * MM_RUNW + 2 * tq;
#pragma unroll
    for (int i = 0; i < 8; ++i)
        o[((i / 2) % 2) * 8 * MM_RUNW + 8 * (i / 4) + i % 2] = d[i];
}

// the kernel of (design, mode): design 0 mma_sync (every mode), 1 wgmma,
// 2 wgmma with its overlap off (modes 1-3); nullptr for none
const void* mma_kernel(int design, int mode)
{
    switch (design * 4 + mode) {
    case 0: return (const void*)mma_micro_kernel<0>;
    case 1: return (const void*)mma_micro_kernel<1>;
    case 2: return (const void*)mma_micro_kernel<2>;
    case 3: return (const void*)mma_micro_kernel<3>;
    case 5: return (const void*)mma_micro_wgmma<1, true>;
    case 6: return (const void*)mma_micro_wgmma<2, true>;
    case 7: return (const void*)mma_micro_wgmma<3, true>;
    case 9: return (const void*)mma_micro_wgmma<1, false>;
    case 10: return (const void*)mma_micro_wgmma<2, false>;
    case 11: return (const void*)mma_micro_wgmma<3, false>;
    default: return nullptr;
    }
}

// the persistent grid of a wgmma kernel: SMs times the blocks of 128
// threads an SM holds
cudaError_t mw_grid(const void* kern, int* per_sm, int* n_sm)
{
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, 128,
                                                          0);
    return e;
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

// design: 0 mma_sync, 1 wgmma, 2 wgmma with its overlap off; mode: 0
// none (mma_sync only), 1 f32 (TF32), 2 f32_highest (3xTF32), 3 bf16;
// x [16, 192] and out [64, 192] float32, out zeroed by the caller
extern "C" int mma_micro(int design, int mode, const float* x, float* out,
                         int ncell, int vpu_flops, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    const void* kern = mma_kernel(design, mode);
    if (kern == nullptr || ncell < 0 || vpu_flops < 0)
        return (int)cudaErrorInvalidValue;
    if (ncell == 0) return 0;
    if (design == 0) {
        int sink = 0;
        void* args[] = {&x, &out, &vpu_flops, &sink};
        cudaError_t e = cudaLaunchKernel(kern, ncell, 128, args, 0, st);
        return (int)(e != cudaSuccess ? e : cudaGetLastError());
    }
    int per_sm, n_sm;
    cudaError_t e = mw_grid(kern, &per_sm, &n_sm);
    if (e != cudaSuccess) return (int)e;
    const int grid = ncell < per_sm * n_sm ? ncell : per_sm * n_sm;
    if (grid == 0) return (int)cudaErrorInvalidConfiguration;
    void* args[] = {&x, &out, &ncell, &vpu_flops};
    e = cudaLaunchKernel(kern, grid, 128, args, 0, st);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// what the kernel of (design, mode) is built and launched with:
// info = {registers a thread, local (spill) bytes a thread, static
// shared bytes, blocks an SM holds, SMs, grid at ncell past it (0: a
// block per cell)}
extern "C" int mma_micro_info(int design, int mode, int* info)
{
    const void* kern = mma_kernel(design, mode);
    if (kern == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kern);
    if (e != cudaSuccess) return (int)e;
    int per_sm, n_sm;
    e = mw_grid(kern, &per_sm, &n_sm);
    if (e != cudaSuccess) return (int)e;
    info[0] = a.numRegs;
    info[1] = (int)a.localSizeBytes;
    info[2] = (int)a.sharedSizeBytes;
    info[3] = per_sm;
    info[4] = n_sm;
    info[5] = design == 0 ? 0 : per_sm * n_sm;
    return 0;
}

// 1: cuTensorMapEncodeTiled through the runtime's driver entry point;
// 2: linked against libcuda; 0: not reachable (the TMA variants fail)
extern "C" int tma_encoder(void)
{
    int how;
    encoder(&how);
    return how;
}
