// Four stripped forms of the blend forward's loop (D6).
//
// Replace the TPU kernels of scripts/profile_kernel_variants.py: make_call
// (:50) around k_dma_only (:66), k_exp_only (:77), k_slices (:91) and
// k_scans (:108), which the JAX authors timed to find what bounds K1.
// Plain versions: fourdgs_tpu_torch/ops/blend_variants.py.
//
// attrs (nt, nch * 32, 16) float32, px (nt, P) float32 -> out (nt, P): for
// tile t and pixel p, acc summed over the nch chunks of 32 rows a of
// attrs[t]:
//   dma_only  acc += a[0][0] * px                    (the chunk's row 0)
//   exp_only  acc += sum_r exp(-0.5 x_r^2),  x_r = a[r][0] - px
//   slices    acc += sum_r (a[r][0] - px + sum_{i=1..9} a[r][i] px)
//   scans     acc += sum_r (P1_r + P2_r), P1 and P2 the inclusive prefix
//             products over the chunk's rows of (1 - 0.001 x_r) and
//             (1 - 0.002 x_r), x_r = a[r][0] px
// Each body evaluates its function at every pixel and row (no sum over rows
// is taken out of the pixel loop), and every chunk of attrs passes through
// shared memory before any thread reads it, so dma_only still moves all of
// attrs, as the TPU variant did. The prefix products, a Kogge-Stone scan
// over sublanes on the TPU, are a serial product in the thread.
//
// Bound on an H100: dma_only by bytes (attrs, px and out once: 128 MB at
// the script's shapes, 2,504 tiles x 24 chunks, 0.038 ms at 3.35 TB/s);
// the other three by the operations their function needs over the 492M
// pixel x row evaluations (tools/profile_kernel_variants.py:FP32_PER_ROW):
// exp_only by its exps on the SFU, slices and scans by FP32 issue. What the
// design does about each:
//   * Issue. A thread holds kPix pixels, so each row's attributes are read
//     from shared memory once for kPix pixels (16-byte broadcast loads:
//     three a row for slices' ten floats), and the FP32 work the bound
//     counts fills the issue slots.
//   * The copy. A tile's chunk is one contiguous 2 KB block: one TMA bulk
//     copy (cp.async.bulk), issued by one thread, lands it in a ring of
//     kStages stages and completes on the stage's `full` mbarrier. Threads
//     wait on that barrier, not on __syncthreads; each warp arrives on the
//     stage's `empty` barrier when it has read it, and the issuing thread
//     waits on that before it copies the chunk kStages ahead into it.
//   * The wave tail. At 256 pixels a tile is one warp, so with 4 KB of
//     ring a block the H100 holds every one of the script's 2,504 tiles at
//     once (19 a SM), where 256-thread blocks ran 2.37 waves.
//   * exp_only. exp(-0.5 x^2) is one ex2.approx.ftz of
//     (x x) (-0.5 log2 e): one MUFU.EX2 and the four FP32 operations the
//     bound counts, where expf issued about five more.
// On an H100 80GB HBM3 at 700 W these took the four bodies from 1.6-2.2x
// their bounds by CUDA events to 1.3-1.5x (1.1-1.4x on the device), at the
// 1,980 MHz clock the bounds assume (tools/profile_kernel_variants.py on
// the card; PERF.md section 6). Of the choices timed there, by device
// time: expf instead of ex2 took exp_only's 0.149 ms
// to 0.227; slices' multiply-adds pixel by pixel instead of attribute by
// attribute took it from 0.235 ms to 0.280; 4 pixels a thread read within
// 3 % of 8, and 1 pixel (eight warps a tile, 2.37 waves) took slices pixel
// by pixel from 0.280 to 0.341; 4 stages or 4 rows unrolled cost scans and
// exp_only 4-5 %.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;          // rows per chunk, the script's K
constexpr int kAttrW = 16;         // floats per row
constexpr int kChunkFloats = kRows * kAttrW;
constexpr unsigned kChunkBytes = kChunkFloats * sizeof(float);
constexpr int kPix = 8;            // pixels a thread
constexpr int kStages = 2;         // ring depth, a power of two
constexpr int kMaxPix = 1024;      // pixels a tile
constexpr int kMaxThreads = kMaxPix / kPix;
constexpr int kRowUnroll = 8;
constexpr float kExpScale = -0.721347520444481703680f;  // -0.5 log2(e)

enum Body { kDmaOnly = 0, kExpOnly = 1, kSlices = 2, kScans = 3 };

__device__ __forceinline__ unsigned smem(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
    } while (!done);
}

// Copy one chunk into a stage with the TMA; it completes on `bar`.
__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem(bar)), "r"(kChunkBytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem(dst)), "l"(src), "r"(kChunkBytes), "r"(smem(bar))
        : "memory");
}

__device__ __forceinline__ float ex2(float u) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(u));
    return y;
}

// One chunk's contribution to each of the thread's pixels.
template <int B>
__device__ __forceinline__ void chunk_body(const float* rows,
                                           const float (&x)[kPix],
                                           float (&acc)[kPix]) {
    if (B == kDmaOnly) {
        const float a0 = rows[0];
#pragma unroll
        for (int k = 0; k < kPix; ++k) acc[k] += a0 * x[k];
        return;
    }
    float sum[kPix], p1[kPix], p2[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
        sum[k] = 0.0f;
        p1[k] = 1.0f;
        p2[k] = 1.0f;
    }
#pragma unroll kRowUnroll
    for (int r = 0; r < kRows; ++r) {
        const float* a = rows + r * kAttrW;
        if (B == kExpOnly) {
            const float a0 = a[0];
#pragma unroll
            for (int k = 0; k < kPix; ++k) {
                const float d = a0 - x[k];
                sum[k] += ex2(d * d * kExpScale);
            }
        } else if (B == kSlices) {
            const float4 lo = *reinterpret_cast<const float4*>(a);
            const float4 mid = *reinterpret_cast<const float4*>(a + 4);
            const float2 hi = *reinterpret_cast<const float2*>(a + 8);
            const float c[10] = {lo.x, lo.y, lo.z, lo.w, mid.x, mid.y,
                                 mid.z, mid.w, hi.x, hi.y};
            // attribute by attribute: kPix independent multiply-adds
            // between two that depend on each other
            float s[kPix];
#pragma unroll
            for (int k = 0; k < kPix; ++k) s[k] = c[0] - x[k];
#pragma unroll
            for (int i = 1; i < 10; ++i)
#pragma unroll
                for (int k = 0; k < kPix; ++k) s[k] += c[i] * x[k];
#pragma unroll
            for (int k = 0; k < kPix; ++k) sum[k] += s[k];
        } else {
            const float a0 = a[0];
#pragma unroll
            for (int k = 0; k < kPix; ++k) {
                const float v = a0 * x[k];
                p1[k] *= 1.0f - 0.001f * v;
                p2[k] *= 1.0f - 0.002f * v;
                sum[k] += p1[k] + p2[k];
            }
        }
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) acc[k] += sum[k];
}

// A block per tile, blockDim.x = 32 ceil(n_pix / (32 kPix)) threads; thread
// t holds pixels t + k blockDim.x, k < kPix.
template <int B>
__global__ void __launch_bounds__(kMaxThreads)
blend_variant_kernel(const float* __restrict__ attrs,
                     const float* __restrict__ px, int nch, int n_pix,
                     float* __restrict__ out) {
    __shared__ __align__(128) float ring[kStages][kChunkFloats];
    __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
    const int t = threadIdx.x;
    const int tile = blockIdx.x;
    const float* src = attrs + (size_t)tile * nch * kChunkFloats;
    if (t == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], blockDim.x / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (t == 0)
        for (int s = 0; s < kStages && s < nch; ++s)
            copy_chunk(ring[s], src + (size_t)s * kChunkFloats, &full[s]);

    const float* row_px = px + (size_t)tile * n_pix;
    float x[kPix], acc[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
        const int p = t + k * blockDim.x;
        x[k] = p < n_pix ? row_px[p] : 0.0f;
        acc[k] = 0.0f;
    }
#pragma unroll 1
    for (int j = 0; j < nch; ++j) {
        const int s = j % kStages;
        const unsigned parity = (j / kStages) & 1;
        mbar_wait(&full[s], parity);
        chunk_body<B>(ring[s], x, acc);
        __syncwarp();
        if ((t & 31) == 0) mbar_arrive(&empty[s]);
        if (t == 0 && j + kStages < nch) {
            mbar_wait(&empty[s], parity);
            // the warps' reads of the stage before the TMA's write
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            copy_chunk(ring[s], src + (size_t)(j + kStages) * kChunkFloats,
                       &full[s]);
        }
    }
    float* row_out = out + (size_t)tile * n_pix;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
        const int p = t + k * blockDim.x;
        if (p < n_pix) row_out[p] = acc[k];
    }
}

template <int B>
cudaError_t launch(const float* attrs, const float* px, int nt, int nch,
                   int n_pix, float* out, cudaStream_t stream) {
    // all the shared memory the SM has, so that every tile of the script's
    // shape is resident at once
    static const cudaError_t carveout = cudaFuncSetAttribute(
        blend_variant_kernel<B>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (carveout != cudaSuccess) return carveout;
    const int threads = 32 * ((n_pix + 32 * kPix - 1) / (32 * kPix));
    blend_variant_kernel<B><<<nt, threads, 0, stream>>>(attrs, px, nch,
                                                        n_pix, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; return the cudaError_t of the launch (0 = ok).
// body: 0 dma_only, 1 exp_only, 2 slices, 3 scans. attrs (nt, nch * 32,
// 16) float32, 16-byte aligned; px and out (nt, n_pix) float32,
// 1 <= n_pix <= 1024.
int blend_variant_launch(int body, const void* attrs, const void* px,
                         int nt, int nch, int n_pix, void* out,
                         void* stream) {
    if (nt == 0) return 0;
    if (n_pix < 1 || n_pix > kMaxPix) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const float* a = (const float*)attrs;
    const float* x = (const float*)px;
    float* o = (float*)out;
    switch (body) {
        case kDmaOnly: return (int)launch<kDmaOnly>(a, x, nt, nch, n_pix, o, s);
        case kExpOnly: return (int)launch<kExpOnly>(a, x, nt, nch, n_pix, o, s);
        case kSlices: return (int)launch<kSlices>(a, x, nt, nch, n_pix, o, s);
        case kScans: return (int)launch<kScans>(a, x, nt, nch, n_pix, o, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
