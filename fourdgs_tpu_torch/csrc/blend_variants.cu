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
// Each body keeps K1's structure (csrc/blend_fwd.cu): one block per tile,
// one thread per pixel, and each chunk's 32 rows of 16 floats staged
// through shared memory before any thread reads them, so that dma_only
// still moves all of attrs, as the TPU variant did. The prefix products,
// a Kogge-Stone scan over sublanes on the TPU, are a serial product in the
// thread. The row loop is unrolled and the chunk loop is not.
//
// Bound on an H100: dma_only by bytes (attrs, px and out once: 128 MB at
// the script's shapes, 2,504 tiles x 24 chunks, 0.038 ms at 3.35 TB/s);
// the other three by the operations their function needs over the 492M
// pixel x row evaluations (tools/profile_kernel_variants.py:FP32_PER_ROW):
// exp_only by its exps on the SFU, slices and scans by FP32 issue.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;     // rows per chunk, the script's K
constexpr int kAttrW = 16;    // floats per row

enum Body { kDmaOnly = 0, kExpOnly = 1, kSlices = 2, kScans = 3 };

template <int B>
__global__ void __launch_bounds__(1024)
blend_variant_kernel(const float4* __restrict__ attrs,
                     const float* __restrict__ px, int nch, int n_pix,
                     float* __restrict__ out) {
    __shared__ float4 s_rows[kRows * kAttrW / 4];
    const float* rows = reinterpret_cast<const float*>(s_rows);
    const int tile = blockIdx.x;
    const int p = threadIdx.x;
    const float x_p = px[(size_t)tile * n_pix + p];
    const float4* src = attrs + (size_t)tile * nch * (kRows * kAttrW / 4);
    float acc = 0.0f;
#pragma unroll 1
    for (int j = 0; j < nch; ++j) {
        for (int q = p; q < kRows * kAttrW / 4; q += n_pix)
            s_rows[q] = src[(size_t)j * (kRows * kAttrW / 4) + q];
        __syncthreads();
        if (B == kDmaOnly) {
            acc += rows[0] * x_p;
        } else {
            float sum = 0.0f;
            float p1 = 1.0f, p2 = 1.0f;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const float* a = rows + r * kAttrW;
                if (B == kExpOnly) {
                    const float x = a[0] - x_p;
                    sum += expf(-0.5f * x * x);
                } else if (B == kSlices) {
                    float s = a[0] - x_p;
#pragma unroll
                    for (int i = 1; i < 10; ++i) s += a[i] * x_p;
                    sum += s;
                } else {
                    const float x = a[0] * x_p;
                    p1 *= 1.0f - 0.001f * x;
                    p2 *= 1.0f - 0.002f * x;
                    sum += p1 + p2;
                }
            }
            acc += sum;
        }
        __syncthreads();      // before the next chunk overwrites s_rows
    }
    out[(size_t)tile * n_pix + p] = acc;
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
    const cudaStream_t s = (cudaStream_t)stream;
    const float4* a = (const float4*)attrs;
    const float* x = (const float*)px;
    float* o = (float*)out;
    switch (body) {
        case kDmaOnly:
            blend_variant_kernel<kDmaOnly><<<nt, n_pix, 0, s>>>(a, x, nch,
                                                                n_pix, o);
            break;
        case kExpOnly:
            blend_variant_kernel<kExpOnly><<<nt, n_pix, 0, s>>>(a, x, nch,
                                                                n_pix, o);
            break;
        case kSlices:
            blend_variant_kernel<kSlices><<<nt, n_pix, 0, s>>>(a, x, nch,
                                                               n_pix, o);
            break;
        case kScans:
            blend_variant_kernel<kScans><<<nt, n_pix, 0, s>>>(a, x, nch,
                                                              n_pix, o);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
