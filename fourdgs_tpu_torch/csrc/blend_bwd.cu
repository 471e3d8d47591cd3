// Blend backward: per-gaussian gradients of the per-tile front-to-back
// alpha compositing, summed inside the kernel.
//
// Replaces the TPU kernel fourdgs_tpu/ops/pallas/blend.py:_bwd_fused_kernel
// (K2). Semantics: the XLA custom VJP of fourdgs_tpu/ops/rasterize_tiled.py
// (`_make_blend.blend_bwd`). Plain version:
// fourdgs_tpu_torch/ops/blend.py:blend_backward_plain.
//
// What it computes. Per pixel, rc = c_final . g_c, rd = d_final * g_d and
// rt = g_t * T_final, from K1's outputs and their cotangents, so no
// back-to-front pass is needed. The kernel replays K1's recurrence in
// forward order with the same gate decisions (blend_common.cuh), keeping
// the running prefix sums after_cg += w (c . g_c) and after_dg += w z g_d,
// and for each used slot takes the alpha gradient by the suffix identity
//   da = t_pref (c . g_c + z g_d)
//        - (rc - after_cg + rd - after_dg + rt) / max(1 - alpha, 0.01),
// chains it to opacity (alpha_u / op), to the power (da * alpha_u) and so
// to pix and the conic, and takes w g_c and w g_d for color and depth:
// ten values [pix(2), conic(3), color(3), opacity, depth] per pixel x slot.
//
// Design. The structure of K1 (blend_fwd.cu): one block per tile, one
// thread per pixel, each chunk's table rows gathered by gidx into shared
// memory, the occupancy bound counts[tile] and the block-wide saturation
// exit. The ten values of a slot are summed over the warp with
// __shfl_down_sync wherever some lane of the warp used the slot, and lane 0
// adds them into a per-chunk (chunk x 10) shared accumulator with shared
// atomics; after the chunk, one global atomicAdd per nonzero (slot, value)
// adds the block's sums into the (N+1, 10) table that the wrapper
// zero-fills (row N is the sentinel). The TPU kernel's lane-packed VMEM
// accumulator and its serial row loop have no counterpart here: device
// memory holds the table and atomics do the sum. The order of the atomic
// sums varies from run to run, so results agree with the plain version to
// rounding, not bit for bit.
//
// Control flow stays warp-uniform around the shuffles: a lane whose pixel
// is saturated, or whose entering transmittance fell to 1e-4, keeps walking
// the slots with zero contributions, and the warp leaves a chunk only when
// every lane has stopped (__all_sync).
//
// Bound on an H100. Per evaluated pixel x slot the replay costs what K1's
// loop costs up to the alpha test; a used slot adds the gradient chain
// (about 40 FP32 instructions); and every slot that some lane of a warp
// used costs the warp 10 five-step shuffle reductions (50 shuffles and 50
// adds a warp, whatever the number of lanes that used it). The bytes are
// K1's plus the cotangents and the (N+1, 10) table. So K2 is bound by
// operations: chip_smoke.py counts this run's evaluations, used slots and
// atomics and computes the bound from FP32 issue, MUFU and bytes.
//
// What this simple design leaves for later: the warp reductions cost as
// much as the per-pixel work; a block-level transpose (each warp writes its
// ten values per slot to shared memory, then one thread per slot sums
// them) or a segmented reduction over only the warps that used a slot would
// cut them. Registers cap a 1024-thread block at 64 a thread.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace fourdgs;

__global__ void __launch_bounds__(1024)
blend_bwd_kernel(const int* __restrict__ gidx,
                 const int* __restrict__ counts,
                 const float4* __restrict__ table,
                 int n_gauss, int tile_cap, int grid_x, int tile_size,
                 int chunk, const float* __restrict__ out_color,
                 const float* __restrict__ out_depth,
                 const float* __restrict__ out_t,
                 const float* __restrict__ g_color,
                 const float* __restrict__ g_depth,
                 const float* __restrict__ g_t, float* __restrict__ grads) {
    extern __shared__ float4 smem[];
    float4* s_rows = smem;                                     // chunk x 3
    float* s_acc = reinterpret_cast<float*>(smem + 3 * chunk);  // chunk x 10
    const int tile = blockIdx.x;
    const int p = threadIdx.x;
    const int n_pix = blockDim.x;
    const int lane = p & 31;
    const int count = counts[tile];
    const int* tile_gidx = gidx + (size_t)tile * tile_cap;
    const BwdPixel q = load_bwd_pixel(tile, p, grid_x, tile_size,
                                      (size_t)tile * n_pix + p, out_color,
                                      out_depth, out_t, g_color, g_depth,
                                      g_t);

    float T = 1.0f, after_cg = 0.0f, after_dg = 0.0f;
    for (int base = 0; base < count; base += chunk) {
        const int nk = min(chunk, count - base);
        gather_rows(s_rows, tile_gidx, table, base, nk, n_gauss);
        for (int i = p; i < nk * kGradW; i += n_pix) s_acc[i] = 0.0f;
        __syncthreads();
        const bool live = T > kTMin;
        if (__any_sync(kFullMask, live)) {
            float cp = 1.0f;
            bool stop = !live;
            for (int k = 0; k < nk; ++k) {
                float v[kGradW];
#pragma unroll
                for (int i = 0; i < kGradW; ++i) v[i] = 0.0f;
                const bool used =
                    !stop && slot_grads(s_rows[3 * k], s_rows[3 * k + 1],
                                        s_rows[3 * k + 2], q, T, cp,
                                        after_cg, after_dg, stop, v);
                if (__any_sync(kFullMask, used)) {
#pragma unroll
                    for (int i = 0; i < kGradW; ++i) v[i] = warp_sum(v[i]);
                    if (lane == 0) {
#pragma unroll
                        for (int i = 0; i < kGradW; ++i)
                            if (v[i] != 0.0f)
                                atomicAdd(&s_acc[k * kGradW + i], v[i]);
                    }
                }
                if (__all_sync(kFullMask, stop)) break;
            }
            if (live) T = __fmul_rn(T, cp);
        }
        __syncthreads();
        // flush the chunk's sums: one global atomic per nonzero value
        for (int i = p; i < nk * kGradW; i += n_pix) {
            const float v = s_acc[i];
            if (v != 0.0f) {
                const int slot = i / kGradW;
                int g = tile_gidx[base + slot];
                g = (g < 0 || g > n_gauss) ? n_gauss : g;
                atomicAdd(&grads[(size_t)g * kGradW + (i - slot * kGradW)],
                          v);
            }
        }
        // barrier before the next chunk overwrites s_rows and s_acc, and
        // the block-wide saturation test
        if (__syncthreads_count(T > kTMin) == 0) break;
    }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// table is (n_gauss + 1, 16) and grads (n_gauss + 1, 10) float32, grads
// zero-filled by the caller; the forward outputs and their cotangents are
// tile-major (num_tiles, P[, 3]).
int blend_bwd_launch(const void* gidx, const void* counts, const void* table,
                     int n_gauss, int num_tiles, int tile_cap, int grid_x,
                     int tile_size, int chunk, const void* out_color,
                     const void* out_depth, const void* out_t,
                     const void* g_color, const void* g_depth,
                     const void* g_t, void* grads, void* stream) {
    const int n_pix = tile_size * tile_size;
    const size_t smem = (size_t)chunk * (3 * sizeof(float4)
                                         + fourdgs::kGradW * sizeof(float));
    blend_bwd_kernel<<<num_tiles, n_pix, smem, (cudaStream_t)stream>>>(
        (const int*)gidx, (const int*)counts, (const float4*)table, n_gauss,
        tile_cap, grid_x, tile_size, chunk, (const float*)out_color,
        (const float*)out_depth, (const float*)out_t, (const float*)g_color,
        (const float*)g_depth, (const float*)g_t, (float*)grads);
    return (int)cudaGetLastError();
}

}  // extern "C"
