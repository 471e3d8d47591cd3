// Blend forward: per-tile front-to-back alpha compositing.
//
// Replaces the TPU kernel fourdgs_tpu/ops/pallas/blend.py:_fwd_kernel (K1).
// Semantics: the spec in fourdgs_tpu_torch/ops/rasterize_ref.py. Plain
// version: fourdgs_tpu_torch/ops/blend.py:blend_forward_plain. Every value
// that feeds a gate is computed by blend_common.cuh, in the plain version's
// order of operations with round-to-nearest intrinsics, so that no FMA
// contraction can flip a gate: a flipped T > 1e-4 or alpha >= 1/255
// decision would move a pixel by up to alpha * T, far above the
// comparison's tolerance. Only the color and depth sums differ in
// association.
//
// Design. One block per tile, one thread per pixel (256 threads at
// tile_size 16, 1024 at 32). The block walks the tile's depth-ordered slot
// list in chunks of `chunk` rows: it gathers each chunk's packed rows
// straight from the per-gaussian table by gidx into shared memory (no
// (num_tiles, tile_cap, 16) staging array), and every thread then runs the
// serial recurrence over the chunk for its pixel. The loop stops at the
// tile's occupancy counts[tile] (the TPU kernel's occupancy skip) and as
// soon as no pixel of the block has T > T_MIN, tested with
// __syncthreads_count (its saturation skip). The TPU kernel's in-chunk
// Kogge-Stone scan exists to vectorise the prefix product over sublanes;
// a thread per pixel needs only the serial product.
//
// Bound on an H100. Per evaluated pixel x slot, the loop body issues 12
// FP32-pipe instructions up to the power test, 9 more and one MUFU.EX2 for
// the expf path (expf without fast math is 5 FP32 instructions, the EX2
// and a multiply), and 9 more for a used slot (read off the sm_90a SASS).
// Bytes: gidx and the table rows of the live slots, and the 5 floats per
// pixel written. At the render path's shapes the work is bound by FP32
// issue (128 lanes a clock per SM, 132 SMs, 1.98 GHz): for chip_smoke.py's
// 100k-Gaussian 800x800 frame at tile 32, 39.6M evaluations (12.6M used)
// take 0.028 ms there, against 0.0095 ms for their expfs at the MUFU rate
// (16 a clock per SM) and 0.0046 ms for their 15.3 MB at 3.35 TB/s.
// chip_smoke.py computes the bound from each run's counts.
//
// What this simple design leaves for later: warp-level culling of slots
// that no pixel of a warp uses (every thread evaluates every slot of a
// live chunk), tiles sized for occupancy (a 1024-thread block is one
// block per SM at 64 registers), and double-buffered chunk loads.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace fourdgs;

__global__ void __launch_bounds__(1024)
blend_fwd_kernel(const int* __restrict__ gidx,
                 const int* __restrict__ counts,
                 const float4* __restrict__ table,
                 int n_gauss, int tile_cap, int grid_x, int tile_size,
                 int chunk, float* __restrict__ out_color,
                 float* __restrict__ out_depth, float* __restrict__ out_t) {
    extern __shared__ float4 s_rows[];  // chunk x 3 float4
    const int tile = blockIdx.x;
    const int p = threadIdx.x;
    const int n_pix = blockDim.x;
    const float px = (float)((tile % grid_x) * tile_size + p % tile_size);
    const float py = (float)((tile / grid_x) * tile_size + p / tile_size);
    const int count = counts[tile];
    const int* tile_gidx = gidx + (size_t)tile * tile_cap;

    float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d = 0.0f;
    for (int base = 0; base < count; base += chunk) {
        const int nk = min(chunk, count - base);
        gather_rows(s_rows, tile_gidx, table, base, nk, n_gauss);
        __syncthreads();
        if (T > kTMin) {
            // cp: product of (1 - alpha) over the chunk's gated slots so
            // far; the entering transmittance of a slot is T * cp.
            float cp = 1.0f, cp_used = 1.0f;
            for (int k = 0; k < nk; ++k) {
                const float4 a = s_rows[3 * k];
                const float4 b = s_rows[3 * k + 1];
                const float4 c = s_rows[3 * k + 2];
                float dx, dy;
                const float power = splat_power(a, b, px, py, dx, dy);
                if (power > 0.0f) continue;
                const float alpha = splat_alpha(splat_alpha_u(c.x, power));
                if (!(alpha >= kAlphaMin)) continue;  // NaN skips too
                const float t_pref = __fmul_rn(T, cp);
                if (t_pref <= kTMin) break;  // entering transmittance test
                const float w = __fmul_rn(alpha, t_pref);
                c0 += w * b.y;
                c1 += w * b.z;
                c2 += w * b.w;
                d += w * c.y;
                cp = __fmul_rn(cp, __fsub_rn(1.0f, alpha));
                cp_used = cp;
            }
            T = __fmul_rn(T, cp_used);
        }
        // barrier before the next chunk overwrites s_rows, and the
        // block-wide saturation test
        if (__syncthreads_count(T > kTMin) == 0) break;
    }
    const size_t o = (size_t)tile * n_pix + p;
    out_color[3 * o] = c0;
    out_color[3 * o + 1] = c1;
    out_color[3 * o + 2] = c2;
    out_depth[o] = d;
    out_t[o] = T;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// table is (n_gauss + 1, 16) float32 with the sentinel row at n_gauss.
int blend_fwd_launch(const void* gidx, const void* counts, const void* table,
                     int n_gauss, int num_tiles, int tile_cap, int grid_x,
                     int tile_size, int chunk, void* out_color,
                     void* out_depth, void* out_t, void* stream) {
    const int n_pix = tile_size * tile_size;
    const size_t smem = (size_t)chunk * 3 * sizeof(float4);
    blend_fwd_kernel<<<num_tiles, n_pix, smem, (cudaStream_t)stream>>>(
        (const int*)gidx, (const int*)counts, (const float4*)table, n_gauss,
        tile_cap, grid_x, tile_size, chunk, (float*)out_color,
        (float*)out_depth, (float*)out_t);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
