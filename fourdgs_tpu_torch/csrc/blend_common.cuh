// Forward math shared by the blend kernels (blend_fwd.cu K1, blend_bwd.cu
// K2 and K3), what a pixel carries into the backward, and the staged slot
// list, row ring and warp transpose reduction of the backward's sub-tile
// blocks (at the end).
//
// Every value that feeds a gate (power > 0, alpha < 1/255, the entering
// transmittance T * cp <= 1e-4, and the chunk's product carried to the next
// chunk) is computed here with round-to-nearest intrinsics in the order of
// fourdgs_tpu_torch/ops/blend.py:_chunk_math, so that no FMA contraction
// can flip a gate. The backward replays the forward's decisions: a gate
// that flipped between K1 and K2 would give a wrong gradient, not a
// slightly noisy one.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace fourdgs {

constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kTMin = 1e-4f;

// A packed row of the per-gaussian table is 16 floats; the kernels read
// its first three float4s: a = [pix_x, pix_y, A, B], b = [C, r, g, b],
// c = [opacity, depth, 0, 0].

// power = -0.5 (A dx^2 + C dy^2) - B dx dy, with d = center - pixel
__device__ __forceinline__ float splat_power(const float4 a, const float4 b,
                                             float px, float py, float& dx,
                                             float& dy) {
    dx = __fsub_rn(a.x, px);
    dy = __fsub_rn(a.y, py);
    const float qa = __fmul_rn(__fmul_rn(a.z, dx), dx);  // A dx^2
    const float qc = __fmul_rn(__fmul_rn(b.x, dy), dy);  // C dy^2
    const float qb = __fmul_rn(__fmul_rn(a.w, dx), dy);  // B dx dy
    return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
}

// unclamped alpha for power <= 0: opacity * exp(power)
__device__ __forceinline__ float splat_alpha_u(float opacity, float power) {
    return __fmul_rn(opacity, expf(power));
}

// min(alpha_u, 0.99) that keeps a NaN (fminf would return 0.99 for it),
// so that the gate `alpha >= 1/255`, written in that positive form, skips
// a NaN splat as the plain version and the JAX package do
__device__ __forceinline__ float splat_alpha(float alpha_u) {
    return alpha_u > kAlphaMax ? kAlphaMax : alpha_u;
}

// What one pixel of the backward replay carries from its forward outputs
// and their cotangents: rc = c_final . g_c, rd = d_final * g_d,
// rt = g_t * T_final.
struct BwdPixel {
    float px, py, gc0, gc1, gc2, gd, rc, rd, rt;
};

// Number of gradient values per slot: [pix(2), conic(3), color(3),
// opacity, depth].
constexpr int kGradW = 10;

// The pixel's coordinates and what it carries into the backward, from the
// tile-major forward outputs and cotangents at pixel o of the tile.
__device__ __forceinline__ BwdPixel load_bwd_pixel(
    int tile, int p, int grid_x, int tile_size, size_t o,
    const float* out_color, const float* out_depth, const float* out_t,
    const float* g_color, const float* g_depth, const float* g_t) {
    BwdPixel q;
    q.px = (float)((tile % grid_x) * tile_size + p % tile_size);
    q.py = (float)((tile / grid_x) * tile_size + p / tile_size);
    q.gc0 = g_color[3 * o];
    q.gc1 = g_color[3 * o + 1];
    q.gc2 = g_color[3 * o + 2];
    q.gd = g_depth[o];
    q.rc = out_color[3 * o] * q.gc0 + out_color[3 * o + 1] * q.gc1
           + out_color[3 * o + 2] * q.gc2;
    q.rd = out_depth[o] * q.gd;
    q.rt = g_t[o] * out_t[o];
    return q;
}

constexpr unsigned kFullMask = 0xffffffffu;

// Stage entries [from, from + n) of a tile's slot list into s_list[0, n),
// each id outside [0, n_gauss] sent to the all-zero sentinel row n_gauss.
// Thread t of a block of kThreads stages the entries i = t (mod kThreads).
template <int kThreads>
__device__ __forceinline__ void stage_ids(int* s_list, const int* tile_gidx,
                                          int from, int n, int n_gauss) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const int g = tile_gidx[from + i];
        s_list[i] = (g < 0 || g > n_gauss) ? n_gauss : g;
    }
}

// Start copying the rows (3 float4 a slot) of staged entries [i0, i0 + nk)
// into rows with cp.async, committed as one group. Thread t copies the
// entries it staged itself (stage_ids), so neither a new segment of the
// list nor its rows need a barrier in between.
template <int kThreads>
__device__ __forceinline__ void copy_rows_async(float4* rows,
                                                const int* s_list,
                                                const float4* table, int i0,
                                                int nk) {
    const int first =
        i0 + (int)((threadIdx.x - (unsigned)i0) & (kThreads - 1));
    for (int i = first; i < i0 + nk; i += kThreads) {
        const float4* src = table + (size_t)s_list[i] * 4;
        float4* dst = rows + 3 * (i - i0);
        __pipeline_memcpy_async(dst, src, sizeof(float4));
        __pipeline_memcpy_async(dst + 1, src + 1, sizeof(float4));
        __pipeline_memcpy_async(dst + 2, src + 2, sizeof(float4));
    }
    __pipeline_commit();
}

// One step of a warp's transpose reduction over n values a lane: the lanes
// whose lane bit `bit` is clear keep lo and add their partner's lo, the
// others keep hi and add their partner's hi (the partner is lane ^ bit).
// n shuffles halve what a lane holds, where a butterfly would take n per
// value-halving step and keep every value in every lane.
template <int N>
__device__ __forceinline__ void transpose_add(float* keep, const float* lo,
                                              const float* hi, int lane,
                                              int bit) {
    const bool upper = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < N; ++i)
        keep[i] = (upper ? hi[i] : lo[i])
                  + __shfl_xor_sync(kFullMask, upper ? lo[i] : hi[i], bit);
}

}  // namespace fourdgs
