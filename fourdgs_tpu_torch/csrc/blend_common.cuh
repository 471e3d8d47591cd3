// Forward math shared by the blend kernels (blend_fwd.cu, blend_bwd.cu).
//
// Every value that feeds a gate (power > 0, alpha < 1/255, the entering
// transmittance T * cp <= 1e-4, and the chunk's product carried to the next
// chunk) is computed here with round-to-nearest intrinsics in the order of
// fourdgs_tpu_torch/ops/blend.py:_chunk_math, so that no FMA contraction
// can flip a gate. The backward replays the forward's decisions: a gate
// that flipped between K1 and K2 would give a wrong gradient, not a
// slightly noisy one.
#pragma once

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

// Gather the rows of slots [base, base + nk) of a tile into shared memory
// (3 float4 per slot); a -1 or out-of-range id reads the all-zero sentinel
// row at n_gauss. The caller synchronises.
__device__ __forceinline__ void gather_rows(float4* s_rows,
                                            const int* tile_gidx,
                                            const float4* table, int base,
                                            int nk, int n_gauss) {
    for (int i = threadIdx.x; i < nk * 3; i += blockDim.x) {
        const int slot = i / 3;
        int g = tile_gidx[base + slot];
        g = (g < 0 || g > n_gauss) ? n_gauss : g;
        s_rows[i] = table[(size_t)g * 4 + (i - slot * 3)];
    }
}

}  // namespace fourdgs
