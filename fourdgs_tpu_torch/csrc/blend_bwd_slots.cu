// Blend backward, per slot: the gradients of the per-tile front-to-back
// alpha compositing for every (tile, slot), unreduced.
//
// Replaces the TPU kernel fourdgs_tpu/ops/pallas/blend.py:_bwd_kernel (K3),
// which the JAX package takes when the fused backward's accumulator does
// not fit its VMEM (blend.py:578-580) or FOURDGS_PALLAS_NO_FUSED_BWD is
// set. Semantics: the XLA custom VJP of fourdgs_tpu/ops/rasterize_tiled.py
// (`_make_blend.blend_bwd`) before its per-gaussian sum. Plain version:
// fourdgs_tpu_torch/ops/blend.py:blend_backward_slots_plain.
//
// What it computes. The replay of K2 (blend_bwd.cu): for each pixel, the
// forward recurrence in forward order with K1's gate decisions, and for
// each used slot the ten gradient values [pix(2), conic(3), color(3),
// opacity, depth] by the suffix identity (blend_common.cuh:slot_grads).
// The sum of each slot's values over the tile's pixels is written to the
// slot's row of a (num_tiles, tile_cap, 10) table; the caller reduces the
// rows per gaussian (index_add_ or K4, ops/scatter.py).
//
// Design. K2's block structure: one block per tile, one thread per pixel,
// each chunk's rows gathered by gidx into shared memory, the occupancy
// bound counts[tile] and the block-wide saturation exit. A slot's ten
// values are summed over the warp with __shfl_down_sync wherever some lane
// of the warp used it, and lane 0 stores the warp's sums in a
// (warps x chunk x 10) shared table that the block zeroes at the start of
// each chunk; after the chunk one thread per (slot, value) adds the warps'
// partial sums in a fixed order and writes the row. No atomics: the result
// is the same from run to run. Every row of an occupied chunk is written,
// zeros for slots past the count and for the chunks left after the block
// saturated (as the TPU kernel writes zeros for its saturated chunks);
// rows past the tile's occupied chunks are left as they are, and the
// reduction never reads them because their gidx is -1 (sent to the
// sacrificial row, blend.py:602-604).
//
// Bound on an H100. The per-pixel work is K2's: the replay up to the alpha
// test, the gradient chain of each used slot, and 10 five-step shuffle
// reductions per slot some lane of a warp used, so it is bound by FP32
// issue as K2 is. The bytes are K2's inputs and the table's written rows
// (40 bytes a slot). What this simple design leaves for later: the warp
// reductions cost as much as the per-pixel chain, as in K2; the shared
// table takes warps x chunk x 40 bytes, 40 KB for 32 warps at chunk 32,
// which caps the blocks per SM.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace fourdgs;

__global__ void __launch_bounds__(1024)
blend_bwd_slots_kernel(const int* __restrict__ gidx,
                       const int* __restrict__ counts,
                       const float4* __restrict__ table,
                       int n_gauss, int tile_cap, int grid_x, int tile_size,
                       int chunk, const float* __restrict__ out_color,
                       const float* __restrict__ out_depth,
                       const float* __restrict__ out_t,
                       const float* __restrict__ g_color,
                       const float* __restrict__ g_depth,
                       const float* __restrict__ g_t,
                       float* __restrict__ slots) {
    extern __shared__ float4 smem[];
    float4* s_rows = smem;                                      // chunk x 3
    float* s_part = reinterpret_cast<float*>(smem + 3 * chunk);  // warps x
                                                                 // chunk x 10
    const int tile = blockIdx.x;
    const int p = threadIdx.x;
    const int n_pix = blockDim.x;
    const int lane = p & 31;
    const int warp = p >> 5;
    const int n_warps = n_pix >> 5;
    const int count = counts[tile];
    const int* tile_gidx = gidx + (size_t)tile * tile_cap;
    float* tile_slots = slots + (size_t)tile * tile_cap * kGradW;
    const BwdPixel q = load_bwd_pixel(tile, p, grid_x, tile_size,
                                      (size_t)tile * n_pix + p, out_color,
                                      out_depth, out_t, g_color, g_depth,
                                      g_t);
    const int part_n = n_warps * chunk * kGradW;
    // the end of the tile's last occupied chunk
    const int occupied = min(tile_cap, (count + chunk - 1) / chunk * chunk);

    float T = 1.0f, after_cg = 0.0f, after_dg = 0.0f;
    int base = 0;
    for (; base < count; base += chunk) {
        const int nk = min(chunk, count - base);
        gather_rows(s_rows, tile_gidx, table, base, nk, n_gauss);
        for (int i = p; i < part_n; i += n_pix) s_part[i] = 0.0f;
        __syncthreads();
        float* warp_part = s_part + warp * chunk * kGradW;
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
                            warp_part[k * kGradW + i] = v[i];
                    }
                }
                if (__all_sync(kFullMask, stop)) break;
            }
            if (live) T = __fmul_rn(T, cp);
        }
        __syncthreads();
        // the chunk's rows: the warps' partial sums, added in warp order
        const int rows_n = min(chunk, tile_cap - base) * kGradW;
        for (int i = p; i < rows_n; i += n_pix) {
            float s = 0.0f;
            if (i < nk * kGradW) {
                for (int w = 0; w < n_warps; ++w)
                    s += s_part[w * chunk * kGradW + i];
            }
            tile_slots[(size_t)base * kGradW + i] = s;
        }
        // barrier before the next chunk overwrites s_rows and s_part, and
        // the block-wide saturation test
        if (__syncthreads_count(T > kTMin) == 0) {
            base += chunk;
            break;
        }
    }
    // zeros for the occupied chunks left after the block saturated
    for (int i = base * kGradW + p; i < occupied * kGradW; i += n_pix)
        tile_slots[i] = 0.0f;
}

}  // namespace

extern "C" {

// The dynamic shared memory the kernel takes for a tile size and chunk.
size_t blend_bwd_slots_smem(int tile_size, int chunk) {
    const int n_warps = tile_size * tile_size / 32;
    return (size_t)chunk * (3 * sizeof(float4) + (size_t)n_warps
                            * fourdgs::kGradW * sizeof(float));
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// table is (n_gauss + 1, 16) float32; slots is (num_tiles, tile_cap, 10)
// float32, of which the kernel writes the rows of each tile's occupied
// chunks; the forward outputs and their cotangents are tile-major
// (num_tiles, P[, 3]).
int blend_bwd_slots_launch(const void* gidx, const void* counts,
                           const void* table, int n_gauss, int num_tiles,
                           int tile_cap, int grid_x, int tile_size,
                           int chunk, const void* out_color,
                           const void* out_depth, const void* out_t,
                           const void* g_color, const void* g_depth,
                           const void* g_t, void* slots, void* stream) {
    const int n_pix = tile_size * tile_size;
    const size_t smem = blend_bwd_slots_smem(tile_size, chunk);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            blend_bwd_slots_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    blend_bwd_slots_kernel<<<num_tiles, n_pix, smem,
                             (cudaStream_t)stream>>>(
        (const int*)gidx, (const int*)counts, (const float4*)table, n_gauss,
        tile_cap, grid_x, tile_size, chunk, (const float*)out_color,
        (const float*)out_depth, (const float*)out_t, (const float*)g_color,
        (const float*)g_depth, (const float*)g_t, (float*)slots);
    return (int)cudaGetLastError();
}

}  // extern "C"
