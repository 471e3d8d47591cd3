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
// association. The TPU kernel's sequential grid over chunks, its
// Kogge-Stone scan over sublanes and its masked min-reduce exist to
// vectorise the prefix product on that machine; a thread per pixel needs
// only the serial product.
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
// chip_smoke.py computes the bound from each run's counts
// (tools/profile_blend_split.py:blend_work).
//
// What keeps the card from that bound is latency that nothing hides, and
// lanes that issue work no pixel needs. The design:
//  * Sub-tile blocks. A block of 128 threads covers a 16 x 8 sub-tile: a
//    tile of 16 is two blocks, a tile of 32 eight. Eight blocks share an
//    SM (__launch_bounds__, 56 registers), so one block's loads and
//    barriers overlap the others' arithmetic, the heavy tiles of a frame
//    spread over many SMs, and each block stops when its own pixels are
//    saturated: an empty edge no longer waits on the tile's busy centre.
//    Every block walks its tile's whole slot list, in order. The list is
//    never split across blocks: compositing segments would multiply T in
//    another order than the plain version and move the gates, and K2 and
//    K3 replay K1's gate decisions.
//  * Warp patches. A warp covers an 8 x 4 patch of pixels, not a row of
//    32, so that its lanes agree more often on power > 0 and on
//    saturation, and fewer issue slots go to lanes that have nothing to
//    do. Outputs stay tile-major, p = y * tile_size + x.
//  * A staged slot list. The block loads its tile's gidx once, coalesced,
//    into shared memory (list_len entries at a time; the wrapper makes
//    that the whole list up to 4,096 slots), with bad ids sent to the
//    sentinel row. A row gather then issues one global load that depends
//    on nothing, not a gidx load and then a row load in a chain. Thread t
//    stages the entries i = t (mod 128) and gathers the rows of the same
//    entries, so restaging a segment needs no barrier.
//  * A cp.async ring. The rows of chunk j + 1 (three 16-byte pieces a
//    slot) are copied into the second of two shared buffers while the
//    block computes chunk j. One barrier a chunk remains: it makes chunk
//    j's rows visible, frees the buffer that chunk j + 1 overwrites, and
//    counts the live pixels for the saturation exit. TMA is no help here:
//    it copies rectangular tiles and cannot gather rows by index.
//  * A gate batch. A thread computes the gates (power, alpha) of four
//    slots with no branch before it walks them in order: they depend on
//    neither T nor one another, so their loads and their two dozen
//    dependent operations each overlap, where one slot at a time waited
//    out the whole chain. The serial pass then only multiplies T and adds
//    the used slots' colors, in the plain version's order.
// Shared memory: 2 x chunk x 48 bytes of rows (chunk rounded up to whole
// batches) and 4 x list_len bytes of list, 112 KB at chunk 1024 and list
// 4,096 (the C entry opts in past the default 48 KB).
//
// What is still left: the blocks of a frame's heavy tiles run wherever
// the grid order puts them, so the kernel's tail waits on the last of
// them (a persistent kernel that takes tiles by count would order them);
// every lane of a live warp still evaluates every slot of its chunk,
// where culling slots per sub-tile before the power test would skip some
// (only with a cull that provably keeps every gate); and the power and
// alpha chain, some 34 issued instructions a slot with expf, runs in FP32
// on the CUDA cores (tensor cores round differently and would move the
// gates).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace fourdgs;

constexpr int kSubW = 16, kSubH = 8;     // a block's sub-tile
constexpr int kThreads = kSubW * kSubH;
constexpr int kPatchW = 8, kPatchH = 4;  // a warp's patch
constexpr int kMinBlocks = 8;            // blocks an SM keeps (<= 64 regs)
constexpr int kBatch = 4;                // slots whose gates go first
constexpr int kDefaultSmem = 48 * 1024;

// Slots a buffer of the ring holds: chunk rounded up to whole batches.
__host__ __device__ __forceinline__ int ring_slots(int chunk) {
    return (chunk + kBatch - 1) / kBatch * kBatch;
}

// Stage entries [from, from + n) of the tile's list into s_list[0, n),
// each id outside [0, n_gauss] sent to the all-zero sentinel row n_gauss.
// Thread t stages the entries i = t (mod kThreads).
__device__ __forceinline__ void stage_list(int* s_list, const int* tile_gidx,
                                           int from, int n, int n_gauss) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const int g = tile_gidx[from + i];
        s_list[i] = (g < 0 || g > n_gauss) ? n_gauss : g;
    }
}

// Start copying the rows of staged entries [i0, i0 + nk) into rows (3
// float4 a slot) and commit them as one cp.async group. Thread t copies
// the entries it staged itself, i = t (mod kThreads).
__device__ __forceinline__ void gather_async(float4* rows, const int* s_list,
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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
blend_fwd_kernel(const int* __restrict__ gidx,
                 const int* __restrict__ counts,
                 const float4* __restrict__ table,
                 int n_gauss, int tile0, int tile_cap, int grid_x,
                 int tile_size, int chunk, int list_len,
                 float* __restrict__ out_color,
                 float* __restrict__ out_depth, float* __restrict__ out_t) {
    extern __shared__ float4 smem[];
    const int ring = ring_slots(chunk);
    float4* s_rows = smem;                       // 2 x ring x 3 float4
    int* s_list = (int*)(smem + 6 * ring);       // list_len ids
    const int subs_x = tile_size / kSubW;        // sub-tiles across a tile
    const int subs = subs_x * (tile_size / kSubH);
    const int tile = blockIdx.x / subs;
    const int sub = blockIdx.x % subs;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int x = (sub % subs_x) * kSubW
                  + (warp % (kSubW / kPatchW)) * kPatchW + lane % kPatchW;
    const int y = (sub / subs_x) * kSubH
                  + (warp / (kSubW / kPatchW)) * kPatchH + lane / kPatchW;
    // the pixel's coordinates are those of global tile tile0 + tile (a
    // band of a tile-sharded render); lists and outputs stay band-local
    const float px = (float)(((tile0 + tile) % grid_x) * tile_size + x);
    const float py = (float)(((tile0 + tile) / grid_x) * tile_size + y);
    const int count = counts[tile];
    const int* tile_gidx = gidx + (size_t)tile * tile_cap;

    if (count > 0) {
        stage_list(s_list, tile_gidx, 0, min(list_len, count), n_gauss);
        gather_async(s_rows, s_list, table, 0, min(chunk, count));
    }
    float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d = 0.0f;
    for (int base = 0, j = 0; base < count; base += chunk, ++j) {
        // chunk j's rows have landed (this thread's copies; the barrier
        // publishes everyone's), every thread is done with chunk j - 1's
        // buffer, and the block stops once none of its pixels is live
        __pipeline_wait_prior(0);
        if (__syncthreads_count(T > kTMin) == 0) break;
        const int next = base + chunk;
        if (next < count) {
            const int i0 = next % list_len;
            if (i0 == 0)   // a new segment of the list; no barrier needed
                stage_list(s_list, tile_gidx, next,
                           min(list_len, count - next), n_gauss);
            gather_async(s_rows + 3 * ring * ((j + 1) & 1), s_list, table,
                         i0, min(chunk, count - next));
        }
        if (T > kTMin) {
            const float4* rows = s_rows + 3 * ring * (j & 1);
            const int nk = min(chunk, count - base);
            // cp: product of (1 - alpha) over the chunk's gated slots so
            // far; the entering transmittance of a slot is T * cp.
            float cp = 1.0f, cp_used = 1.0f;
            bool spent = false;
            for (int k0 = 0; k0 < nk && !spent; k0 += kBatch) {
                // The batch's gates first: they depend on neither T nor one
                // another, and nothing branches, so their loads and
                // arithmetic overlap. A slot past nk reads a stale or
                // unwritten row of the ring (it holds whole batches) and is
                // masked. A gated alpha is >= 1/255; 0 marks a slot that is
                // not (power > 0, alpha < 1/255 or NaN, or past nk).
                float gate[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const float4 a = rows[3 * (k0 + u)];
                    const float4 b = rows[3 * (k0 + u) + 1];
                    float dx, dy;
                    const float power = splat_power(a, b, px, py, dx, dy);
                    const float alpha = splat_alpha(
                        splat_alpha_u(rows[3 * (k0 + u) + 2].x, power));
                    gate[u] = (k0 + u < nk && power <= 0.0f
                               && alpha >= kAlphaMin) ? alpha : 0.0f;
                }
                // then the serial pass over the gated slots, in order
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    if (gate[u] == 0.0f) continue;
                    const float t_pref = __fmul_rn(T, cp);
                    if (t_pref <= kTMin) {  // entering transmittance test
                        spent = true;
                        break;
                    }
                    const float w = __fmul_rn(gate[u], t_pref);
                    const float4 b = rows[3 * (k0 + u) + 1];
                    c0 += w * b.y;
                    c1 += w * b.z;
                    c2 += w * b.w;
                    d += w * rows[3 * (k0 + u) + 2].y;
                    cp = __fmul_rn(cp, __fsub_rn(1.0f, gate[u]));
                    cp_used = cp;
                }
            }
            T = __fmul_rn(T, cp_used);
        }
    }
    const size_t o = (size_t)tile * tile_size * tile_size + y * tile_size + x;
    out_color[3 * o] = c0;
    out_color[3 * o + 1] = c1;
    out_color[3 * o + 2] = c2;
    out_depth[o] = d;
    out_t[o] = T;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// table is (n_gauss + 1, 16) float32 with the sentinel row at n_gauss;
// tile_size is 16 or 32; list_len, the slots staged at a time, is a
// multiple of chunk. The num_tiles lists are those of global tiles
// [tile0, tile0 + num_tiles) of a grid grid_x tiles wide.
int blend_fwd_launch(const void* gidx, const void* counts, const void* table,
                     int n_gauss, int num_tiles, int tile0, int tile_cap,
                     int grid_x,
                     int tile_size, int chunk, int list_len, void* out_color,
                     void* out_depth, void* out_t, void* stream) {
    const size_t smem = (size_t)ring_slots(chunk) * 6 * sizeof(float4)
                        + (size_t)list_len * sizeof(int);
    if (smem > kDefaultSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            blend_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int subs = (tile_size / kSubW) * (tile_size / kSubH);
    blend_fwd_kernel<<<num_tiles * subs, kThreads, smem,
                       (cudaStream_t)stream>>>(
        (const int*)gidx, (const int*)counts, (const float4*)table, n_gauss,
        tile0, tile_cap, grid_x, tile_size, chunk, list_len, (float*)out_color,
        (float*)out_depth, (float*)out_t);
    return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
