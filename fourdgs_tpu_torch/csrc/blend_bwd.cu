// Blend backward: the gradients of the per-tile front-to-back alpha
// compositing, summed per gaussian inside the kernel (K2), or per (tile,
// slot) into a table that the caller reduces (K3, a second build of the
// same kernel, at the end).
//
// Replaces the TPU kernels fourdgs_tpu/ops/pallas/blend.py:_bwd_fused_kernel
// (K2) and :_bwd_kernel (K3), which the JAX package takes when the fused
// kernel's accumulator does not fit its VMEM (blend.py:578-580) or
// FOURDGS_PALLAS_NO_FUSED_BWD is set. Semantics: the XLA custom VJP of
// fourdgs_tpu/ops/rasterize_tiled.py (`_make_blend.blend_bwd`). Plain
// versions: fourdgs_tpu_torch/ops/blend.py:blend_backward_plain and
// blend_backward_slots_plain.
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
// ten values [pix(2), conic(3), color(3), opacity, depth] per pixel x slot,
// summed over the pixels into the (N+1, 10) table (row N is the sentinel).
//
// Bound on an H100. Per evaluated pixel x slot the replay costs what K1's
// loop costs up to the alpha test; a used slot adds the gradient chain
// (about 40 FP32 instructions). The bytes are K1's plus the cotangents and
// the (N+1, 10) table. So K2 is bound by FP32 issue: chip_smoke.py counts
// this run's evaluations and used slots and computes the bound from FP32
// issue, MUFU and bytes. The sums over pixels cost what a design makes
// them cost: the first design summed each slot some lane of a warp used
// with ten five-step shuffle reductions (50 shuffles and 50 adds a warp)
// and then ten shared atomics by one lane, as much as the per-pixel work.
//
// Design. K1's layout (blend_fwd.cu), with the gate chain replayed bit for
// bit, and the sums reorganised:
//  * Sub-tile blocks. A block of 128 threads covers a 16 x 8 sub-tile (two
//    a tile at tile 16, eight at tile 32) and a warp an 8 x 4 patch; each
//    block walks its tile's whole slot list in order and stops when its
//    own pixels are saturated. The launch bound asks for four blocks an
//    SM and leaves ptxas its register count: 72 here (seven blocks). A
//    bound of eight, which caps it at 64, ran slower.
//  * A staged slot list and a cp.async ring. The tile's gidx is staged in
//    shared memory (list_len ids at a time) and the rows of chunk j + 1
//    are copied into the second of two buffers while chunk j is replayed.
//    One barrier a chunk: at the head of chunk j it makes chunk j's rows
//    visible, frees chunk j - 1's buffers, counts the live pixels for the
//    exit and closes chunk j - 1's partial sums, which the block then
//    flushes; the partial sums are double-buffered like the rows.
//  * Batches of four slots. A thread computes the four slots' gates with
//    no branch (the same __f*_rn chain and expf as K1 and _chunk_math),
//    then replays the gated ones in order. A batch that no live lane of
//    the warp gates is skipped by one vote.
//  * Transpose reductions. The batch's 40 values a lane (4 slots x 10)
//    are summed over the warp by halving steps: at each shuffle a lane
//    trades the half of its values that its partner keeps for the other
//    half (blend_common.cuh:transpose_add), so 20 + 10 + 5 shuffles leave
//    5 values a lane, each a sum over 8 lanes, and two butterfly steps
//    finish them: 45 shuffles for 4 slots, where the first design took 50
//    for one. Each (slot, value) sum then sits in one group of four lanes,
//    which store it to the warp's partial row in shared memory: no shared
//    atomics. The batch's first pair of slots is reduced before the second
//    pair is replayed, which keeps 30 values live, not 40.
//  * Vector atomics. After the barrier, the block adds its four warps'
//    partial rows in warp order and adds each nonzero pair of values into
//    the table with one float2 atomicAdd (Hopper's vector atomics on
//    global memory; a 40-byte row is 8-byte aligned): five a row. A
//    slot's row is flushed once by each sub-tile block that used it.
// The C entry zero-fills the table (cudaMemsetAsync) before the launch.
// The order of the atomic sums varies from run to run, so results agree
// with the plain version to rounding, not bit for bit.
//
// Shared memory: 2 x chunk x 48 bytes of rows and 2 x 4 x chunk x 40
// bytes of partial rows (chunk rounded up to whole batches), and
// 4 x list_len bytes of list: 224 KB at chunk 512 and list 4,096 (the C
// entry opts in past the default 48 KB), 16 KB at chunk 32 and list 768.
//
// A second build of the kernel (kCount) also tallies the float2 atomics it
// issues, the batches its warps reduce and the chunks its blocks walk, for
// chip_smoke.py's phase 6; the build that the wrapper times and the
// training step run has none.
//
// What is still left. On an H100 at chip_smoke.py phase 6's input, the
// gates and the recurrence alone (the chain and the reductions removed)
// take about half of K2's time, the gradient chain and the reductions the
// other half, and the global atomics about 4 %. Every lane of a live warp
// evaluates every slot of its chunk (a per-sub-tile cull before the power
// test would skip some, only with a cull that provably keeps every gate),
// and the heavy tiles' blocks run wherever the grid order puts them.
//
// K3, the per-slot build (kSlots). Row (t, s) of a (num_tiles, tile_cap,
// 10) table holds slot s's ten values summed over tile t's pixels; rows of
// occupied chunks past the count, and of the chunks left after the tile
// saturated, are zero; rows past the tile's occupied chunks are left as
// they are (their gidx is -1, which the reduction sends to a sacrificial
// row). The same replay, gates and partial rows as K2; what changes is
// where the sums go and when a block stops:
//  * A cluster per tile. The launch groups a tile's sub-tile blocks (8 at
//    tile 32, 2 at tile 16) into one thread block cluster, whose ranks are
//    the sub-tiles in grid order. One cluster barrier a chunk takes the
//    place of K2's block barrier: it also publishes each warp's flag "a
//    pixel of mine is live", kept in its block's shared memory and
//    double-buffered by chunk parity, which every warp then reads from
//    every rank (a lane a flag) and votes on. The tile stops when its list
//    ends or no pixel of any of its sub-tiles is live; a rank whose own
//    pixels are all spent walks on, its warps writing zero partial rows,
//    and copies no more rows.
//  * The flush through distributed shared memory. After the barrier at
//    chunk j's head, rank r sums chunk j - 1's slots r, r + subs, ...: each
//    pair of values adds the ranks' per-warp partial rows in rank order,
//    then warp order, and is stored with one float2 store (zero past the
//    count). That fixed order gives the same table from run to run; no
//    atomics, no fill: each row of an occupied chunk is written once. After
//    the loop the ranks split the zero rows of the occupied chunks left,
//    and a last cluster barrier keeps every block resident until no rank
//    can still read its shared memory.
// The coupled exit holds a spent sub-tile's block on its SM while its
// tile's other sub-tiles walk on. The flags take 2 x 4 ints of shared
// memory beyond K2's. A counting build tallies the float2 stores, the
// reduced batches (equal to K2's on the same input) and the chunks its
// blocks walk (subs x the tile's).
// What it costs, on an H100 at chip_smoke.py phase 8's input: ptxas gives
// the timed build 96 registers (five blocks an SM; a bound of six, 80 with
// a small spill, ran no faster), and it runs about a third longer than K2
// on the device. An atomics build of the same kernel (a zero-filled table,
// no cluster, each sub-tile exiting alone; sums that vary in the last
// bits) ran as fast as K2; the cluster build without the flush's remote
// reads lost about a quarter of the difference. The rest is the cluster
// barrier and the coupled exit, under which a tile's blocks walk some 23 %
// more chunks than K2's sub-tile blocks.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace fourdgs;

constexpr int kSubW = 16, kSubH = 8;     // a block's sub-tile
constexpr int kThreads = kSubW * kSubH;
constexpr int kWarps = kThreads / 32;
constexpr int kPatchW = 8, kPatchH = 4;  // a warp's patch
constexpr int kMinBlocks = 4;            // at most 128 registers a thread
constexpr int kBatch = 4;                // slots replayed and reduced together
constexpr int kHalfW = kGradW / 2;       // values a lane ends a batch with;
                                         // float2 atomics a row
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSubs = 8;              // sub-tiles of a tile, at tile 32

// Slots a buffer of the ring holds: chunk rounded up to whole batches.
__host__ __device__ __forceinline__ int ring_slots(int chunk) {
    return (chunk + kBatch - 1) / kBatch * kBatch;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int chunk,
                                                      int list_len) {
    return (size_t)ring_slots(chunk)
               * (2 * 3 * sizeof(float4) + 2 * kWarps * kGradW * sizeof(float))
           + (size_t)list_len * sizeof(int);
}

// K3's: K2's and the two buffers of live flags
__host__ __device__ __forceinline__ size_t slots_smem_bytes(int chunk,
                                                            int list_len) {
    return smem_bytes(chunk, list_len) + 2 * kWarps * sizeof(int);
}

// One pixel's replay of one slot of a batch (row: its three float4; alpha:
// its gate, 0 when it is not gated; alpha_u, dx, dy from the gate pass).
// A used slot writes its ten gradient values to v, advances after_cg,
// after_dg and cp (the product of (1 - alpha) over the chunk's used slots
// so far); a gated slot whose entering transmittance T * cp fell to 1e-4
// ends the pixel's chunk (spent), as in K1. v is zero otherwise. With the
// suffix identity
//   da = t_pref (c . g_c + z g_d)
//        - (rc - after_cg + rd - after_dg + rt) / max(1 - alpha, 0.01),
// chained to opacity (alpha_u / op), to the power (da * alpha_u) and so to
// pix and the conic, and w g_c, w g_d for color and depth.
__device__ __forceinline__ void replay(const float4* row, float alpha,
                                       float alpha_u, float dx, float dy,
                                       const BwdPixel& q, float T, float& cp,
                                       float& after_cg, float& after_dg,
                                       bool& spent, float* v) {
#pragma unroll
    for (int i = 0; i < kGradW; ++i) v[i] = 0.0f;
    if (spent || alpha == 0.0f) return;
    const float t_pref = __fmul_rn(T, cp);
    if (t_pref <= kTMin) {  // entering transmittance test
        spent = true;
        return;
    }
    const float4 a = row[0], b = row[1], c = row[2];
    const float w = alpha * t_pref;
    const float cg = b.y * q.gc0 + b.z * q.gc1 + b.w * q.gc2;
    const float dg = c.y * q.gd;
    after_cg += w * cg;
    after_dg += w * dg;
    const float one_m_a = fmaxf(1.0f - alpha, 1.0f - kAlphaMax);
    const float da = t_pref * (cg + dg)
                     - (q.rc - after_cg + q.rd - after_dg + q.rt) / one_m_a;
    const float d_pow = da * alpha_u;
    v[0] = d_pow * -(a.z * dx + a.w * dy);
    v[1] = d_pow * -(b.x * dy + a.w * dx);
    v[2] = -0.5f * d_pow * dx * dx;
    v[3] = -d_pow * dx * dy;
    v[4] = -0.5f * d_pow * dy * dy;
    v[5] = w * q.gc0;
    v[6] = w * q.gc1;
    v[7] = w * q.gc2;
    v[8] = c.x > 0.0f ? da * (alpha_u / fmaxf(c.x, 1e-20f)) : 0.0f;
    v[9] = w * q.gd;
    cp = __fmul_rn(cp, __fsub_rn(1.0f, alpha));
}

// Replay one chunk's slots [0, nk) (rows: the ring buffer) for the warp's
// pixels and write the warp's sums to its partial rows part (ring x 10).
// T is the pixel's entering transmittance; returns the chunk's product of
// (1 - alpha) over the used slots. The counting build (kCount) adds each
// batch the warp reduces to tally[1].
template <bool kCount>
__device__ __forceinline__ float replay_chunk(const float4* rows, int nk,
                                              const BwdPixel& q, float T,
                                              float& after_cg,
                                              float& after_dg, float* part,
                                              unsigned long long* tally) {
    const int lane = threadIdx.x % 32;
    const bool live = T > kTMin;
    if (!__any_sync(kFullMask, live)) {   // a saturated patch: zero sums
        for (int i = lane; i < nk * kGradW; i += 32) part[i] = 0.0f;
        return 1.0f;
    }
    // where this lane's sums of a batch go: slot 2 * bit3 + bit4 of the
    // batch, columns 5 * bit2 .. + 4 (the transpose steps below)
    float* dst = part + (2 * ((lane >> 3) & 1) + ((lane >> 4) & 1)) * kGradW
                 + kHalfW * ((lane >> 2) & 1);
    float cp = 1.0f;
    bool spent = !live;
    for (int k0 = 0; k0 < nk; k0 += kBatch, dst += kBatch * kGradW) {
        float s[kHalfW];
#pragma unroll
        for (int i = 0; i < kHalfW; ++i) s[i] = 0.0f;
        if (__any_sync(kFullMask, !spent)) {
            // The batch's gates first, with no branch: they depend on
            // neither T nor one another. A slot past nk reads a stale or
            // unwritten row of the ring (it holds whole batches) and is
            // masked by its index.
            float gate[kBatch], alpha_u[kBatch], dx[kBatch], dy[kBatch];
            bool gated = false;
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const float4* row = rows + 3 * (k0 + u);
                const float power =
                    splat_power(row[0], row[1], q.px, q.py, dx[u], dy[u]);
                alpha_u[u] = splat_alpha_u(row[2].x, power);
                const float alpha = splat_alpha(alpha_u[u]);
                gate[u] = (k0 + u < nk && power <= 0.0f
                           && alpha >= kAlphaMin) ? alpha : 0.0f;
                gated |= gate[u] != 0.0f;
            }
            if (__any_sync(kFullMask, gated && !spent)) {
                if (kCount && lane == 0) atomicAdd(tally + 1, 1ull);
                // the replay in order, reduced a pair of slots at a time
                float v0[kGradW], v1[kGradW], h0[kGradW], h1[kGradW];
                const float4* row = rows + 3 * k0;
                replay(row, gate[0], alpha_u[0], dx[0], dy[0], q, T, cp,
                       after_cg, after_dg, spent, v0);
                replay(row + 3, gate[1], alpha_u[1], dx[1], dy[1], q, T, cp,
                       after_cg, after_dg, spent, v1);
                transpose_add<kGradW>(h0, v0, v1, lane, 16);  // slot bit4
                replay(row + 6, gate[2], alpha_u[2], dx[2], dy[2], q, T, cp,
                       after_cg, after_dg, spent, v0);
                replay(row + 9, gate[3], alpha_u[3], dx[3], dy[3], q, T, cp,
                       after_cg, after_dg, spent, v1);
                transpose_add<kGradW>(h1, v0, v1, lane, 16);  // 2 + bit4
                transpose_add<kGradW>(v0, h0, h1, lane, 8);   // + 2 * bit3
                transpose_add<kHalfW>(s, v0, v0 + kHalfW, lane, 4);
#pragma unroll
                for (int i = 0; i < kHalfW; ++i) {
                    s[i] += __shfl_xor_sync(kFullMask, s[i], 2);
                    s[i] += __shfl_xor_sync(kFullMask, s[i], 1);
                }
            }
        }
        // the four lanes of a group hold the same sums; each stores some
#pragma unroll
        for (int i = 0; i < kHalfW; ++i)
            if ((i & 3) == (lane & 3)) dst[i] = s[i];
    }
    return cp;
}

// Add the block's sums of the tile's slots [from, from + nk), its warps'
// partial rows (kWarps x ring x 10) in warp order, into grads: one float2
// atomic per nonzero pair of values. The ids are read from gidx, not from
// the staged list, which a new segment may be overwriting. The counting
// build (kCount) adds the atomics it issued to tally[0].
template <bool kCount>
__device__ __forceinline__ void flush(const float* part, int ring,
                                      const int* tile_gidx, int from, int nk,
                                      int n_gauss, float* grads,
                                      unsigned long long* tally) {
    unsigned issued = 0;
    for (int i = threadIdx.x; i < nk * kHalfW; i += kThreads) {
        const int slot = i / kHalfW, pair = i - slot * kHalfW;
        float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float2 p = *reinterpret_cast<const float2*>(
                part + ((size_t)w * ring + slot) * kGradW + 2 * pair);
            s.x += p.x;
            s.y += p.y;
        }
        if (s.x != 0.0f || s.y != 0.0f) {
            int g = tile_gidx[from + slot];
            g = (g < 0 || g > n_gauss) ? n_gauss : g;
            atomicAdd(reinterpret_cast<float2*>(
                          grads + (size_t)g * kGradW + 2 * pair), s);
            ++issued;
        }
    }
    if (kCount && issued) atomicAdd(tally, (unsigned long long)issued);
}

// K3's flags at one chunk (flags: this block's kWarps ints of one buffer),
// as a mask over the cluster's warps: bit kWarps * r + w is set when warp
// w of rank r has a live pixel. Lane l reads flag l; every warp gets the
// same mask.
__device__ __forceinline__ unsigned cluster_flags(int* flags, int subs,
                                                  int lane) {
    int f = 0;
    if (lane < subs * kWarps)
        f = *cg::this_cluster().map_shared_rank(flags + lane % kWarps,
                                                lane / kWarps);
    return __ballot_sync(kFullMask, f != 0);
}

// K3's flush of one chunk: store the cluster's sums of its slots
// [0, chunk) into the tile's rows (rows: the chunk's first row of the
// table). Rank `rank` of `subs` takes slots rank, rank + subs, ...; the
// pair of a slot that lies within the count (nk) adds the ranks' partial
// rows (part: kWarps x ring x 10, in each rank's shared memory at the same
// offset) in rank order, then warp order, and the others store zeros. The
// counting build (kCount) adds the float2 stores to tally[0].
template <bool kCount>
__device__ __forceinline__ void flush_slots(float* part, int ring, int subs,
                                            int rank, int nk, int chunk,
                                            float* rows,
                                            unsigned long long* tally) {
    cg::cluster_group cluster = cg::this_cluster();
    const int mine = (chunk - rank + subs - 1) / subs;
    unsigned stored = 0;
    for (int i = threadIdx.x; i < mine * kHalfW; i += kThreads) {
        const int k = i / kHalfW, pair = i - k * kHalfW;
        const int slot = rank + subs * k;
        float2 s = make_float2(0.0f, 0.0f);
        if (slot < nk) {
#pragma unroll
            for (int r = 0; r < kMaxSubs; ++r) {
                if (r >= subs) break;
                const float* src = cluster.map_shared_rank(part, r)
                                   + slot * kGradW + 2 * pair;
#pragma unroll
                for (int w = 0; w < kWarps; ++w) {
                    const float2 p = *reinterpret_cast<const float2*>(
                        src + w * ring * kGradW);
                    s.x += p.x;
                    s.y += p.y;
                }
            }
        }
        *reinterpret_cast<float2*>(rows + slot * kGradW + 2 * pair) = s;
        ++stored;
    }
    if (kCount && stored) atomicAdd(tally, (unsigned long long)stored);
}

// kCount: the counting build, which tallies its float2 atomics (K2) or
// stores (K3), its reduced batches and the chunks its blocks walked into
// tally[0], tally[1] and tally[2] (for measurement; the timed builds are
// kCount = false, which compile no tally). kSlots: K3, launched as a
// cluster of a tile's sub-tile blocks, writing the per-slot table `grads`
// (num_tiles, tile_cap, 10); else K2, adding into the per-gaussian rows
// (n_gauss + 1, 10).
template <bool kCount, bool kSlots>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
blend_bwd_kernel(const int* __restrict__ gidx,
                 const int* __restrict__ counts,
                 const float4* __restrict__ table,
                 int n_gauss, int tile0, int tile_cap, int grid_x,
                 int tile_size, int chunk, int list_len,
                 const float* __restrict__ out_color,
                 const float* __restrict__ out_depth,
                 const float* __restrict__ out_t,
                 const float* __restrict__ g_color,
                 const float* __restrict__ g_depth,
                 const float* __restrict__ g_t, float* __restrict__ grads,
                 unsigned long long* __restrict__ tally) {
    const int subs_x = tile_size / kSubW;        // sub-tiles across a tile
    const int subs = subs_x * (tile_size / kSubH);
    const int tile = blockIdx.x / subs;
    const int count = counts[tile];
    if (count <= 0) return;   // the whole block (K3: every rank of the tile)
    extern __shared__ float4 smem[];
    const int ring = ring_slots(chunk);
    const int part_len = kWarps * ring * kGradW;  // one buffer's partials
    float4* s_rows = smem;                        // 2 x ring x 3 float4
    float* s_part = reinterpret_cast<float*>(smem + 6 * ring);
    int* s_list = reinterpret_cast<int*>(s_part + 2 * part_len);
    int* s_live = s_list + list_len;              // K3: 2 x kWarps flags
    const int sub = blockIdx.x % subs;            // K3: the cluster rank
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int x = (sub % subs_x) * kSubW
                  + (warp % (kSubW / kPatchW)) * kPatchW + lane % kPatchW;
    const int y = (sub / subs_x) * kSubH
                  + (warp / (kSubW / kPatchW)) * kPatchH + lane / kPatchW;
    const int p = y * tile_size + x;
    const int* tile_gidx = gidx + (size_t)tile * tile_cap;
    float* tile_rows = grads + (size_t)tile * tile_cap * kGradW;  // K3
    // pixel coordinates of global tile tile0 + tile; everything else is
    // read and written at the band-local tile
    const BwdPixel q = load_bwd_pixel(
        tile0 + tile, p, grid_x, tile_size,
        (size_t)tile * tile_size * tile_size + p,
        out_color, out_depth, out_t, g_color, g_depth, g_t);

    stage_ids<kThreads>(s_list, tile_gidx, 0, min(list_len, count), n_gauss);
    copy_rows_async<kThreads>(s_rows, s_list, table, 0, min(chunk, count));
    float T = 1.0f, after_cg = 0.0f, after_dg = 0.0f;
    int base = 0;
    for (int j = 0;; base += chunk, ++j) {
        // chunk j's rows have landed (this thread's copies; the barrier
        // publishes everyone's), every warp has written chunk j - 1's
        // partial rows and is done with its buffers, and the block (K3:
        // the tile) stops once the list ends or none of its pixels is live
        __pipeline_wait_prior(0);
        bool go, own = true;
        if constexpr (kSlots) {
            const bool live = __any_sync(kFullMask, T > kTMin);
            if (lane == 0) s_live[(j & 1) * kWarps + warp] = live;
            cg::this_cluster().sync();
            const unsigned flags =
                cluster_flags(s_live + (j & 1) * kWarps, subs, lane);
            own = (flags >> (sub * kWarps)) & ((1u << kWarps) - 1);
            go = base < count && flags != 0;
            if (j > 0)
                flush_slots<kCount>(s_part + ((j - 1) & 1) * part_len, ring,
                                    subs, sub,
                                    min(chunk, count - (base - chunk)), chunk,
                                    tile_rows + (size_t)(base - chunk)
                                                    * kGradW,
                                    tally);
        } else {
            go = __syncthreads_count(base < count && T > kTMin) != 0;
            if (j > 0)
                flush<kCount>(s_part + ((j - 1) & 1) * part_len, ring,
                              tile_gidx, base - chunk,
                              min(chunk, count - (base - chunk)), n_gauss,
                              grads, tally);
        }
        if (!go) break;
        const int next = base + chunk;
        if (next < count) {
            const int i0 = next % list_len;
            if (i0 == 0)   // a new segment of the list; no barrier needed
                stage_ids<kThreads>(s_list, tile_gidx, next,
                                    min(list_len, count - next), n_gauss);
            if (own)       // K3: a spent rank reads no more rows
                copy_rows_async<kThreads>(s_rows + 3 * ring * ((j + 1) & 1),
                                          s_list, table, i0,
                                          min(chunk, count - next));
        }
        const float cp = replay_chunk<kCount>(
            s_rows + 3 * ring * (j & 1), min(chunk, count - base), q, T,
            after_cg, after_dg,
            s_part + (j & 1) * part_len + warp * ring * kGradW, tally);
        T = __fmul_rn(T, cp);
    }
    if (kCount && threadIdx.x == 0)   // the chunks this block replayed
        atomicAdd(tally + 2, (unsigned long long)(base / chunk));
    if constexpr (kSlots) {
        // zeros for the occupied chunks left, split over the ranks, while
        // the last cluster barrier waits for every rank's last flush: no
        // block exits while another may still read its shared memory
        asm volatile("barrier.cluster.arrive;" ::: "memory");
        const int occupied =
            min(tile_cap, (count + chunk - 1) / chunk * chunk);
        float2* zero = reinterpret_cast<float2*>(tile_rows
                                                 + (size_t)base * kGradW);
        unsigned stored = 0;
        for (int i = sub * kThreads + threadIdx.x;
             i < (occupied - base) * kHalfW; i += subs * kThreads) {
            zero[i] = make_float2(0.0f, 0.0f);
            ++stored;
        }
        if (kCount && stored) atomicAdd(tally, (unsigned long long)stored);
        asm volatile("barrier.cluster.wait;" ::: "memory");
    }
}

// Launch one build of the kernel, opting in past the default shared
// memory first where it needs to; K3 as clusters of a tile's sub-tiles.
template <bool kCount, bool kSlots>
cudaError_t launch(const int* gidx, const int* counts, const float4* table,
                   int n_gauss, int num_tiles, int tile0, int tile_cap,
                   int grid_x, int tile_size, int chunk, int list_len,
                   const float* const* fwd, float* out,
                   unsigned long long* tally, cudaStream_t s) {
    const size_t smem = kSlots ? slots_smem_bytes(chunk, list_len)
                               : smem_bytes(chunk, list_len);
    if (smem > kDefaultSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            blend_bwd_kernel<kCount, kSlots>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int subs = (tile_size / kSubW) * (tile_size / kSubH);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(num_tiles * subs);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem;
    config.stream = s;
    cudaLaunchAttribute cluster;
    if (kSlots) {
        cluster.id = cudaLaunchAttributeClusterDimension;
        cluster.val.clusterDim.x = subs;
        cluster.val.clusterDim.y = 1;
        cluster.val.clusterDim.z = 1;
        config.attrs = &cluster;
        config.numAttrs = 1;
    }
    return cudaLaunchKernelEx(&config, blend_bwd_kernel<kCount, kSlots>,
                              gidx, counts, table, n_gauss, tile0, tile_cap,
                              grid_x,
                              tile_size, chunk, list_len, fwd[0], fwd[1],
                              fwd[2], fwd[3], fwd[4], fwd[5], out, tally);
}

}  // namespace

extern "C" {

// K2. Zero-fill grads on `stream`, then launch; returns the cudaError_t of
// the fill or the launch (0 = ok). table is (n_gauss + 1, 16) and grads
// (n_gauss + 1, 10) float32 (8-byte aligned); the forward outputs and
// their cotangents are tile-major (num_tiles, P[, 3]); tile_size is 16 or
// 32; list_len, the slots staged at a time, is a multiple of chunk; the
// num_tiles lists are global tiles [tile0, tile0 + num_tiles). tally
// is null, or three uint64 on the card to which the counting build adds
// the float2 atomics it issued, the warp batches it reduced and the chunks
// its blocks walked.
int blend_bwd_launch(const void* gidx, const void* counts, const void* table,
                     int n_gauss, int num_tiles, int tile0, int tile_cap,
                     int grid_x,
                     int tile_size, int chunk, int list_len,
                     const void* out_color, const void* out_depth,
                     const void* out_t, const void* g_color,
                     const void* g_depth, const void* g_t, void* grads,
                     void* tally, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(
        grads, 0, sizeof(float) * fourdgs::kGradW * ((size_t)n_gauss + 1), s);
    if (err != cudaSuccess) return (int)err;
    if (num_tiles == 0) return 0;
    const float* fwd[6] = {(const float*)out_color, (const float*)out_depth,
                           (const float*)out_t, (const float*)g_color,
                           (const float*)g_depth, (const float*)g_t};
    auto build = tally ? &launch<true, false> : &launch<false, false>;
    return (int)build((const int*)gidx, (const int*)counts,
                      (const float4*)table, n_gauss, num_tiles, tile0,
                      tile_cap, grid_x, tile_size, chunk, list_len, fwd,
                      (float*)grads,
                      (unsigned long long*)tally, s);
}

// K3. Launch on `stream` with K2's arguments; returns the cudaError_t of
// the launch (0 = ok), for instance of a cluster that cannot be placed.
// slots is the (num_tiles, tile_cap, 10) float32 table (8-byte aligned),
// of which the kernel writes the rows of each tile's occupied chunks. tally
// is null, or three uint64 on the card to which the counting build adds
// the float2 stores it issued, the warp batches it reduced and the chunks
// its blocks walked.
int blend_bwd_slots_launch(const void* gidx, const void* counts,
                           const void* table, int n_gauss, int num_tiles,
                           int tile0, int tile_cap, int grid_x, int tile_size,
                           int chunk, int list_len, const void* out_color,
                           const void* out_depth, const void* out_t,
                           const void* g_color, const void* g_depth,
                           const void* g_t, void* slots, void* tally,
                           void* stream) {
    if (num_tiles == 0) return 0;
    const float* fwd[6] = {(const float*)out_color, (const float*)out_depth,
                           (const float*)out_t, (const float*)g_color,
                           (const float*)g_depth, (const float*)g_t};
    auto build = tally ? &launch<true, true> : &launch<false, true>;
    return (int)build((const int*)gidx, (const int*)counts,
                      (const float4*)table, n_gauss, num_tiles, tile0,
                      tile_cap, grid_x, tile_size, chunk, list_len, fwd,
                      (float*)slots,
                      (unsigned long long*)tally, (cudaStream_t)stream);
}

}  // extern "C"
