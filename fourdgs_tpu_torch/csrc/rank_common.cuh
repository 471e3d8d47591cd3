// Deterministic serial ranks on the card, shared by the counting kernels
// binner.cu (the rasterizer's binner), binner_proto.cu (D2) and serial.cu
// (D4b).
//
// The TPU kernels walk their pairs in one serial loop over the grid and
// keep a counter per tile in SMEM that is zeroed at grid step 0 only
// (scripts/exp_pallas_binner_proto.py:33-38, exp_pallas_serial.py:45-47),
// so a pair's rank is the number of earlier pairs, in serial order, that
// fell on the same tile. Blocks run in no order on the card, and an
// atomicAdd per pair would give ranks that are a permutation changing from
// run to run. Here the serial order is cut into segments of kSegItems
// items (item i owns count(i) pairs, in order j = 0, 1, ...), and three
// kernels give every pair its serial rank:
//   1. histogram: a block per segment counts how many of its pairs fall on
//      each tile (shared-memory counters: a count does not depend on
//      order); its threads take the segment's pairs in flat order, so an
//      item with many pairs does not hold up a warp;
//   2. scan: per tile, an exclusive scan over the segments in order, so
//      that each segment knows the rank its first pair on each tile takes,
//      and each tile its total;
//   3. walk: a block per segment; each of its four warps takes a quarter
//      of the items, counts its pairs by tile, and from the segment's first
//      ranks and the earlier quarters' counts knows its own; then it walks
//      its pairs in serial order, 32 at a time (past 14,239 tiles, whose
//      four sets of counters do not fit in shared memory, the quarters
//      share counters in pairs or all four, and walk in turn). __match_any_sync groups the
//      lanes whose pairs fall on one tile; a lane's rank is the tile's
//      shared counter plus the number of lanes of its group below it
//      (__popc), and the group's highest lane advances the counter.
// A pair whose tile lies outside [0, nt) takes no rank: it is emitted with
// t = -1 and rank = -1.
//
// The layout is the card's, not the TPU's: hist is segment-major
// (hist[s * nt + t]), so the histogram writes and the walk reads a
// segment's row with consecutive lanes on consecutive tiles, and the scan
// reads 8 consecutive tiles of each of 4 segments a warp load, with the
// segments cut into 128 runs a block so that some 80 blocks (at 625
// tiles) share the scan. Both passes over the pairs stage the segment's
// items in shared memory with one read of each, so a pair reads its item
// there, and find a pair's item by a fixed 7-step search over the
// segment's 128 offsets. The walk's quarters cut each warp's serial chain
// to a quarter of the segment's pairs and put four warps on each segment,
// for the latency of each step's shuffles and stores.
//
// A Source has a trivially copyable `Item` and
//   __device__ Item load(long long i) const;       item i, read once a pass
//   __device__ int count(const Item&) const;       its pairs, 0 or more
//   __device__ int tile(const Item&, int j) const; pair j's tile
// An Emit has `__device__ void operator()(long long i, const Item&, int j,
// int t, int rank) const`, called once for every pair.
//
// Cost beside a one-pass atomic counter: the histogram pass and the
// walk's quarter counts expand every pair once more each, the scan reads
// hist twice and writes it once, and the walk runs 32 pairs per warp
// step.
#pragma once

#include <cuda_runtime.h>

// Named namespaces only, and the kernels templates: nvcc's registration
// code cannot tell an unnamed namespace here from the including file's.
namespace fourdgs {
namespace rank {

constexpr int kSegItems = 128;     // items per segment, a power of two
constexpr int kSegThreads = kSegItems;    // an item a thread while staging
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kScanTiles = 8;      // a scan block's tiles
constexpr int kScanWarps = 32;
constexpr int kScanHold = 16;      // counts a scan thread loads at once
constexpr int kStaticSmem = 48 * 1024;

// The largest k in [0, kSegItems) with off[k] <= p, off ascending from
// off[0] = 0 <= p: the item that owns pair p (items without pairs share
// their offset with the next item, and the search passes over them).
__device__ __forceinline__ int owner_of(const int* off, int p) {
    int k = 0;
#pragma unroll
    for (int step = kSegItems / 2; step > 0; step >>= 1)
        if (off[k + step] <= p) k += step;
    return k;
}

// Items' shared-memory staging: offsets, then the items (16-byte aligned).
template <class Item>
__host__ __device__ constexpr int stage_bytes() {
    return (int)(((sizeof(int) * kSegItems + 15) / 16) * 16
                 + sizeof(Item) * kSegItems);
}

// Stages the block's segment: thread k loads item kSegItems * blockIdx.x
// + k into s_item[k], and s_off takes the exclusive scan of the items'
// counts. Returns the segment's pairs; ends with a barrier.
template <class Source>
__device__ int stage_segment(const Source& src, long long n_items,
                             int* s_off, typename Source::Item* s_item,
                             int* s_warp) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long i = (long long)blockIdx.x * kSegItems + threadIdx.x;
    int c = 0;
    if (i < n_items) {
        const typename Source::Item it = src.load(i);
        s_item[threadIdx.x] = it;
        c = src.count(it);
    }
    int x = c;                                  // inclusive, in the warp
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kSegWarps; ++w) {
        before += w < warp ? s_warp[w] : 0;
        total += s_warp[w];
    }
    s_off[threadIdx.x] = before + x - c;
    __syncthreads();
    return total;
}

// The shared memory of a segment's block: the staging, then `counters`
// arrays of nt ints.
template <class Item>
__host__ __device__ constexpr int segment_smem(int nt, int counters) {
    return stage_bytes<Item>() + (int)sizeof(int) * nt * counters;
}

// hist (n_segs, nt): pairs of segment s on tile t at hist[s * nt + t]
template <class Source>
__global__ void __launch_bounds__(kSegThreads)
rank_histogram_kernel(Source src, long long n_items, int nt,
                      int* __restrict__ hist) {
    using Item = typename Source::Item;
    extern __shared__ __align__(16) unsigned char smem[];
    int* s_off = reinterpret_cast<int*>(smem);
    Item* s_item = reinterpret_cast<Item*>(
        smem + ((sizeof(int) * kSegItems + 15) / 16) * 16);
    int* s_cnt = reinterpret_cast<int*>(smem + stage_bytes<Item>());
    __shared__ int s_warp[kSegWarps];
    for (int t = threadIdx.x; t < nt; t += kSegThreads) s_cnt[t] = 0;
    const int total = stage_segment(src, n_items, s_off, s_item, s_warp);
    for (int p = threadIdx.x; p < total; p += kSegThreads) {
        const int k = owner_of(s_off, p);
        const int t = src.tile(s_item[k], p - s_off[k]);
        if (t >= 0 && t < nt) atomicAdd(&s_cnt[t], 1);
    }
    __syncthreads();
    int* row = hist + (size_t)blockIdx.x * nt;
    for (int t = threadIdx.x; t < nt; t += kSegThreads) row[t] = s_cnt[t];
}

// A block per kScanTiles tiles: lane l of warp w takes tile
// kScanTiles * blockIdx.x + l % kScanTiles and the r-th of the block's
// runs of consecutive segments, r = (32 / kScanTiles) * w + l / kScanTiles,
// so that a warp's load reads kScanTiles consecutive tiles of 32 /
// kScanTiles segments. A thread loads its run kScanHold counts at a time
// into registers, all in flight together, and keeps them for the second
// pass when the run fits. hist's column becomes its exclusive scan in
// segment order; cnt (if not null) the column's total.
template <int Warps>
__global__ void __launch_bounds__(32 * Warps)
rank_scan_kernel(int* __restrict__ hist, int nt, int n_segs,
                 int* __restrict__ cnt) {
    constexpr int kRuns = 32 / kScanTiles;      // runs a warp
    __shared__ int s_warp[Warps][kScanTiles];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int col = lane % kScanTiles, q = lane / kScanTiles;
    const int t = blockIdx.x * kScanTiles + col;
    const int runs = Warps * kRuns, r = warp * kRuns + q;
    const int per = (n_segs + runs - 1) / runs;
    const int s0 = min(r * per, n_segs), s1 = t < nt ? min(s0 + per, n_segs)
                                                     : s0;
    int held[kScanHold];
    int sum = 0;
    for (int c = s0; c < s1; c += kScanHold) {
#pragma unroll
        for (int k = 0; k < kScanHold; ++k)
            held[k] = c + k < s1 ? hist[(size_t)(c + k) * nt + t] : 0;
#pragma unroll
        for (int k = 0; k < kScanHold; ++k) sum += held[k];
    }
    int x = sum;                        // inclusive over the warp's runs
    for (int d = kScanTiles; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    if (q == kRuns - 1) s_warp[warp][col] = x;
    __syncthreads();
    int run = x - sum;
    for (int w = 0; w < warp; ++w) run += s_warp[w][col];
    for (int c = s0; c < s1; c += kScanHold) {
        if (s1 - s0 > kScanHold) {      // the run did not fit: load again
#pragma unroll
            for (int k = 0; k < kScanHold; ++k)
                held[k] = c + k < s1 ? hist[(size_t)(c + k) * nt + t] : 0;
        }
#pragma unroll
        for (int k = 0; k < kScanHold; ++k) {
            if (c + k < s1) hist[(size_t)(c + k) * nt + t] = run;
            run += held[k];
        }
    }
    if (t < nt && r == runs - 1 && cnt != nullptr) cnt[t] = run;
}

// A block per segment; warp w walks the pairs of the segment's items
// [32 w, 32 w + 32) in order. The warps form `groups` groups of
// consecutive warps (4, 2 or 1), each with nt shared counters: each warp
// first counts its pairs by tile into its group's counters (shared-memory
// atomics), and the block turns the segment's scanned first ranks (hist's
// row) and those counts into each group's first ranks, so the groups walk
// at once and the warps of a group one after another. Four groups need
// 4 nt counters; fewer fit more tiles in the card's shared memory.
template <class Source, class Emit>
__global__ void __launch_bounds__(kSegThreads)
rank_walk_kernel(Source src, long long n_items, int nt, int groups,
                 const int* __restrict__ hist, Emit emit) {
    using Item = typename Source::Item;
    extern __shared__ __align__(16) unsigned char smem[];
    int* s_off = reinterpret_cast<int*>(smem);
    Item* s_item = reinterpret_cast<Item*>(
        smem + ((sizeof(int) * kSegItems + 15) / 16) * 16);
    int* s_next = reinterpret_cast<int*>(smem + stage_bytes<Item>());
    __shared__ int s_warp[kSegWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int turns = kSegWarps / groups;       // warps a group
    for (int t = threadIdx.x; t < groups * nt; t += kSegThreads)
        s_next[t] = 0;
    const int total = stage_segment(src, n_items, s_off, s_item, s_warp);
    const int lo = s_off[32 * warp];
    const int hi = warp == kSegWarps - 1 ? total : s_off[32 * warp + 32];
    int* mine = s_next + (warp / turns) * nt;
    if (groups > 1) {
        for (int p = lo + lane; p < hi; p += 32) {
            const int k = owner_of(s_off, p);
            const int t = src.tile(s_item[k], p - s_off[k]);
            if (t >= 0 && t < nt) atomicAdd(&mine[t], 1);
        }
    }
    __syncthreads();
    const int* row = hist + (size_t)blockIdx.x * nt;
    for (int t = threadIdx.x; t < nt; t += kSegThreads) {
        int next = row[t];
        for (int g = 0; g < groups; ++g) {
            const int c = s_next[g * nt + t];
            s_next[g * nt + t] = next;
            next += c;
        }
    }
    __syncthreads();

    const long long first = (long long)blockIdx.x * kSegItems;
    for (int turn = 0; turn < turns; ++turn) {
        if (warp % turns == turn) {
            for (int base = lo; base < hi; base += 32) {
                const int p = base + lane;
                const bool active = p < hi;
                int k = 0, j = 0, t = -1;
                if (active) {
                    k = owner_of(s_off, p);
                    j = p - s_off[k];
                    t = src.tile(s_item[k], j);
                }
                const bool valid = active && t >= 0 && t < nt;
                const unsigned peers =
                    __match_any_sync(0xffffffffu, valid ? t : -1);
                int rank = -1;
                if (valid) rank = mine[t] + __popc(peers & ((1u << lane) - 1u));
                __syncwarp();                   // all have read mine
                if (valid && (peers >> lane) == 1u) mine[t] += __popc(peers);
                __syncwarp();
                if (active) emit(first + k, s_item[k], j, valid ? t : -1,
                                 rank);
            }
        }
        if (turns > 1) __syncthreads();         // the next warp's turn
    }
}

inline long long rank_segments(long long n_items) {
    return (n_items + kSegItems - 1) / kSegItems;
}

// The static shared memory of the histogram and the walk (s_warp), which
// counts against a block's limit beside the dynamic part.
constexpr int kOwnSmem = (int)sizeof(int) * kSegWarps;

// The walk's groups for nt tiles: the most of 4, 2, 1 whose counters
// and staging fit in `smem_limit` bytes of a block's shared memory, or 0
// when none does.
template <class Item>
inline int walk_groups(int nt, int smem_limit) {
    for (int g = kSegWarps; g >= 1; g >>= 1)
        if (segment_smem<Item>(nt, g) + kOwnSmem <= smem_limit) return g;
    return 0;
}

// Ranks every pair of n_items items over nt tiles and emits it. nt is at
// least 1 and at most what one array of nt counters and the staging
// leave in the card's opt-in shared memory (56,956 tiles for 32-byte
// items in the H100's 227 KB; cudaErrorInvalidValue past it). The walk
// takes 4 groups of counters up to 14,239 such tiles, 2 up to 28,478.
// hist: rank_segments(n_items) x nt ints of scratch; cnt (nt,) or null:
// the tiles' totals. Returns the first launch error.
template <class Source, class Emit>
cudaError_t rank_pairs(Source src, long long n_items, int nt, int* hist,
                       int* cnt, Emit emit, cudaStream_t stream) {
    using Item = typename Source::Item;
    if (nt < 1) return cudaErrorInvalidValue;
    int device = 0, smem_limit = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    const int groups = walk_groups<Item>(nt, smem_limit);
    if (groups == 0) return cudaErrorInvalidValue;
    if (n_items <= 0) {
        if (cnt != nullptr) cudaMemsetAsync(cnt, 0, sizeof(int) * nt, stream);
        return cudaGetLastError();
    }
    const int n_segs = (int)rank_segments(n_items);
    const int hist_smem = segment_smem<Item>(nt, 1);
    const int walk_smem = segment_smem<Item>(nt, groups);
    if (hist_smem + kOwnSmem > kStaticSmem)
        err = cudaFuncSetAttribute(rank_histogram_kernel<Source>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   hist_smem);
    if (err == cudaSuccess && walk_smem + kOwnSmem > kStaticSmem)
        err = cudaFuncSetAttribute(rank_walk_kernel<Source, Emit>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   walk_smem);
    if (err != cudaSuccess) return err;
    rank_histogram_kernel<Source><<<n_segs, kSegThreads, hist_smem,
                                    stream>>>(src, n_items, nt, hist);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    rank_scan_kernel<kScanWarps><<<(nt + kScanTiles - 1) / kScanTiles,
                                   32 * kScanWarps, 0, stream>>>(
        hist, nt, n_segs, cnt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    rank_walk_kernel<Source, Emit><<<n_segs, kSegThreads, walk_smem,
                                     stream>>>(src, n_items, nt, groups,
                                               hist, emit);
    return cudaGetLastError();
}

}  // namespace rank
}  // namespace fourdgs
