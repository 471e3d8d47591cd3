// Deterministic serial ranks on the card, shared by the counting kernels
// binner_proto.cu (D2) and serial.cu (D4b).
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
//   1. histogram: per segment, how many of its pairs fall on each tile
//      (shared-memory counters: a count does not depend on order);
//   2. scan: per tile, an exclusive scan over the segments in order, so
//      that each segment knows the rank its first pair on each tile takes,
//      and each tile its total;
//   3. walk: one warp per segment walks its pairs in serial order, 32 at a
//      time. __match_any_sync groups the lanes whose pairs fall on one
//      tile; a lane's rank is the tile's shared counter plus the number of
//      lanes of its group below it (__popc), and the group's highest lane
//      advances the counter.
// A pair whose tile lies outside [0, nt) takes no rank: it is emitted with
// t = -1 and rank = -1.
//
// A Source has `__device__ int count(long long i) const` (the pairs of item
// i, 0 or more) and `__device__ int tile(long long i, int j) const`. An
// Emit has `__device__ void operator()(long long i, int j, int t, int rank)
// const`, called once for every pair.
//
// Cost beside a one-pass atomic counter: the histogram pass reads the
// items once more, the scan reads and writes nt x n_segments ints, and the
// walk runs 32 pairs per warp step.
#pragma once

#include <cuda_runtime.h>

// Named namespaces only, and the kernels templates: nvcc's registration
// code cannot tell an unnamed namespace here from the including file's.
namespace fourdgs {
namespace rank {

constexpr int kSegItems = 256;     // items per segment
constexpr int kHistThreads = 256;
constexpr int kScanThreads = 256;
constexpr int kMaxTiles = 8192;    // shared counters: nt ints a block

// hist (nt, n_segs): pairs of segment s on tile t at hist[t * n_segs + s]
template <class Source>
__global__ void __launch_bounds__(kHistThreads)
rank_histogram_kernel(Source src, long long n_items, int nt, int n_segs,
                      int* __restrict__ hist) {
    extern __shared__ int s_hist[];
    for (int t = threadIdx.x; t < nt; t += blockDim.x) s_hist[t] = 0;
    __syncthreads();
    const long long first = (long long)blockIdx.x * kSegItems;
    const long long last = min(first + kSegItems, n_items);
    for (long long i = first + threadIdx.x; i < last; i += blockDim.x) {
        const int c = src.count(i);
        for (int j = 0; j < c; ++j) {
            const int t = src.tile(i, j);
            if (t >= 0 && t < nt) atomicAdd(&s_hist[t], 1);
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nt; t += blockDim.x)
        hist[(size_t)t * n_segs + blockIdx.x] = s_hist[t];
}

// One block of Threads per tile: hist's row becomes its exclusive scan in
// segment order; cnt (if not null) the row's total.
template <int Threads>
__global__ void __launch_bounds__(Threads)
rank_scan_kernel(int* __restrict__ hist, int n_segs, int* __restrict__ cnt) {
    __shared__ int s_warp[Threads / 32];
    __shared__ int s_carry;
    int* row = hist + (size_t)blockIdx.x * n_segs;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) s_carry = 0;
    __syncthreads();
    for (int base = 0; base < n_segs; base += Threads) {
        const int s = base + threadIdx.x;
        const int v = s < n_segs ? row[s] : 0;
        int x = v;                              // inclusive, in the warp
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) s_warp[warp] = x;
        __syncthreads();
        if (warp == 0) {                        // the warps' totals
            int w = lane < Threads / 32 ? s_warp[lane] : 0;
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xffffffffu, w, d);
                if (lane >= d) w += y;
            }
            if (lane < Threads / 32) s_warp[lane] = w;
        }
        __syncthreads();
        const int incl = x + (warp > 0 ? s_warp[warp - 1] : 0) + s_carry;
        if (s < n_segs) row[s] = incl - v;
        __syncthreads();                        // all have read s_carry
        if (threadIdx.x == Threads - 1) s_carry = incl;
        __syncthreads();
    }
    if (cnt != nullptr && threadIdx.x == 0) cnt[blockIdx.x] = s_carry;
}

// One warp per segment; hist holds the scanned first ranks.
template <class Source, class Emit>
__global__ void __launch_bounds__(32)
rank_walk_kernel(Source src, long long n_items, int nt, int n_segs,
                 const int* __restrict__ hist, Emit emit) {
    extern __shared__ int smem[];
    int* s_next = smem;                 // nt: the next rank on each tile
    int* s_off = smem + nt;             // kSegItems: first pair of each item
    const int lane = threadIdx.x;
    const long long first = (long long)blockIdx.x * kSegItems;
    const int n_seg = (int)min((long long)kSegItems, n_items - first);
    for (int t = lane; t < nt; t += 32)
        s_next[t] = hist[(size_t)t * n_segs + blockIdx.x];

    // the items' pair offsets: each lane sums kSegItems / 32 consecutive
    // items, then an exclusive warp scan of the sums places them
    constexpr int kPer = kSegItems / 32;
    int local[kPer];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        const int k = lane * kPer + q;
        local[q] = k < n_seg ? src.count(first + k) : 0;
        sum += local[q];
    }
    int incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        s_off[lane * kPer + q] = run;
        run += local[q];
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    __syncwarp();

    for (int base = 0; base < total; base += 32) {
        const int p = base + lane;
        const bool active = p < total;
        int k = 0, j = 0, t = -1;
        if (active) {
            // the last item whose first pair is at or before p (items
            // without pairs share their offset with the next item)
            int lo = 0, hi = n_seg - 1;
            while (lo < hi) {
                const int mid = (lo + hi + 1) >> 1;
                if (s_off[mid] <= p) lo = mid; else hi = mid - 1;
            }
            k = lo;
            j = p - s_off[k];
            t = src.tile(first + k, j);
        }
        const bool valid = active && t >= 0 && t < nt;
        const unsigned peers = __match_any_sync(0xffffffffu, valid ? t : -1);
        int rank = -1;
        if (valid) rank = s_next[t] + __popc(peers & ((1u << lane) - 1u));
        __syncwarp();                           // all have read s_next
        if (valid && (peers >> lane) == 1u) s_next[t] += __popc(peers);
        __syncwarp();
        if (active) emit(first + k, j, valid ? t : -1, rank);
    }
}

inline long long rank_segments(long long n_items) {
    return (n_items + kSegItems - 1) / kSegItems;
}

// Ranks every pair of n_items items over nt tiles (1 <= nt <= kMaxTiles)
// and emits it. hist: nt x rank_segments(n_items) ints of scratch; cnt
// (nt,) or null: the tiles' totals. Returns the first launch error.
template <class Source, class Emit>
cudaError_t rank_pairs(Source src, long long n_items, int nt, int* hist,
                       int* cnt, Emit emit, cudaStream_t stream) {
    if (n_items <= 0) {
        if (cnt != nullptr) cudaMemsetAsync(cnt, 0, sizeof(int) * nt, stream);
        return cudaGetLastError();
    }
    const int n_segs = (int)rank_segments(n_items);
    rank_histogram_kernel<Source><<<n_segs, kHistThreads, sizeof(int) * nt,
                                    stream>>>(src, n_items, nt, n_segs,
                                              hist);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    rank_scan_kernel<kScanThreads><<<nt, kScanThreads, 0, stream>>>(
        hist, n_segs, cnt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    rank_walk_kernel<Source, Emit><<<n_segs, 32,
                                     sizeof(int) * (nt + kSegItems),
                                     stream>>>(src, n_items, nt, n_segs,
                                               hist, emit);
    return cudaGetLastError();
}

}  // namespace rank
}  // namespace fourdgs
