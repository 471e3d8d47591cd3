// Serial scalar stores (D4a) and a per-tile counter with a dependent store
// (D4b).
//
// Replace the TPU kernels of scripts/exp_pallas_serial.py: `store` (:70,
// body store_kernel :31) and `counter` (:77, body counter_kernel :43),
// scalar loops over SMEM chunks into a VMEM-resident int32 table. Plain
// versions: fourdgs_tpu_torch/ops/serial.py:scalar_store_plain and
// tile_counter_store_plain.
//
// D4a computes out[idx[i]] = val[i] in order i over a zeroed (n_out,)
// table, so among repeated indices the last write wins; an index outside
// [0, n_out) is dropped. Blocks run in no order on the card, so the last
// writer of each element is found first: winner[d] = atomicMax of i over
// the pairs on element d (an integer maximum, the same from run to run),
// then the winner stores its value.
//
// D4b computes r = cnt[t]++ in serial order (the rank of rank_common.cuh)
// and out[min(t * tile_cap + r, n_out - 1)] = val[i]; where the clamp, or
// a rank past tile_cap that runs into the next tile's range, lands two
// pairs on one element, the last one wins, through D4a's stores. cnt is
// each tile's total. A tid outside [0, n_tiles) is dropped: not counted,
// not stored.
//
// Bound on an H100: bytes, the indices and values read once and out (and
// cnt) written once: 5.9 MB at the script's shapes (2^18 pairs into a
// 960,000-element table), 0.0018 ms at 3.35 TB/s. The winner table and
// D4b's histograms are scratch, which the bound leaves out. At that size a
// call is a few microseconds of device work, so launches and fills, not
// bytes, set its time: the stores are one cooperative kernel
// (store_last_kernel) whose grid-stride phases fill winner with -1, take
// the atomic maxima, and write each element of out once, its winner's
// value or 0, with a grid barrier between phases (scattered stores of the
// winners over a zero-filled out took 0.0158 ms on the device against
// 0.0109 for this). No PyTorch fill and no memset run beside it,
// and out and winner are the two halves of one buffer that the wrapper
// allocates, so D4a's call is one allocation, one ctypes call and one
// kernel. The grid is as many blocks as the card holds at once (the
// occupancy API), never more, so the cooperative launch cannot be refused
// for its size.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "rank_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kStoreThreads = 1024;

// out[dest[i]] = val[i] over zeros, the largest i winning on each element;
// out and winner (n_out,) int32 each, written whole.
__global__ void __launch_bounds__(kStoreThreads)
store_last_kernel(const int* __restrict__ dest, const int* __restrict__ val,
                  int m, int n_out, int* __restrict__ out,
                  int* __restrict__ winner) {
    cg::grid_group grid = cg::this_grid();
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long k = first; k < n_out; k += stride) winner[k] = -1;
    grid.sync();
    for (long long i = first; i < m; i += stride) {
        const int d = dest[i];
        if (d >= 0 && d < n_out) atomicMax(&winner[d], (int)i);
    }
    grid.sync();
    // each element takes its winner's value, or 0: out is written once, in
    // order, with no fill before it; past the barrier the winners are read
    // from L2, where the atomics left them, not from L1
    for (long long k = first; k < n_out; k += stride) {
        const int w = __ldcg(&winner[k]);
        out[k] = w >= 0 ? val[w] : 0;
    }
}

struct TileSource {
    using Item = int;                   // the pair's tile
    const int* tid;
    __device__ Item load(long long i) const { return tid[i]; }
    __device__ int count(const Item&) const { return 1; }
    __device__ int tile(const Item& t, int) const { return t; }
};

struct DestEmit {
    int tile_cap, n_out;
    int* dest;
    __device__ void operator()(long long i, const int&, int, int t,
                               int rank) const {
        if (t < 0) {
            dest[i] = -1;
            return;
        }
        const long long d = (long long)t * tile_cap + rank;
        dest[i] = (int)(d < n_out - 1 ? d : (long long)n_out - 1);
    }
};

// The blocks of store_last_kernel that the current card holds at once.
cudaError_t resident_blocks(int* blocks) {
    static int cached[64] = {0};
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64 && cached[dev] > 0) {
        *blocks = cached[dev];
        return cudaSuccess;
    }
    int sms, per_sm;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, store_last_kernel, kStoreThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *blocks = sms * per_sm;
    if (dev < 64) cached[dev] = *blocks;
    return cudaSuccess;
}

// out[dest[i]] = val[i] over zeros, the largest i winning on each element;
// buf (2 n_out,) int32: out, then winner (scratch).
cudaError_t store_last(const int* dest, const int* val, int m, int n_out,
                       int* buf, cudaStream_t stream) {
    int resident;
    cudaError_t err = resident_blocks(&resident);
    if (err != cudaSuccess) return err;
    const long long work = m > n_out ? m : n_out;
    const long long wanted = (work + kStoreThreads - 1) / kStoreThreads;
    const int blocks = (int)(wanted < resident ? wanted : resident);
    int* out = buf;
    int* winner = buf + n_out;
    void* args[] = {(void*)&dest, (void*)&val, (void*)&m, (void*)&n_out,
                    (void*)&out, (void*)&winner};
    return cudaLaunchCooperativeKernel((const void*)store_last_kernel,
                                       dim3(blocks), dim3(kStoreThreads),
                                       args, 0, stream);
}

}  // namespace

extern "C" {

// The serial ranks' segment length, which sizes their scratch.
int rank_segment_items(void) { return fourdgs::rank::kSegItems; }

// Launch on `stream`; return the cudaError_t of the launch (0 = ok).
// idx, val (m,) int32; buf (2 n_out,) int32: out (n_out,), then winner
// scratch. Writes every element of out.
int scalar_store_launch(const void* idx, const void* val, int m, int n_out,
                        void* buf, void* stream) {
    return (int)store_last((const int*)idx, (const int*)val, m, n_out,
                           (int*)buf, (cudaStream_t)stream);
}

// tid, val (m,) int32; hist (rank segments of m, n_tiles) and dest (m,)
// int32 scratch; cnt (n_tiles,) int32; buf (2 n_out,) int32: out (n_out,),
// then winner scratch. 1 <= n_tiles <= MAX_TILES (ops/serial.py;
// rank_common.cuh: rank_pairs).
int tile_counter_store_launch(const void* tid, const void* val, int m,
                              int n_tiles, int tile_cap, int n_out,
                              void* hist, void* dest, void* cnt, void* buf,
                              void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = fourdgs::rank::rank_pairs(
        TileSource{(const int*)tid}, m, n_tiles, (int*)hist, (int*)cnt,
        DestEmit{tile_cap, n_out, (int*)dest}, s);
    if (err != cudaSuccess) return (int)err;
    return (int)store_last((const int*)dest, (const int*)val, m, n_out,
                           (int*)buf, s);
}

}  // extern "C"
