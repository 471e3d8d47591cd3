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
// [0, n_out) is dropped. Blocks run in no order on the card, so it takes
// two passes: winner[d] = atomicMax of i over the pairs on element d (an
// integer maximum, the same from run to run), then the winner stores its
// value.
//
// D4b computes r = cnt[t]++ in serial order (the rank of rank_common.cuh)
// and out[min(t * tile_cap + r, n_out - 1)] = val[i]; where the clamp, or
// a rank past tile_cap that runs into the next tile's range, lands two
// pairs on one element, the last one wins, through D4a's two passes. cnt
// is each tile's total. A tid outside [0, n_tiles) is dropped: not
// counted, not stored.
//
// Bound on an H100: bytes, the indices and values read once and out (and
// cnt) written once: 5.9 MB at the script's shapes (2^18 pairs into a
// 960,000-element table), 0.0018 ms at 3.35 TB/s. The winner table and
// D4b's histograms are scratch, which the bound leaves out.

#include <cuda_runtime.h>

#include "rank_common.cuh"

namespace {

__global__ void last_writer_kernel(const int* __restrict__ dest, int m,
                                   int n_out, int* __restrict__ winner) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const int d = dest[i];
    if (d < 0 || d >= n_out) return;
    atomicMax(&winner[d], i);
}

__global__ void store_winner_kernel(const int* __restrict__ dest,
                                    const int* __restrict__ val, int m,
                                    int n_out,
                                    const int* __restrict__ winner,
                                    int* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const int d = dest[i];
    if (d < 0 || d >= n_out || winner[d] != i) return;
    out[d] = val[i];
}

struct TileSource {
    const int* tid;
    __device__ int count(long long) const { return 1; }
    __device__ int tile(long long i, int) const { return tid[i]; }
};

struct DestEmit {
    int tile_cap, n_out;
    int* dest;
    __device__ void operator()(long long i, int, int t, int rank) const {
        if (t < 0) {
            dest[i] = -1;
            return;
        }
        const long long d = (long long)t * tile_cap + rank;
        dest[i] = (int)(d < n_out - 1 ? d : (long long)n_out - 1);
    }
};

constexpr int kThreads = 256;

// out[dest[i]] = val[i], the largest i winning on each element; winner
// (n_out,) int32 scratch.
cudaError_t store_last(const int* dest, const int* val, int m, int n_out,
                       int* winner, int* out, cudaStream_t stream) {
    if (m == 0) return cudaSuccess;
    cudaMemsetAsync(winner, 0xff, sizeof(int) * (size_t)n_out, stream);
    const int blocks = (m + kThreads - 1) / kThreads;
    last_writer_kernel<<<blocks, kThreads, 0, stream>>>(dest, m, n_out,
                                                        winner);
    store_winner_kernel<<<blocks, kThreads, 0, stream>>>(dest, val, m, n_out,
                                                         winner, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The serial ranks' segment length, which sizes their scratch.
int rank_segment_items(void) { return fourdgs::rank::kSegItems; }

// Launch on `stream`; return the cudaError_t of the launches (0 = ok).
// idx, val (m,) int32; winner (n_out,) int32 scratch; out (n_out,) int32
// zero-filled.
int scalar_store_launch(const void* idx, const void* val, int m, int n_out,
                        void* winner, void* out, void* stream) {
    return (int)store_last((const int*)idx, (const int*)val, m, n_out,
                           (int*)winner, (int*)out, (cudaStream_t)stream);
}

// tid, val (m,) int32; hist (n_tiles, rank segments of m) and dest (m,)
// int32 scratch; winner (n_out,) int32 scratch; cnt (n_tiles,) int32; out
// (n_out,) int32 zero-filled. 1 <= n_tiles <= 8192.
int tile_counter_store_launch(const void* tid, const void* val, int m,
                              int n_tiles, int tile_cap, int n_out,
                              void* hist, void* dest, void* winner,
                              void* cnt, void* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = fourdgs::rank::rank_pairs(
        TileSource{(const int*)tid}, m, n_tiles, (int*)hist, (int*)cnt,
        DestEmit{tile_cap, n_out, (int*)dest}, s);
    if (err != cudaSuccess) return (int)err;
    return (int)store_last((const int*)dest, (const int*)val, m, n_out,
                           (int*)winner, (int*)out, s);
}

}  // extern "C"
