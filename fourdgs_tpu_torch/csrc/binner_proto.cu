// Serial pair expansion and per-tile rank, the counting binner's prototype
// (D2).
//
// Replaces the TPU kernel of scripts/exp_pallas_binner_proto.py:78
// (make_kernel's pallas_call, body :29): for each gaussian i of each chunk
// of g, in order, and each pair j < sx * sy of its tile rect, in order,
// t = (y0 + j / sx) * grid_x + x0 + j % sx and rank = cnt[t]++, the
// counters carried across chunks; if slot0 + j < pc the chunk's row
// slot0 + j becomes [dest, gid, 0, ...] with dest = t * tile_cap + rank,
// or nt * tile_cap once rank >= tile_cap. A pair past pc still advances
// its tile's counter. Plain version:
// fourdgs_tpu_torch/ops/binner_proto.py:expand_rank_plain.
//
// The serial rank is rank_common.cuh's: a histogram per segment of 256
// gaussians, a scan per tile over the segments, and a warp per segment
// that walks its pairs in order with __match_any_sync, so the rows are the
// same from run to run and equal to the serial loop's. Gaussians without
// pairs (sx or sy below 1) emit none; a pair whose tile lies outside
// [0, nt) takes no rank and, if it is stored, dest nt * tile_cap. Rows
// that no pair writes keep the caller's zeros; the stored pairs' slots
// must be distinct (slot0 a running offset within each chunk, as the
// binner gives it).
//
// Bound on an H100: bytes, the six (n,) inputs read once and the (chunks,
// pc, 8) output written once: 19.9 MB at the script's shapes (131,072
// gaussians in 32 chunks of 4,096, pc 16,384), 0.0059 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include "rank_common.cuh"

namespace {

struct RectSource {
    const int *x0, *y0, *sx, *sy;
    int grid_x;
    __device__ int count(long long i) const {
        const int a = sx[i], b = sy[i];
        return a > 0 && b > 0 ? a * b : 0;
    }
    __device__ int tile(long long i, int j) const {
        const int a = sx[i];
        return (y0[i] + j / a) * grid_x + x0[i] + j % a;
    }
};

struct RowEmit {
    const int *slot0, *gid;
    int g, pc, nt, tile_cap;
    int* out;
    __device__ void operator()(long long i, int j, int t, int rank) const {
        const long long s = (long long)slot0[i] + j;
        if (s < 0 || s >= pc) return;
        const int dest = t >= 0 && rank < tile_cap ? t * tile_cap + rank
                                                   : nt * tile_cap;
        int* row = out + ((size_t)(i / g) * pc + s) * 8;
        row[0] = dest;
        row[1] = gid[i];
    }
};

}  // namespace

extern "C" {

// Launch on `stream`; return the cudaError_t of the launches (0 = ok).
// x0, y0, sx, sy, slot0, gid: (n,) int32, chunk c's gaussians at
// [c * g, (c + 1) * g); hist: (nt, rank segments of n) int32 scratch; out:
// (n / g, pc, 8) int32 zero-filled. 1 <= nt <= 8192, nt * tile_cap and
// (n / g) * pc * 8 below 2^31.
int expand_rank_launch(const void* x0, const void* y0, const void* sx,
                       const void* sy, const void* slot0, const void* gid,
                       long long n, int g, int pc, int nt, int grid_x,
                       int tile_cap, void* hist, void* out, void* stream) {
    const RectSource src{(const int*)x0, (const int*)y0, (const int*)sx,
                         (const int*)sy, grid_x};
    const RowEmit emit{(const int*)slot0, (const int*)gid, g, pc, nt,
                       tile_cap, (int*)out};
    return (int)fourdgs::rank::rank_pairs(src, n, nt, (int*)hist, nullptr,
                                          emit, (cudaStream_t)stream);
}

}  // extern "C"
