// The rasterizer's counting binner on the card: D2's serial rank at the
// JAX binner's contract.
//
// Replaces the pair expansion, corner cull and per-tile rank of
// fourdgs_tpu/ops/rasterize_tiled.py:178 bin_gaussians_count (an XLA
// scan of one-hot matmuls on the TPU) with the serial rank that the TPU
// prototype scripts/exp_pallas_binner_proto.py:78 (D2) computes, through
// rank_common.cuh. Plain version:
// fourdgs_tpu_torch/ops/rasterize_tiled.py:bin_gaussians_count_plain.
//
// An item is a gaussian in depth order. After the depth sort (PyTorch's),
// bin_items_kernel gathers each gaussian's row once into depth order (its
// plain version: ops/rasterize_tiled.py:depth_ordered_items): x0, y0, sx
// (the rect's width, at least 1), touched, qpix x, qpix y, cull_r2, gid;
// the wrapper's cumulative sum of touched gives the run ends. Its
// pairs are those of its rect that fall inside the budget, so the run of
// the gaussian that straddles the budget keeps its first part:
// count = clamp(total_slots - run_start, 0, touched). Pair j lies on
// tile (y0 + j / sx, x0 + j % sx), row-major, and takes no rank when the
// exact corner cull drops it (the integer test of the JAX binner, :278-304:
// the -1 absorbs qpix rounding, distances clamp to 23000). So a pair's
// rank is the number of earlier kept pairs, in depth order, on its tile,
// as in JAX, where the cull comes before the rank. A band of tile rows
// (a tile-sharded step bins only its band, its rects clipped to band-local
// rows) ranks over nt = rows x grid_x tiles with the cull off, as JAX's
// binner with num_tiles set: its rect rows no longer give pixel rows.
//
// Emit: gidx[t * tile_cap + rank] = gid for rank < tile_cap, over a gidx
// that the items' gather fills with -1. Under FOURDGS_BIN_SCATTER=pallas
// it writes instead, per budget slot, dest = t * tile_cap + rank (or nt * tile_cap,
// dropped, past tile_cap, for a culled pair and for a slot no pair takes)
// and src = gid, which K5 then scatters, as the JAX switch does. A last
// block turns the tiles' totals into counts and overflow, and the run ends
// into num_pairs and dropped_pairs.
//
// Bound on an H100: bytes. The projection's fields that the binner reads
// (depth, pix, the rect, touched, cull_r2: 36 bytes a gaussian) read once,
// gidx, counts and overflow written once: at phase 5's step (131,072
// gaussians, 625 tiles, tile_cap 768) 4.7 + 1.9 MB = 6.6 MB, 0.0020 ms at
// 3.35 TB/s. The depth-ordered rows and run ends (4.7 MB) and hist (rank
// segments x nt ints, 2.6 MB there, written once and read twice) are
// scratch, which the bound leaves out, as serial.cu's does.

#include <cuda_runtime.h>

#include "rank_common.cuh"

namespace {

constexpr int kCullClamp = 23000;
constexpr int kFinishThreads = 1024;

struct __align__(16) BinItem {
    int x0, y0, sx, count, qx, qy, r2, gid;
};

struct BinSource {
    using Item = BinItem;
    const int4* rows;       // (n, 2) int4: x0 y0 sx touched | qx qy r2 gid
    const int* ends;        // (n,) inclusive run ends
    int total_slots, ts, grid_x;
    bool cull;              // the exact corner cull (off for a band)
    __device__ Item load(long long i) const {
        const int4 a = __ldg(rows + 2 * i), b = __ldg(rows + 2 * i + 1);
        const int start = __ldg(ends + i) - a.w;
        const int count = min(max(total_slots - start, 0), a.w);
        return {a.x, a.y, a.z, count, b.x, b.y, b.z, b.w};
    }
    __device__ int count(const Item& it) const { return it.count; }
    __device__ int tile(const Item& it, int j) const {
        const int dy = j / it.sx;
        const int tx = it.x0 + (j - dy * it.sx), ty = it.y0 + dy;
        if (!cull) return ty * grid_x + tx;
        const int lox = tx * ts, loy = ty * ts;
        const int ddx = min(max(max(lox - it.qx, it.qx - (lox + ts - 1)) - 1,
                                0), kCullClamp);
        const int ddy = min(max(max(loy - it.qy, it.qy - (loy + ts - 1)) - 1,
                                0), kCullClamp);
        return ddx * ddx + ddy * ddy <= it.r2 ? ty * grid_x + tx : -1;
    }
};

struct GidxEmit {
    int tile_cap;
    int* gidx;
    __device__ void operator()(long long, const BinItem& it, int, int t,
                               int rank) const {
        if (t >= 0 && rank < tile_cap)
            gidx[(size_t)t * tile_cap + rank] = it.gid;
    }
};

struct SlotEmit {
    const int4* rows;
    const int* ends;
    int tile_cap, n_out;
    int *dest, *src;
    __device__ void operator()(long long i, const BinItem& it, int j, int t,
                               int rank) const {
        const int slot = __ldg(ends + i) - __ldg(&rows[2 * i].w) + j;
        dest[slot] = t >= 0 && rank < tile_cap ? t * tile_cap + rank : n_out;
        src[slot] = it.gid;
    }
};

// rows[i] = gaussian order[i]'s row, touched_s[i] its touched: the
// depth-ordered items, each gaussian read once. The grid also fills the
// n_fill ints of `fill` with `value` (the lists with -1, or the slots'
// dest with nt * tile_cap), 16 bytes a store, before the rank writes them.
__global__ void bin_items_kernel(const long long* __restrict__ order,
                                 const float2* __restrict__ pix,
                                 const int2* __restrict__ rect_min,
                                 const int2* __restrict__ rect_max,
                                 const int* __restrict__ touched,
                                 const int* __restrict__ cull_r2,
                                 long long n, int4* __restrict__ rows,
                                 int* __restrict__ touched_s,
                                 int* __restrict__ fill, long long n_fill,
                                 int value) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const int4 v4 = make_int4(value, value, value, value);
    for (long long k = i; k < n_fill / 4; k += stride)
        reinterpret_cast<int4*>(fill)[k] = v4;
    for (long long k = n_fill / 4 * 4 + i; k < n_fill; k += stride)
        fill[k] = value;
    if (i >= n) return;
    const long long g = order[i];
    const float2 p = __ldg(pix + g);
    const int2 lo = __ldg(rect_min + g), hi = __ldg(rect_max + g);
    const int tc = __ldg(touched + g);
    // round(clamp(pix, -2^20, 2^20)), half to even; a NaN centre takes 0,
    // as the card's conversion of the plain version's NaN does
    const float c = 1048576.0f;
    const int qx = isnan(p.x) ? 0 : __float2int_rn(fminf(fmaxf(p.x, -c), c));
    const int qy = isnan(p.y) ? 0 : __float2int_rn(fminf(fmaxf(p.y, -c), c));
    rows[2 * i] = make_int4(lo.x, lo.y, max(hi.x - lo.x, 1), tc);
    rows[2 * i + 1] = make_int4(qx, qy, __ldg(cull_r2 + g), (int)g);
    touched_s[i] = tc;
}

// One block: counts = min(cnt, tile_cap), overflow = max(cnt - tile_cap,
// 0), scalars = (num_pairs, dropped_pairs, dropped_tile).
__global__ void __launch_bounds__(kFinishThreads)
bin_finish_kernel(const int* __restrict__ cnt, int nt, int tile_cap,
                  const int* __restrict__ ends, long long n, int total_slots,
                  int* __restrict__ counts, int* __restrict__ overflow,
                  int* __restrict__ scalars) {
    __shared__ int s_warp[kFinishThreads / 32];
    int drop = 0;
    for (int t = threadIdx.x; t < nt; t += kFinishThreads) {
        const int c = cnt[t];
        counts[t] = min(c, tile_cap);
        overflow[t] = max(c - tile_cap, 0);
        drop += max(c - tile_cap, 0);
    }
    for (int d = 16; d > 0; d >>= 1)
        drop += __shfl_xor_sync(0xffffffffu, drop, d);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = drop;
    __syncthreads();
    if (threadIdx.x == 0) {
        int total_drop = 0;
        for (int w = 0; w < kFinishThreads / 32; ++w) total_drop += s_warp[w];
        const int total = n > 0 ? ends[n - 1] : 0;
        scalars[0] = total;
        scalars[1] = max(total - total_slots, 0);
        scalars[2] = total_drop;
    }
}

}  // namespace

extern "C" {

// Launch on `stream`; return the cudaError_t of the launch (0 = ok).
// order (n,) int64, the depth order; pix (n, 2) float32, rect_min and
// rect_max (n, 2) int32 (8-byte aligned), touched and cull_r2 (n,) int32:
// the projection; rows (n, 8) int32 (16-byte aligned) and touched_s (n,)
// int32 take the depth-ordered items; fill (n_fill,) int32, 16-byte
// aligned, takes `value` everywhere.
int bin_items_launch(const void* order, const void* pix, const void* rect_min,
                     const void* rect_max, const void* touched,
                     const void* cull_r2, long long n, void* rows,
                     void* touched_s, void* fill, long long n_fill,
                     int value, void* stream) {
    const long long threads = n > n_fill / 4 ? n : n_fill / 4;
    if (threads == 0 && n_fill == 0) return 0;
    const long long blocks = (threads + 255) / 256;
    bin_items_kernel<<<(unsigned)(blocks < 1 ? 1 : blocks), 256, 0,
                       (cudaStream_t)stream>>>(
        (const long long*)order, (const float2*)pix, (const int2*)rect_min,
        (const int2*)rect_max, (const int*)touched, (const int*)cull_r2, n,
        (int4*)rows, (int*)touched_s, (int*)fill, n_fill, value);
    return (int)cudaGetLastError();
}

// Launch on `stream`; return the cudaError_t of the launches (0 = ok).
// rows (n, 8) int32 and ends (n,) int32 in depth order (the rows 16-byte
// aligned); hist (rank segments of n, nt) and cnt (nt,) int32 scratch;
// counts, overflow (nt,) and scalars (3,) int32. With gidx (nt *
// tile_cap,) int32 not null, the ranks go there; else dest and src
// (total_slots,) int32 take each budget slot's pair. bin_items_launch has
// filled gidx with -1, or dest with nt * tile_cap. 1 <= nt <= MAX_TILES
// (ops/serial.py); nt * tile_cap and total_slots below 2^31. cull is 1 for
// the exact corner cull, 0 for a band's binning.
int bin_tiles_launch(const void* rows, const void* ends, long long n,
                     int total_slots, int nt, int grid_x, int tile_size,
                     int tile_cap, int cull, void* hist, void* cnt, void* gidx,
                     void* dest, void* src, void* counts, void* overflow,
                     void* scalars, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const BinSource source{(const int4*)rows, (const int*)ends, total_slots,
                           tile_size, grid_x, cull != 0};
    const int n_out = nt * tile_cap;
    const cudaError_t err =
        gidx != nullptr
            ? fourdgs::rank::rank_pairs(source, n, nt, (int*)hist, (int*)cnt,
                                        GidxEmit{tile_cap, (int*)gidx}, s)
            : fourdgs::rank::rank_pairs(
                  source, n, nt, (int*)hist, (int*)cnt,
                  SlotEmit{(const int4*)rows, (const int*)ends, tile_cap,
                           n_out, (int*)dest, (int*)src}, s);
    if (err != cudaSuccess) return (int)err;
    bin_finish_kernel<<<1, kFinishThreads, 0, s>>>(
        (const int*)cnt, nt, tile_cap, (const int*)ends, n, total_slots,
        (int*)counts, (int*)overflow, (int*)scalars);
    return (int)cudaGetLastError();
}

}  // extern "C"
