// Scatter kernels: a row scatter-add (K4) and a scalar scatter-set (K5).
//
// Replace the TPU kernels fourdgs_tpu/ops/pallas/scatter.py:
// `scatter_add_rows` (K4, :26) and `scatter_set_scalars` (K5, :73), serial
// Mosaic loops over a VMEM-resident accumulator. Plain versions:
// fourdgs_tpu_torch/ops/scatter.py:scatter_add_rows_plain and
// scatter_set_scalars_plain. Each C entry fills its output on the stream
// (cudaMemsetAsync) and then launches its kernel there, so a call is one
// ctypes call, one fill and one kernel, with no PyTorch fill kernel.
//
// K4 computes out[idx[i]] += rows[i] for (M, W) float32 rows into an
// (n_out, W) table, with each index clamped to [0, n_out - 1] (the JAX
// kernel's clip: out-of-range indices land on the sacrificial last row).
// Bound on an H100: bytes, the rows and indices read once and the table
// written once, at 3.35 TB/s. What keeps a simple kernel (one float atomic
// per element) far from it is same-address atomics: its callers send long
// runs of consecutive rows to one row (every tile's empty slots to the
// blend reduction's sacrificial row; the dead slots of the gaussian buffer,
// all at xyz = 0, to one HexPlane cell), and atomics on one address
// serialise in one L2 slice. So the rows are summed per run before any
// atomic:
//   * a block owns a contiguous segment of rows; each of its threads owns
//     one vector of V columns (V = 4, 2 or 1, as W and the rows' address
//     allow) of a contiguous stretch of that segment (a "lane" of rows),
//     and walks it in order, loads batched four rows at a time;
//   * consecutive rows with the same clamped index form a run; a thread
//     adds one atomic per run it closes inside its lane. Its lane's first
//     and last runs go to shared memory, where one thread per column
//     vector joins them across the block's lanes in order, so a run that
//     crosses lanes and warps costs one atomic per block;
//   * each atomic adds V floats at once (the H100's vector float atomics
//     on global memory, atomicAdd on float2 and float4), and a run whose
//     sums are all zero issues none (a NaN is not zero and is added).
// Uniform random indices keep one atomic per (row, column vector). The
// float sums run in the atomics' order, which changes from run to run (as
// index_add_'s do on the card).
//
// K5 computes out[idx[i]] = val[i] for unique int32 indices into an
// (n_out,) int32 buffer filled with -1; an index at or past n_out, or
// below 0, is dropped and stores nothing (the binner drops every pair past
// tile_cap, hundreds of thousands a frame, and stores of them all to one
// sacrificial address would serialise). Bound on an H100: bytes, the
// indices and values read once and the buffer written once, some 6 MB at
// the binner's shapes: a few microseconds, so what a call costs is mostly
// its launch path. Each thread takes four elements through one 16-byte
// load of idx and one of val (the leading and trailing elements that
// alignment leaves over go one at a time), over a grid of a few waves of
// the 132 SMs with a grid-stride loop. The binner's destinations rise
// within each tile, so a warp's stores fall in few sectors: plain stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSMs = 132;
constexpr int kBatch = 4;          // rows loaded ahead in K4's walk

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

template <int V>
struct Part {
    float v[V];
};

template <int V>
__device__ __forceinline__ Part<V> part_zero() {
    Part<V> p;
#pragma unroll
    for (int i = 0; i < V; ++i) p.v[i] = 0.0f;
    return p;
}

template <int V>
__device__ __forceinline__ void part_add(Part<V>& a, const Part<V>& b) {
#pragma unroll
    for (int i = 0; i < V; ++i) a.v[i] += b.v[i];
}

template <int V>
__device__ __forceinline__ bool part_nonzero(const Part<V>& a) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < V; ++i) any |= (a.v[i] != 0.0f);   // NaN counts
    return any;
}

template <int V>
__device__ __forceinline__ Part<V> part_load(const float* p);

template <>
__device__ __forceinline__ Part<1> part_load<1>(const float* p) {
    Part<1> r;
    r.v[0] = __ldg(p);
    return r;
}

template <>
__device__ __forceinline__ Part<2> part_load<2>(const float* p) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    Part<2> r;
    r.v[0] = t.x;
    r.v[1] = t.y;
    return r;
}

template <>
__device__ __forceinline__ Part<4> part_load<4>(const float* p) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    Part<4> r;
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
    return r;
}

template <int V>
__device__ __forceinline__ void part_atomic(float* dst, const Part<V>& s);

template <>
__device__ __forceinline__ void part_atomic<1>(float* dst, const Part<1>& s) {
    atomicAdd(dst, s.v[0]);
}

template <>
__device__ __forceinline__ void part_atomic<2>(float* dst, const Part<2>& s) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(s.v[0], s.v[1]));
}

template <>
__device__ __forceinline__ void part_atomic<4>(float* dst, const Part<4>& s) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(s.v[0], s.v[1], s.v[2], s.v[3]));
}

__device__ __forceinline__ int clamp_index(int g, int n_out) {
    return g < 0 ? 0 : (g >= n_out ? n_out - 1 : g);
}

// Grid (segments, column blocks); block = cv_block column vectors x lanes
// lanes of lane_rows rows each. Thread t is lane t / cv_block, column
// vector t % cv_block of its column block.
template <int V>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const int* __restrict__ idx,
                        const float* __restrict__ rows, long long m, int w,
                        int n_out, int cv_block, int lanes, int lane_rows,
                        float* __restrict__ out) {
    __shared__ int head_key[kThreads];
    __shared__ int tail_key[kThreads];
    __shared__ Part<V> head_sum[kThreads];
    __shared__ Part<V> tail_sum[kThreads];

    const int t = threadIdx.x;
    const int lane = t / cv_block;
    const int cl = t - lane * cv_block;
    const int cv = blockIdx.y * cv_block + cl;
    const bool col_ok = cv * V < w;
    const int c = col_ok ? cv * V : 0;
    const long long seg = (long long)lanes * lane_rows;
    const long long seg_end = min((long long)(blockIdx.x + 1) * seg, m);
    const long long a = (long long)blockIdx.x * seg
                        + (long long)lane * lane_rows;
    const long long b = min(a + lane_rows, seg_end);

    auto flush = [&](int key, const Part<V>& s) {
        if (key >= 0 && col_ok && part_nonzero(s))
            part_atomic<V>(out + (size_t)key * w + c, s);
    };

    // walk the lane: the first run is kept as the head, runs closed after
    // it are flushed, the open run at the end is the tail
    bool have_head = false;
    int hk = -1, ck = -1;
    Part<V> hs = part_zero<V>(), cs = part_zero<V>();
    auto step = [&](int k, const Part<V>& v) {
        if (k != ck) {
            if (ck >= 0) {
                if (have_head) {
                    flush(ck, cs);
                } else {
                    have_head = true;
                    hk = ck;
                    hs = cs;
                }
            }
            ck = k;
            cs = part_zero<V>();
        }
        part_add(cs, v);
    };
    long long r = a;
    for (; r + kBatch <= b; r += kBatch) {
        int k[kBatch];
        Part<V> v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            k[u] = clamp_index(__ldg(idx + r + u), n_out);
            v[u] = col_ok ? part_load<V>(rows + (size_t)(r + u) * w + c)
                          : part_zero<V>();
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) step(k[u], v[u]);
    }
    for (; r < b; ++r)
        step(clamp_index(__ldg(idx + r), n_out),
             col_ok ? part_load<V>(rows + (size_t)r * w + c)
                    : part_zero<V>());

    if (cl == 0) {
        head_key[lane] = have_head ? hk : -1;
        tail_key[lane] = ck;             // -1 for a lane past the rows
    }
    head_sum[t] = hs;
    tail_sum[t] = cs;
    __syncthreads();

    // join the lanes' first and last runs in row order, one thread per
    // column vector
    if (lane != 0 || !col_ok) return;
    int carry_k = -1;
    Part<V> carry = part_zero<V>();
    for (int q = 0; q < lanes; ++q) {
        const int h = head_key[q], tk = tail_key[q];
        if (tk < 0) break;               // this lane and the rest are empty
        const int s = q * cv_block + cl;
        if (h >= 0) {                    // head, flushed runs, then tail
            if (h == carry_k) {
                part_add(carry, head_sum[s]);
            } else {
                flush(carry_k, carry);
                carry = head_sum[s];
            }
            flush(h, carry);
            carry_k = tk;
            carry = tail_sum[s];
        } else if (tk == carry_k) {      // the whole lane is one run
            part_add(carry, tail_sum[s]);
        } else {
            flush(carry_k, carry);
            carry_k = tk;
            carry = tail_sum[s];
        }
    }
    flush(carry_k, carry);
}

template <int V>
int launch_add_rows(const int* idx, const float* rows, long long m, int w,
                    int n_out, float* out, cudaStream_t stream) {
    const int cols_v = w / V;
    const int cv_block = cols_v < kThreads ? cols_v : kThreads;
    const int lanes = kThreads / cv_block;
    const int grid_y = (cols_v + cv_block - 1) / cv_block;
    // a few waves of blocks over the SMs, each lane at least 4 rows long
    long long target = (long long)kSMs * 8 / grid_y;
    if (target < 1) target = 1;
    long long seg = (m + target - 1) / target;
    if (seg < 4LL * lanes) seg = 4LL * lanes;
    const long long lane_rows = (seg + lanes - 1) / lanes;
    seg = lane_rows * lanes;
    const long long grid_x = (m + seg - 1) / seg;
    scatter_add_rows_kernel<V><<<dim3((unsigned)grid_x, (unsigned)grid_y),
                                 cv_block * lanes, 0, stream>>>(
        idx, rows, m, w, n_out, cv_block, lanes, (int)lane_rows, out);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_scalar(int g, int v, int n_out,
                                             int* __restrict__ out) {
    if ((unsigned)g < (unsigned)n_out) out[g] = v;   // drops g < 0 too
}

// Elements [0, head) and [head + 4 groups, m) one at a time, the groups of
// four between them through 16-byte loads (idx + head and val + head are
// 16-byte aligned when groups > 0).
__global__ void __launch_bounds__(kThreads)
scatter_set_scalars_kernel(const int* __restrict__ idx,
                           const int* __restrict__ val, long long m,
                           long long head, long long groups, int n_out,
                           int* __restrict__ out) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int4* idx4 = reinterpret_cast<const int4*>(idx + head);
    const int4* val4 = reinterpret_cast<const int4*>(val + head);
    for (long long g = t; g < groups; g += stride) {
        const int4 i = __ldg(idx4 + g);
        const int4 v = __ldg(val4 + g);
        store_scalar(i.x, v.x, n_out, out);
        store_scalar(i.y, v.y, n_out, out);
        store_scalar(i.z, v.z, n_out, out);
        store_scalar(i.w, v.w, n_out, out);
    }
    for (long long e = t; e < head; e += stride)
        store_scalar(__ldg(idx + e), __ldg(val + e), n_out, out);
    for (long long e = head + 4 * groups + t; e < m; e += stride)
        store_scalar(__ldg(idx + e), __ldg(val + e), n_out, out);
}

}  // namespace

extern "C" {

// Zero-fill out on `stream`, then launch; return the cudaError_t of the
// fill or the launch (0 = ok). idx (m,) int32, rows (m, w) float32
// (4-byte aligned; V is chosen from w and the address), out (n_out, w)
// float32 (16-byte aligned, as the caching allocator hands it out).
int scatter_add_rows_launch(const void* idx, const void* rows, long long m,
                            int w, int n_out, void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n_out
                                      * (size_t)w, s);
    if (err != cudaSuccess) return (int)err;
    if (m == 0 || w == 0) return 0;
    const uintptr_t addr = (uintptr_t)rows | (uintptr_t)out;
    const int* i = (const int*)idx;
    const float* r = (const float*)rows;
    float* o = (float*)out;
    if (w % 4 == 0 && addr % 16 == 0)
        return launch_add_rows<4>(i, r, m, w, n_out, o, s);
    if (w % 2 == 0 && addr % 8 == 0)
        return launch_add_rows<2>(i, r, m, w, n_out, o, s);
    return launch_add_rows<1>(i, r, m, w, n_out, o, s);
}

// Fill out with -1 on `stream`, then launch. idx, val (m,) int32, the
// in-range indices unique; out (n_out,) int32.
int scatter_set_scalars_launch(const void* idx, const void* val, long long m,
                               int n_out, void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0xFF, sizeof(int) * (size_t)n_out,
                                      s);
    if (err != cudaSuccess) return (int)err;
    if (m == 0) return 0;
    // 16-byte loads where idx and val share their offset within 16 bytes
    const uintptr_t ia = (uintptr_t)idx, va = (uintptr_t)val;
    long long head = m, groups = 0;
    if (ia % 16 == va % 16) {
        head = (long long)((16 - ia % 16) % 16 / sizeof(int));
        if (head > m) head = m;
        groups = (m - head) / 4;
    }
    const long long work = groups + (m - 4 * groups);
    long long blocks = (work + kThreads - 1) / kThreads;
    if (blocks > kSMs * 8) blocks = kSMs * 8;
    scatter_set_scalars_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int*)idx, (const int*)val, m, head, groups, n_out, (int*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
