// Row gather: out[i] = table[idx[i]] (D1), the HexPlane's forward gather.
//
// Replaces the TPU kernels of scripts/exp_pallas_gather.py (gather1 :50,
// gather2 :75, gather3 :102, gather4 :125): four ways to write one gather
// from a VMEM-resident table in Pallas (jnp.take, take_along_axis, a loop
// of dynamic row copies, advanced indexing). On the card one kernel
// computes the function; on the main path it is the forward of
// fourdgs_tpu/models/hexplane.py:71 _gather_rows, where XLA gathers.
// Plain version: fourdgs_tpu_torch/ops/gather.py:gather_rows_plain.
//
// table (n_rows, w) float32, w a multiple of 4, idx (m,) int32 clamped to
// [0, n_rows - 1], out (m, w) float32.
//
// Bound on an H100: bytes. The index is read once and the output written
// once; the table's rows are read through L2 (a HexPlane plane of 4,096 or
// 16,384 rows of 32 floats, a time plane's lerped row of 64 or 128, the
// script's 8 MiB table: all fit the 50 MB L2), so each row that some index
// names leaves device memory once. A HexPlane gather at the step (131,072
// indices, rows of 32) writes 16.8 MB and reads 0.5 MB of indices: 0.0052
// ms at 3.35 TB/s; the script's shapes (131,072 x 16 table, 2^20
// indices) 76 MiB, 0.024 ms.
//
// Design: the row width is a template parameter (W4 float4s, a power of
// two up to 32), so a lane's column and row within a warp are a mask and
// a shift, not a 64-bit division. 32 / W4 rows share a warp step, which
// writes 512 contiguous bytes, and a thread takes kRows rows spaced a warp
// step apart: it loads their kRows indices first, then their kRows 16-byte
// row pieces, then stores them, so that kRows loads of each kind are in
// flight a thread. Other widths take the generic kernel (a row's float4s
// walked by a thread group, one division a thread).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;

__device__ __forceinline__ int clamp_row(int g, int n_rows) {
    return g < 0 ? 0 : (g >= n_rows ? n_rows - 1 : g);
}

template <int W4>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table,
                   const int* __restrict__ idx, int m, int n_rows,
                   float4* __restrict__ out) {
    constexpr int kStep = 32 / W4;          // rows a warp step
    const int lane = threadIdx.x & 31;
    const int c = lane & (W4 - 1);
    const long long warp =
        ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    const long long first = warp * kStep * kRows + lane / W4;
    int g[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const long long r = first + k * kStep;
        g[k] = r < m ? clamp_row(__ldg(idx + r), n_rows) : 0;
    }
    float4 v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
        if (first + k * kStep < m)
            v[k] = __ldg(table + (size_t)g[k] * W4 + c);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const long long r = first + k * kStep;
        if (r < m) out[r * W4 + c] = v[k];
    }
}

__global__ void __launch_bounds__(kThreads)
gather_rows_any_kernel(const float4* __restrict__ table,
                       const int* __restrict__ idx, long long m, int w4,
                       int n_rows, float4* __restrict__ out) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= m * w4) return;
    const long long r = i / w4;
    const int c = (int)(i - r * w4);
    const int g = clamp_row(__ldg(&idx[r]), n_rows);
    out[i] = __ldg(&table[(size_t)g * w4 + c]);
}

template <int W4>
cudaError_t launch(const float4* table, const int* idx, long long m,
                   int n_rows, float4* out, cudaStream_t stream) {
    constexpr long long kRowsBlock = (long long)kThreads / 32 * (32 / W4)
                                     * kRows;
    const long long blocks = (m + kRowsBlock - 1) / kRowsBlock;
    gather_rows_kernel<W4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        table, idx, (int)m, n_rows, out);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; return the cudaError_t of the launch (0 = ok).
// w % 4 == 0, table and out 16-byte aligned, m below 2^31 (the wrapper
// checks).
int gather_rows_launch(const void* table, const void* idx, long long m,
                       int w, int n_rows, void* out, void* stream) {
    if (m == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    const float4* t = (const float4*)table;
    const int* i = (const int*)idx;
    float4* o = (float4*)out;
    switch (w / 4) {
        case 1: return (int)launch<1>(t, i, m, n_rows, o, s);
        case 2: return (int)launch<2>(t, i, m, n_rows, o, s);
        case 4: return (int)launch<4>(t, i, m, n_rows, o, s);
        case 8: return (int)launch<8>(t, i, m, n_rows, o, s);
        case 16: return (int)launch<16>(t, i, m, n_rows, o, s);
        case 32: return (int)launch<32>(t, i, m, n_rows, o, s);
        default: break;
    }
    const long long n = m * (w / 4);
    gather_rows_any_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                             kThreads, 0, s>>>(t, i, m, w / 4, n_rows, o);
    return (int)cudaGetLastError();
}

}  // extern "C"
