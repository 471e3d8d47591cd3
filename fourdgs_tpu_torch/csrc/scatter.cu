// Scatter kernels: a row scatter-add (K4) and a scalar scatter-set (K5).
//
// Replace the TPU kernels fourdgs_tpu/ops/pallas/scatter.py:
// `scatter_add_rows` (K4) and `scatter_set_scalars` (K5), serial Mosaic
// loops over a VMEM-resident accumulator. Plain versions:
// fourdgs_tpu_torch/ops/scatter.py:scatter_add_rows_plain and
// scatter_set_scalars_plain.
//
// K4 computes out[idx[i]] += rows[i] for (M, W) float32 rows into an
// (n_out, W) table that the caller zero-fills, with each index clamped to
// [0, n_out - 1] (the JAX kernel's clip: out-of-range indices land on the
// sacrificial last row). One thread per (row, column), one atomicAdd each;
// a zero value is skipped, which leaves the sum as it is. The float sums
// run in the atomics' order, which changes from run to run (as
// index_add_'s do on the card). Bound on an H100: bytes, the rows and
// indices read once and the table written once, at 3.35 TB/s; the atomics
// of many rows into one table row serialise in L2, which this simple
// design does nothing about.
//
// K5 computes out[idx[i]] = val[i] for unique int32 indices into an
// (n_out,) int32 buffer that the caller fills with -1; an index at or past
// n_out, or below 0, is dropped (the TPU kernel's sacrificial slot). One
// thread per element, one store. A dropped element stores nothing: the
// binner drops every pair past tile_cap, hundreds of thousands a frame,
// and stores of them all to one sacrificial address serialise. Bound on
// an H100: bytes, the indices and values read once and the buffer
// written once.

#include <cuda_runtime.h>

namespace {

__global__ void scatter_add_rows_kernel(const int* __restrict__ idx,
                                        const float* __restrict__ rows,
                                        long long m, int w, int n_out,
                                        float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m * w) return;
    const float v = rows[i];
    if (v == 0.0f) return;
    const long long r = i / w;
    const int c = (int)(i - r * w);
    int g = idx[r];
    g = g < 0 ? 0 : (g >= n_out ? n_out - 1 : g);
    atomicAdd(&out[(size_t)g * w + c], v);
}

__global__ void scatter_set_scalars_kernel(const int* __restrict__ idx,
                                           const int* __restrict__ val,
                                           long long m, int n_out,
                                           int* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    const int g = idx[i];
    if (g < 0 || g >= n_out) return;
    out[g] = val[i];
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// Launch on `stream`; return the cudaError_t of the launch (0 = ok).
// idx (m,) int32, rows (m, w) float32, out (n_out, w) float32 zero-filled.
int scatter_add_rows_launch(const void* idx, const void* rows, long long m,
                            int w, int n_out, void* out, void* stream) {
    const long long n = m * w;
    if (n == 0) return 0;
    const long long blocks = (n + kThreads - 1) / kThreads;
    scatter_add_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const int*)idx, (const float*)rows, m, w, n_out, (float*)out);
    return (int)cudaGetLastError();
}

// idx, val (m,) int32, the in-range indices unique; out (n_out,) int32
// filled with -1.
int scatter_set_scalars_launch(const void* idx, const void* val, long long m,
                               int n_out, void* out, void* stream) {
    if (m == 0) return 0;
    const long long blocks = (m + kThreads - 1) / kThreads;
    scatter_set_scalars_kernel<<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const int*)idx, (const int*)val, m, n_out, (int*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
