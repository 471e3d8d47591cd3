// Row gather: out[i] = table[idx[i]] (D1).
//
// Replaces the TPU kernels of scripts/exp_pallas_gather.py (gather1 :50,
// gather2 :75, gather3 :102, gather4 :125): four ways to write one gather
// from a VMEM-resident table in Pallas (jnp.take, take_along_axis, a loop
// of dynamic row copies, advanced indexing). On the card one kernel
// computes the function. Plain version:
// fourdgs_tpu_torch/ops/gather.py:gather_rows_plain.
//
// table (n_rows, w) float32, w a multiple of 4, idx (m,) int32 clamped to
// [0, n_rows - 1], out (m, w) float32.
//
// One thread per 16 bytes of an output row (the rows 16-byte aligned), so
// the four threads of a 64-byte row share its index and a warp writes 512
// contiguous bytes.
//
// Bound on an H100: bytes. The index is read once and the output written
// once; the table's rows are read through L2 (the script's 8 MiB table
// fits the 50 MB L2), so each row that some index names leaves device
// memory once. At the script's shapes (131,072 x 16 table, 2^20 indices)
// that is 76 MiB, 0.024 ms at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clamp_row(int g, int n_rows) {
    return g < 0 ? 0 : (g >= n_rows ? n_rows - 1 : g);
}

__global__ void gather_rows_vec4_kernel(const float4* __restrict__ table,
                                        const int* __restrict__ idx,
                                        long long m, int w4, int n_rows,
                                        float4* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m * w4) return;
    const long long r = i / w4;
    const int c = (int)(i - r * w4);
    const int g = clamp_row(__ldg(&idx[r]), n_rows);
    out[i] = __ldg(&table[(size_t)g * w4 + c]);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// Launch on `stream`; return the cudaError_t of the launch (0 = ok).
// w % 4 == 0, table and out 16-byte aligned (the wrapper checks).
int gather_rows_launch(const void* table, const void* idx, long long m,
                       int w, int n_rows, void* out, void* stream) {
    const long long n = m * (w / 4);
    if (n == 0) return 0;
    const long long blocks = (n + kThreads - 1) / kThreads;
    gather_rows_vec4_kernel<<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const float4*)table, (const int*)idx, m, w / 4, n_rows,
        (float4*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
