// Device marks of the tracer (fourdgs_tpu_torch/utils/tracing.py): one
// thread writes the card's global nanosecond timer (%globaltimer) into
// column `col` of the ring's current row, the row the counter names modulo
// `rows`. The last mark of a replay (`advance`) moves the counter on, so
// the next replay of any traced program writes the next row.
//
// A captured program launches its marks on its own stream, in the order
// of the work they bound, so that every mark of a replay reads the
// counter after the previous replay's last mark wrote it: the stream
// orders them and no atomic is needed. Nothing on the host waits on the
// ring; the tracer reads it after the work is done.
//
// ring (rows, cols) int64, counter (1,) int64. Plain version:
// utils/tracing.py:stamp_plain (the host's nanosecond clock).

#include <cuda_runtime.h>

__global__ void trace_stamp_kernel(long long* ring, long long* counter,
                                   int rows, int cols, int col,
                                   int advance) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long r = *reinterpret_cast<volatile long long*>(counter);
  ring[(r % rows) * cols + col] = static_cast<long long>(now);
  if (advance) *counter = r + 1;
}

extern "C" {

int trace_stamp_launch(void* ring, void* counter, int rows, int cols,
                       int col, int advance, void* stream) {
  trace_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(counter), rows,
      cols, col, advance);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
