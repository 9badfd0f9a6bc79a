// Kernel K6: inclusive segmented sum down the rows of an (N, 128) matrix.
//
// Replaces: envgs_tpu/ops/segsum.py::_segscan_kernel (Pallas, TPU).
// out[i] = rows[i] + (seg_start[i] ? 0 : out[i-1]) per lane, with a zero
// carry before row 0. It is the scan of the scatter-free transpose of the
// pair gather (permute the cotangent rows into segment order, scan, read
// each segment's last row).
//
// What bounds it on the card: memory. One add per element against 8 bytes
// moved (a row element read, a sum written); the least traffic is N * 128 *
// 8 bytes plus the flags.
//
// Design: the TPU kernel scans each 1024-row block with a log-step tree
// and carries the last row from grid step to grid step in scratch memory,
// which relies on the TPU running its grid in order. Blocks on the card
// run in no order, so the scan takes three launches over the same 1024-row
// blocks: (1) each block's tail sum (the sum since the block's last
// segment start, or over the whole block) and whether it holds a start,
// (2) one block turns those into each block's carry-in (a carry passes
// through a block without a start and is replaced by the tail of a block
// with one), (3) each block scans again from its carry-in and writes. One
// thread per lane walks the block's rows in order, so a warp reads and
// writes whole 128-byte lines and the sum inside a block is sequential,
// not a tree: it differs from the TPU's result by float32 rounding. A
// segment start assigns zero to the running sum (it does not multiply), so
// a NaN or Inf row never leaks into the next segment. The rows are read
// twice (launches 1 and 3): 1.5x the least traffic. The wrapper counts the
// three launches as one call of K6.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;   // columns of a row, one thread each
constexpr int SROWS = 1024;  // rows per block

// (1) tail sum and start flag of each block
__global__ void __launch_bounds__(LANES)
segscan_tails(const float* __restrict__ rows, const int32_t* __restrict__ flags,
              float* __restrict__ tails, int32_t* __restrict__ has_start) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const float* r = rows + (size_t)b * SROWS * LANES + lane;
  const int32_t* f = flags + (size_t)b * SROWS;
  float acc = 0.0f;
  int any = 0;
#pragma unroll 8
  for (int i = 0; i < SROWS; ++i) {
    const float v = r[(size_t)i * LANES];
    if (f[i] != 0) {
      acc = 0.0f;
      any = 1;
    }
    acc += v;
  }
  tails[(size_t)b * LANES + lane] = acc;
  if (lane == 0) has_start[b] = any;
}

// (2) one block: tails (nb, 128) -> each block's carry-in, in place
__global__ void __launch_bounds__(LANES)
segscan_carries(float* __restrict__ tails, const int32_t* __restrict__ has_start,
                int nb) {
  const int lane = threadIdx.x;
  float carry = 0.0f;
#pragma unroll 8
  for (int b = 0; b < nb; ++b) {
    float* t = tails + (size_t)b * LANES + lane;
    const float tail = *t;
    *t = carry;
    carry = has_start[b] != 0 ? tail : carry + tail;
  }
}

// (3) scan each block from its carry-in and write
__global__ void __launch_bounds__(LANES)
segscan_apply(const float* __restrict__ rows, const int32_t* __restrict__ flags,
              const float* __restrict__ carries, float* __restrict__ out) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t off = (size_t)b * SROWS * LANES + lane;
  const float* r = rows + off;
  float* o = out + off;
  const int32_t* f = flags + (size_t)b * SROWS;
  float acc = carries[(size_t)b * LANES + lane];
#pragma unroll 8
  for (int i = 0; i < SROWS; ++i) {
    const float v = r[(size_t)i * LANES];
    if (f[i] != 0) acc = 0.0f;
    acc += v;
    o[(size_t)i * LANES] = acc;
  }
}

}  // namespace

// Launches K6 (three kernels) on `stream`; returns cudaGetLastError()
// (0 = launched). rows, out: (n, 128) f32, n a multiple of 1024; flags:
// (n,) int32, nonzero at a segment's first row; tails: scratch of
// (n / 1024, 128) f32; has_start: scratch of n / 1024 int32.
extern "C" int segscan(const float* rows, const int32_t* flags, int n,
                       float* tails, int32_t* has_start, float* out,
                       void* stream) {
  const int nb = n / SROWS;
  cudaStream_t s = (cudaStream_t)stream;
  segscan_tails<<<nb, LANES, 0, s>>>(rows, flags, tails, has_start);
  segscan_carries<<<1, LANES, 0, s>>>(tails, has_start, nb);
  segscan_apply<<<nb, LANES, 0, s>>>(rows, flags, tails, out);
  return (int)cudaGetLastError();
}
