// Kernel K5: multi-channel int32 "last marker wins" segmented broadcast.
//
// Replaces: envgs_tpu/ops/fill_forward.py::_ff_kernel (Pallas, TPU). Given
// value channels vals (C, N) int32 and markers valid (N,), every position i
// takes the channel values at the last marker at or before i (0 before the
// first marker). The training layout of ops/binning.py runs it over the
// chunk-aligned pair slots (N = cap_aligned, C = 3).
//
// What bounds it on the card: memory. Per position it reads one marker and
// writes C ints, reading C more from the marker's own position (a gather
// that hits L2: markers are sparse and reused by the positions behind
// them); no arithmetic to speak of.
//
// Design: the TPU kernel carries the last marker from grid step to grid
// step in scratch memory, which relies on the TPU running its grid in
// order. Blocks on the card run in no order, so the scan runs in three
// launches over 1024-position blocks: (1) each block's last marker index,
// (2) one block scans those per-block maxima (a running max over the
// blocks), (3) each block scans its own markers, takes the carry of the
// blocks before it, and gathers the channel values. The scanned quantity
// is the marker's position (a running max of i where valid, else -1), so
// all channels ride one scan. The wrapper counts the three launches as one
// call of K5.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;  // consecutive positions per thread
constexpr int BLOCK = THREADS * PER;
constexpr unsigned FULL = 0xffffffffu;

// Inclusive running max over the block of one int per thread, in thread
// order. `scratch` holds THREADS ints.
__device__ int block_scan_max(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = max(v, n);
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < THREADS / 32 ? scratch[lane] : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w = max(w, n);
    }
    if (lane < THREADS / 32) scratch[THREADS / 32 + lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = max(v, scratch[THREADS / 32 + warp - 1]);
  __syncthreads();  // scratch is reused by the caller's next scan
  return v;
}

// Inclusive running max of x[0..PER) over the block's BLOCK consecutive
// positions (thread t holds positions t*PER .. t*PER+PER-1), after `carry`.
__device__ void scan_block(int x[PER], int carry, int* scratch, int* excl) {
#pragma unroll
  for (int k = 1; k < PER; ++k) x[k] = max(x[k], x[k - 1]);
  const int inc = block_scan_max(x[PER - 1], scratch);
  excl[threadIdx.x] = inc;
  __syncthreads();
  const int before = max(carry, threadIdx.x > 0 ? excl[threadIdx.x - 1] : -1);
#pragma unroll
  for (int k = 0; k < PER; ++k) x[k] = max(x[k], before);
  __syncthreads();
}

__device__ void load_markers(const int32_t* valid, int n, int b, int x[PER]) {
  const int i0 = b * BLOCK + threadIdx.x * PER;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = i0 + k;
    x[k] = (i < n && valid[i] != 0) ? i : -1;
  }
}

// (1) last marker index of each block, -1 if none
__global__ void __launch_bounds__(THREADS)
ff_block_last(const int32_t* __restrict__ valid, int n,
              int32_t* __restrict__ block_last) {
  __shared__ int scratch[THREADS];
  int x[PER];
  load_markers(valid, n, blockIdx.x, x);
  int m = x[0];
#pragma unroll
  for (int k = 1; k < PER; ++k) m = max(m, x[k]);
  m = block_scan_max(m, scratch);
  if (threadIdx.x == THREADS - 1) block_last[blockIdx.x] = m;
}

// (2) one block: running max over the per-block values, in place
__global__ void __launch_bounds__(THREADS)
ff_carry_scan(int32_t* __restrict__ block_last, int nb) {
  __shared__ int scratch[THREADS];
  __shared__ int excl[THREADS];
  int carry = -1;
  for (int b0 = 0; b0 < nb; b0 += BLOCK) {
    int x[PER];
    const int i0 = b0 + threadIdx.x * PER;
#pragma unroll
    for (int k = 0; k < PER; ++k)
      x[k] = i0 + k < nb ? block_last[i0 + k] : -1;
    scan_block(x, carry, scratch, excl);
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (i0 + k < nb) block_last[i0 + k] = x[k];
    // the block's overall max sits in the last thread's last element
    if (threadIdx.x == THREADS - 1) excl[0] = x[PER - 1];
    __syncthreads();
    carry = excl[0];
    __syncthreads();
  }
}

// (3) scan within each block after the carry, then gather the channels
__global__ void __launch_bounds__(THREADS)
ff_apply(const int32_t* __restrict__ vals, const int32_t* __restrict__ valid,
         int n, int C, const int32_t* __restrict__ scanned,
         int32_t* __restrict__ out) {
  __shared__ int scratch[THREADS];
  __shared__ int excl[THREADS];
  const int b = blockIdx.x;
  int x[PER];
  load_markers(valid, n, b, x);
  scan_block(x, b > 0 ? scanned[b - 1] : -1, scratch, excl);
  const int i0 = b * BLOCK + threadIdx.x * PER;
  for (int c = 0; c < C; ++c) {
    const int32_t* v = vals + (size_t)c * n;
    int32_t* o = out + (size_t)c * n;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = i0 + k;
      if (i < n) o[i] = x[k] >= 0 ? v[x[k]] : 0;
    }
  }
}

}  // namespace

// Launches K5 (three kernels) on `stream`; returns cudaGetLastError()
// (0 = launched). vals, out: (C, n) int32; valid: (n,) int32 0/1;
// block_last: scratch of ceil(n / 1024) int32.
extern "C" int fill_forward(const int32_t* vals, const int32_t* valid, int n,
                            int C, int32_t* block_last, int32_t* out,
                            void* stream) {
  const int nb = (n + BLOCK - 1) / BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  ff_block_last<<<nb, THREADS, 0, s>>>(valid, n, block_last);
  ff_carry_scan<<<1, THREADS, 0, s>>>(block_last, nb);
  ff_apply<<<nb, THREADS, 0, s>>>(vals, valid, n, C, block_last, out);
  return (int)cudaGetLastError();
}
