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
// order. Blocks on the card run in no order, so the carry between blocks
// comes from a single-pass scan with decoupled look-back, in one launch
// over 2048-position blocks: each block takes its index from a counter in
// launch order (so every block before it has started), scans its markers
// (the scanned quantity is the marker's position, a running max of i where
// valid, else -1, so all channels ride one scan), and publishes in one
// 64-bit status word its inclusive prefix at once if it holds a marker
// (the running max of a block with a marker does not depend on the blocks
// before it), else the fact that it holds none. One warp then looks back
// over the status words of the 32 blocks before it at a time and takes the
// carry from the nearest one with an inclusive prefix; a block without a
// marker publishes its inclusive prefix (the carry) after that. Each
// position then gathers its channels from its marker's own position, and
// the (C, N) output is written once, by 16-byte stores where the layout
// allows. `valid` is read once. The status words and the counter are
// zeroed by a memset on the stream before the launch; the wrapper counts
// the two as one call of K5.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;  // consecutive positions per thread, a multiple of 4
constexpr int BLOCK = THREADS * PER;
constexpr int NWARP = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// status word: the flag in bits 62-63, the position + 1 (0: none) below
constexpr unsigned long long NONE_YET = 0ull, NO_MARKER = 1ull << 62,
                             INCLUSIVE = 2ull << 62;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* s) {
  return *reinterpret_cast<const volatile unsigned long long*>(s);
}

__device__ __forceinline__ void store_status(unsigned long long* s,
                                             unsigned long long flag,
                                             int pos) {
  *reinterpret_cast<volatile unsigned long long*>(s) =
      flag | (unsigned long long)(unsigned)(pos + 1);
}

__global__ void __launch_bounds__(THREADS)
ff_scan(const int32_t* __restrict__ vals, const int32_t* __restrict__ valid,
        int n, int C, unsigned long long* __restrict__ status,
        unsigned* __restrict__ counter, int32_t* __restrict__ out) {
  __shared__ int warp_max[NWARP];
  __shared__ int s_block, s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_block = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int b = s_block;
  const int i0 = b * BLOCK + tid * PER;
  // 16-byte loads and stores where every row of the layout is aligned
  const bool vec = (n & 3) == 0 && ((uintptr_t)valid & 15) == 0
                   && ((uintptr_t)vals & 15) == 0
                   && ((uintptr_t)out & 15) == 0;
  int x[PER];
  if (vec && i0 + PER <= n) {
#pragma unroll
    for (int k = 0; k < PER; k += 4) {
      const int4 v = *reinterpret_cast<const int4*>(valid + i0 + k);
      x[k] = v.x != 0 ? i0 + k : -1;
      x[k + 1] = v.y != 0 ? i0 + k + 1 : -1;
      x[k + 2] = v.z != 0 ? i0 + k + 2 : -1;
      x[k + 3] = v.w != 0 ? i0 + k + 3 : -1;
    }
  } else {
#pragma unroll
    for (int k = 0; k < PER; ++k)
      x[k] = (i0 + k < n && valid[i0 + k] != 0) ? i0 + k : -1;
  }
#pragma unroll
  for (int k = 1; k < PER; ++k) x[k] = max(x[k], x[k - 1]);

  // the running max over the threads before this one, and the block's
  int inc = x[PER - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int m = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc = max(inc, m);
  }
  int before = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) before = -1;
  if (lane == 31) warp_max[warp] = inc;
  __syncthreads();
  int agg = -1;
#pragma unroll
  for (int k = 0; k < NWARP; ++k) {
    if (k < warp) before = max(before, warp_max[k]);
    agg = max(agg, warp_max[k]);
  }

  if (warp == 0) {
    if (lane == 0)
      store_status(status + b, agg >= 0 ? INCLUSIVE : NO_MARKER, agg);
    // look back: lane l reads the status of block p - l, 32 blocks at a
    // time, until the nearest block with an inclusive prefix
    int carry = -1;
    for (int p = b - 1; p >= 0; p -= 32) {
      const int q = p - lane;
      unsigned long long s = INCLUSIVE;  // before block 0: no marker
      if (q >= 0)
        do s = load_status(status + q); while ((s >> 62) == NONE_YET);
      const unsigned found =
          __ballot_sync(FULL, (s >> 62) == (INCLUSIVE >> 62));
      if (found) {
        carry = __shfl_sync(FULL, (int)(unsigned)s - 1, __ffs(found) - 1);
        break;
      }
    }
    if (lane == 0) {
      if (agg < 0) store_status(status + b, INCLUSIVE, carry);
      s_carry = carry;
    }
  }
  __syncthreads();
  before = max(before, s_carry);
#pragma unroll
  for (int k = 0; k < PER; ++k) x[k] = max(x[k], before);

  for (int c = 0; c < C; ++c) {
    const int32_t* v = vals + (size_t)c * n;
    int32_t* o = out + (size_t)c * n;
    int y[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) y[k] = x[k] >= 0 ? v[x[k]] : 0;
    if (vec && i0 + PER <= n) {
#pragma unroll
      for (int k = 0; k < PER; k += 4)
        *reinterpret_cast<int4*>(o + i0 + k) =
            make_int4(y[k], y[k + 1], y[k + 2], y[k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (i0 + k < n) o[i0 + k] = y[k];
    }
  }
}

}  // namespace

// Launches K5 on `stream` (a memset of the status words, then one kernel);
// returns the CUDA error (0 = launched). vals, out: (C, n) int32; valid:
// (n,) int32 0/1; scratch: 2 * (ceil(n / 2048) + 1) int32, 8-byte aligned
// (the counter, then one status word a block).
extern "C" int fill_forward(const int32_t* vals, const int32_t* valid, int n,
                            int C, int32_t* scratch, int32_t* out,
                            void* stream) {
  const int nb = (n + BLOCK - 1) / BLOCK;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long)
                                                    * (nb + 1), s);
  if (err != cudaSuccess) return (int)err;
  ff_scan<<<nb, THREADS, 0, s>>>(
      vals, valid, n, C,
      reinterpret_cast<unsigned long long*>(scratch) + 1,
      reinterpret_cast<unsigned*>(scratch), out);
  return (int)cudaGetLastError();
}

// K5's resources as compiled: out[0] registers per thread, out[1] static
// shared bytes per block, out[2] resident blocks per SM, out[3] local
// (spill) bytes per thread. Launches nothing; returns a CUDA error code.
extern "C" int fill_forward_resources(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ff_scan);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ff_scan,
                                                      THREADS, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  return (int)err;
}
