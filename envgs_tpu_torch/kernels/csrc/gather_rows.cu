// Kernels P1 and P2: the row gather out[j, :] = table[idx[j], :] of 128-
// column rows, the staging pattern of the blend kernels (packed[gauss_idx]).
//
// Replaces: scripts/tpu_micro_dmagather.py::_gather_kernel_rows (P1: one
// asynchronous row copy per index, 16 in flight) and ::_gather_kernel_win8
// (P2: the copy of the 8-row window aligned down from idx[j], the row
// idx[j] % 8 picked after the copy) (Pallas, TPU). Both move bytes only, so
// the output is bit-equal to table[idx] for any 16- or 32-bit row type.
//
// What bounds them on the card: memory. Each output row is read once from
// the table and written once; with more output rows than table rows the
// table's re-reads hit L2 when it fits (the probe's bf16 table is 128 MB,
// its f32 table 256 MB, the L2 holds 50 MB).
//
// Design. P1: the TPU kernel starts per-row DMAs from one core and keeps
// 16 in flight; on the card the threads are the parallelism. Every thread
// moves one 16-byte vector, so a 512-byte f32 row is one warp's coalesced
// load and store and a 256-byte bf16 row half a warp's; rows in flight are
// bounded by the resident warps, not by a semaphore ring. P2: each warp
// walks its own run of output rows and stages each row's 8-row window in
// shared memory with cp.async (the counterpart of the TPU's asynchronous
// copy), two windows deep: the next row's window is in flight while this
// one's picked row is written. It reads 8x the bytes P1 reads, as the TPU
// variant does; it exists to measure what aligned windows cost here.
// An index outside [0, S) is clamped into it (the JAX gather's rule).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WIN = 8;             // rows of an aligned window
constexpr int WIN_WARPS = 4;       // warps per block of the window kernel
constexpr int ROWS_PER_WARP = 16;  // consecutive output rows per warp

__device__ __forceinline__ int clamp_row(int i, int S) {
  return min(max(i, 0), S - 1);
}

// P1: thread g moves vector g % VPR of output row g / VPR.
template <int VPR>  // 16-byte vectors per row
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ idx, int n, int S,
                   uint4* __restrict__ out) {
  const size_t g = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t j = g / VPR;
  if (j >= (size_t)n) return;
  const int v = (int)(g % VPR);
  const int i = clamp_row(idx[j], S);
  out[g] = table[(size_t)i * VPR + v];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// P2: each warp stages the aligned 8-row window of each of its rows.
template <int VPR>
__global__ void __launch_bounds__(WIN_WARPS * 32)
gather_win8_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ idx, int n, int S,
                   uint4* __restrict__ out) {
  __shared__ uint4 win[WIN_WARPS][2][WIN * VPR];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = (blockIdx.x * WIN_WARPS + warp) * ROWS_PER_WARP;
  const int j1 = min(j0 + ROWS_PER_WARP, n);
  if (j0 >= j1) return;  // the whole warp leaves; no block-wide barrier below

  auto stage_window = [&](int j, int stage) {
    const int i = clamp_row(idx[j], S);
    const uint4* src = table + (size_t)(i / WIN) * WIN * VPR;
    for (int v = lane; v < WIN * VPR; v += 32)
      cp_async16(&win[warp][stage][v], src + v);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  stage_window(j0, 0);
  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) & 1;
    if (j + 1 < j1) {
      stage_window(j + 1, stage ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp();  // every lane's copies of this window have landed
    const int r = clamp_row(idx[j], S) % WIN;
    if (lane < VPR) out[(size_t)j * VPR + lane] = win[warp][stage][r * VPR + lane];
    __syncwarp();  // the window is read before the next copy reuses it
  }
}

}  // namespace

// Launch P1 on `stream`; returns cudaGetLastError() (0 = launched), -1 for
// a row size other than 256 or 512 bytes. table: (S, 128) rows of
// `row_bytes`; idx: (n,) int32; out: (n, 128) of the table's type.
extern "C" int gather_rows(const void* table, const int32_t* idx, int n, int S,
                           int row_bytes, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int vpr = row_bytes / 16;
  const size_t threads = (size_t)n * vpr;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  if (row_bytes == 512)
    gather_rows_kernel<32><<<blocks, THREADS, 0, s>>>(
        (const uint4*)table, idx, n, S, (uint4*)out);
  else if (row_bytes == 256)
    gather_rows_kernel<16><<<blocks, THREADS, 0, s>>>(
        (const uint4*)table, idx, n, S, (uint4*)out);
  else
    return -1;
  return (int)cudaGetLastError();
}

// Launch P2 on `stream`; as gather_rows, S a multiple of 8.
extern "C" int gather_rows_win8(const void* table, const int32_t* idx, int n,
                                int S, int row_bytes, void* out,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int per_block = WIN_WARPS * ROWS_PER_WARP;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  if (row_bytes == 512)
    gather_win8_kernel<32><<<blocks, WIN_WARPS * 32, 0, s>>>(
        (const uint4*)table, idx, n, S, (uint4*)out);
  else if (row_bytes == 256)
    gather_win8_kernel<16><<<blocks, WIN_WARPS * 32, 0, s>>>(
        (const uint4*)table, idx, n, S, (uint4*)out);
  else
    return -1;
  return (int)cudaGetLastError();
}
