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
// bounded by the resident warps, not by a semaphore ring.
// P2 keeps the TPU kernel's mechanism, a copy engine fed by one issuing
// thread with a ring of copies in flight that complete on barriers, and
// drops its workaround. The TPU copies the whole aligned 8-row window
// because its DMAs must start on an (8, 128) tile; the card's bulk
// asynchronous copy (cp.async.bulk, the linear form of the TMA) needs 16-
// byte alignment and a size that is a multiple of 16, which a 256- or 512-
// byte row meets, so only the picked row moves and no window is left in the
// kernel (the wrapper still asks for S % 8 == 0, the TPU kernel's contract,
// so that both take the same calls). Each warp owns a contiguous
// run of RUN output rows: the warp stages the run's clamped indices in
// shared memory, then lane 0 alone drives a ring of STAGES stages of GROUP
// rows: per stage one mbarrier (arrive.expect_tx of the stage's bytes), one
// bulk load per row completing on it, and, once try_wait.parity passes, one
// bulk store of the whole stage, whose rows lie contiguous in the ring as
// they do in the output. A stage is refilled when the store before the
// newest has finished reading it (wait_group.read 1), so STAGES - 1 stages
// (24 rows) of loads are in flight per issuing thread. No thread moves a
// data byte through registers: the rows are written and read by the
// asynchronous proxy only, so the one fence.proxy.async stands after the
// barriers' initialisation by the generic proxy. A ragged last stage (n no
// multiple of GROUP or RUN, n below the ring's depth, n = 1) expects, loads
// and stores only its own rows.
// An index outside [0, S) is clamped into it (the JAX gather's rule).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 8;      // rows of a ring stage: one barrier, one store
constexpr int STAGES = 4;     // ring depth per warp, in stages
constexpr int BULK_WARPS = 2; // warps (issuing threads) per block
constexpr int RUN = 256;      // consecutive output rows per warp

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// P2: lane 0 of each warp moves the warp's run of rows through its ring
// with bulk asynchronous copies; see the header note.
template <int ROW_BYTES>
__global__ void __launch_bounds__(BULK_WARPS * 32)
gather_win8_kernel(const char* __restrict__ table,
                   const int32_t* __restrict__ idx, int n, int S,
                   char* __restrict__ out) {
  __shared__ __align__(128) char ring[BULK_WARPS][STAGES][GROUP * ROW_BYTES];
  __shared__ __align__(8) uint64_t full[BULK_WARPS][STAGES];
  __shared__ int32_t rows[BULK_WARPS][RUN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = (blockIdx.x * BULK_WARPS + warp) * RUN;
  const int j1 = min(j0 + RUN, n);
  if (j0 >= j1) return;  // the whole warp leaves; no block-wide barrier below
  for (int r = lane; r < j1 - j0; r += 32)
    rows[warp][r] = clamp_row(idx[j0 + r], S);
  __syncwarp();
  if (lane != 0) return;

  for (int s = 0; s < STAGES; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&full[warp][s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int ngroups = (j1 - j0 + GROUP - 1) / GROUP;
  auto load_group = [&](int g) {  // rows of group g -> stage g % STAGES
    const int s = g % STAGES;
    const int r0 = g * GROUP, cnt = min(GROUP, j1 - j0 - r0);
    const uint32_t bar = smem_addr(&full[warp][s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(cnt * ROW_BYTES) : "memory");
    for (int r = 0; r < cnt; ++r) {
      const char* src = table + (size_t)rows[warp][r0 + r] * ROW_BYTES;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          ::"r"(smem_addr(&ring[warp][s][r * ROW_BYTES])),
            "l"(__cvta_generic_to_global(src)), "r"(ROW_BYTES), "r"(bar)
          : "memory");
    }
  };

  for (int g = 0; g < min(STAGES, ngroups); ++g) load_group(g);
  for (int g = 0; g < ngroups; ++g) {
    const int s = g % STAGES;
    mbar_wait(smem_addr(&full[warp][s]), (g / STAGES) & 1);
    const int r0 = g * GROUP, cnt = min(GROUP, j1 - j0 - r0);
    char* dst = out + (size_t)(j0 + r0) * ROW_BYTES;
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        ::"l"(__cvta_generic_to_global(dst)),
          "r"(smem_addr(&ring[warp][s][0])), "r"(cnt * ROW_BYTES)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // all but the newest store have read their stages: refill the stage of
    // group g - 1 with the group STAGES after it
    asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    if (g >= 1 && g - 1 + STAGES < ngroups) load_group(g - 1 + STAGES);
  }
  // the ring must outlive the stores that read it
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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

// Launch P2 on `stream`; as gather_rows.
extern "C" int gather_rows_win8(const void* table, const int32_t* idx, int n,
                                int S, int row_bytes, void* out,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int per_block = BULK_WARPS * RUN;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  if (row_bytes == 512)
    gather_win8_kernel<512><<<blocks, BULK_WARPS * 32, 0, s>>>(
        (const char*)table, idx, n, S, (char*)out);
  else if (row_bytes == 256)
    gather_win8_kernel<256><<<blocks, BULK_WARPS * 32, 0, s>>>(
        (const char*)table, idx, n, S, (char*)out);
  else
    return -1;
  return (int)cudaGetLastError();
}
