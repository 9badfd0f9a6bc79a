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
// 8 bytes plus the flags. This design reads each row once and writes each
// sum once; the only other traffic is each tile's status (a 64-bit word per
// column, 1 KB a tile, zeroed, written once or twice and read by the next
// tiles: some 3% of the rows' bytes at 128 rows a tile).
//
// Design: the TPU kernel carries the last row from grid step to grid step
// in scratch memory, which relies on the TPU running its grid in order.
// Blocks on the card run in no order, so the carry crosses tiles by a
// single-pass scan with decoupled look-back, in one launch over 128-row
// tiles (as K5, fill_forward.cu):
// - a block takes its tile from a counter in launch order (so every tile
//   before it has started and publishes without waiting on anything);
// - each warp is a row group of RPT consecutive rows, each lane 4 columns
//   (16-byte loads and stores, a warp reads or writes 512 contiguous bytes
//   a row); a thread keeps its RPT rows in registers and scans them in
//   order; the group sums are folded across the GROUPS groups in order
//   through shared memory. The tile is read from memory once. (128-row
//   tiles at 2 blocks an SM beat 64-row tiles at 4 by 3.5%, H100: half the
//   look-backs and status words for the same bytes in flight);
// - warp 0 publishes the tile's 128-column sum at once: as its INCLUSIVE
//   prefix if the tile holds a segment start (that prefix does not depend
//   on the tiles before it), else as its AGGREGATE. Each column's status is
//   one 64-bit word, the value's bits beside its flag, written whole: a
//   reader sees a column's old or new word, never a mix, so no fence and no
//   separate flag (a flag word with __threadfence() around two 512-byte
//   vectors costs 0.9 against 0.8 ms at 2^21 rows, H100: the look-back's
//   round trips);
// - a tile whose row 0 is not a start needs the carry: each lane of warp 0
//   looks back over its own 4 columns to the nearest tile j whose words
//   are all inclusive, then folds the tiles after j onto I_j in order:
//   I_j + A_{j+1} + ... + A_{k-1}, taking an inclusive prefix published
//   since in place of the fold up to it. Every published inclusive prefix
//   is that left fold (I_k = I_{k-1} + A_k), so by induction a column's
//   carry has the same bits wherever its look-back stops, and the result
//   is the same on every run. A tile without a start then publishes I_k;
// - rows at or after a start of their tile are written before the
//   look-back, the rest (the carry plus their prefix) after it.
// A segment start assigns the running sum (f ? v_hi : v_lo + v_hi), never
// multiplies it by (1 - f), so a NaN or Inf row does not leak into the next
// segment. The summation order (sequential within a thread's rows, in order
// across row groups, then the carry) differs from the TPU's log-step tree
// by float32 rounding. The status words and the counter are zeroed by
// memsets on the stream before the launch; the wrapper counts them and the
// launch as one call of K6.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;         // columns of a row
constexpr int QUADS = LANES / 4;   // float4 columns of a row, one lane each
constexpr int GROUPS = 8;          // row groups of a tile, one warp each
constexpr int RPT = 16;            // consecutive rows of a row group
constexpr int TILE = GROUPS * RPT;  // rows per tile (block)
constexpr int THREADS = GROUPS * 32;
// a status word: a column's float32 bits below, its flag above
constexpr unsigned NONE_YET = 0, AGGREGATE = 1, INCLUSIVE = 2;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ unsigned long long word(float v, unsigned flag) {
  return (unsigned long long)flag << 32 | __float_as_uint(v);
}

// a lane's 4 columns of a tile's status: two 16-byte stores of whole
// 64-bit words (each word is written at once: a reader sees its old or
// its new value and flag, never a mix), no fence
__device__ __forceinline__ void publish(unsigned long long* w, float4 v,
                                        unsigned flag) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(w),
               "l"(word(v.x, flag)), "l"(word(v.y, flag)) : "memory");
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(w + 2),
               "l"(word(v.z, flag)), "l"(word(v.w, flag)) : "memory");
}

__device__ __forceinline__ void read4(const unsigned long long* w,
                                      unsigned long long (&out)[4]) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(out[0]), "=l"(out[1]) : "l"(w) : "memory");
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(out[2]), "=l"(out[3]) : "l"(w + 2) : "memory");
}

__device__ __forceinline__ unsigned flag_of(unsigned long long w) {
  return (unsigned)(w >> 32);
}

__device__ __forceinline__ float value_of(unsigned long long w) {
  return __uint_as_float((unsigned)w);
}

// a column of the carry: I_m as published, else c + A_m (c: the fold up
// to m - 1, nothing before the first)
__device__ __forceinline__ float fold(float c, bool have,
                                      unsigned long long w) {
  return (flag_of(w) == INCLUSIVE || !have) ? value_of(w) : c + value_of(w);
}

__global__ void __launch_bounds__(THREADS, 2)
segscan_tiles(const float* __restrict__ rows, const int32_t* __restrict__ seg,
              unsigned long long* __restrict__ status,
              unsigned* __restrict__ counter, float* __restrict__ out) {
  __shared__ float4 s_grp[GROUPS][QUADS];
  __shared__ float4 s_carry[QUADS];
  __shared__ int s_gflag[GROUPS];
  __shared__ int s_tile, s_have;
  const int tid = threadIdx.x, q = tid & 31, g = tid >> 5;
  if (tid == 0) s_tile = (int)atomicAdd(counter, 1u);
  __syncthreads();
  const int b = s_tile;
  const size_t row0 = (size_t)b * TILE + (size_t)g * RPT;
  const float4* src = reinterpret_cast<const float4*>(rows) + row0 * QUADS + q;
  float4* dst = reinterpret_cast<float4*>(out) + row0 * QUADS + q;

  float4 v[RPT];
  bool f[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) v[i] = __ldcs(src + (size_t)i * QUADS);
#pragma unroll
  for (int i = 0; i < RPT; ++i) f[i] = __ldg(seg + row0 + i) != 0;
  // the group's own scan, in row order; own[i]: a start at or before row i
  bool own[RPT];
  own[0] = f[0];
#pragma unroll
  for (int i = 1; i < RPT; ++i) {
    v[i] = f[i] ? v[i] : add4(v[i - 1], v[i]);
    own[i] = own[i - 1] || f[i];
  }
  if (q == 0) s_gflag[g] = own[RPT - 1];
  s_grp[g][q] = v[RPT - 1];
  __syncthreads();

  // the groups before this one, folded in order (e: their segmented sum,
  // before: a start among them)
  float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
  bool before = false, have = false;
#pragma unroll
  for (int h = 0; h < GROUPS; ++h) {
    if (h < g) {
      const float4 G = s_grp[h][q];
      const bool F = s_gflag[h] != 0;
      e = (F || !have) ? G : add4(e, G);
      before = before || F;
      have = true;
    }
  }
  // the prefix within the tile, and the rows that need the carry
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    if (have && !own[i]) v[i] = add4(e, v[i]);
  const bool need_any = !before && !own[0];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    if (before || own[i]) __stcs(dst + (size_t)i * QUADS, v[i]);

  // the tile needs a carry unless its row 0 is a start
  const bool tile_needs = __ldg(seg + (size_t)b * TILE) == 0;
  if (g == 0) {
    // the tile's sum A (all groups folded in order), a start in it: FA
    float4 A = s_grp[0][q];
    bool FA = s_gflag[0] != 0;
#pragma unroll
    for (int h = 1; h < GROUPS; ++h) {
      const bool F = s_gflag[h] != 0;
      A = F ? s_grp[h][q] : add4(A, s_grp[h][q]);
      FA = FA || F;
    }
    unsigned long long* mine = status + (size_t)b * LANES + 4 * q;
    publish(mine, A, FA ? INCLUSIVE : AGGREGATE);
    if (tile_needs) {
      // look back, each lane over its own 4 columns: the nearest tile j
      // whose 4 words are inclusive (j = -1: the zero carry before tile 0),
      // waiting where a word is not published yet
      unsigned long long w[4] = {0, 0, 0, 0};
      int j = b - 1;
      for (; j >= 0; --j) {
        const unsigned long long* at = status + (size_t)j * LANES + 4 * q;
        bool none, all_inc;
        do {
          read4(at, w);
          none = flag_of(w[0]) == NONE_YET || flag_of(w[1]) == NONE_YET ||
                 flag_of(w[2]) == NONE_YET || flag_of(w[3]) == NONE_YET;
          all_inc = flag_of(w[0]) == INCLUSIVE &&
                    flag_of(w[1]) == INCLUSIVE &&
                    flag_of(w[2]) == INCLUSIVE && flag_of(w[3]) == INCLUSIVE;
        } while (none);
        if (all_inc) break;
      }
      // I_j, then the tiles after it folded in order: an aggregate is
      // added, an inclusive prefix published since is taken as it is (it
      // is that same fold, to the bit)
      bool have_c = j >= 0;
      float4 c = have_c ? make_float4(value_of(w[0]), value_of(w[1]),
                                      value_of(w[2]), value_of(w[3]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int m = j + 1; m < b; ++m) {
        read4(status + (size_t)m * LANES + 4 * q, w);
        c = make_float4(fold(c.x, have_c, w[0]), fold(c.y, have_c, w[1]),
                        fold(c.z, have_c, w[2]), fold(c.w, have_c, w[3]));
        have_c = true;
      }
      if (!FA)  // the tile's inclusive prefix: I_{k-1} + A_k
        publish(mine, have_c ? add4(c, A) : A, INCLUSIVE);
      s_carry[q] = c;
      if (q == 0) s_have = have_c;
    }
  }
  if (tile_needs) {
    __syncthreads();
    if (need_any) {
      const float4 c = s_carry[q];
      const bool have_c = s_have != 0;
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (!own[i]) __stcs(dst + (size_t)i * QUADS,
                            have_c ? add4(c, v[i]) : v[i]);
    }
  }
}

}  // namespace

// Launches K6 on `stream` (memsets of the status words and the counter,
// then one kernel); returns the CUDA error (0 = launched). rows, out: (n,
// 128) f32, 16-byte aligned, n a multiple of 128; flags: (n,) int32,
// nonzero at a segment's first row; status: scratch of n / 128 * 128
// 64-bit words (each tile's per-column value and flag), 16-byte aligned;
// counter: scratch of one int32.
extern "C" int segscan(const float* rows, const int32_t* flags, int n,
                       void* status, int32_t* counter, float* out,
                       void* stream) {
  const int nt = n / TILE;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * LANES * (size_t)nt, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counter, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  segscan_tiles<<<nt, THREADS, 0, s>>>(
      rows, flags, reinterpret_cast<unsigned long long*>(status),
      reinterpret_cast<unsigned*>(counter), out);
  return (int)cudaGetLastError();
}

// K6's resources as compiled: out[0] registers per thread, out[1] static
// shared bytes per block, out[2] resident blocks per SM, out[3] local
// (spill) bytes per thread. Launches nothing; returns a CUDA error code.
extern "C" int segscan_resources(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, segscan_tiles);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, segscan_tiles,
                                                      THREADS, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  return (int)err;
}
