// The env cull: cone culling of a scene's Morton chunks and their splats
// for every 16x16 ray tile, and each tile's kept splats in radial order,
// written straight into the 64-aligned slot list the traced blend reads.
//
// No TPU kernel stands behind it: the JAX package culls in plain jnp
// (envgs_tpu/ops/tracer.py::cull_and_sort), and so does the port's plain
// version (ops/tracer.py::cull_and_sort_torch), whose chain of some sixty
// torch ops over (tiles x per-tile cap) planes, a stable sort of every one
// of those candidate slots and a (tiles, cap) int32 plane this replaces.
// The arithmetic of one (tile, chunk) and one (tile, candidate) is in
// env_cull.cuh; the outputs equal the plain version's integer for integer.
//
// Design: the work follows the chunks each tile meets, not tiles x cap.
//   1. coarse: one block a tile streams the chunk spheres, counts the met
//      ones (`cut` = met past Kc) and lists them; where more than Kc meet,
//      a radix select over (radial bits, chunk index) keeps the Kc nearest.
//   2. a block sort of each tile's list into (radial, chunk index) order:
//      a chunk's position there is its rank, the tie-break of the radial
//      sort below.
//   3. refine, one warp a kept (tile, chunk) pair, two candidates a lane:
//      a count of each tile's kept candidates (and its largest radial, for
//      the quantized keys), keeping the pair's 64 flags; then, after the
//      scan of the 64-aligned counts, each kept candidate's 64-bit key at
//      its tile's offset (an atomic cursor: the sort makes the order
//      canonical, every key being unique).
//   4. a sort of each tile's keys (ranked by counting up to 512, a block
//      radix sort in shared memory up to 4096, else a stable LSD radix
//      sort in global memory by the same block), decoded to pool indices
//      at the tile's slot range, truncated at the slot budget; the rest of
//      the list is the sentinel P.
// Two single-block scans give the pair offsets and the slot offsets. No
// host synchronisation: every buffer is sized on the host from T, Kc, NC
// and the slot budget. Seven launches and a memset a call.
//
// What bounds it on the card (chip_smoke.py's bound): each input byte read
// and each output byte written once, against the float operations the met
// pairs need. Bytes: the chunk table (NC x 2,321 B: the sphere, the eight
// candidate rows, the pool indices) and the slot list (4 B a slot of the
// budget). Operations: T x NC coarse tests at 35 each, the 64 sphere tests
// (26 each) of every met pair within Kc, and the probe (140) of every kept
// candidate, counted off env_cull.cuh (a square root or a division as one;
// the keys and the sorts left out). At envgs-train's shapes the bytes
// bound it (the 268 MB slot list of a 2^26 budget: 0.088 ms); the kernels
// take ~39x that in latency: seven dependent launches, the per-tile
// sorts, and the refine reading each met pair's 2.3 KB of rows from L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "env_cull.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;
constexpr int TILE_ITEMS = THREADS * ITEMS;  // a sort in shared memory
constexpr int RANK_ITEMS = 512;  // lists ranked by counting
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_DEVICES = 64;
constexpr uint64_t PAD_KEY = ~0ull;

struct Args {
  const float* cmean;   // (NC, 3)
  const float* crad;    // (NC,)
  const uint8_t* cact;  // (NC,)
  const float* cand;    // (NC, 8, 64)
  const int32_t* order; // (NC * 64,) pool index a candidate, P inactive
  const float* apex;    // (T, 3)
  const float* axis;    // (T, 3)
  const float* tan_half;
  const float* spread;
  const uint8_t* tmask;  // (T,)
  const float* pframe;   // (T, 2, 3)
  const float* pbox;     // (T, 4, 10)
  const uint8_t* pok;    // (T,), null: no probe
  int T, NC, Kc, Kcap, P;
  int idx_bits, rank_bits, cid_bits, quant;
  long long cap;  // slots of the output
  uint64_t* clist;  // (T * Kcap) each tile's kept chunks' keys
  uint64_t* calt;   // (T * Kcap) the sort's second buffer
  int32_t* nk;      // (T,) kept chunks
  int32_t* cnt;     // (T,) kept candidates
  int32_t* cursor;  // (T,)
  uint32_t* rmax;   // (T,) bits of the largest kept radial
  long long* po;    // (T + 1,) pair offsets
  long long* so;    // (T + 1,) 64-aligned slot offsets, before the budget
  uint64_t* keys;   // (NB,) candidate keys at the slot offsets
  uint64_t* alt;    // (NB,)
  int32_t* gauss;   // (cap,) filled with P before
  int32_t* bounds;  // (T + 1,)
  int32_t* dropped;
  int32_t* cut;
  long long* met;
};

__device__ __forceinline__ uint64_t hi_bits(uint64_t x, int s) {
  return s >= 64 ? 0ull : x >> s;
}

// ---- 1. coarse: one block a tile ----

__device__ __forceinline__ float chunk_radial(const Args& a, const ec::Cone& k,
                                              int c) {
  if (!a.cact[c]) return INFINITY;
  return ec::coarse(k, a.cmean[3 * c], a.cmean[3 * c + 1],
                    a.cmean[3 * c + 2], a.crad[c]);
}

__global__ void __launch_bounds__(THREADS) coarse_kernel(Args a) {
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  __shared__ int s_n;
  __shared__ int hist[256];
  __shared__ int s_sel, s_rem;
  uint64_t* list = a.clist + (long long)t * a.Kcap;
  if (!a.tmask[t]) {
    if (tid == 0) a.nk[t] = 0;
    return;
  }
  const ec::Cone k = ec::load_cone(a.apex, a.axis, a.tan_half, a.spread, t);
  if (tid == 0) s_n = 0;
  __syncthreads();
  // count the met chunks, listing them while they fit
  for (int c0 = 0; c0 < a.NC; c0 += THREADS) {
    const int c = c0 + tid;
    float r = INFINITY;
    if (c < a.NC) r = chunk_radial(a, k, c);
    const bool m = r < INFINITY;
    const unsigned vote = __ballot_sync(0xffffffffu, m);
    int base = 0;
    if (lane == 0 && vote) base = atomicAdd(&s_n, __popc(vote));
    base = __shfl_sync(0xffffffffu, base, 0);
    const int pos = base + __popc(vote & ((1u << lane) - 1u));
    if (m && pos < a.Kcap) list[pos] = ec::chunk_key(r, c, a.idx_bits);
  }
  __syncthreads();
  const int met = s_n;
  if (met > a.Kc) {
    // the Kc nearest: the Kc-th smallest (radial bits, chunk) key by a
    // radix select, 8 bits a pass from the top; keys are unique
    const int key_bits = 31 + a.idx_bits;
    uint64_t prefix = 0;
    if (tid == 0) s_rem = a.Kc;
    for (int shift = ((key_bits - 1) / 8) * 8; shift >= 0; shift -= 8) {
      hist[tid] = 0;
      __syncthreads();
      for (int c = tid; c < a.NC; c += THREADS) {
        const float r = chunk_radial(a, k, c);
        if (!(r < INFINITY)) continue;
        const uint64_t key = ec::chunk_key(r, c, a.idx_bits);
        if (hi_bits(key, shift + 8) == hi_bits(prefix, shift + 8))
          atomicAdd(&hist[(key >> shift) & 255], 1);
      }
      __syncthreads();
      if (tid == 0) {
        int acc = 0, rem = s_rem, sel = 255;
        for (int b = 0; b < 256; ++b) {
          if (acc + hist[b] >= rem) {
            sel = b;
            break;
          }
          acc += hist[b];
        }
        s_sel = sel;
        s_rem = rem - acc;
      }
      __syncthreads();
      prefix |= (uint64_t)s_sel << shift;
    }
    if (tid == 0) s_n = 0;
    __syncthreads();
    for (int c0 = 0; c0 < a.NC; c0 += THREADS) {
      const int c = c0 + tid;
      uint64_t key = PAD_KEY;
      if (c < a.NC) {
        const float r = chunk_radial(a, k, c);
        if (r < INFINITY) key = ec::chunk_key(r, c, a.idx_bits);
      }
      const bool m = key <= prefix;
      const unsigned vote = __ballot_sync(0xffffffffu, m);
      int base = 0;
      if (lane == 0 && vote) base = atomicAdd(&s_n, __popc(vote));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (m) list[base + __popc(vote & ((1u << lane) - 1u))] = key;
    }
  }
  if (tid == 0) {
    a.nk[t] = met < a.Kc ? met : a.Kc;
    if (met > a.Kc) atomicAdd(a.cut, met - a.Kc);
    atomicAdd((unsigned long long*)a.met, (unsigned long long)met);
  }
}

// ---- the scans: one block ----

// out[i] = sum of in[0..i) (each rounded up to a multiple of 64 with
// `align`), out[n] the total. With bounds: bounds[i] = min(out[i], cap) as
// int32 and *dropped = max(total - cap, 0).
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const int32_t* in, int n, int align, long long* out,
            int32_t* bounds, long long cap, int32_t* dropped) {
  using Scan = cub::BlockScan<long long, SCAN_THREADS>;
  __shared__ typename Scan::TempStorage tmp;
  long long carry = 0;
  for (int b = 0; b < n; b += SCAN_THREADS) {
    const int i = b + threadIdx.x;
    long long v = i < n ? in[i] : 0;
    if (align) v = (v + ec::CHUNK - 1) / ec::CHUNK * ec::CHUNK;
    long long ex, total;
    Scan(tmp).ExclusiveSum(v, ex, total);
    if (i < n) {
      out[i] = carry + ex;
      if (bounds) bounds[i] = (int32_t)(carry + ex < cap ? carry + ex : cap);
    }
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[n] = carry;
    if (bounds) {
      bounds[n] = (int32_t)(carry < cap ? carry : cap);
      *dropped = (int32_t)(carry > cap ? carry - cap : 0);
    }
  }
}

// ---- 3. refine: one warp a kept (tile, chunk) pair ----

// Each warp takes a contiguous run of the pairs, so that it looks its tile
// up once, then steps through the tiles and loads a tile's cone and probe
// when the tile changes. The count pass refines and leaves each pair's
// 64 keep flags in `calt` (free after the chunk sort: a word a pair); the
// write pass recomputes only the kept candidates' radials.
template <bool WRITE>
__global__ void __launch_bounds__(THREADS) refine_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WARPS;
  const long long total = a.po[a.T];
  const long long per = (total + n_warps - 1) / n_warps;
  const long long p0 = warp * per;
  const long long p1 = p0 + per < total ? p0 + per : total;
  if (p0 >= p1) return;
  int lo = 0, hi = a.T;  // the last t with po[t] <= p0
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a.po[mid] <= p0) lo = mid; else hi = mid;
  }
  int t = lo, loaded = -1;
  const uint64_t cmask = (1ull << a.idx_bits) - 1ull;
  ec::Cone k;
  ec::Probe probe;
  float rmax = 0.0f;
  for (long long p = p0; p < p1; ++p) {
    while (a.po[t + 1] <= p) ++t;
    if (WRITE && a.so[t] >= a.cap) continue;  // the whole tile past the budget
    if (t != loaded) {
      loaded = t;
      k = ec::load_cone(a.apex, a.axis, a.tan_half, a.spread, t);
      if (!WRITE && a.pok) probe = ec::load_probe(a.pframe, a.pbox, a.pok, t);
      if (WRITE && a.quant) rmax = __uint_as_float(a.rmax[t]);
    }
    const int rank = (int)(p - a.po[t]);
    const long long c = (long long)(a.clist[(long long)t * a.Kcap + rank]
                                    & cmask);
    const float* rows = a.cand + c * ec::CAND_ROWS * ec::CHUNK;
    if (!WRITE) {
      unsigned votes[2];
      uint32_t r_top = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = lane + 32 * h;
        float row[ec::CAND_ROWS];
#pragma unroll
        for (int i = 0; i < ec::CAND_ROWS; ++i) row[i] = rows[i * ec::CHUNK + l];
        float radial;
        const bool keep = ec::refine(k, a.pok ? &probe : nullptr, row,
                                     a.order[c * ec::CHUNK + l], a.P, &radial);
        votes[h] = __ballot_sync(0xffffffffu, keep);
        if (keep) r_top = max(r_top, ec::fbits(radial));
      }
      const int n_kept = __popc(votes[0]) + __popc(votes[1]);
      if (lane == 0) {
        a.calt[p] = ((uint64_t)votes[1] << 32) | votes[0];
        if (n_kept) atomicAdd(&a.cnt[t], n_kept);
      }
      if (a.quant && n_kept) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          r_top = max(r_top, __shfl_xor_sync(0xffffffffu, r_top, o));
        if (lane == 0) atomicMax(&a.rmax[t], r_top);
      }
      continue;
    }
    const uint64_t kept = a.calt[p];
    if (kept == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(&a.cursor[t], __popcll(kept));
    base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = lane + 32 * h;
      if (!((kept >> l) & 1ull)) continue;
      const float m[3] = {rows[l], rows[ec::CHUNK + l], rows[2 * ec::CHUNK + l]};
      const float radial = sqrtf(ec::dist2(k, m));
      const int cid = a.order[c * ec::CHUNK + l];
      const uint64_t key = a.quant
          ? ec::quant_key(radial, rmax, cid, a.cid_bits)
          : ec::float_key(radial, rank, l, a.rank_bits);
      a.keys[a.so[t] + base + __popcll(kept & ((1ull << l) - 1ull))] = key;
    }
  }
}

// ---- 2. and 4. the per-tile sorts: one block a tile ----

using BlockSort = cub::BlockRadixSort<unsigned long long, THREADS, ITEMS>;
using BinScan = cub::BlockScan<int, THREADS>;

struct SortSmem {
  union {
    typename BlockSort::TempStorage sort;
    typename BinScan::TempStorage scan;
  } u;
  int hist[256];
  int off[256];
  int first[256];
  int last_digit[THREADS];
};

// What a sorted key becomes: a chunk list keeps its keys in place; a
// candidate's key becomes its pool index at the tile's slot offset, where
// that lies within the budget.
template <bool CAND>
__device__ __forceinline__ void emit(const Args& a, int t, long long base,
                                     long long p, uint64_t key) {
  if (!CAND) {
    a.clist[base + p] = key;
    return;
  }
  const long long s = base + p;
  if (s >= a.cap) return;
  int cid;
  if (a.quant) {
    cid = (int)(key & ((1ull << a.cid_bits) - 1ull));
  } else {
    const int lane = (int)(key & 63ull);
    const int rank = (int)((key >> 6) & ((1ull << a.rank_bits) - 1ull));
    const int c = (int)(a.clist[(long long)t * a.Kcap + rank]
                        & ((1ull << a.idx_bits) - 1ull));
    cid = a.order[(long long)c * ec::CHUNK + lane];
  }
  a.gauss[s] = cid;
}

template <bool CAND>
__global__ void __launch_bounds__(THREADS) sort_kernel(Args a, int end_bit) {
  __shared__ SortSmem sm;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  long long base;
  int n;
  uint64_t *src, *dst;
  if (CAND) {
    base = a.so[t];
    n = a.cnt[t];
    if (base >= a.cap) return;
    src = a.keys + base;
    dst = a.alt + base;
  } else {
    base = (long long)t * a.Kcap;
    n = a.nk[t];
    src = a.clist + base;
    dst = a.calt + base;
  }
  if (n == 0) return;
  if (n <= RANK_ITEMS) {
    // a key's place is the count of smaller keys (all unique)
    uint64_t* s = reinterpret_cast<uint64_t*>(&sm.u);
    for (int i = tid; i < n; i += THREADS) s[i] = src[i];
    __syncthreads();
    for (int i = tid; i < n; i += THREADS) {
      const uint64_t key = s[i];
      int r = 0;
      for (int j = 0; j < n; ++j) r += s[j] < key;
      emit<CAND>(a, t, base, r, key);
    }
    return;
  }
  unsigned long long k[ITEMS];
  if (n <= TILE_ITEMS) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = tid * ITEMS + j;
      k[j] = i < n ? src[i] : PAD_KEY;
    }
    BlockSort(sm.u.sort).Sort(k, 0, end_bit);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = tid * ITEMS + j;
      if (i < n) emit<CAND>(a, t, base, i, k[j]);
    }
    return;
  }
  // a stable LSD radix sort, 8 bits a pass, between src and dst: each pass
  // a histogram of the whole list and its scan, then tiles of TILE_ITEMS
  // keys sorted by the digit in shared memory (stable) and scattered to
  // their digit's next places
  for (int shift = 0; shift < end_bit; shift += 8) {
    const int hi = shift + 8 < 64 ? shift + 8 : 64;
    sm.hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += THREADS)
      atomicAdd(&sm.hist[(src[i] >> shift) & 255], 1);
    __syncthreads();
    int ex;
    BinScan(sm.u.scan).ExclusiveSum(sm.hist[tid], ex);
    sm.off[tid] = ex;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += TILE_ITEMS) {
      const int m = n - i0 < TILE_ITEMS ? n - i0 : TILE_ITEMS;
      sm.hist[tid] = 0;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int i = tid * ITEMS + j;
        k[j] = i < m ? src[i0 + i] : PAD_KEY;
        if (i < m) atomicAdd(&sm.hist[(k[j] >> shift) & 255], 1);
      }
      BlockSort(sm.u.sort).Sort(k, shift, hi);
      sm.last_digit[tid] = (int)((k[ITEMS - 1] >> shift) & 255);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int i = tid * ITEMS + j;
        const int d = (int)((k[j] >> shift) & 255);
        const int prev = j > 0 ? (int)((k[j - 1] >> shift) & 255)
                               : (tid > 0 ? sm.last_digit[tid - 1] : -1);
        if (i < m && d != prev) sm.first[d] = i;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int i = tid * ITEMS + j;
        if (i < m) {
          const int d = (int)((k[j] >> shift) & 255);
          dst[sm.off[d] + i - sm.first[d]] = k[j];
        }
      }
      __syncthreads();
      sm.off[tid] += sm.hist[tid];
      __syncthreads();
    }
    uint64_t* s = src;
    src = dst;
    dst = s;
    __syncthreads();
  }
  for (int i = tid; i < n; i += THREADS) {
    if (CAND || src != a.clist + base) emit<CAND>(a, t, base, i, src[i]);
  }
}

int refine_grid(const void* fn, int* full) {
  int dev = 0;
  cudaGetDevice(&dev);
  int most = dev < MAX_DEVICES ? full[dev] : 0;
  if (most == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
    most = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (dev < MAX_DEVICES) full[dev] = most;
  }
  return most;
}

int count_full[MAX_DEVICES], write_full[MAX_DEVICES];

int bit_length(long long x) {
  int b = 0;
  while (x > 0) {
    ++b;
    x >>= 1;
  }
  return b;
}

}  // namespace

// The whole cull on `stream`. The caller allocates: clist, calt (T * Kcap
// int64 each, Kcap = min(Kc, NC) or 1), ints (4T int32: nk, cnt, cursor,
// rmax), offs (2 (T + 1) int64: po, so), keys, alt (cap + Kc * 64 int64
// each), gauss (cap int32, filled with P), bounds (T + 1 int32), small (2
// int32: dropped, cut) and met (1 int64), those two zeroed. Returns a
// cudaError_t.
extern "C" int env_cull(
    const float* cmean, const float* crad, const uint8_t* cact,
    const float* cand, const int32_t* order, const float* apex,
    const float* axis, const float* tan_half, const float* spread,
    const uint8_t* tmask, const float* pframe, const float* pbox,
    const uint8_t* pok, int T, int NC, int Kc, int P, int cap, void* clist,
    void* calt, int32_t* ints, long long* offs, void* keys, void* alt,
    int32_t* gauss, int32_t* bounds, int32_t* small, long long* met,
    void* stream_ptr) {
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  Args a;
  a.cmean = cmean;
  a.crad = crad;
  a.cact = cact;
  a.cand = cand;
  a.order = order;
  a.apex = apex;
  a.axis = axis;
  a.tan_half = tan_half;
  a.spread = spread;
  a.tmask = tmask;
  a.pframe = pframe;
  a.pbox = pbox;
  a.pok = pok;
  a.T = T;
  a.NC = NC;
  a.Kc = Kc;
  a.Kcap = Kc < NC ? Kc : NC;
  if (a.Kcap < 1) a.Kcap = 1;
  a.P = P;
  a.idx_bits = bit_length(NC > 1 ? NC - 1 : 1);
  a.rank_bits = bit_length(a.Kcap > 1 ? a.Kcap - 1 : 1);
  a.cid_bits = bit_length(P);
  a.quant = 32 - a.cid_bits >= 14;
  a.cap = cap;
  a.clist = (uint64_t*)clist;
  a.calt = (uint64_t*)calt;
  a.nk = ints;
  a.cnt = ints + T;
  a.cursor = ints + 2 * T;
  a.rmax = (uint32_t*)(ints + 3 * T);
  a.po = offs;
  a.so = offs + T + 1;
  a.keys = (uint64_t*)keys;
  a.alt = (uint64_t*)alt;
  a.gauss = gauss;
  a.bounds = bounds;
  a.dropped = small;
  a.cut = small + 1;
  a.met = met;
  if (T <= 0) return 0;
  cudaMemsetAsync(ints + T, 0, sizeof(int32_t) * 3 * T, stream);
  coarse_kernel<<<T, THREADS, 0, stream>>>(a);
  scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(a.nk, T, 0, a.po, nullptr, 0,
                                              nullptr);
  sort_kernel<false><<<T, THREADS, 0, stream>>>(a, 31 + a.idx_bits);
  refine_kernel<false>
      <<<refine_grid((const void*)refine_kernel<false>, count_full), THREADS,
         0, stream>>>(a);
  scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(a.cnt, T, 1, a.so, bounds, cap,
                                              a.dropped);
  refine_kernel<true>
      <<<refine_grid((const void*)refine_kernel<true>, write_full), THREADS,
         0, stream>>>(a);
  sort_kernel<true><<<T, THREADS, 0, stream>>>(
      a, a.quant ? 32 : 31 + a.rank_bits + 6);
  return (int)cudaGetLastError();
}

// What the kernels were compiled to: out[5 kernels][4] = registers, static
// shared bytes, resident blocks per SM, local bytes: coarse, refine
// (count), refine (write), sort (chunks), sort (candidates).
extern "C" int env_cull_resources(int* out) {
  const void* fns[5] = {(const void*)coarse_kernel,
                        (const void*)refine_kernel<false>,
                        (const void*)refine_kernel<true>,
                        (const void*)sort_kernel<false>,
                        (const void*)sort_kernel<true>};
  for (int i = 0; i < 5; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fns[i]);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[i],
                                                        THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    out[4 * i] = attr.numRegs;
    out[4 * i + 1] = (int)attr.sharedSizeBytes;
    out[4 * i + 2] = blocks;
    out[4 * i + 3] = (int)attr.localSizeBytes;
  }
  return 0;
}
