// Kernel K3: per-tile front-to-back blend of 2DGS surfels along rays.
//
// Replaces: envgs_tpu/ops/tracer.py::_fwd_kernel (Pallas, TPU) in four
// configurations, a compile-time CFG:
// - render (need_geo, need_dist and need_wet off; 5 planes: rgb, acc, T);
// - geometry (need_geo on, need_dist and need_wet off, what a traced base
//   pass renders with; 10 + A planes: rgb, depth*w, acc, ray-facing normal,
//   distortion (zeros, as the JAX kernel leaves its rows), aux (A <= 2), T);
// - training (need_geo and need_dist on; 13 + A planes in the JAX row
//   order: rgb, depth*w, acc, ray-facing normal, distortion, aux, T, D1,
//   D2, last contributing rank); the per-slot wet is then delivered by the
//   backward kernel K4 (the wet_zero hook);
// - training with the forward wet (need_wet on as well, what multi-bounce
//   tracing asks for): the training planes and each slot's wet, its w
//   summed over the tile's 256 rays; the per-splat sum stays outside
//   (index_add_, as the JAX package's segment_sum outside Pallas).
// It also absorbs the per-slot row gather of
// tracer.py::_gather_blend_trace: rows are read straight from the per-splat
// scene table, no (slots, 128) array is built.
//
// What bounds it on the card: instruction issue on candidates that cannot
// contribute, not bytes. The cull hands a tile every splat near any of its
// 256 rays; reflected rays scatter, so on the train bench scene (an H100,
// 6370 tiles, 2.78M candidate slots) a ray takes 0.4 of its tile's 436
// candidates on average, no ray saturates, and of 7.1e8 (slot, ray) pairs
// 6.2e5 contribute. The first design of this kernel paid the exact terms
// (an IEEE division, an expf, some 60 instructions) for every pair: two
// thirds of its time. One 128-byte table row per slot is read once per
// tile.
//
// Design: one block per 16x16 ray tile, one thread per ray, a warp an 8x4
// patch of the tile; the ray's origin and direction sit in registers. The
// configuration and its number of aux channels are template parameters, so
// the render kernel carries none of the training accumulators and the
// geometry kernel none of the distortion's. The block
// walks the tile's 64-aligned slot range from cull_and_sort in the JAX
// kernel's 64-slot chunks; each chunk's table rows are staged in shared
// memory by 16-byte cp.async copies, two chunks deep (the next chunk is in
// flight while this one is blended), with one barrier a chunk, and every
// thread reads each row as a broadcast.
// Ahead of the exact terms stands a bounding test (reach2, in_reach): a
// ray whose line passes a splat's centre farther off than the radius at
// which its alpha falls under 1/255, with margins for float32 rounding,
// cannot pass the exact test, and the test costs a dozen fused
// multiply-adds without division or expf. Each warp works out the reach of
// the chunk's 64 slots once (two per lane, kept in its own strip of shared
// memory), then tests 16 slots at a time, the 16 tests independent of each
// other so that their latencies overlap, and votes; only a slot within
// reach of some ray of the warp pays the exact terms (4% of the (slot,
// warp) combinations on the train bench scene, 40% on the denser render
// bench scene, where the test still gains). The contribution rule is the
// JAX kernel's exactly: a candidate contributes iff its alpha passes the
// 1/255 floor, t > 1e-4 and |d.n| >= 1e-9, and T*(1-a) >= 1e-4; within a
// chunk, the first candidate that fails the transmittance test ends the
// chunk for that ray. A ray can take nothing more once T*(1 - 1/255) <
// 1e-4 (every candidate's alpha is at least 1/255, and float32 products
// are monotone, so its test fails). A warp all of whose rays have failed in
// this chunk or can take nothing more skips the rest of the chunk's slots;
// one whose rays can all take nothing more skips the remaining chunks and
// only keeps the block's barriers; the block stops once that holds for all
// its rays (__syncthreads_or, which is also the chunk's barrier). No
// skipped slot could have contributed, so the result is the full walk's to
// the bit. The training outputs are running sums in registers (distortion
// with m = t / (1 + |t|) from the running acc and moments before each
// candidate). Built with -fmad=false so each operation of the exact terms
// rounds as the plain PyTorch version's does. 64 registers with
// __launch_bounds__(256, 4); three or five blocks an SM are slower.
// The wet of a slot is summed within each warp by a shuffle tree, only
// where a ray of the warp takes the slot, into a (8 warps, 64 slots)
// shared block (zeros for the slots a warp skips), and the 8 partial sums
// are added in warp order after the chunk, so it does not vary from run to
// run; the plain version sums in the same tree (`_ray_sum`) and the two
// agree to the bit. The block's barriers carry it: a warp whose rays can
// take nothing more still zeroes its partial sums each chunk, and the
// chunk's sums are written after the next chunk's barrier (double
// buffered), the last walked chunk's after one more. Chunks past the
// block's exit keep the zeros the wrapper fills in.
// What is left: the bounding test itself, 22M (slot, warp) combinations of
// some 25 instructions, is three quarters of the training launch.
#include "trace_blend.cuh"

namespace {

// the configurations: the planes each writes (see the top of the file)
constexpr int CFG_RENDER = 0, CFG_GEO = 1, CFG_TRAIN = 2, CFG_WET = 3;
// resident blocks per SM asked of the compiler
constexpr int MIN_BLOCKS = 4;
constexpr int GROUP = 16;  // slots whose reach is tested together

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

template <int CFG, int A>
__global__ void __launch_bounds__(NRAY, MIN_BLOCKS)
trace_blend_fwd_kernel(const float* __restrict__ packed, int n_rows,
                       const int32_t* __restrict__ gauss_idx, int n_idx,
                       const float* __restrict__ rays,
                       const int32_t* __restrict__ bounds, int tiles_x,
                       int tiles_y, float* __restrict__ out,
                       float* __restrict__ wet) {
  constexpr bool GEO = CFG >= CFG_GEO;  // depth, normal, aux
  constexpr bool DIST = CFG >= CFG_TRAIN;  // distortion, D1, D2, last
  constexpr bool WET = CFG == CFG_WET;
  __shared__ __align__(16) float rows[2][CHUNK][LO];
  __shared__ float reach[NWARP][CHUNK];  // each warp's own copy, no barrier
  __shared__ float wpart[WET ? 2 : 1][WET ? NWARP : 1][WET ? CHUNK : 1];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // ray of this thread inside the tile: warp w is the 8x4 patch at
  // (w % 2, w / 2), lane l its ray (l % 8, l / 8)
  const int ix = (warp % (TILE / WARP_W)) * WARP_W + lane % WARP_W;
  const int iy = (warp / (TILE / WARP_W)) * WARP_H + lane / WARP_W;
  const float* ray = rays + (size_t)t * 8 * NRAY + iy * TILE + ix;
  const float ox = ray[0], oy = ray[NRAY], oz = ray[2 * NRAY];
  const float dx = ray[3 * NRAY], dy = ray[4 * NRAY], dz = ray[5 * NRAY];
  const float dd = dx * dx + dy * dy + dz * dz;
  const float dd_s = dd * (1.f - POS_SLACK);
  const int start = bounds[t], end = bounds[t + 1];
  const int nchunk = (end - start) / CHUNK;

  // Staging: thread `tid` copies vectors tid and tid + 256 of a chunk's 512
  // (row e / 8, vector e % 8). A slot outside the tile's range or the index
  // array, or naming a row outside the table, reads as the zero row.
  int g_next[2];
  auto load_idx = [&](int ch) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = start + ch * CHUNK + (tid + h * NRAY) / VPR;
      int g = -1;
      if (i < end && i < n_idx) {
        g = gauss_idx[i];
        if (g < 0 || g >= n_rows) g = -1;
      }
      g_next[h] = g;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = tid + h * NRAY;
      const int r = e / VPR, v = e % VPR;
      const int g = g_next[h];
      float* dst = &rows[buf][r][v * 4];
      if (g >= 0)
        cp_async16(dst, packed + (size_t)g * LO + v * 4);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the wet of chunk `ch` from its buffer: the 8 warps' sums in order
  auto flush = [&](int ch) {
    if (tid < CHUNK) {
      const int i = start + ch * CHUNK + tid;
      if (i < end && i < n_idx) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < NWARP; ++k) sum += wpart[ch & 1][k][tid];
        wet[i] = sum;
      }
    }
  };
  if (nchunk > 0) {
    load_idx(0);
    stage(0);
    if (nchunk > 1) load_idx(1);
  }

  float r0 = 0.f, r1 = 0.f, r2 = 0.f, acc = 0.f, T = 1.f;
  float dpt = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f, dist = 0.f, d1 = 0.f,
        d2 = 0.f, last = -1.f;
  float aux[MAXA] = {0.f, 0.f};
  bool dead = false;  // T * (1 - 1/255) < 1e-4: the ray can take nothing more
  int walked = nchunk;
  for (int ch = 0; ch < nchunk; ++ch) {
    const int buf = ch & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // the barrier: this chunk's rows (and, with WET, the chunk before's
    // partial wet) are in and every thread is done with the other buffer;
    // and the block's exit, once no ray can take more
    const bool alive = __syncthreads_or(!dead);
    if (WET && ch > 0) flush(ch - 1);
    if (!alive) {
      walked = ch;
      break;
    }
    if (ch + 1 < nchunk) {
      stage(buf ^ 1);
      if (ch + 2 < nchunk) load_idx(ch + 2);
    }
    float* wp = wpart[WET ? buf : 0][WET ? warp : 0];
    if (WET) {  // the slots this warp skips add zeros
      wp[lane] = 0.f;
      wp[lane + 32] = 0.f;
      __syncwarp();
    }
    if (__all_sync(FULL, dead)) continue;  // this warp only keeps the barriers
    __syncwarp();  // the warp is done with the chunk before's reach
    reach[warp][lane] = reach2(rows[buf][lane]);
    reach[warp][lane + 32] = reach2(rows[buf][lane + 32]);
    __syncwarp();
    bool fail = false;
    for (int j0 = 0; j0 < CHUNK; j0 += GROUP) {
      // no ray of the warp can take a candidate of this chunk any more
      if (__all_sync(FULL, fail || dead)) break;
      // the slots of this group within reach of a ray that can still take
      // one; the 16 tests are independent and overlap
      unsigned hit = 0;
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const float4 c = *reinterpret_cast<const float4*>(rows[buf][j0 + k]);
        const bool may = in_reach(c.x - ox, c.y - oy, c.z - oz, dx, dy, dz,
                                  dd, dd_s, reach[warp][j0 + k])
                         && !(fail || dead);
        if (__any_sync(FULL, may)) hit |= 1u << k;
      }
      for (; hit; hit &= hit - 1) {  // in slot order
        const int j = j0 + __ffs(hit) - 1;
        const float* d = rows[buf][j];
        const float4 q0 = *reinterpret_cast<const float4*>(d);
        const float4 q1 = *reinterpret_cast<const float4*>(d + 4);
        const float4 q2 = *reinterpret_cast<const float4*>(d + 8);
        const float4 q3 = *reinterpret_cast<const float4*>(d + 12);
        const float cx = q0.x, cy = q0.y, cz = q0.z;
        const float nx = q2.y, ny = q2.z, nz = q2.w;
        const float dn = dx * nx + dy * ny + dz * nz;
        const float dn_s = fabsf(dn) < 1e-9f ? 1e-9f : dn;
        const float num = (cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz;
        const float tt = num / dn_s;
        const float ex = ox + tt * dx - cx;
        const float ey = oy + tt * dy - cy;
        const float ez = oz + tt * dz - cz;
        const float u = ex * q0.w + ey * q1.x + ez * q1.y;
        const float v = ex * q1.z + ey * q1.w + ez * q2.x;
        const float rho = u * u + v * v;
        const float a = fminf(q3.x * expf(-0.5f * rho), ALPHA_MAX);
        const bool amask = a >= ALPHA_MIN && tt > T_MIN && fabsf(dn) >= 1e-9f;
        if (WET) {  // the whole warp is here: `hit` is the warp's
          const bool pass = amask && !fail && T * (1.f - a) >= T_CUTOFF;
          if (__any_sync(FULL, pass)) {
            const float sum = warp_sum(pass ? a * T : 0.f);
            if (lane == 0) wp[j] = sum;
          }
        }
        if (!amask || fail) continue;
        const float test = T * (1.f - a);
        if (!(test >= T_CUTOFF)) {
          fail = true;
          continue;
        }
        const float w = a * T;
        if (DIST) {
          const float m = tt / (1.f + fabsf(tt));
          const float wm = w * m;
          dist += w * (m * m * acc + d2 - 2.f * m * d1);
          d1 += wm;
          d2 += wm * m;
          last = (float)(ch * CHUNK + j);
        }
        if (GEO) {
          const float flip = dn > 0.f ? -1.f : 1.f;
          n0 += w * (nx * flip);
          n1 += w * (ny * flip);
          n2 += w * (nz * flip);
#pragma unroll
          for (int i = 0; i < A; ++i) aux[i] += w * d[C_AUX + i];
          dpt += w * tt;
        }
        r0 += w * q3.y;
        r1 += w * q3.z;
        r2 += w * q3.w;
        acc += w;
        T = test;
        dead = !(T * (1.f - ALPHA_MIN) >= T_CUTOFF);
      }
    }
  }
  if (WET && walked == nchunk && nchunk > 0) {  // the last chunk walked
    __syncthreads();
    flush(nchunk - 1);
  }

  const int tx = t % tiles_x, ty = t / tiles_x;
  const int out_w = tiles_x * TILE;
  const size_t plane = (size_t)tiles_y * TILE * out_w;
  float* o = out + (size_t)(ty * TILE + iy) * out_w + tx * TILE + ix;
  o[0] = r0;
  o[plane] = r1;
  o[2 * plane] = r2;
  if (GEO) {  // JAX rows: rgb, dpt, acc, normal, dist, aux, T, D1, D2, last
    o[3 * plane] = dpt;
    o[4 * plane] = acc;
    o[5 * plane] = n0;
    o[6 * plane] = n1;
    o[7 * plane] = n2;
    o[8 * plane] = dist;
#pragma unroll
    for (int i = 0; i < A; ++i) o[(9 + i) * plane] = aux[i];
    o[(9 + A) * plane] = T;
    if (DIST) {
      o[(10 + A) * plane] = d1;
      o[(11 + A) * plane] = d2;
      o[(12 + A) * plane] = last;
    }
  } else {
    o[3 * plane] = acc;
    o[4 * plane] = T;
  }
}

template <int CFG, int A>
struct Launch {
  static int run(const float* packed, int n_rows, const int32_t* gauss_idx,
                 int n_idx, const float* rays, const int32_t* bounds,
                 int tiles_x, int tiles_y, float* out, float* wet,
                 cudaStream_t stream) {
    trace_blend_fwd_kernel<CFG, A><<<tiles_x * tiles_y, NRAY, 0, stream>>>(
        packed, n_rows, gauss_idx, n_idx, rays, bounds, tiles_x, tiles_y,
        out, wet);
    return (int)cudaGetLastError();
  }
};

template <int CFG, int A>
struct Resources {
  static int run(int* out) {
    cudaFuncAttributes attr;
    cudaError_t err =
        cudaFuncGetAttributes(&attr, trace_blend_fwd_kernel<CFG, A>);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, trace_blend_fwd_kernel<CFG, A>, NRAY, 0);
    out[0] = attr.numRegs;
    out[1] = (int)attr.sharedSizeBytes;
    out[2] = blocks;
    out[3] = (int)attr.localSizeBytes;
    return (int)err;
  }
};

// Calls F<CFG, A>::run(args...) for the run-time configuration: mode 0
// render (A not read), 1 geometry, 2 training, with `wet` the training
// configuration with the forward wet; cudaErrorInvalidValue for A outside
// 0..2 or the wet outside training.
template <template <int, int> class F, int CFG, typename... Args>
int with_aux(int A, Args... args) {
  return A == 0 ? F<CFG, 0>::run(args...) : A == 1 ? F<CFG, 1>::run(args...)
         : A == 2 ? F<CFG, 2>::run(args...) : (int)cudaErrorInvalidValue;
}

template <template <int, int> class F, typename... Args>
int dispatch(int mode, int A, bool wet, Args... args) {
  if (wet && mode != 2) return (int)cudaErrorInvalidValue;
  if (mode == 0) return F<CFG_RENDER, 0>::run(args...);
  if (mode == 1) return with_aux<F, CFG_GEO>(A, args...);
  if (mode != 2) return (int)cudaErrorInvalidValue;
  return wet ? with_aux<F, CFG_WET>(A, args...)
             : with_aux<F, CFG_TRAIN>(A, args...);
}

}  // namespace

// Launches K3 on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an unknown mode, A outside 0..2, or the wet
// outside training. mode 0 (render; A is not read): out (5, tiles_y*16,
// tiles_x*16) f32 = rgb, acc, T; mode 1 (geometry): (10 + A, ...); mode 2
// (training): (13 + A, ...); every element written. wet: null, or in
// training (n_idx,) f32, zero-filled by the caller, each walked slot's wet
// written.
extern "C" int trace_blend_fwd(const float* packed, int n_rows,
                               const int32_t* gauss_idx, int n_idx,
                               const float* rays, const int32_t* bounds,
                               int tiles_x, int tiles_y, int mode, int A,
                               float* out, float* wet, void* stream) {
  return dispatch<Launch>(mode, A, wet != nullptr, packed, n_rows, gauss_idx,
                          n_idx, rays, bounds, tiles_x, tiles_y, out, wet,
                          (cudaStream_t)stream);
}

// K3's resources as compiled for (mode, A, wet), as trace_blend_fwd takes
// them: out[0] registers per thread, out[1] static shared bytes per block,
// out[2] resident blocks per SM, out[3] local (spill) bytes per thread.
// Launches nothing; returns a CUDA error code (0 = ok).
extern "C" int trace_blend_fwd_resources(int mode, int A, int wet, int* out) {
  return dispatch<Resources>(mode, A, wet != 0, out);
}
