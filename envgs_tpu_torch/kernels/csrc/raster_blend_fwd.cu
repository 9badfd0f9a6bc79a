// Kernel K1: per-tile front-to-back blend of 2DGS surfels or 3DGS
// Gaussians.
//
// Replaces: envgs_tpu/ops/raster_pallas.py::_fwd_kernel (Pallas, TPU) in
// both of its geometries, a compile-time MODE here: surfel (2DGS ray-plane
// intersection) and gauss3d (3DGS EWA conic: rho = a dx^2 + c dy^2 +
// 2 b dx dy from the table's columns 0-2, the splat's view depth in column
// 3). The JAX kernel's static switches, compile-time here: DIST (its
// need_dist: the map-depth moments, the distortion, D1, D2 and `last`, the
// rank of the last contributing pair), MED (need_med: the median depth),
// WET (need_wet: each pair's wet, its w summed over the tile's pixels; the
// per-splat sum stays outside, index_add_, as the JAX package's
// segment_sum outside Pallas) and ALIGNED (the pair layout: each tile's
// range whole 64-pair windows from a multiple of 64, the training layout;
// else raw ranges, each window from start - start % 8 with the pairs
// outside [start, end) masked). WET needs ALIGNED, as in JAX. Planes: with
// DIST or MED, C + 11 in the JAX row order (colors, depth*w, alpha,
// normal, median depth, distortion, T, D1, D2, last), the planes a switch
// strips as the JAX kernel leaves them (zero; `last` -1); with neither,
// C + 6 (colors, depth*w, alpha, normal, T). A switch only strips work:
// the planes a configuration writes are the all-on configuration's to the
// bit. The surfel mode is compiled in each legal configuration (4 on the
// unaligned layout, 8 on the aligned one), the gauss3d mode all on (the
// only configuration the 3DGS families call). It also
// absorbs the per-pair row gather of raster_pallas.py::gather_blend_tiles:
// rows are read straight from the per-splat table, no (pairs, 128) array is
// built.
//
// What bounds it on the card: instruction issue on pairs that cannot
// contribute. The exact terms of a (pair, pixel) are a ray-plane
// intersection through the 3x3 screen transform (two IEEE divisions) or a
// conic quadratic, an expf and the tests, some 60 (30) instructions. The
// binning culls pairs per 16-pixel tile row, so inside a tile most splats
// reach a few of its pixels: the first design of this kernel evaluated
// every (pair, pixel) of every window it walked and reached 5-11% of the
// bound of the pairs up to each pixel's last contributor. The bytes are
// small next to that: one 128-byte table row per pair, read once per tile.
//
// Design: one block per 16x16 tile, one thread per pixel, a warp an 8x4
// patch of the tile (16x2 with WET, see below). The block walks the tile's
// pair range in the JAX kernel's 64-pair windows (starting at start -
// start % 8); each window's table rows are staged in shared memory by
// 16-byte cp.async copies, three windows deep (the next two windows are in
// flight while this one is blended, their splat indices loaded one window
// earlier still: the training and 3DGS tables outgrow L2), with one
// barrier a window, and every thread reads each row as a broadcast. Ahead
// of the exact terms, each lane tests two of the window's pairs against its
// warp's patch (may_reach: a conservative bound of the alpha floor's
// footprint, a logf of the opacity and some 60 multiplies and adds, no
// expf; it refuses no pixel the exact test admits, with margins for
// float32 rounding) and the warp votes, so a warp evaluates only the pairs
// whose footprint may reach its patch, in pair order: 39-42% of the (pair,
// warp) combinations on the bench scenes, where the first design evaluated
// all. A warp also stops a window once each of its pixels has failed in
// it or can take nothing more, and skips the remaining windows once all
// its pixels can take nothing more
// (T*(1 - 1/255) < 1e-4: every pair's alpha is at least 1/255 and float32
// products are monotone, so the test fails); it then only keeps the
// block's barriers, and the block stops once that holds for all its pixels
// (__syncthreads_or, which is also the window's barrier). No skipped pair
// could have contributed to any plane, so the result is the full walk's to
// the bit. The contribution rule is the JAX kernel's exactly: a pair
// contributes iff its alpha passes the 1/255 floor and the near plane and
// T*(1-a) >= 1e-4; within a window, the first pair that fails the
// transmittance test ends the window for that pixel. DIST's outputs are
// running sums in registers beside the render ones (distortion from the
// running alpha and moments before each pair, as the JAX kernel's
// exclusive prefix sums give them); MED's is the depth of the last
// contributor taken at T > 0.5, which the sequential walk keeps without
// the rank the JAX kernel's closed form selects by.
// The wet of a pair is summed within each warp by a shuffle tree, only
// where a pixel of the warp takes the pair, into a (8 warps, 64 pairs)
// shared block, and the 8 partial sums are added in a fixed order after the
// window, so it does not vary from run to run. Its warps are 16x2 strips:
// the plain version sums each strip by the same halving tree and the strips
// one after another, and the two agree to the bit; pairs past the early
// stop keep the zeros the wrapper fills in. Built with -fmad=false so each
// operation of the exact terms rounds as the plain PyTorch version's does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int CHUNK = 64;
constexpr int LO = 32;  // packed row width
constexpr int LOS = 36;  // row stride in shared memory: a lane per row reads
                         // the rows' columns without bank conflicts
constexpr int VPR = LO / 4;  // 16-byte vectors per row
constexpr int MAXC = 7;
constexpr int NWARP = NPIX / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SURFEL = 0, GAUSS3D = 1;  // geometry modes
// resident blocks per SM asked of the compiler
constexpr int MIN_BLOCKS_RENDER = 4, MIN_BLOCKS_TRAIN = 4;
// packed columns (ops/raster_blend.py)
constexpr int C_CX = 9, C_CY = 10, C_OPAC = 11, C_NRM = 12, C_COLOR = 15;
// the JAX package's constants, rounded to float32 as JAX rounds them
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_CUTOFF = (float)1e-4;
constexpr float NEAR_PLANE = (float)0.2;
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float FAR_PLANE = (float)100.0;
constexpr float FAR_M_NEAR = (float)(100.0 - 0.2);
constexpr int NSTAGE = 3;  // windows staged ahead: the one in use + 2
// margins of the footprint test: the level's relative and absolute slack
// (they also cover the rounding of the centre's offsets), the relative
// rounding allowance of q = k x l (the probe's FOOT_* model;
// tests/test_torch_raster_fwd_design.py)
constexpr float FOOT_RHO_MARGIN = 1.01f, FOOT_RHO_SLACK = 0.01f;
constexpr float FOOT_EPS = 3.814697265625e-06f;  // 2^-18

__device__ __forceinline__ float map_depth(float z) {
  const float zc = fmaxf(z, 1e-6f);
  return (FAR_PLANE * (zc - NEAR_PLANE)) / (FAR_M_NEAR * zc);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

// The JAX kernel's _splat_pixel_terms: alpha (clamped) and depth of the
// splat in table row d at pixel (px, py); false where amask fails.
template <int MODE>
__device__ __forceinline__ bool pixel_terms(const float* d, float px, float py,
                                            float& a, float& z) {
  const float4 q0 = *reinterpret_cast<const float4*>(d);
  const float4 q1 = *reinterpret_cast<const float4*>(d + 4);
  const float4 q2 = *reinterpret_cast<const float4*>(d + 8);
  const float dx = q2.y - px;  // C_CX
  const float dy = q2.z - py;  // C_CY
  if (MODE == GAUSS3D) {
    const float rho = q0.x * dx * dx + q0.z * dy * dy + 2.f * q0.y * dx * dy;
    a = fminf(q2.w * expf(-0.5f * fmaxf(rho, 0.f)), ALPHA_MAX);
    z = q0.w;
    return a >= ALPHA_MIN && rho >= 0.f && z >= NEAR_PLANE;
  }
  const float kx = q0.x - px * q1.z;
  const float ky = q0.y - px * q1.w;
  const float kz = q0.z - px * q2.x;
  const float lx = q0.w - py * q1.z;
  const float ly = q1.x - py * q1.w;
  const float lz = q1.y - py * q2.x;
  const float qx = ky * lz - kz * ly;
  const float qy = kz * lx - kx * lz;
  float qz = kx * ly - ky * lx;
  if (fabsf(qz) < 1e-12f) qz = 1e-12f;
  const float u = qx / qz;
  const float v = qy / qz;
  const float rho3d = u * u + v * v;
  const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
  const float rho = fminf(rho3d, rho2d);
  z = rho3d <= rho2d ? u * q1.z + v * q1.w + q2.x : q2.x;
  a = fminf(q2.w * expf(-0.5f * rho), ALPHA_MAX);
  return a >= ALPHA_MIN && z >= NEAR_PLANE;
}

// Whether the splat in table row d may pass the alpha floor at some pixel
// of the patch centred at (xc, yc) with half-widths (hx, hy) (from the
// centre to the outer pixels' centres). alpha = opacity exp(-rho / 2) >=
// 1/255 needs rho <= 2 ln(255 opacity), taken with margins as `level`.
// Surfel: rho is min(rho3d, rho2d), so the pair is refused only where both
// exceed the level over the patch: rho2d by the patch's distance from the centre;
// rho3d = (qx^2 + qy^2) / qz^2 with q = k x l, which is linear in the pixel
// (q = q(centre) + dx (l x r2) + dy (r2 x k), r2 the w-row), so over the
// patch each component lies in an interval, widened by FOOT_EPS times the
// magnitudes of the products the exact terms round. Gauss3d: where the
// conic is positive definite, the ellipse at the level lies in |dy| <=
// sqrt(level a / det) and, at each dy, within sqrt(level / a) of
// -b dy / a. Each refusal needs a comparison that is true, so a NaN lets
// the pair through.
template <int MODE>
__device__ __forceinline__ bool may_reach(const float* d, float xc, float yc,
                                          float hx, float hy) {
  // t00 t01 t02 | t10 t11 t12 | t20 t21 t22 cx cy opacity (gauss3d: a b c)
  const float4 q0 = *reinterpret_cast<const float4*>(d);
  const float4 q1 = *reinterpret_cast<const float4*>(d + 4);
  const float4 q2 = *reinterpret_cast<const float4*>(d + 8);
  const float opac = q2.w;
  if (opac < ALPHA_MIN) return false;
  const float level =
      FOOT_RHO_MARGIN * (2.f * logf(opac / ALPHA_MIN)) + FOOT_RHO_SLACK;
  const float dxc = q2.y - xc;
  const float dyc = q2.z - yc;
  if (MODE == GAUSS3D) {
    const float a = q0.x, b = q0.y, c = q0.z;
    const float det = a * c - b * b;
    if (!(a > 0.f && det > 0.f)) return true;
    const float ey = sqrtf(level * a / det);
    const float ylo = fmaxf(dyc - hy, -ey);
    const float yhi = fminf(dyc + hy, ey);
    const float s = b / a;
    const float r = sqrtf(level / a);
    const float xl = fminf(-s * ylo, -s * yhi) - r;
    const float xr = fmaxf(-s * ylo, -s * yhi) + r;
    return !(ylo > yhi || dxc - hx > xr || dxc + hx < xl);
  }
  const float ex = fmaxf(fabsf(dxc) - hx, 0.f);
  const float ey = fmaxf(fabsf(dyc) - hy, 0.f);
  if (!(FILTER_INV_SQUARE * (ex * ex + ey * ey) > level)) return true;
  const float r0x = q0.x, r0y = q0.y, r0z = q0.z;
  const float r1x = q0.w, r1y = q1.x, r1z = q1.y;
  const float r2x = q1.z, r2y = q1.w, r2z = q2.x;
  const float kx = r0x - xc * r2x, ky = r0y - xc * r2y, kz = r0z - xc * r2z;
  const float lx = r1x - yc * r2x, ly = r1y - yc * r2y, lz = r1z - yc * r2z;
  const float ax = fabsf(xc) + hx, ay = fabsf(yc) + hy;
  const float kmx = fabsf(r0x) + ax * fabsf(r2x);
  const float kmy = fabsf(r0y) + ax * fabsf(r2y);
  const float kmz = fabsf(r0z) + ax * fabsf(r2z);
  const float lmx = fabsf(r1x) + ay * fabsf(r2x);
  const float lmy = fabsf(r1y) + ay * fabsf(r2y);
  const float lmz = fabsf(r1z) + ay * fabsf(r2z);
  const float qx = ky * lz - kz * ly;
  const float qy = kz * lx - kx * lz;
  const float qz = kx * ly - ky * lx;
  const float bx = ly * r2z - lz * r2y;  // l x r2: q's step along x
  const float by = lz * r2x - lx * r2z;
  const float bz = lx * r2y - ly * r2x;
  const float cx = r2y * kz - r2z * ky;  // r2 x k: q's step along y
  const float cy = r2z * kx - r2x * kz;
  const float cz = r2x * ky - r2y * kx;
  const float wx = fabsf(bx) * hx + fabsf(cx) * hy
                   + FOOT_EPS * (kmy * lmz + kmz * lmy);
  const float wy = fabsf(by) * hx + fabsf(cy) * hy
                   + FOOT_EPS * (kmz * lmx + kmx * lmz);
  const float wz = fabsf(bz) * hx + fabsf(cz) * hy
                   + FOOT_EPS * (kmx * lmy + kmy * lmx);
  const float lox = fmaxf(fabsf(qx) - wx, 0.f);
  const float loy = fmaxf(fabsf(qy) - wy, 0.f);
  const float hiz = fmaxf(fabsf(qz) + wz, 1e-12f);
  return !(lox * lox + loy * loy > level * (hiz * hiz));
}

template <int MODE, bool DIST, bool MED, bool WET, bool ALIGNED>
__global__ void
__launch_bounds__(NPIX, DIST || MED ? MIN_BLOCKS_TRAIN : MIN_BLOCKS_RENDER)
raster_blend_fwd_kernel(const float* __restrict__ packed, int n_rows,
                        const int32_t* __restrict__ gauss_idx, int n_idx,
                        const int32_t* __restrict__ bounds, int C,
                        int tiles_x, int tiles_y, int row_off,
                        float* __restrict__ out, float* __restrict__ wet) {
  static_assert(ALIGNED || !WET, "the wet needs the aligned layout");
  // a warp's patch: 8x4, or with WET the 16x2 strip the wet's order needs
  constexpr int WW = WET ? 16 : 8, WH = 32 / WW;
  constexpr float HX = 0.5f * (WW - 1), HY = 0.5f * (WH - 1);
  __shared__ __align__(16) float rows[NSTAGE][CHUNK][LOS];
  __shared__ float wpart[WET ? 2 : 1][WET ? NWARP : 1][CHUNK];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = t % tiles_x, ty = t / tiles_x;
  // warp w is the patch at (w % (16 / WW), w / (16 / WW)), lane l its pixel
  // (l % WW, l / WW)
  const int wx0 = (warp % (TILE / WW)) * WW, wy0 = (warp / (TILE / WW)) * WH;
  const int ix = wx0 + lane % WW, iy = wy0 + lane / WW;
  const float px = (float)(tx * TILE + ix);
  const float py = (float)(ty * TILE + row_off + iy);
  const float xc = (float)(tx * TILE + wx0) + 0.5f * (WW - 1);
  const float yc = (float)(ty * TILE + row_off + wy0) + 0.5f * (WH - 1);
  const int start = bounds[t], end = bounds[t + 1];
  const int wstart = ALIGNED ? start : start - start % 8;
  const int nwin = max(0, (end - wstart + CHUNK - 1) / CHUNK);

  // Staging: thread `tid` copies vectors tid and tid + 256 of a window's
  // 512 (row e / 8, vector e % 8). A pair outside [start, end) (none on the
  // aligned layout) or the index array, or naming a row outside the table,
  // reads as the zero row.
  int g_next[2];
  auto load_idx = [&](int win) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = wstart + win * CHUNK + (tid + h * NPIX) / VPR;
      int g = -1;
      if ((ALIGNED || (i >= start && i < end)) && i < n_idx) {
        g = gauss_idx[i];
        if (g < 0 || g >= n_rows) g = -1;
      }
      g_next[h] = g;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = tid + h * NPIX;
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
  // the wet of window `win` from its buffer: the 8 warps' sums in order
  auto flush = [&](int win) {
    if (tid < CHUNK) {
      const int i = wstart + win * CHUNK + tid;
      if ((ALIGNED || (i >= start && i < end)) && i < n_idx) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < NWARP; ++k) sum += wpart[win & 1][k][tid];
        wet[i] = sum;
      }
    }
  };
  for (int k = 0; k < NSTAGE - 1 && k < nwin; ++k) {
    load_idx(k);
    stage(k);
  }
  if (NSTAGE - 1 < nwin) load_idx(NSTAGE - 1);

  float col[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) col[c] = 0.f;
  float dep = 0.f, alp = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f, T = 1.f;
  float dist = 0.f, d1 = 0.f, d2 = 0.f, med = 0.f, last = -1.f;
  bool dead = false;  // T * (1 - 1/255) < 1e-4: the pixel can take no more
  int walked = nwin;
  for (int win = 0; win < nwin; ++win) {
    const int buf = win % NSTAGE;
    // this window's rows are in (the next window's may still be in flight)
    if (win + 1 < nwin)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // the barrier: this window's rows (and, with WET, the last window's
    // partial wet) are in for every thread, and every thread is done with
    // the buffers staged next; and the block's exit, once no pixel can
    // take more
    const bool alive = __syncthreads_or(!dead);
    if (WET && win > 0) flush(win - 1);
    if (!alive) {
      walked = win;
      break;
    }
    if (win + NSTAGE - 1 < nwin) {
      stage((win + NSTAGE - 1) % NSTAGE);
      if (win + NSTAGE < nwin) load_idx(win + NSTAGE);
    }
    float* wp = wpart[WET ? win & 1 : 0][WET ? warp : 0];
    if (WET) {  // the pairs this warp skips add zeros
      wp[lane] = 0.f;
      wp[lane + 32] = 0.f;
      __syncwarp();
    }
    if (__all_sync(FULL, dead)) continue;  // this warp keeps the barriers
    // the pairs whose footprint may reach this warp's patch, in pair order
    unsigned long long hit =
        __ballot_sync(FULL, may_reach<MODE>(rows[buf][lane], xc, yc, HX, HY))
        | (unsigned long long)__ballot_sync(
              FULL, may_reach<MODE>(rows[buf][lane + 32], xc, yc, HX, HY))
              << 32;
    bool fail = false;
    for (; hit; hit &= hit - 1) {
      // no pixel of the warp can take a pair of this window any more
      if (__all_sync(FULL, fail || dead)) break;
      const int j = __ffsll(hit) - 1;
      const float* d = rows[buf][j];
      float a, z;
      const bool amask = pixel_terms<MODE>(d, px, py, a, z);
      if (WET) {
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
        const float m = map_depth(z);
        const float wm = w * m;
        dist += w * (m * m * alp + d2 - 2.f * m * d1);
        d1 += wm;
        d2 += wm * m;
        last = (float)(win * CHUNK + j);
      }
      if (MED && T > 0.5f) med = z;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) col[c] += w * d[C_COLOR + c];
      dep += w * z;
      alp += w;
      n0 += w * d[C_NRM];
      n1 += w * d[C_NRM + 1];
      n2 += w * d[C_NRM + 2];
      T = test;
      dead = !(T * (1.f - ALPHA_MIN) >= T_CUTOFF);
    }
  }
  if (WET && walked == nwin && nwin > 0) {  // the last window walked
    __syncthreads();
    flush(nwin - 1);
  }

  const int out_w = tiles_x * TILE;
  const size_t plane = (size_t)tiles_y * TILE * out_w;
  float* o = out + (size_t)(ty * TILE + iy) * out_w + tx * TILE + ix;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) o[c * plane] = col[c];
  o[C * plane] = dep;
  o[(C + 1) * plane] = alp;
  o[(C + 2) * plane] = n0;
  o[(C + 3) * plane] = n1;
  o[(C + 4) * plane] = n2;
  if (DIST || MED) {  // a stripped register keeps its start: 0, last -1
    o[(C + 5) * plane] = med;
    o[(C + 6) * plane] = dist;
    o[(C + 7) * plane] = T;
    o[(C + 8) * plane] = d1;
    o[(C + 9) * plane] = d2;
    o[(C + 10) * plane] = last;
  } else {
    o[(C + 5) * plane] = T;
  }
}

template <int MODE, bool DIST, bool MED, bool WET, bool ALIGNED>
struct Launch {
  static int run(const float* packed, int n_rows, const int32_t* gauss_idx,
                 int n_idx, const int32_t* bounds, int C, int tiles_x,
                 int tiles_y, int row_off, float* out, float* wet,
                 cudaStream_t stream) {
    raster_blend_fwd_kernel<MODE, DIST, MED, WET, ALIGNED>
        <<<tiles_x * tiles_y, NPIX, 0, stream>>>(packed, n_rows, gauss_idx,
                                                 n_idx, bounds, C, tiles_x,
                                                 tiles_y, row_off, out, wet);
    return (int)cudaGetLastError();
  }
};

template <int MODE, bool DIST, bool MED, bool WET, bool ALIGNED>
struct Resources {
  static int run(int* out) {
    const auto kernel = raster_blend_fwd_kernel<MODE, DIST, MED, WET, ALIGNED>;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NPIX,
                                                        0);
    out[0] = attr.numRegs;
    out[1] = (int)attr.sharedSizeBytes;
    out[2] = blocks;
    out[3] = (int)attr.localSizeBytes;
    return (int)err;
  }
};

constexpr int config_code(bool dist, bool med, bool wet, bool aligned) {
  return (dist ? 1 : 0) | (med ? 2 : 0) | (wet ? 4 : 0) | (aligned ? 8 : 0);
}

// Calls F<MODE, DIST, MED, WET, ALIGNED>::run(args...) for a compiled
// configuration; cudaErrorInvalidValue for any other.
template <template <int, bool, bool, bool, bool> class F, typename... Args>
int dispatch(int mode, int dist, int med, int wet, int aligned,
             Args... args) {
  const int bad = (int)cudaErrorInvalidValue;
  if (mode == GAUSS3D)
    return dist && med && wet && aligned
               ? F<GAUSS3D, true, true, true, true>::run(args...)
               : bad;
  if (mode != SURFEL) return bad;
  switch (config_code(dist, med, wet, aligned)) {
#define K1_SURFEL(D, M, W, A)        \
  case config_code(D, M, W, A):      \
    return F<SURFEL, D, M, W, A>::run(args...);
    K1_SURFEL(false, false, false, false)
    K1_SURFEL(true, false, false, false)
    K1_SURFEL(false, true, false, false)
    K1_SURFEL(true, true, false, false)
    K1_SURFEL(false, false, false, true)
    K1_SURFEL(true, false, false, true)
    K1_SURFEL(false, true, false, true)
    K1_SURFEL(true, true, false, true)
    K1_SURFEL(false, false, true, true)
    K1_SURFEL(true, false, true, true)
    K1_SURFEL(false, true, true, true)
    K1_SURFEL(true, true, true, true)
#undef K1_SURFEL
  }
  return bad;  // the wet on the unaligned layout
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a configuration that is not compiled (the
// wet without `aligned`; gauss3d other than all on). mode: 0 surfel, 1
// gauss3d; dist, med, aligned: the switches above, the wet's by `wet`.
// out: (C + 11, tiles_y*16, tiles_x*16) f32 with dist or med, else
// (C + 6, ...), every element written. wet: null, or (n_idx,) f32 zeroed
// by the caller, receiving each in-range pair's wet.
extern "C" int raster_blend_fwd(const float* packed, int n_rows,
                                const int32_t* gauss_idx, int n_idx,
                                const int32_t* bounds, int C, int tiles_x,
                                int tiles_y, int row_off, int dist, int med,
                                int aligned, int mode, float* out, float* wet,
                                void* stream) {
  return dispatch<Launch>(mode, dist, med, wet != nullptr, aligned, packed,
                          n_rows, gauss_idx, n_idx, bounds, C, tiles_x,
                          tiles_y, row_off, out, wet, (cudaStream_t)stream);
}

// K1's resources as compiled for (dist, med, wet, aligned, mode): out[0]
// registers per thread, out[1] static shared bytes per block, out[2]
// resident blocks per SM, out[3] local (spill) bytes per thread. Launches
// nothing; returns a CUDA error code (0 = ok).
extern "C" int raster_blend_fwd_resources(int dist, int med, int wet,
                                          int aligned, int mode, int* out) {
  return dispatch<Resources>(mode, dist, med, wet, aligned, out);
}
