// Kernel K1: per-tile front-to-back blend of 2DGS surfels or 3DGS
// Gaussians.
//
// Replaces: envgs_tpu/ops/raster_pallas.py::_fwd_kernel (Pallas, TPU) in
// both of its geometries, a compile-time MODE here: surfel (2DGS ray-plane
// intersection) and gauss3d (3DGS EWA conic: rho = a dx^2 + c dy^2 +
// 2 b dx dy from the table's columns 0-2, the splat's view depth in column
// 3). Two configurations: render (unaligned pair layout; distortion, median
// depth and per-pair wet off; C + 6 planes) and training (aligned layout;
// C + 11 planes in the JAX row order: colors, depth*w, alpha, normal,
// median depth, distortion, T, D1, D2, last contributing rank; a render
// that needs the median depth launches this configuration on the unaligned
// layout, the window walk takes either). With `wet`
// it also writes each pair's wet (its w summed over the tile's pixels, the
// JAX kernel's need_wet rows); the per-splat sum stays outside (index_add_,
// as the JAX package's segment_sum outside Pallas). It also absorbs the
// per-pair row gather of raster_pallas.py::gather_blend_tiles: rows are
// read straight from the per-splat table, no (pairs, 128) array is built.
//
// What bounds it on the card: arithmetic. Every (pair, pixel) of a tile is
// evaluated: a ray-plane intersection through the 3x3 screen transform (two
// IEEE divisions) or a conic quadratic, an expf and the blend, some 60 (30)
// fp32 operations, for about 256 pixels times the tile's pair count. The
// bytes are small next to that: one 128-byte table row per pair, read once
// per tile. The wet costs five warp shuffles per pair.
//
// Design: one block per 16x16 tile, one thread per pixel. The block walks
// the tile's pair range in the JAX kernel's 64-pair windows (starting at
// start - start % 8); the threads first stage the window's table rows in
// shared memory (coalesced 128-byte rows), then every thread reads each row
// as a broadcast and blends it into registers. The contribution rule is the
// JAX kernel's exactly: a pair contributes iff its alpha passes the 1/255
// floor and the near plane and T*(1-a) >= 1e-4; within a window, the first
// pair that fails the transmittance test ends the window for that pixel.
// The block stops early once no pixel can take any further pair
// (T*(1 - 1/255) < 1e-4 for all), decided with __syncthreads_or. The
// training outputs are running sums in registers beside the render ones
// (distortion from the running alpha and moments before each pair, as the
// JAX kernel's exclusive prefix sums give them). The wet of a pair is summed
// within each warp with shuffles into a (8 warps, 64 pairs) shared block and
// the 8 partial sums are added in a fixed order after the window, so it does
// not vary from run to run; pairs past the early stop keep the zeros the
// wrapper fills in. Built with -fmad=false so each operation rounds as the
// plain PyTorch version's does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int CHUNK = 64;
constexpr int LO = 32;  // packed row width
constexpr int MAXC = 7;
constexpr int NWARP = NPIX / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SURFEL = 0, GAUSS3D = 1;  // geometry modes
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

__device__ __forceinline__ float map_depth(float z) {
  const float zc = fmaxf(z, 1e-6f);
  return (FAR_PLANE * (zc - NEAR_PLANE)) / (FAR_M_NEAR * zc);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// The JAX kernel's _splat_pixel_terms: alpha (clamped) and depth of the
// splat in table row d at pixel (px, py); false where amask fails.
template <int MODE>
__device__ __forceinline__ bool pixel_terms(const float* d, float px, float py,
                                            float& a, float& z) {
  if (MODE == GAUSS3D) {
    const float dx = d[C_CX] - px;
    const float dy = d[C_CY] - py;
    const float rho = d[0] * dx * dx + d[2] * dy * dy + 2.f * d[1] * dx * dy;
    a = fminf(d[C_OPAC] * expf(-0.5f * fmaxf(rho, 0.f)), ALPHA_MAX);
    z = d[3];
    return a >= ALPHA_MIN && rho >= 0.f && z >= NEAR_PLANE;
  }
  const float kx = d[0] - px * d[6];
  const float ky = d[1] - px * d[7];
  const float kz = d[2] - px * d[8];
  const float lx = d[3] - py * d[6];
  const float ly = d[4] - py * d[7];
  const float lz = d[5] - py * d[8];
  const float qx = ky * lz - kz * ly;
  const float qy = kz * lx - kx * lz;
  float qz = kx * ly - ky * lx;
  if (fabsf(qz) < 1e-12f) qz = 1e-12f;
  const float u = qx / qz;
  const float v = qy / qz;
  const float rho3d = u * u + v * v;
  const float dx = d[C_CX] - px;
  const float dy = d[C_CY] - py;
  const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
  const float rho = fminf(rho3d, rho2d);
  z = rho3d <= rho2d ? u * d[6] + v * d[7] + d[8] : d[8];
  a = fminf(d[C_OPAC] * expf(-0.5f * rho), ALPHA_MAX);
  return a >= ALPHA_MIN && z >= NEAR_PLANE;
}

template <int MODE, bool WET>
__global__ void __launch_bounds__(NPIX)
raster_blend_fwd_kernel(const float* __restrict__ packed, int n_rows,
                        const int32_t* __restrict__ gauss_idx, int n_idx,
                        const int32_t* __restrict__ bounds, int C,
                        int tiles_x, int tiles_y, int row_off, int train,
                        float* __restrict__ out, float* __restrict__ wet) {
  __shared__ float rows[CHUNK][LO];
  __shared__ float wpart[WET ? NWARP : 1][CHUNK];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tx = t % tiles_x, ty = t / tiles_x;
  const float px = (float)(tx * TILE + lane % TILE);
  const float py = (float)(ty * TILE + row_off + lane / TILE);
  const int start = bounds[t], end = bounds[t + 1];
  const int wstart = start - start % 8;
  const int nwin = (end - wstart + CHUNK - 1) / CHUNK;

  float col[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) col[c] = 0.f;
  float dep = 0.f, alp = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f, T = 1.f;
  float dist = 0.f, d1 = 0.f, d2 = 0.f, med = 0.f, last = -1.f;

  for (int win = 0; win < nwin; ++win) {
    const int base = wstart + win * CHUNK;
    for (int e = lane; e < CHUNK * LO; e += NPIX) {
      const int r = e / LO, k = e % LO;
      const int i = base + r;
      float val = 0.f;  // rows outside [start, end) read as the zero row
      if (i >= start && i < end && i < n_idx) {
        const int g = gauss_idx[i];
        if (g >= 0 && g < n_rows) val = packed[(size_t)g * LO + k];
      }
      rows[r][k] = val;
    }
    __syncthreads();
    bool fail = false;
    for (int j = 0; j < CHUNK; ++j) {
      const float* d = rows[j];
      float a, z;
      const bool amask = pixel_terms<MODE>(d, px, py, a, z);
      if (WET) {  // every lane takes part in the shuffles
        const bool pass = amask && !fail && T * (1.f - a) >= T_CUTOFF;
        const float sum = warp_sum(pass ? a * T : 0.f);
        if ((lane & 31) == 0) wpart[lane >> 5][j] = sum;
      }
      if (!amask || fail) continue;
      const float test = T * (1.f - a);
      if (!(test >= T_CUTOFF)) {
        fail = true;
        continue;
      }
      const float w = a * T;
      if (train) {
        const float m = map_depth(z);
        const float wm = w * m;
        dist += w * (m * m * alp + d2 - 2.f * m * d1);
        d1 += wm;
        d2 += wm * m;
        if (T > 0.5f) med = z;
        last = (float)(win * CHUNK + j);
      }
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) col[c] += w * d[C_COLOR + c];
      dep += w * z;
      alp += w;
      n0 += w * d[C_NRM];
      n1 += w * d[C_NRM + 1];
      n2 += w * d[C_NRM + 2];
      T = test;
    }
    // also the barrier before the next window overwrites `rows` (and,
    // with WET, before wpart is read here and rewritten in the next window)
    const bool alive = __syncthreads_or(T * (1.f - ALPHA_MIN) >= T_CUTOFF);
    if (WET && lane < CHUNK) {
      const int i = base + lane;
      if (i >= start && i < end && i < n_idx) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < NWARP; ++k) sum += wpart[k][lane];
        wet[i] = sum;
      }
    }
    if (!alive) break;
  }

  const int out_w = tiles_x * TILE;
  const size_t plane = (size_t)tiles_y * TILE * out_w;
  float* o = out + (size_t)(ty * TILE + lane / TILE) * out_w
             + tx * TILE + lane % TILE;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) o[c * plane] = col[c];
  o[C * plane] = dep;
  o[(C + 1) * plane] = alp;
  o[(C + 2) * plane] = n0;
  o[(C + 3) * plane] = n1;
  o[(C + 4) * plane] = n2;
  if (train) {
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

}  // namespace

template <int MODE, bool WET>
static void launch(const float* packed, int n_rows, const int32_t* gauss_idx,
                   int n_idx, const int32_t* bounds, int C, int tiles_x,
                   int tiles_y, int row_off, int train, float* out,
                   float* wet, cudaStream_t stream) {
  raster_blend_fwd_kernel<MODE, WET><<<tiles_x * tiles_y, NPIX, 0, stream>>>(
      packed, n_rows, gauss_idx, n_idx, bounds, C, tiles_x, tiles_y, row_off,
      train, out, wet);
}

// Launches K1 on `stream`; returns cudaGetLastError() (0 = launched).
// mode: 0 surfel, 1 gauss3d. out: (C + 6, tiles_y*16, tiles_x*16) f32
// (train = 0) or (C + 11, ...) (train = 1), every element written. wet:
// null, or (n_idx,) f32 zeroed by the caller, receiving each in-range
// pair's wet.
extern "C" int raster_blend_fwd(const float* packed, int n_rows,
                                const int32_t* gauss_idx, int n_idx,
                                const int32_t* bounds, int C, int tiles_x,
                                int tiles_y, int row_off, int train, int mode,
                                float* out, float* wet, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == GAUSS3D && wet)
    launch<GAUSS3D, true>(packed, n_rows, gauss_idx, n_idx, bounds, C,
                          tiles_x, tiles_y, row_off, train, out, wet, st);
  else if (mode == GAUSS3D)
    launch<GAUSS3D, false>(packed, n_rows, gauss_idx, n_idx, bounds, C,
                           tiles_x, tiles_y, row_off, train, out, wet, st);
  else if (wet)
    launch<SURFEL, true>(packed, n_rows, gauss_idx, n_idx, bounds, C,
                         tiles_x, tiles_y, row_off, train, out, wet, st);
  else
    launch<SURFEL, false>(packed, n_rows, gauss_idx, n_idx, bounds, C,
                          tiles_x, tiles_y, row_off, train, out, wet, st);
  return (int)cudaGetLastError();
}
