// Kernel K1: per-tile front-to-back blend of 2DGS surfels, render mode.
//
// Replaces: envgs_tpu/ops/raster_pallas.py::_fwd_kernel (Pallas, TPU) in its
// render configuration: surfel geometry, the unaligned pair layout, and the
// distortion / median-depth / per-pair-wet outputs off. It also absorbs the
// per-pair row gather of raster_pallas.py::gather_blend_tiles: rows are read
// straight from the per-splat table, no (pairs, 128) array is built.
//
// What bounds it on the card: arithmetic. Every (pair, pixel) of a tile is
// evaluated: a ray-plane intersection through the 3x3 screen transform (two
// IEEE divisions), an expf and the blend, some 60 fp32 operations, for about
// 256 pixels times the tile's pair count. The bytes are small next to that:
// one 128-byte table row per pair, read once per tile.
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
// (T*(1 - 1/255) < 1e-4 for all), decided with __syncthreads_or. Built with
// -fmad=false so each operation rounds as the plain PyTorch version's does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int CHUNK = 64;
constexpr int LO = 32;  // packed row width
constexpr int MAXC = 7;
// packed columns (ops/raster_blend.py)
constexpr int C_CX = 9, C_CY = 10, C_OPAC = 11, C_NRM = 12, C_COLOR = 15;
// the JAX package's constants, rounded to float32 as JAX rounds them
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_CUTOFF = (float)1e-4;
constexpr float NEAR_PLANE = (float)0.2;
constexpr float FILTER_INV_SQUARE = 2.0f;

__global__ void __launch_bounds__(NPIX)
raster_blend_fwd_kernel(const float* __restrict__ packed, int n_rows,
                        const int32_t* __restrict__ gauss_idx, int n_idx,
                        const int32_t* __restrict__ bounds, int C,
                        int tiles_x, int tiles_y, int row_off,
                        float* __restrict__ out) {
  __shared__ float rows[CHUNK][LO];
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
      const float z = rho3d <= rho2d ? u * d[6] + v * d[7] + d[8] : d[8];
      const float a = fminf(d[C_OPAC] * expf(-0.5f * rho), ALPHA_MAX);
      if (!(a >= ALPHA_MIN && z >= NEAR_PLANE) || fail) continue;
      const float test = T * (1.f - a);
      if (!(test >= T_CUTOFF)) {
        fail = true;
        continue;
      }
      const float w = a * T;
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
    // also the barrier before the next window overwrites `rows`
    if (!__syncthreads_or(T * (1.f - ALPHA_MIN) >= T_CUTOFF)) break;
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
  o[(C + 5) * plane] = T;
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 = launched).
// out: (C + 6, tiles_y*16, tiles_x*16) f32, every element written.
extern "C" int raster_blend_fwd(const float* packed, int n_rows,
                                const int32_t* gauss_idx, int n_idx,
                                const int32_t* bounds, int C, int tiles_x,
                                int tiles_y, int row_off, float* out,
                                void* stream) {
  raster_blend_fwd_kernel<<<tiles_x * tiles_y, NPIX, 0,
                            (cudaStream_t)stream>>>(
      packed, n_rows, gauss_idx, n_idx, bounds, C, tiles_x, tiles_y, row_off,
      out);
  return (int)cudaGetLastError();
}
