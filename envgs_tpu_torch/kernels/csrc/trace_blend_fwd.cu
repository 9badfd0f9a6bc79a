// Kernel K3: per-tile front-to-back blend of 2DGS surfels along rays.
//
// Replaces: envgs_tpu/ops/tracer.py::_fwd_kernel (Pallas, TPU) in two
// configurations: render (need_geo, need_dist and need_wet off; 5 planes:
// rgb, acc, T) and training (need_geo and need_dist on; 13 + A planes in
// the JAX row order: rgb, depth*w, acc, ray-facing normal, distortion, aux
// (A <= 2), T, D1, D2, last contributing rank). The per-slot wet is not
// written: the backward kernel K4 delivers it. It also absorbs the
// per-slot row gather of
// tracer.py::_gather_blend_trace: rows are read straight from the per-splat
// scene table, no (slots, 128) array is built.
//
// What bounds it on the card: arithmetic. Every (candidate, ray) of a tile
// is evaluated: an exact ray-plane intersection (one IEEE division), the
// in-plane coordinates, an expf and the blend, some 45 fp32 operations, for
// 256 rays times the tile's candidate slots. One 128-byte table row per
// slot is read once per tile.
//
// Design: one block per 16x16 ray tile, one thread per ray; the ray's origin
// and direction sit in registers. The block walks the tile's 64-aligned slot
// range from cull_and_sort in the JAX kernel's 64-slot chunks, stages each
// chunk's table rows in shared memory (coalesced 128-byte rows), and every
// thread reads each row as a broadcast. The contribution rule is the JAX
// kernel's exactly: a candidate contributes iff its alpha passes the 1/255
// floor, t > 1e-4 and |d.n| >= 1e-9, and T*(1-a) >= 1e-4; within a chunk,
// the first candidate that fails the transmittance test ends the chunk for
// that ray. The block stops early once no ray can take any further
// candidate (T*(1 - 1/255) < 1e-4 for all), decided with __syncthreads_or.
// The training outputs are running sums in registers (distortion with
// m = t / (1 + |t|) from the running acc and moments before each
// candidate). Built with -fmad=false so each operation rounds as the plain
// PyTorch version's does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NRAY = TILE * TILE;
constexpr int CHUNK = 64;
constexpr int LO = 32;  // packed row width
// packed columns (ops/trace_blend.py)
constexpr int C_MEAN = 0, C_TU = 3, C_TV = 6, C_N = 9, C_OPAC = 12,
              C_COLOR = 13, C_AUX = 16;
constexpr int MAXA = 2;
// the JAX package's constants, rounded to float32 as JAX rounds them
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_CUTOFF = (float)1e-4;
constexpr float T_MIN = (float)1e-4;

__global__ void __launch_bounds__(NRAY)
trace_blend_fwd_kernel(const float* __restrict__ packed, int n_rows,
                       const int32_t* __restrict__ gauss_idx, int n_idx,
                       const float* __restrict__ rays,
                       const int32_t* __restrict__ bounds, int tiles_x,
                       int tiles_y, int train, int A,
                       float* __restrict__ out) {
  __shared__ float rows[CHUNK][LO];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ray = rays + (size_t)t * 8 * NRAY + lane;
  const float ox = ray[0], oy = ray[NRAY], oz = ray[2 * NRAY];
  const float dx = ray[3 * NRAY], dy = ray[4 * NRAY], dz = ray[5 * NRAY];
  const int start = bounds[t], end = bounds[t + 1];
  const int nchunk = (end - start) / CHUNK;

  float r0 = 0.f, r1 = 0.f, r2 = 0.f, acc = 0.f, T = 1.f;
  float dpt = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f, dist = 0.f, d1 = 0.f,
        d2 = 0.f, last = -1.f;
  float aux[MAXA] = {0.f, 0.f};
  for (int ch = 0; ch < nchunk; ++ch) {
    const int base = start + ch * CHUNK;
    for (int e = lane; e < CHUNK * LO; e += NRAY) {
      const int r = e / LO, k = e % LO;
      const int i = base + r;
      float val = 0.f;
      if (i < n_idx) {
        const int g = gauss_idx[i];
        if (g >= 0 && g < n_rows) val = packed[(size_t)g * LO + k];
      }
      rows[r][k] = val;
    }
    __syncthreads();
    bool fail = false;
    for (int j = 0; j < CHUNK; ++j) {
      const float* d = rows[j];
      const float cx = d[C_MEAN], cy = d[C_MEAN + 1], cz = d[C_MEAN + 2];
      const float nx = d[C_N], ny = d[C_N + 1], nz = d[C_N + 2];
      const float dn = dx * nx + dy * ny + dz * nz;
      const float dn_s = fabsf(dn) < 1e-9f ? 1e-9f : dn;
      const float num = (cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz;
      const float tt = num / dn_s;
      const float ex = ox + tt * dx - cx;
      const float ey = oy + tt * dy - cy;
      const float ez = oz + tt * dz - cz;
      const float u = ex * d[C_TU] + ey * d[C_TU + 1] + ez * d[C_TU + 2];
      const float v = ex * d[C_TV] + ey * d[C_TV + 1] + ez * d[C_TV + 2];
      const float rho = u * u + v * v;
      const float a = fminf(d[C_OPAC] * expf(-0.5f * rho), ALPHA_MAX);
      if (!(a >= ALPHA_MIN && tt > T_MIN && fabsf(dn) >= 1e-9f) || fail)
        continue;
      const float test = T * (1.f - a);
      if (!(test >= T_CUTOFF)) {
        fail = true;
        continue;
      }
      const float w = a * T;
      if (train) {
        const float flip = dn > 0.f ? -1.f : 1.f;
        const float m = tt / (1.f + fabsf(tt));
        const float wm = w * m;
        dist += w * (m * m * acc + d2 - 2.f * m * d1);
        d1 += wm;
        d2 += wm * m;
        n0 += w * (d[C_N] * flip);
        n1 += w * (d[C_N + 1] * flip);
        n2 += w * (d[C_N + 2] * flip);
#pragma unroll
        for (int i = 0; i < MAXA; ++i)
          if (i < A) aux[i] += w * d[C_AUX + i];
        dpt += w * tt;
        last = (float)(ch * CHUNK + j);
      }
      r0 += w * d[C_COLOR];
      r1 += w * d[C_COLOR + 1];
      r2 += w * d[C_COLOR + 2];
      acc += w;
      T = test;
    }
    // also the barrier before the next chunk overwrites `rows`
    if (!__syncthreads_or(T * (1.f - ALPHA_MIN) >= T_CUTOFF)) break;
  }

  const int tx = t % tiles_x, ty = t / tiles_x;
  const int out_w = tiles_x * TILE;
  const size_t plane = (size_t)tiles_y * TILE * out_w;
  float* o = out + (size_t)(ty * TILE + lane / TILE) * out_w
             + tx * TILE + lane % TILE;
  o[0] = r0;
  o[plane] = r1;
  o[2 * plane] = r2;
  if (train) {  // JAX rows: rgb, dpt, acc, normal, dist, aux, T, D1, D2, last
    o[3 * plane] = dpt;
    o[4 * plane] = acc;
    o[5 * plane] = n0;
    o[6 * plane] = n1;
    o[7 * plane] = n2;
    o[8 * plane] = dist;
#pragma unroll
    for (int i = 0; i < MAXA; ++i)
      if (i < A) o[(9 + i) * plane] = aux[i];
    o[(9 + A) * plane] = T;
    o[(10 + A) * plane] = d1;
    o[(11 + A) * plane] = d2;
    o[(12 + A) * plane] = last;
  } else {
    o[3 * plane] = acc;
    o[4 * plane] = T;
  }
}

}  // namespace

// Launches K3 on `stream`; returns cudaGetLastError() (0 = launched).
// out: (5, tiles_y*16, tiles_x*16) f32 = rgb, acc, T (train = 0) or
// (13 + A, ...) (train = 1); every element written.
extern "C" int trace_blend_fwd(const float* packed, int n_rows,
                               const int32_t* gauss_idx, int n_idx,
                               const float* rays, const int32_t* bounds,
                               int tiles_x, int tiles_y, int train, int A,
                               float* out, void* stream) {
  trace_blend_fwd_kernel<<<tiles_x * tiles_y, NRAY, 0,
                           (cudaStream_t)stream>>>(
      packed, n_rows, gauss_idx, n_idx, rays, bounds, tiles_x, tiles_y,
      train, A, out);
  return (int)cudaGetLastError();
}
