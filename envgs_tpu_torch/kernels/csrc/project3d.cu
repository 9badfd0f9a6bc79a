// The 3DGS EWA projection, forward and backward, one launch each.
//
// No TPU kernel stands behind it: the JAX package projects in plain jnp
// (envgs_tpu/ops/raster3d_ref.py::prepare_splats3d), and so does the port's
// plain version (ops/project3d.py::project3d_torch), whose batched 3x3 and
// 2x3 products and some sixty elementwise launches these replace. The
// per-splat arithmetic is in project3d.cuh.
//
// What bounds it on the card: memory. The forward reads about 45 B a splat
// (mean, quaternion, scales, opacity, mask) and writes about 65 B (conic,
// center, depth, radius, validity, extents, the row-cull parameters, the
// opacity where a filter changes it); the backward reads the inputs and
// 24-28 B of cotangents and writes 40-44 B of gradients. A few hundred
// float operations a splat stay far below the card's rate.
//
// Design: one thread a splat, a grid-stride loop over the pool, every
// intermediate in registers; no shared memory, no atomics. The backward
// recomputes the forward's intermediates from the inputs, so the forward
// keeps nothing for it. The camera (R, T, K, pix_from_world; 33 floats) is
// read from device memory by every thread (one broadcast line); the scale
// modifier and the screen-space dilation come by value from the host.
#include <cuda_runtime.h>
#include <stdint.h>

#include "project3d.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;

// The blocks of a launch over P splats: one a THREADS splats, at most as
// many as the device holds at once (the grid-stride loop takes the rest).
// `full` caches that most for each device, asked on its first launch.
int grid_for(int P, const void* fn, int* full) {
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
  const int need = (P + THREADS - 1) / THREADS;
  return need < most ? need : most;
}

int fwd_full[MAX_DEVICES], bwd_full[MAX_DEVICES];

__global__ void __launch_bounds__(THREADS)
project3d_fwd_kernel(const float* __restrict__ means,
                     const float* __restrict__ quats,
                     const float* __restrict__ scales,
                     const float* __restrict__ opac,
                     const uint8_t* __restrict__ active,
                     const float* __restrict__ filter,
                     const float* __restrict__ cam, int P, int W, int H,
                     float sm, float lp, int compensate,
                     float* __restrict__ conic, float* __restrict__ center,
                     float* __restrict__ depth, float* __restrict__ radius,
                     uint8_t* __restrict__ valid, float* __restrict__ ext,
                     float* __restrict__ rowcull,
                     float* __restrict__ opac_out) {
  const p3d::Cam k = p3d::load_cam(cam, W, H);
  const bool has_f = filter != nullptr;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < P;
       i += gridDim.x * THREADS) {
    float m[3], s[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      m[j] = means[3 * i + j];
      s[j] = scales[3 * i + j];
    }
    const float4 q4 = reinterpret_cast<const float4*>(quats)[i];
    const float q[4] = {q4.x, q4.y, q4.z, q4.w};
    p3d::Fwd o;
    p3d::forward(k, m, q, s, sm, lp, has_f, has_f ? filter[i] : 0.0f, o);
    const p3d::Rest r = p3d::rest(k, o, active == nullptr || active[i]);
#pragma unroll
    for (int j = 0; j < 3; ++j) conic[3 * i + j] = o.conic[j];
    reinterpret_cast<float2*>(center)[i] = make_float2(o.center[0],
                                                       o.center[1]);
    depth[i] = o.t[2];
    radius[i] = r.radius;
    valid[i] = r.valid;
    reinterpret_cast<float2*>(ext)[i] = make_float2(r.ext[0], r.ext[1]);
    float2* rc = reinterpret_cast<float2*>(rowcull + 6 * i);
    rc[0] = make_float2(r.rowcull[0], r.rowcull[1]);
    rc[1] = make_float2(r.rowcull[2], r.rowcull[3]);
    rc[2] = make_float2(r.rowcull[4], r.rowcull[5]);
    if (opac_out != nullptr) {
      float op = opac[i];
      if (has_f) op = op * o.sq1;
      if (compensate) op = op * p3d::compensation(o).sq2;
      opac_out[i] = op;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
project3d_bwd_kernel(const float* __restrict__ means,
                     const float* __restrict__ quats,
                     const float* __restrict__ scales,
                     const float* __restrict__ opac,
                     const float* __restrict__ filter,
                     const float* __restrict__ cam, int P, int W, int H,
                     float sm, float lp, int compensate,
                     const float* __restrict__ g_conic,
                     const float* __restrict__ g_center,
                     const float* __restrict__ g_depth,
                     const float* __restrict__ g_opac,
                     float* __restrict__ d_means, float* __restrict__ d_quats,
                     float* __restrict__ d_scales,
                     float* __restrict__ d_opac) {
  const p3d::Cam k = p3d::load_cam(cam, W, H);
  const bool has_f = filter != nullptr, has_go = g_opac != nullptr;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < P;
       i += gridDim.x * THREADS) {
    float m[3], s[3], gc[3] = {0.0f, 0.0f, 0.0f}, gp[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      m[j] = means[3 * i + j];
      s[j] = scales[3 * i + j];
      if (g_conic != nullptr) gc[j] = g_conic[3 * i + j];
    }
    if (g_center != nullptr) {
      const float2 g2 = reinterpret_cast<const float2*>(g_center)[i];
      gp[0] = g2.x;
      gp[1] = g2.y;
    }
    const float4 q4 = reinterpret_cast<const float4*>(quats)[i];
    const float q[4] = {q4.x, q4.y, q4.z, q4.w};
    float dm[3], dq[4], dsc[3], dop = 0.0f;
    p3d::backward(k, m, q, s, has_go ? opac[i] : 0.0f, sm, lp, has_f,
                  has_f ? filter[i] : 0.0f, compensate != 0, gc, gp,
                  g_depth != nullptr ? g_depth[i] : 0.0f, has_go,
                  has_go ? g_opac[i] : 0.0f, dm, dq, dsc, &dop);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      d_means[3 * i + j] = dm[j];
      d_scales[3 * i + j] = dsc[j];
    }
    reinterpret_cast<float4*>(d_quats)[i] =
        make_float4(dq[0], dq[1], dq[2], dq[3]);
    if (has_go) d_opac[i] = dop;
  }
}

int resources(const void* fn, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  return (int)err;
}

}  // namespace

// Launches the forward on `stream`; returns the CUDA error (0 = launched).
// means, scales (P, 3), quats (P, 4) 16-byte aligned, opac (P,) f32;
// active (P,) bool or null; filter (P,) f32 or null (the mip 3D filter's
// std); cam (33,) f32 on the card (project3d.cuh); params: two floats in
// host memory, the scale modifier and the screen-space dilation. Writes
// conic (P, 3), center (P, 2), depth, radius (P,), valid (P,) bool, ext
// (P, 2), rowcull (P, 6) and, unless null, opac_out (P,): the opacity the
// filter and the compensation change.
extern "C" int project3d_fwd(const float* means, const float* quats,
                             const float* scales, const float* opac,
                             const uint8_t* active, const float* filter,
                             const float* cam, const float* params, int P,
                             int W, int H, int compensate, float* conic,
                             float* center, float* depth, float* radius,
                             uint8_t* valid, float* ext, float* rowcull,
                             float* opac_out, void* stream) {
  if (P <= 0) return 0;
  project3d_fwd_kernel<<<grid_for(P, (const void*)project3d_fwd_kernel,
                                  fwd_full),
                         THREADS, 0, (cudaStream_t)stream>>>(
      means, quats, scales, opac, active, filter, cam, P, W, H, params[0],
      params[1], compensate, conic, center, depth, radius, valid, ext,
      rowcull, opac_out);
  return (int)cudaGetLastError();
}

// Launches the backward on `stream`: the forward's inputs as above, the
// cotangents of conic (P, 3), center (P, 2), depth (P,) and of the changed
// opacity (P,), each null when zero (g_opac null also when the opacity is
// not changed) -> d_means, d_scales (P, 3), d_quats (P, 4) and, where
// g_opac is given, d_opac (P,).
extern "C" int project3d_bwd(const float* means, const float* quats,
                             const float* scales, const float* opac,
                             const float* filter, const float* cam,
                             const float* params, int P, int W, int H,
                             int compensate, const float* g_conic,
                             const float* g_center, const float* g_depth,
                             const float* g_opac, float* d_means,
                             float* d_quats, float* d_scales, float* d_opac,
                             void* stream) {
  if (P <= 0) return 0;
  project3d_bwd_kernel<<<grid_for(P, (const void*)project3d_bwd_kernel,
                                  bwd_full),
                         THREADS, 0, (cudaStream_t)stream>>>(
      means, quats, scales, opac, filter, cam, P, W, H, params[0], params[1],
      compensate, g_conic, g_center, g_depth, g_opac, d_means, d_quats,
      d_scales, d_opac);
  return (int)cudaGetLastError();
}

// The forward's resources as compiled: out[0] registers per thread, out[1]
// static shared bytes per block, out[2] resident blocks of 256 threads per
// SM, out[3] local (spill) bytes per thread. Launches nothing.
extern "C" int project3d_fwd_resources(int* out) {
  return resources((const void*)project3d_fwd_kernel, out);
}

// The backward's resources, as project3d_fwd_resources.
extern "C" int project3d_bwd_resources(int* out) {
  return resources((const void*)project3d_bwd_kernel, out);
}
