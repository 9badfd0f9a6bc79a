// What the traced blend's two kernels, K3 (trace_blend_fwd.cu) and K4
// (trace_blend_bwd.cu), share: the scene table's columns, the blend rule's
// constants, the 16-byte asynchronous copy their staging is made of, and
// the bounding test that stands ahead of their exact terms.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NRAY = TILE * TILE;
constexpr int CHUNK = 64;
constexpr int LO = 32;  // packed row width
constexpr int VPR = LO / 4;  // 16-byte vectors per row
constexpr int MAXA = 2;
constexpr int WARP_W = 8, WARP_H = 4;  // a warp's patch of the tile
constexpr int NWARP = NRAY / 32;
constexpr unsigned FULL = 0xffffffffu;
// packed columns (ops/trace_blend.py)
constexpr int C_MEAN = 0, C_TU = 3, C_TV = 6, C_N = 9, C_OPAC = 12,
              C_COLOR = 13, C_AUX = 16;
// the JAX package's constants, rounded to float32 as JAX rounds them
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_CUTOFF = (float)1e-4;
constexpr float T_MIN = (float)1e-4;

// The reach of a splat: no ray passes its alpha floor unless the ray's line
// comes within sqrt(reach2) of its centre. alpha >= 1/255 needs rho = u^2 +
// v^2 <= 2 ln(255 opacity); with e the hit point's offset from the centre,
// in the splat's plane, rho >= lmin |e|^2 for lmin the smaller eigenvalue
// of the tangents' Gram matrix (tangents orthogonal to the normal, as every
// surfel's are), and the line passes no farther from the centre than its
// hit point lies. The margins (10% and 0.01 on rho, 1e-5 of the Gram
// matrix's size) cover the float32 rounding of the exact terms, so a slot
// whose exact test passes is never refused. -1: no ray (opacity under the
// floor, the zero row of a padding slot); infinity: every ray.
constexpr float RHO_MARGIN = 1.1f, RHO_SLACK = 0.01f;
__device__ __forceinline__ float reach2(const float* d) {
  const float opac = d[C_OPAC];
  if (!(opac >= ALPHA_MIN)) return -1.f;
  const float a = d[C_TU] * d[C_TU] + d[C_TU + 1] * d[C_TU + 1]
                  + d[C_TU + 2] * d[C_TU + 2];
  const float b = d[C_TU] * d[C_TV] + d[C_TU + 1] * d[C_TV + 1]
                  + d[C_TU + 2] * d[C_TV + 2];
  const float c = d[C_TV] * d[C_TV] + d[C_TV + 1] * d[C_TV + 1]
                  + d[C_TV + 2] * d[C_TV + 2];
  const float half = 0.5f * (a + c), diff = 0.5f * (a - c);
  const float lmin = half - sqrtf(diff * diff + b * b) - 1e-5f * half;
  const float rho_max = RHO_MARGIN * 2.f * logf(opac / ALPHA_MIN) + RHO_SLACK;
  return lmin > 0.f ? rho_max / lmin : __int_as_float(0x7f800000);
}

// Whether the line of a ray (direction d, |d|^2 = dd, the splat's centre at
// oc from its origin) comes within the splat's reach: the squared distance
// times dd, |oc|^2 dd - (oc.d)^2, against reach2 dd. The difference cancels
// where the line passes close by a far centre, so 4e-6 |oc|^2 is allowed
// on top (some ten times the rounding of the two products; it also covers
// the rounding of the exact hit point): dd_s is dd (1 - 4e-6). Fused
// multiply-adds here: the test only has to be safe, and feeds no output.
constexpr float POS_SLACK = 4e-6f;
__device__ __forceinline__ bool in_reach(float ocx, float ocy, float ocz,
                                         float dx, float dy, float dz,
                                         float dd, float dd_s, float r2) {
  const float oc2 = __fmaf_rn(ocx, ocx, __fmaf_rn(ocy, ocy, ocz * ocz));
  const float dot = __fmaf_rn(ocx, dx, __fmaf_rn(ocy, dy, ocz * dz));
  return __fmaf_rn(-dot, dot, oc2 * dd_s) <= r2 * dd;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

}  // namespace
