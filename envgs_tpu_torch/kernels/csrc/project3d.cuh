// The 3DGS EWA projection of one splat, forward and backward: the per-splat
// arithmetic of the kernels in project3d.cu, kept in a header of its own so
// that a host compiler can build it too (tests/test_torch_project3d.py holds
// it against the plain PyTorch version and its autograd on the CPU).
//
// The forward follows ops/project3d.py::project3d_torch operation for
// operation, in float32 and in its order: the library builds with
// -fmad=false, so every product and sum is rounded on its own, as the plain
// version's elementwise ops are. The plain version's batched 3x3 and 2x3
// products run in cuBLAS, which sums each 3-term dot product with fused
// multiply-adds, k ascending; dot3 does the same. rsqrt is the plain
// version's torch.rsqrt (rsqrtf on the card, 1 / sqrtf on the host, as
// torch's CPU rsqrt). So on the card the forward equals the plain version
// to the bit wherever the plain version's reductions take the order
// written here. The backward is autograd's chain rule through the same
// ops, each at autograd's convention: clamp passes the gradient where
// lo <= x <= hi, where() to the branch taken, sqrt divides by twice the
// result, a quotient's divisor gets -g * ((x / y) / y).
#pragma once
#include <math.h>

#ifdef __CUDACC__
#define P3D_FN __host__ __device__ __forceinline__
#else
#define P3D_FN static inline
#endif

namespace p3d {

constexpr float NEAR_PLANE = 0.2f;      // ops/common.py
constexpr float ROWCULL_LEVEL = 11.15f;  // ops/common.py
constexpr float CUTOFF = 3.0f;           // 3-sigma extents
constexpr float FRUSTUM = 1.3f;          // the Jacobian's clamp, x half-FOV
constexpr float TZ_MIN = 1e-6f;
constexpr float QUAT_EPS2 = 1e-16f;  // utils/transforms.py::normalize's eps^2
constexpr float DET_MIN = 1e-30f;    // the opacity factors' clamped divisors
constexpr float LAM_FLOOR = 0.1f;
// the camera as the kernels read it: R (9), T (3), K (9), pix_from_world
// (12), row-major
constexpr int CAM_FLOATS = 33;

P3D_FN float rsqrt_(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// torch.clamp: NaN passes through
P3D_FN float clamp_min(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}
P3D_FN float clamp2(float x, float lo, float hi) {
  return x != x ? x : (x < lo ? lo : (x > hi ? hi : x));
}
// clamp's gradient mask
P3D_FN float pass2(float g, float x, float lo, float hi) {
  return (x >= lo && x <= hi) ? g : 0.0f;
}
P3D_FN float where_small(float x, float tiny, float repl) {
  return fabsf(x) < tiny ? repl : x;
}
P3D_FN float sign_(float x) { return (float)((0.0f < x) - (x < 0.0f)); }

// a0 b0 + a1 b1 + a2 b2 as cuBLAS sums it
P3D_FN float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

struct Cam {
  float R[9], T[3], fx, fy, Mp[12], lim_x, lim_y;
  int W, H;
};

P3D_FN Cam load_cam(const float* c, int W, int H) {
  Cam k;
#pragma unroll
  for (int i = 0; i < 9; ++i) k.R[i] = c[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) k.T[i] = c[9 + i];
  k.fx = c[12];
  k.fy = c[16];
#pragma unroll
  for (int i = 0; i < 12; ++i) k.Mp[i] = c[21 + i];
  // 1.3 * (0.5 * W / fx): the Python scalar over a tensor is the tensor's
  // reciprocal times the scalar
  k.lim_x = (1.0f / k.fx) * (float)(0.5 * W) * FRUSTUM;
  k.lim_y = (1.0f / k.fy) * (float)(0.5 * H) * FRUSTUM;
  k.W = W;
  k.H = H;
  return k;
}

// Everything the backward needs of the forward, recomputed from the inputs.
struct Fwd {
  float rs, qn[4], R[9], S[3], M[9], cov3[9];
  float sq1;  // the 3D filter's opacity factor
  float t[3], tz, ux, uy, uxc, uyc, txc, tyc, J00, J02, J11, J12;
  float JW[6], A[6], c00, c01, c11, a, b, c, det, ds, conic[3];
  float ph[3], ws, center[2];
};

// Forward up to the conic and the center. has_f: the mip 3D filter of std f.
P3D_FN void forward(const Cam& k, const float* m, const float* q,
                    const float* s, float sm, float lp, bool has_f, float f,
                    Fwd& o) {
  // quat_to_rotmat(normalize(q)); |q|^2 summed in the order torch's sum
  // of a row of four takes (each order measured bit for bit: on the card,
  // torch 2.11; on the host's CPU a left fold)
  const float q00 = q[0] * q[0], q11 = q[1] * q[1], q22 = q[2] * q[2],
              q33 = q[3] * q[3];
#ifdef __CUDA_ARCH__
  const float n2 = (q00 + q22) + (q11 + q33);
#else
  const float n2 = q00 + q11 + q22 + q33;
#endif
  o.rs = rsqrt_(n2 + QUAT_EPS2);
#pragma unroll
  for (int i = 0; i < 4; ++i) o.qn[i] = q[i] * o.rs;
  const float w = o.qn[0], x = o.qn[1], y = o.qn[2], z = o.qn[3];
  o.R[0] = 1.0f - 2.0f * (y * y + z * z);
  o.R[1] = 2.0f * (x * y - w * z);
  o.R[2] = 2.0f * (x * z + w * y);
  o.R[3] = 2.0f * (x * y + w * z);
  o.R[4] = 1.0f - 2.0f * (x * x + z * z);
  o.R[5] = 2.0f * (y * z - w * x);
  o.R[6] = 2.0f * (x * z - w * y);
  o.R[7] = 2.0f * (y * z + w * x);
  o.R[8] = 1.0f - 2.0f * (x * x + y * y);
  // M = R diag(S), cov3 = M M^T
#pragma unroll
  for (int j = 0; j < 3; ++j) o.S[j] = s[j] * sm;
#pragma unroll
  for (int i = 0; i < 9; ++i) o.M[i] = o.R[i] * o.S[i % 3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.cov3[3 * i + j] = dot3(o.M[3 * i], o.M[3 * j], o.M[3 * i + 1],
                               o.M[3 * j + 1], o.M[3 * i + 2], o.M[3 * j + 2]);
  o.sq1 = 1.0f;
  if (has_f) {
    const float f2 = f * f;
    const float p = o.S[0] * o.S[1] * o.S[2];
    const float u0 = o.S[0] * o.S[0] + f2, u1 = o.S[1] * o.S[1] + f2,
                u2 = o.S[2] * o.S[2] + f2;
    const float r1 = (p * p) / clamp_min(u0 * u1 * u2, DET_MIN);
    o.sq1 = sqrtf(clamp2(r1, 0.0f, 1.0f));
    o.cov3[0] = o.cov3[0] + f2;
    o.cov3[4] = o.cov3[4] + f2;
    o.cov3[8] = o.cov3[8] + f2;
  }
  // view-space center, frustum-clamped for the Jacobian
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o.t[i] = dot3(m[0], k.R[3 * i], m[1], k.R[3 * i + 1], m[2],
                  k.R[3 * i + 2]) + k.T[i];
  o.tz = clamp_min(o.t[2], TZ_MIN);
  o.ux = o.t[0] / o.tz;
  o.uy = o.t[1] / o.tz;
  o.uxc = clamp2(o.ux, -k.lim_x, k.lim_x);
  o.uyc = clamp2(o.uy, -k.lim_y, k.lim_y);
  o.txc = o.uxc * o.tz;
  o.tyc = o.uyc * o.tz;
  const float tz2 = o.tz * o.tz;
  o.J00 = k.fx / o.tz;
  o.J02 = (-k.fx * o.txc) / tz2;
  o.J11 = k.fy / o.tz;
  o.J12 = (-k.fy * o.tyc) / tz2;
  // JW = J R_cam (J's zeros kept: the product sums them as cuBLAS does)
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o.JW[j] = dot3(o.J00, k.R[j], 0.0f, k.R[3 + j], o.J02, k.R[6 + j]);
    o.JW[3 + j] = dot3(0.0f, k.R[j], o.J11, k.R[3 + j], o.J12, k.R[6 + j]);
  }
  // cov2 = (JW cov3) JW^T
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.A[3 * i + j] = dot3(o.JW[3 * i], o.cov3[j], o.JW[3 * i + 1],
                            o.cov3[3 + j], o.JW[3 * i + 2], o.cov3[6 + j]);
  o.c00 = dot3(o.A[0], o.JW[0], o.A[1], o.JW[1], o.A[2], o.JW[2]);
  o.c01 = dot3(o.A[0], o.JW[3], o.A[1], o.JW[4], o.A[2], o.JW[5]);
  o.c11 = dot3(o.A[3], o.JW[3], o.A[4], o.JW[4], o.A[5], o.JW[5]);
  o.a = o.c00 + lp;
  o.b = o.c01;
  o.c = o.c11 + lp;
  o.det = o.a * o.c - o.b * o.b;
  o.ds = o.det <= 0.0f ? 1.0f : o.det;
  o.conic[0] = o.c / o.ds;
  o.conic[1] = -o.b / o.ds;
  o.conic[2] = o.a / o.ds;
  // the projected center
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o.ph[i] = dot3(m[0], k.Mp[4 * i], m[1], k.Mp[4 * i + 1], m[2],
                   k.Mp[4 * i + 2]) + k.Mp[4 * i + 3];
  o.ws = o.ph[2] == 0.0f ? 1.0f : o.ph[2];
  o.center[0] = o.ph[0] / o.ws;
  o.center[1] = o.ph[1] / o.ws;
}

// The 2D filter's opacity compensation sqrt(clamp(det2 / det2_dilated, 0, 1))
// and its pieces.
struct Comp {
  float raw, dd, ratio, sq2;
};

P3D_FN Comp compensation(const Fwd& o) {
  Comp c;
  c.raw = o.c00 * o.c11 - o.c01 * o.c01;
  c.dd = clamp_min(o.det, DET_MIN);
  c.ratio = clamp_min(c.raw, 0.0f) / c.dd;
  c.sq2 = sqrtf(clamp2(c.ratio, 0.0f, 1.0f));
  return c;
}

// The outputs that are not the conic or the center: radius, extents,
// validity, the row-cull parameters (ops/common.py::rowcull_params).
struct Rest {
  float radius, ext[2], rowcull[6];
  bool valid;
};

P3D_FN Rest rest(const Cam& k, const Fwd& o, bool active) {
  Rest r;
  const float mid = 0.5f * (o.a + o.c);
  const float lam = mid + sqrtf(clamp_min(mid * mid - o.det, LAM_FLOOR));
  const float radius = ceilf(CUTOFF * sqrtf(lam));
  const float bx = ceilf(CUTOFF * sqrtf(clamp_min(o.a, 0.0f)));
  const float by = ceilf(CUTOFF * sqrtf(clamp_min(o.c, 0.0f)));
  const float cx = o.center[0], cy = o.center[1];
  const bool in_img = (cx + radius >= 0.0f)
                      && (cx - radius <= (float)(k.W - 1))
                      && (cy + radius >= 0.0f)
                      && (cy - radius <= (float)(k.H - 1));
  r.valid = (o.t[2] > NEAR_PLANE) && (o.det > 0.0f) && active && in_img;
  r.radius = r.valid ? radius : 0.0f;
  const float v = r.valid ? 1.0f : 0.0f;
  r.ext[0] = bx * v;
  r.ext[1] = by * v;
  const float An = o.conic[0], Bn = o.conic[1], Cn = o.conic[2];
  const float An_s = where_small(An, 1e-12f, 1e-12f);
  const float sa = Bn / An_s;
  const float p1 = (Bn * Bn - An * Cn) / (An_s * An_s);
  const float p2 = ROWCULL_LEVEL / An_s;
  const float p1_s = where_small(p1, 1e-12f, -1e-12f);
  const float denom = p1_s * (p1_s - sa * sa);
  const float dy_t2 = sa * sa * p2 / where_small(denom, 1e-20f, 1e-20f);
  r.rowcull[0] = cx;
  r.rowcull[1] = cy;
  r.rowcull[2] = sa;
  r.rowcull[3] = p1;
  r.rowcull[4] = p2;
  r.rowcull[5] = -sign_(sa) * sqrtf(clamp_min(dy_t2, 0.0f));
  return r;
}

// The backward of one splat: cotangents of the conic (gc), the center (gp),
// the depth (gd) and, where has_go, of the opacity the filters changed (go)
// -> gradients of the mean (dm), quaternion (dq), activated scales (dsc) and
// opacity (*dop, written where has_go).
P3D_FN void backward(const Cam& k, const float* m, const float* q,
                     const float* s, float op, float sm, float lp, bool has_f,
                     float f, bool comp, const float* gc, const float* gp,
                     float gd, bool has_go, float go, float* dm, float* dq,
                     float* dsc, float* dop) {
  Fwd o;
  forward(k, m, q, s, sm, lp, has_f, f, o);

  // conic = (c, -b, a) / ds
  float g_ds = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) g_ds += -gc[i] * (o.conic[i] / o.ds);
  float g_c = gc[0] / o.ds, g_b = -(gc[1] / o.ds), g_a = gc[2] / o.ds;
  float g_det = o.det <= 0.0f ? 0.0f : g_ds;
  float g00 = 0.0f, g01 = 0.0f, g11 = 0.0f;  // of cov2's used entries

  // the opacity: op1 = op * sq1 (3D filter), op2 = op1 * sq2 (compensation)
  float g_op = 0.0f, g_sq1 = 0.0f;
  if (has_go) {
    float g_op1 = go;
    if (comp) {
      const Comp cp = compensation(o);
      const float op1 = op * o.sq1;
      g_op1 = go * cp.sq2;
      const float g_cl = (go * op1) / (2.0f * cp.sq2);
      const float g_ratio = pass2(g_cl, cp.ratio, 0.0f, 1.0f);
      const float g_dd = -g_ratio * (cp.ratio / cp.dd);
      g_det += o.det >= DET_MIN ? g_dd : 0.0f;
      const float g_raw = cp.raw >= 0.0f ? g_ratio / cp.dd : 0.0f;
      g00 += g_raw * o.c11;
      g11 += g_raw * o.c00;
      g01 += -(g_raw * (2.0f * o.c01));
    }
    g_op = has_f ? g_op1 * o.sq1 : g_op1;
    g_sq1 = g_op1 * op;
  }

  // det = a c - b b; a = c00 + lp, b = c01, c = c11 + lp
  g_a += g_det * o.c;
  g_c += g_det * o.a;
  g_b += -(g_det * o.b + g_det * o.b);
  g00 += g_a;
  g01 += g_b;
  g11 += g_c;

  // cov2 = A JW^T with A = JW cov3; G = [[g00, g01], [0, g11]]
  float gA[6], gJW[6];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gA[j] = g00 * o.JW[j] + g01 * o.JW[3 + j];  // (G JW)_0j
    gA[3 + j] = g11 * o.JW[3 + j];              // (G JW)_1j
    gJW[j] = g00 * o.A[j];                      // (G^T A)_0j
    gJW[3 + j] = g01 * o.A[j] + g11 * o.A[3 + j];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int kk = 0; kk < 3; ++kk)  // += gA cov3^T
      gJW[3 * i + kk] += dot3(gA[3 * i], o.cov3[3 * kk], gA[3 * i + 1],
                              o.cov3[3 * kk + 1], gA[3 * i + 2],
                              o.cov3[3 * kk + 2]);
  float gcov[9];  // JW^T gA
#pragma unroll
  for (int kk = 0; kk < 3; ++kk)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      gcov[3 * kk + j] = o.JW[kk] * gA[j] + o.JW[3 + kk] * gA[3 + j];

  // cov3 = M M^T (+ f^2 I): gM = (gcov + gcov^T) M
  float gS[3] = {0.0f, 0.0f, 0.0f}, gR[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float gM = dot3(gcov[3 * i], o.M[j], gcov[3 * i + 1], o.M[3 + j],
                            gcov[3 * i + 2], o.M[6 + j])
                       + dot3(gcov[i], o.M[j], gcov[3 + i], o.M[3 + j],
                              gcov[6 + i], o.M[6 + j]);
      gR[3 * i + j] = gM * o.S[j];
      gS[j] += gM * o.R[3 * i + j];
    }
  if (has_f && has_go) {
    // sq1 = sqrt(clamp(p^2 / clamp(u0 u1 u2, 1e-30), 0, 1)), p = S0 S1 S2,
    // u = S^2 + f^2
    const float f2 = f * f;
    const float s01 = o.S[0] * o.S[1];
    const float p = s01 * o.S[2];
    const float u0 = o.S[0] * o.S[0] + f2, u1 = o.S[1] * o.S[1] + f2,
                u2 = o.S[2] * o.S[2] + f2;
    const float dflt = u0 * u1 * u2;
    const float dfc = clamp_min(dflt, DET_MIN);
    const float r1 = (p * p) / dfc;
    const float g_r1 = pass2(g_sq1 / (2.0f * o.sq1), r1, 0.0f, 1.0f);
    const float g_p = (g_r1 / dfc) * (2.0f * p);
    const float g_dflt = dflt >= DET_MIN ? -g_r1 * (r1 / dfc) : 0.0f;
    // the product's gradient: the other two factors
    gS[0] += (g_dflt * (u1 * u2)) * (2.0f * o.S[0]);
    gS[1] += (g_dflt * (u0 * u2)) * (2.0f * o.S[1]);
    gS[2] += (g_dflt * (u0 * u1)) * (2.0f * o.S[2]);
    gS[2] += g_p * s01;
    gS[0] += (g_p * o.S[2]) * o.S[1];
    gS[1] += (g_p * o.S[2]) * o.S[0];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) dsc[j] = gS[j] * sm;

  // R(qn), then qn = q * rsqrt(|q|^2 + eps^2)
  const float w = o.qn[0], x = o.qn[1], y = o.qn[2], z = o.qn[3];
  float gq[4];
  gq[0] = 2.0f * (-z * gR[1] + y * gR[2] + z * gR[3] - x * gR[5]
                  - y * gR[6] + x * gR[7]);
  gq[1] = 2.0f * (y * gR[1] + z * gR[2] + y * gR[3] - 2.0f * x * gR[4]
                  - w * gR[5] + z * gR[6] + w * gR[7] - 2.0f * x * gR[8]);
  gq[2] = 2.0f * (-2.0f * y * gR[0] + x * gR[1] + w * gR[2] + x * gR[3]
                  + z * gR[5] - w * gR[6] + z * gR[7] - 2.0f * y * gR[8]);
  gq[3] = 2.0f * (-2.0f * z * gR[0] - w * gR[1] + x * gR[2] + w * gR[3]
                  - 2.0f * z * gR[4] + y * gR[5] + x * gR[6] + y * gR[7]);
  const float g_rs = gq[0] * q[0] + gq[1] * q[1] + gq[2] * q[2]
                     + gq[3] * q[3];
  const float g_n2 = (-0.5f * g_rs) * (o.rs * o.rs * o.rs);
#pragma unroll
  for (int i = 0; i < 4; ++i) dq[i] = gq[i] * o.rs + 2.0f * q[i] * g_n2;

  // JW = J R_cam: gJ = gJW R_cam^T (J's four non-zero entries)
  const float gJ00 = dot3(gJW[0], k.R[0], gJW[1], k.R[1], gJW[2], k.R[2]);
  const float gJ02 = dot3(gJW[0], k.R[6], gJW[1], k.R[7], gJW[2], k.R[8]);
  const float gJ11 = dot3(gJW[3], k.R[3], gJW[4], k.R[4], gJW[5], k.R[5]);
  const float gJ12 = dot3(gJW[3], k.R[6], gJW[4], k.R[7], gJW[5], k.R[8]);
  const float tz2 = o.tz * o.tz;
  float g_tz = -gJ00 * (o.J00 / o.tz) - gJ11 * (o.J11 / o.tz);
  // J02 = (-fx txc) / tz^2
  const float g_tz2 = -gJ02 * (o.J02 / tz2) - gJ12 * (o.J12 / tz2);
  g_tz += g_tz2 * o.tz + g_tz2 * o.tz;
  const float g_txc = (gJ02 / tz2) * -k.fx;
  const float g_tyc = (gJ12 / tz2) * -k.fy;
  // txc = clamp(tx / tz, -lim, lim) * tz
  g_tz += g_txc * o.uxc + g_tyc * o.uyc;
  const float g_ux = pass2(g_txc * o.tz, o.ux, -k.lim_x, k.lim_x);
  const float g_uy = pass2(g_tyc * o.tz, o.uy, -k.lim_y, k.lim_y);
  g_tz += -g_ux * (o.ux / o.tz) - g_uy * (o.uy / o.tz);
  float gt[3];
  gt[0] = g_ux / o.tz;
  gt[1] = g_uy / o.tz;
  gt[2] = gd + (o.t[2] >= TZ_MIN ? g_tz : 0.0f);
  // center = ph[:2] / where(ph[2] == 0, 1, ph[2])
  float gph[3];
  gph[0] = gp[0] / o.ws;
  gph[1] = gp[1] / o.ws;
  const float g_ws =
      -gp[0] * (o.center[0] / o.ws) - gp[1] * (o.center[1] / o.ws);
  gph[2] = o.ph[2] == 0.0f ? 0.0f : g_ws;
  // t = R_cam m + T, ph = Mp[:, :3] m + Mp[:, 3]
#pragma unroll
  for (int j = 0; j < 3; ++j)
    dm[j] = dot3(k.R[j], gt[0], k.R[3 + j], gt[1], k.R[6 + j], gt[2])
            + dot3(k.Mp[j], gph[0], k.Mp[4 + j], gph[1], k.Mp[8 + j], gph[2]);
  if (has_go) *dop = g_op;
}

}  // namespace p3d
