// Kernel K4: backward of the per-tile traced surfel blend (K3, training).
//
// Replaces: envgs_tpu/ops/tracer.py::_bwd_kernel (Pallas, TPU) with
// emit_wet on, together with the pair-gradient transpose that follows it
// there (ops/segsum.gather_transpose): the TPU kernel writes one
// (slots, 128) gradient row per slot and a segmented scan sums them per
// splat; here each slot's gradient row is summed over the tile's rays
// inside the block and added into its splat's row of the (P+1, 32) table
// gradient with atomicAdd. The per-ray gradients of the ray origin and
// direction (the reflected-ray chain into the base pass) are written by
// the thread that owns the ray, once, with no atomics.
//
// What bounds it on the card: arithmetic and the per-slot reductions. Every
// (candidate, ray) of a tile up to the last contributor is evaluated again
// (the ray-plane intersection, a logf/expf pair and the chain into mean,
// tangents, normal and the ray, some 200 fp32 operations), and each slot's
// up to 19 gradient columns are summed over 256 threads.
//
// Design: one block per 16x16 ray tile, one thread per ray, the ray in
// registers. The block walks the tile's 64-slot chunks in reverse from the
// last chunk holding a contributor of any ray (the JAX kernel's
// nchunks_eff), staging each chunk's table rows in shared memory; each
// thread keeps the JAX kernel's suffix accumulators in registers and walks
// the chunk's candidates in reverse (T before a candidate is T_fin *
// exp(-suffix sum of log(1-a)), over the set amask & (rank <= last)). A
// warp with no contributing ray for a candidate skips it (all its updates
// are exactly zero); otherwise it sums each column with shuffles into a
// shared (64, 20) block, flushed with one atomicAdd per non-zero entry
// after the chunk. The per-slot wet goes to column 31. Atomics make the
// order of the float sums vary from run to run. Built with -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NRAY = TILE * TILE;
constexpr int CHUNK = 64;
constexpr int LO = 32;  // packed row width
constexpr int MAXA = 2;
constexpr int NCOL = 20;  // staged columns: 16 + A (<= 18), wet at NCOL - 1
constexpr int WET_COL = LO - 1;
constexpr unsigned FULL = 0xffffffffu;
// packed columns (ops/trace_blend.py)
constexpr int C_MEAN = 0, C_TU = 3, C_TV = 6, C_N = 9, C_OPAC = 12,
              C_COLOR = 13, C_AUX = 16;
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_CUTOFF = (float)1e-4;
constexpr float T_MIN = (float)1e-4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(NRAY)
trace_blend_bwd_kernel(const float* __restrict__ packed, int n_rows,
                       const int32_t* __restrict__ gauss_idx, int n_idx,
                       const float* __restrict__ rays,
                       const int32_t* __restrict__ bounds, int tiles_x,
                       int tiles_y, int A, const float* __restrict__ fwd,
                       const float* __restrict__ gout,
                       float* __restrict__ gpacked,
                       float* __restrict__ grays) {
  __shared__ float rows[CHUNK][LO];
  __shared__ float acc[CHUNK][NCOL];
  __shared__ int gid[CHUNK];
  __shared__ int lastmax;
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ray = rays + (size_t)t * 8 * NRAY + lane;
  const float ox = ray[0], oy = ray[NRAY], oz = ray[2 * NRAY];
  const float dx = ray[3 * NRAY], dy = ray[4 * NRAY], dz = ray[5 * NRAY];
  const int tx = t % tiles_x, ty = t / tiles_x;
  const int out_w = tiles_x * TILE;
  const size_t plane = (size_t)tiles_y * TILE * out_w;
  const size_t pix = (size_t)(ty * TILE + lane / TILE) * out_w
                     + tx * TILE + lane % TILE;
  // JAX row order: rgb, dpt, acc, normal(3), dist, aux(A), T, D1, D2, last
  const int R_DPT = 3, R_ACC = 4, R_NRM = 5, R_DIST = 8, R_AUX = 9,
            R_TRANS = 9 + A, R_D1 = 10 + A, R_D2 = 11 + A, R_LAST = 12 + A;
  const float A_tot = fwd[R_ACC * plane + pix];
  const float D1_tot = fwd[R_D1 * plane + pix];
  const float D2_tot = fwd[R_D2 * plane + pix];
  const float T_fin = fwd[R_TRANS * plane + pix];
  const float last = fwd[R_LAST * plane + pix];
  const float g_trans = gout[R_TRANS * plane + pix];
  const float g_dpt = gout[R_DPT * plane + pix];
  const float g_acc = gout[R_ACC * plane + pix];
  const float g_dist = gout[R_DIST * plane + pix];
  const float g_c0 = gout[pix], g_c1 = gout[plane + pix],
              g_c2 = gout[2 * plane + pix];
  const float g_n0 = gout[R_NRM * plane + pix];
  const float g_n1 = gout[(R_NRM + 1) * plane + pix];
  const float g_n2 = gout[(R_NRM + 2) * plane + pix];
  float g_aux[MAXA];
#pragma unroll
  for (int i = 0; i < MAXA; ++i)
    g_aux[i] = i < A ? gout[(R_AUX + i) * plane + pix] : 0.f;

  if (lane == 0) lastmax = -1;
  __syncthreads();
  atomicMax(&lastmax, (int)last);
  __syncthreads();
  const int start = bounds[t], end = bounds[t + 1];
  const int nchunks = (end - start) / CHUNK;
  const int neff = max(0, min(nchunks, (lastmax + CHUNK) / CHUNK));
  const int ncols = 16 + A;

  float g_ox = 0.f, g_oy = 0.f, g_oz = 0.f, g_dx = 0.f, g_dy = 0.f,
        g_dz = 0.f;
  float tcur = T_fin;
  float suf0 = 0.f, suf1 = 0.f, suf2 = 0.f, suf3 = 0.f;
  for (int ch = neff - 1; ch >= 0; --ch) {
    const int base = start + ch * CHUNK;
    for (int e = lane; e < CHUNK * LO; e += NRAY) {
      const int r = e / LO, k = e % LO;
      const int i = base + r;
      float val = 0.f;
      if (i < end && i < n_idx) {
        const int g = gauss_idx[i];
        if (g >= 0 && g < n_rows) val = packed[(size_t)g * LO + k];
      }
      rows[r][k] = val;
    }
    for (int e = lane; e < CHUNK * NCOL; e += NRAY) (&acc[0][0])[e] = 0.f;
    if (lane < CHUNK) {
      const int i = base + lane;
      gid[lane] = (i < end && i < n_idx) ? gauss_idx[i] : -1;
    }
    __syncthreads();

    float s_log = 0.f, sw = 0.f, sm = 0.f, sm2 = 0.f, sgw = 0.f;
    for (int j = CHUNK - 1; j >= 0; --j) {
      const float* d = rows[j];
      const float cx = d[C_MEAN], cy = d[C_MEAN + 1], cz = d[C_MEAN + 2];
      const float nx = d[C_N], ny = d[C_N + 1], nz = d[C_N + 2];
      const float dn0 = dx * nx + dy * ny + dz * nz;
      const float dn = fabsf(dn0) < 1e-9f ? 1e-9f : dn0;
      const float num = (cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz;
      const float tt = num / dn;
      const float ex = ox + tt * dx - cx;
      const float ey = oy + tt * dy - cy;
      const float ez = oz + tt * dz - cz;
      const float tux = d[C_TU], tuy = d[C_TU + 1], tuz = d[C_TU + 2];
      const float tvx = d[C_TV], tvy = d[C_TV + 1], tvz = d[C_TV + 2];
      const float u = ex * tux + ey * tuy + ez * tuz;
      const float v = ex * tvx + ey * tvy + ez * tvz;
      const float rho = u * u + v * v;
      const float G = expf(-0.5f * rho);
      const float oG = d[C_OPAC] * G;
      const float a_raw = fminf(oG, ALPHA_MAX);
      const bool contrib = a_raw >= ALPHA_MIN && tt > T_MIN
                           && fabsf(dn0) >= 1e-9f
                           && (float)(ch * CHUNK + j) <= last;
      if (!__any_sync(FULL, contrib)) continue;

      float v_out[NCOL];
#pragma unroll
      for (int k = 0; k < NCOL; ++k) v_out[k] = 0.f;
      if (contrib) {
        const float a = a_raw;
        const float om = 1.f - a;
        const float flip = dn0 > 0.f ? -1.f : 1.f;
        s_log += log1pf(-a);
        const float T_bef = tcur * expf(-s_log);
        const float w = a * T_bef;
        const float m = tt / (1.f + fabsf(tt));
        const float wm = w * m;
        const float wm2 = wm * m;
        sw += w;
        sm += wm;
        sm2 += wm2;
        const float A_suf = suf0 + sw - w;
        const float D1_suf = suf1 + sm - wm;
        const float D2_suf = suf2 + sm2 - wm2;
        const float A_pre = A_tot - suf0 - sw;
        const float D1_pre = D1_tot - suf1 - sm;
        const float D2_pre = D2_tot - suf2 - sm2;

        float g_w = g_acc + g_dpt * tt;
        g_w = g_w + g_c0 * d[C_COLOR];
        g_w = g_w + g_n0 * (nx * flip);
        g_w = g_w + g_c1 * d[C_COLOR + 1];
        g_w = g_w + g_n1 * (ny * flip);
        g_w = g_w + g_c2 * d[C_COLOR + 2];
        g_w = g_w + g_n2 * (nz * flip);
#pragma unroll
        for (int i = 0; i < MAXA; ++i)
          if (i < A) g_w = g_w + g_aux[i] * d[C_AUX + i];
        g_w = g_w + g_dist * (m * m * (A_pre + A_suf) + (D2_pre + D2_suf)
                              - 2.f * m * (D1_pre + D1_suf));
        const float gww = g_w * w;
        sgw += gww;
        const float S_gw = suf3 + sgw - gww;
        const float g_a = g_w * T_bef - (S_gw + g_trans * T_fin) / om;
        const float g_m = g_dist * 2.f * (m * (A_pre + A_suf)
                                          - (D1_pre + D1_suf)) * w;
        const float at1 = 1.f + fabsf(tt);
        const float dm_dt = 1.f / (at1 * at1);
        float g_t = w * g_dpt + g_m * dm_dt;

        const bool clampm = oG < ALPHA_MAX;
        const float g_G = clampm ? g_a * d[C_OPAC] : 0.f;
        const float g_opac = clampm ? g_a * G : 0.f;
        const float g_rho = -0.5f * G * g_G;
        const float g_u = 2.f * u * g_rho;
        const float g_v = 2.f * v * g_rho;
        const float g_ex = g_u * tux + g_v * tvx;
        const float g_ey = g_u * tuy + g_v * tvy;
        const float g_ez = g_u * tuz + g_v * tvz;
        g_t = g_t + g_ex * dx + g_ey * dy + g_ez * dz;
        const float g_nx = g_t * ((cx - ox) - tt * dx) / dn
                           + g_n0 * flip * w;
        const float g_ny = g_t * ((cy - oy) - tt * dy) / dn
                           + g_n1 * flip * w;
        const float g_nz = g_t * ((cz - oz) - tt * dz) / dn
                           + g_n2 * flip * w;
        const float gtn_x = g_t * nx / dn;
        const float gtn_y = g_t * ny / dn;
        const float gtn_z = g_t * nz / dn;
        v_out[0] = -g_ex + gtn_x;
        v_out[1] = -g_ey + gtn_y;
        v_out[2] = -g_ez + gtn_z;
        v_out[3] = g_u * ex;
        v_out[4] = g_u * ey;
        v_out[5] = g_u * ez;
        v_out[6] = g_v * ex;
        v_out[7] = g_v * ey;
        v_out[8] = g_v * ez;
        v_out[9] = g_nx;
        v_out[10] = g_ny;
        v_out[11] = g_nz;
        v_out[12] = g_opac;
        v_out[13] = g_c0 * w;
        v_out[14] = g_c1 * w;
        v_out[15] = g_c2 * w;
#pragma unroll
        for (int i = 0; i < MAXA; ++i)
          if (i < A) v_out[16 + i] = g_aux[i] * w;
        v_out[NCOL - 1] = T_bef * om >= T_CUTOFF ? w : 0.f;
        // the ray: o enters e directly and t through (c - o).n; d enters e
        // through t d and t through d.n
        const float gtt_x = g_t * tt * nx / dn;
        const float gtt_y = g_t * tt * ny / dn;
        const float gtt_z = g_t * tt * nz / dn;
        g_ox += g_ex - gtn_x;
        g_oy += g_ey - gtn_y;
        g_oz += g_ez - gtn_z;
        g_dx += g_ex * tt - gtt_x;
        g_dy += g_ey * tt - gtt_y;
        g_dz += g_ez * tt - gtt_z;
      }
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        if (k >= ncols && k < NCOL - 1) continue;
        const float sum = warp_sum(v_out[k]);
        if ((lane & 31) == 0 && sum != 0.f) atomicAdd(&acc[j][k], sum);
      }
    }
    __syncthreads();
    for (int e = lane; e < CHUNK * NCOL; e += NRAY) {
      const int j = e / NCOL, k = e % NCOL;
      const float val = acc[j][k];
      const int g = gid[j];
      if (val != 0.f && g >= 0 && g < n_rows) {
        const int col = k == NCOL - 1 ? WET_COL : k;
        atomicAdd(&gpacked[(size_t)g * LO + col], val);
      }
    }
    suf0 += sw;
    suf1 += sm;
    suf2 += sm2;
    suf3 += sgw;
    tcur = tcur * expf(-s_log);
    __syncthreads();  // before the next chunk overwrites rows / acc / gid
  }
  float* gr = grays + (size_t)t * 8 * NRAY + lane;
  gr[0] = g_ox;
  gr[NRAY] = g_oy;
  gr[2 * NRAY] = g_oz;
  gr[3 * NRAY] = g_dx;
  gr[4 * NRAY] = g_dy;
  gr[5 * NRAY] = g_dz;
  gr[6 * NRAY] = 0.f;
  gr[7 * NRAY] = 0.f;
}

}  // namespace

// Launches K4 on `stream`; returns cudaGetLastError() (0 = launched).
// fwd, gout: (13 + A, tiles_y*16, tiles_x*16) f32 training planes and their
// cotangents; gpacked: (n_rows, 32) f32, zeroed by the caller, receives the
// table gradient with the per-splat wet in column 31; grays: (T, 8, 256)
// f32, every element written.
extern "C" int trace_blend_bwd(const float* packed, int n_rows,
                               const int32_t* gauss_idx, int n_idx,
                               const float* rays, const int32_t* bounds,
                               int tiles_x, int tiles_y, int A,
                               const float* fwd, const float* gout,
                               float* gpacked, float* grays, void* stream) {
  trace_blend_bwd_kernel<<<tiles_x * tiles_y, NRAY, 0,
                           (cudaStream_t)stream>>>(
      packed, n_rows, gauss_idx, n_idx, rays, bounds, tiles_x, tiles_y, A,
      fwd, gout, gpacked, grays);
  return (int)cudaGetLastError();
}
