// Kernel K2: backward of the per-tile blend (K1, training mode) of 2DGS
// surfels or 3DGS Gaussians.
//
// Replaces: envgs_tpu/ops/raster_pallas.py::_bwd_kernel (Pallas, TPU) with
// emit_wet on, in both geometries (a compile-time MODE here: the surfel
// chain into the 3x3 screen transform, or the gauss3d chain into the conic,
// the view depth and the center), together with the pair-gradient
// transpose that follows it there (ops/segsum.presort_transpose): the TPU
// kernel writes one (pairs, 128) gradient row per pair and a segmented
// scan sums them per splat; here each pair's gradient row is summed over
// the tile's pixels inside the block and added into its splat's row of the
// (P+1, 32) table gradient with atomicAdd, and no per-pair array exists.
//
// What bounds it on the card: arithmetic and the per-pair reductions. Every
// (pair, pixel) of a tile up to the last contributor is evaluated again
// (the forward geometry, a logf/expf pair and the chain into the screen
// transform or the conic, some 200 (150) fp32 operations), and each pair's
// up to 23 gradient columns are summed over 256 threads.
//
// Design: one block per 16x16 tile, one thread per pixel. The block walks
// the tile's 64-pair chunks in reverse, starting at the last chunk that
// holds a contributor of any pixel (the JAX kernel's nchunks_eff), staging
// each chunk's table rows in shared memory. Each thread keeps the JAX
// kernel's suffix accumulators (sum of log(1-a), w, w m, w m^2, g_w w) in
// registers and walks the chunk's pairs in reverse, so T before a pair is
// T_fin * exp(-suffix sum of log(1-a)) as in the JAX kernel, over the same
// contributing set amask & (rank <= last). A warp whose pixels have no
// contribution from a pair skips it: every gradient and accumulator update
// of a non-contributing pixel is exactly zero. Otherwise the warp sums each
// gradient column with shuffles and one lane adds the sums into a
// shared-memory (64, 24) block; after the chunk, the block adds each
// non-zero entry into the table gradient with one atomicAdd. The per-pair
// wet (the pair's w where the forward's own test T_bef (1 - a) >= 1e-4
// passes) goes to column 31. Atomics make the order of the float sums vary
// from run to run. Built with -fmad=false, as K1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int CHUNK = 64;
constexpr int LO = 32;  // packed row width
constexpr int MAXC = 7;
constexpr int NCOL = 24;  // staged columns: 15 + C (<= 22), wet at NCOL - 1
constexpr int WET_COL = LO - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SURFEL = 0, GAUSS3D = 1;  // geometry modes
// packed columns (ops/raster_blend.py)
constexpr int C_CX = 9, C_CY = 10, C_OPAC = 11, C_NRM = 12, C_COLOR = 15;
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_CUTOFF = (float)1e-4;
constexpr float NEAR_PLANE = (float)0.2;
constexpr float FILTER_INV_SQUARE = 2.0f;
constexpr float FAR_PLANE = (float)100.0;
constexpr float FAR_M_NEAR = (float)(100.0 - 0.2);
constexpr float FAR_X_NEAR = (float)(100.0 * 0.2);

__device__ __forceinline__ float map_depth(float z) {
  const float zc = fmaxf(z, 1e-6f);
  return (FAR_PLANE * (zc - NEAR_PLANE)) / (FAR_M_NEAR * zc);
}

__device__ __forceinline__ float dmap_dz(float z) {
  const float zc = fmaxf(z, 1e-6f);
  return FAR_X_NEAR / (FAR_M_NEAR * zc * zc);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

template <int MODE>
__global__ void __launch_bounds__(NPIX)
raster_blend_bwd_kernel(const float* __restrict__ packed, int n_rows,
                        const int32_t* __restrict__ gauss_idx, int n_idx,
                        const int32_t* __restrict__ bounds, int C,
                        int tiles_x, int tiles_y, int row_off,
                        const float* __restrict__ fwd,
                        const float* __restrict__ gout,
                        float* __restrict__ gpacked) {
  __shared__ float rows[CHUNK][LO];
  __shared__ float acc[CHUNK][NCOL];
  __shared__ int gid[CHUNK];
  __shared__ int lastmax;
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tx = t % tiles_x, ty = t / tiles_x;
  const float px = (float)(tx * TILE + lane % TILE);
  const float py = (float)(ty * TILE + row_off + lane / TILE);
  const int out_w = tiles_x * TILE;
  const size_t plane = (size_t)tiles_y * TILE * out_w;
  const size_t pix = (size_t)(ty * TILE + lane / TILE) * out_w
                     + tx * TILE + lane % TILE;
  // JAX row order: colors, depth, alpha, normal(3), med, dist, T, D1, D2, last
  const int R_DEPTH = C, R_ALPHA = C + 1, R_NRM = C + 2, R_DIST = C + 6,
            R_TRANS = C + 7, R_D1 = C + 8, R_D2 = C + 9, R_LAST = C + 10;
  const float A_tot = fwd[R_ALPHA * plane + pix];
  const float D1_tot = fwd[R_D1 * plane + pix];
  const float D2_tot = fwd[R_D2 * plane + pix];
  const float T_fin = fwd[R_TRANS * plane + pix];
  const float last = fwd[R_LAST * plane + pix];
  const float g_trans = gout[R_TRANS * plane + pix];
  const float g_depth = gout[R_DEPTH * plane + pix];
  const float g_alpha = gout[R_ALPHA * plane + pix];
  const float g_dist = gout[R_DIST * plane + pix];
  const float g_d1 = gout[R_D1 * plane + pix];
  const float g_d2 = gout[R_D2 * plane + pix];
  float g_col[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) g_col[c] = c < C ? gout[c * plane + pix] : 0.f;
  const float g_n0 = gout[R_NRM * plane + pix];
  const float g_n1 = gout[(R_NRM + 1) * plane + pix];
  const float g_n2 = gout[(R_NRM + 2) * plane + pix];

  if (lane == 0) lastmax = -1;
  __syncthreads();
  atomicMax(&lastmax, (int)last);
  __syncthreads();
  const int start = bounds[t], end = bounds[t + 1];
  const int nchunks = (end - start) / CHUNK;
  const int neff = max(0, min(nchunks, (lastmax + CHUNK) / CHUNK));
  const int ncols = 15 + C;

  float tcur = T_fin;
  float suf0 = 0.f, suf1 = 0.f, suf2 = 0.f, suf3 = 0.f;
  for (int ch = neff - 1; ch >= 0; --ch) {
    const int base = start + ch * CHUNK;
    for (int e = lane; e < CHUNK * LO; e += NPIX) {
      const int r = e / LO, k = e % LO;
      const int i = base + r;
      float val = 0.f;
      if (i < end && i < n_idx) {
        const int g = gauss_idx[i];
        if (g >= 0 && g < n_rows) val = packed[(size_t)g * LO + k];
      }
      rows[r][k] = val;
    }
    for (int e = lane; e < CHUNK * NCOL; e += NPIX) (&acc[0][0])[e] = 0.f;
    if (lane < CHUNK) {
      const int i = base + lane;
      gid[lane] = (i < end && i < n_idx) ? gauss_idx[i] : -1;
    }
    __syncthreads();

    float s_log = 0.f, sw = 0.f, sm = 0.f, sm2 = 0.f, sgw = 0.f;
    for (int j = CHUNK - 1; j >= 0; --j) {
      const float* d = rows[j];
      const float t20 = d[6], t21 = d[7], t22 = d[8];
      const float dx = d[C_CX] - px;
      const float dy = d[C_CY] - py;
      // surfel intermediates (unused by gauss3d)
      float kx = 0.f, ky = 0.f, kz = 0.f, lx = 0.f, ly = 0.f, lz = 0.f;
      float qz = 1.f, u = 0.f, v = 0.f;
      bool b3 = false, amask;
      float z, G;
      if (MODE == GAUSS3D) {
        const float rho = d[0] * dx * dx + d[2] * dy * dy
                          + 2.f * d[1] * dx * dy;
        z = d[3];
        G = expf(-0.5f * fmaxf(rho, 0.f));
        amask = rho >= 0.f;
      } else {
        kx = d[0] - px * t20;
        ky = d[1] - px * t21;
        kz = d[2] - px * t22;
        lx = d[3] - py * t20;
        ly = d[4] - py * t21;
        lz = d[5] - py * t22;
        const float qx = ky * lz - kz * ly;
        const float qy = kz * lx - kx * lz;
        qz = kx * ly - ky * lx;
        if (fabsf(qz) < 1e-12f) qz = 1e-12f;
        u = qx / qz;
        v = qy / qz;
        const float rho3d = u * u + v * v;
        const float rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy);
        b3 = rho3d <= rho2d;
        const float rho = fminf(rho3d, rho2d);
        z = b3 ? u * t20 + v * t21 + t22 : t22;
        G = expf(-0.5f * rho);
        amask = true;
      }
      const float oG = d[C_OPAC] * G;
      const float a_raw = fminf(oG, ALPHA_MAX);
      const bool contrib = amask && a_raw >= ALPHA_MIN && z >= NEAR_PLANE
                           && (float)(ch * CHUNK + j) <= last;
      if (!__any_sync(FULL, contrib)) continue;

      float v_out[NCOL];
#pragma unroll
      for (int k = 0; k < NCOL; ++k) v_out[k] = 0.f;
      if (contrib) {
        const float a = a_raw;
        const float om = 1.f - a;
        s_log += log1pf(-a);
        const float T_bef = tcur * expf(-s_log);
        const float w = a * T_bef;
        const float m = map_depth(z);
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

        float g_w = g_alpha + g_depth * z + g_d1 * m + g_d2 * m * m;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) g_w = g_w + g_col[c] * d[C_COLOR + c];
        g_w = g_w + g_n0 * d[C_NRM];
        g_w = g_w + g_n1 * d[C_NRM + 1];
        g_w = g_w + g_n2 * d[C_NRM + 2];
        g_w = g_w + g_dist * (m * m * (A_pre + A_suf) + (D2_pre + D2_suf)
                              - 2.f * m * (D1_pre + D1_suf));
        const float gww = g_w * w;
        sgw += gww;
        const float S_gw = suf3 + sgw - gww;
        const float g_a = g_w * T_bef - (S_gw + g_trans * T_fin) / om;
        const float g_m = g_dist * 2.f * (m * (A_pre + A_suf)
                                          - (D1_pre + D1_suf)) * w
                          + (g_d1 + 2.f * g_d2 * m) * w;
        const float g_z = w * g_depth + g_m * dmap_dz(z);

        const bool clampm = oG < ALPHA_MAX;
        const float g_G = clampm ? g_a * d[C_OPAC] : 0.f;
        const float g_opac = clampm ? g_a * G : 0.f;
        const float g_rho = -0.5f * G * g_G;
        if (MODE == GAUSS3D) {
          // rho = a dx^2 + c dy^2 + 2 b dx dy, dx = cx - px; z: column 3
          v_out[0] = g_rho * dx * dx;
          v_out[1] = 2.f * g_rho * dx * dy;
          v_out[2] = g_rho * dy * dy;
          v_out[3] = g_z;
          v_out[9] = g_rho * (2.f * d[0] * dx + 2.f * d[1] * dy);
          v_out[10] = g_rho * (2.f * d[2] * dy + 2.f * d[1] * dx);
          v_out[11] = g_opac;
        } else {
          const float b3f = b3 ? 1.f : 0.f;
          const float b2f = b3 ? 0.f : 1.f;
          const float g_u = b3f * (2.f * u * g_rho + g_z * t20);
          const float g_v = b3f * (2.f * v * g_rho + g_z * t21);
          const float g_t20 = g_z * u * b3f;
          const float g_t21 = g_z * v * b3f;
          const float g_t22 = g_z;
          const float g_qx = g_u / qz;
          const float g_qy = g_v / qz;
          const float g_qzz = -(u * g_u + v * g_v) / qz;
          const float g_kx = ly * g_qzz - lz * g_qy;
          const float g_ky = lz * g_qx - lx * g_qzz;
          const float g_kz = lx * g_qy - ly * g_qx;
          const float g_lx = g_qy * kz - g_qzz * ky;
          const float g_ly = g_qzz * kx - g_qx * kz;
          const float g_lz = g_qx * ky - g_qy * kx;
          v_out[0] = g_kx;
          v_out[1] = g_ky;
          v_out[2] = g_kz;
          v_out[3] = g_lx;
          v_out[4] = g_ly;
          v_out[5] = g_lz;
          v_out[6] = -px * g_kx - py * g_lx + g_t20;
          v_out[7] = -px * g_ky - py * g_ly + g_t21;
          v_out[8] = -px * g_kz - py * g_lz + g_t22;
          v_out[9] = g_rho * b2f * 2.f * FILTER_INV_SQUARE * dx;
          v_out[10] = g_rho * b2f * 2.f * FILTER_INV_SQUARE * dy;
          v_out[11] = g_opac;
          v_out[12] = g_n0 * w;
          v_out[13] = g_n1 * w;
          v_out[14] = g_n2 * w;
        }
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) v_out[15 + c] = g_col[c] * w;
        v_out[NCOL - 1] = T_bef * om >= T_CUTOFF ? w : 0.f;
      }
#pragma unroll
      for (int k = 0; k < NCOL; ++k) {
        if (k >= ncols && k < NCOL - 1) continue;
        const float sum = warp_sum(v_out[k]);
        if ((lane & 31) == 0 && sum != 0.f) atomicAdd(&acc[j][k], sum);
      }
    }
    __syncthreads();
    for (int e = lane; e < CHUNK * NCOL; e += NPIX) {
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
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() (0 = launched).
// mode: 0 surfel, 1 gauss3d. fwd, gout: (C + 11, tiles_y*16, tiles_x*16)
// f32 training planes and their cotangents; gpacked: (n_rows, 32) f32,
// zeroed by the caller, receives the table gradient with the per-splat wet
// in column 31.
extern "C" int raster_blend_bwd(const float* packed, int n_rows,
                                const int32_t* gauss_idx, int n_idx,
                                const int32_t* bounds, int C, int tiles_x,
                                int tiles_y, int row_off, int mode,
                                const float* fwd, const float* gout,
                                float* gpacked, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == GAUSS3D)
    raster_blend_bwd_kernel<GAUSS3D><<<tiles_x * tiles_y, NPIX, 0, st>>>(
        packed, n_rows, gauss_idx, n_idx, bounds, C, tiles_x, tiles_y,
        row_off, fwd, gout, gpacked);
  else
    raster_blend_bwd_kernel<SURFEL><<<tiles_x * tiles_y, NPIX, 0, st>>>(
        packed, n_rows, gauss_idx, n_idx, bounds, C, tiles_x, tiles_y,
        row_off, fwd, gout, gpacked);
  return (int)cudaGetLastError();
}
