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
// (P+1, 32) table gradient with atomic adds, and no per-pair array exists.
//
// What bounds it on the card: arithmetic and its latency, not bytes.
// Every (pair, pixel) of a tile up to the last contributor pays the forward
// geometry; on the bench scenes about half the (pair, warp) combinations
// hold a contributing pixel (12 to 16 of the warp's 32 lanes) and pay the
// chain (a log1pf / expf pair, divisions and the chain into the screen
// transform or the conic, some 250 operations, most of them dependent)
// and one reduction of the pair's gradient row over the warp. Measured on
// an H100, the first design of this kernel (each column reduced by five
// shuffles of its own, one lane adding the 21 sums into a shared block
// with atomicAdd, which is a compare-and-swap loop for floats) spent two
// thirds of its time in that reduction, a quarter in the chain, a tenth in
// the geometry and 1% staging rows.
//
// Design: one block per 16x16 tile, one thread per pixel, a warp an 8x4
// patch of the tile (a splat of a few pixels meets fewer warps and fills
// more lanes of each than in a 16x2 strip). The block walks the tile's
// 64-pair chunks in reverse, starting at the last chunk that holds a
// contributor of any pixel (the JAX kernel's nchunks_eff). Each chunk's
// table rows are staged in shared memory by 16-byte cp.async copies, two
// chunks deep: the chunk before this one in the walk is in flight while
// this one is computed, its splat indices loaded one chunk earlier still,
// and one __syncthreads per chunk is left. Each thread keeps the JAX
// kernel's suffix accumulators (sum of log(1-a), w, w m, w m^2, g_w w) in
// registers and walks the chunk's pairs in reverse, so T before a pair is
// T_fin * exp(-suffix sum of log(1-a)) as in the JAX kernel, over the same
// contributing set amask & (rank <= last). A warp skips a pair that lies
// past the last contributor of all its pixels before any geometry, and one
// whose pixels have no contribution after it: every gradient and
// accumulator update of a non-contributing pixel is exactly zero.
// Otherwise the warp reduces the pair's gradient row by transposition: in
// halving steps each lane hands its partner the half of its remaining
// columns that the partner keeps (16, 8, 4, 2, 1 shuffles for the surfel
// row's 32 slots; 8, 4, 2, 1 and one fold for the 16 slots the gauss3d row
// is packed into), after which lane k holds the warp's sum of column k, and
// all lanes add at once into the splat's row of the table gradient: one
// 128-byte reduction (red.global.add.f32, no return value, resolved in L2)
// per (pair, warp) instead of a shared block, its atomics and a flush
// pass. The per-pair wet (the pair's w where the forward's own test T_bef
// (1 - a) >= 1e-4 passes) rides in the row's last slot to column 31.
// Atomics make the order of the float sums vary from run to run.
//
// Arithmetic: built with -fmad=false, as K1. Every term up to the pixel's
// own sums rounds as the plain version's, so only the order of the sums
// over pixels and pairs differs. Fused multiply-adds move the comparisons
// K1 made (b3, the alpha floor) and fail the kernel's bounds; a shared
// reciprocal in map_depth fails them too, through the cancellation in
// prefix = total - suffix. The one liberty taken is a single reciprocal of
// qz for the three quotients of the surfel chain, which feed no comparison.
// 80 registers with __launch_bounds__(256, 3): three blocks an SM run 13%
// faster than two at 102 registers, four at 64 spill and gain nothing.
// Tried and left out: a conservative test without division or expf ahead
// of the geometry (rho <= 2 ln(255 opacity)) gains 1% in surfel mode and
// loses 8% in gauss3d mode; tiles ordered heaviest first (the largest tile
// is under 4% of an SM's chunks).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int CHUNK = 64;
constexpr int LO = 32;  // packed row width
constexpr int VPR = LO / 4;  // 16-byte vectors per row
constexpr int MAXC = 7;
constexpr int WARP_W = 8, WARP_H = 4;  // a warp's patch of the tile
constexpr int WET_COL = LO - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SURFEL = 0, GAUSS3D = 1;  // geometry modes
constexpr int MIN_BLOCKS = 3;  // resident blocks per SM asked of the compiler
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

// Slots of the reduced gradient row and the table column of each. Surfel:
// 32 slots, slot k is column k (15 + C live, the wet in slot 31). Gauss3d:
// 16 slots: conic and depth 0-3, centre and opacity 4-6 (columns 9-11),
// colors 7-13 (columns 15-21), the wet in slot 15.
template <int MODE> struct Row {
  static constexpr int N = MODE == GAUSS3D ? 16 : 32;
  static constexpr int WET = N - 1;
  static constexpr int COLOR = MODE == GAUSS3D ? 7 : C_COLOR;
};

__device__ __forceinline__ int gauss3d_column(int slot) {
  return slot < 4 ? slot : slot < 7 ? slot + 5 : slot < 15 ? slot + 8 : WET_COL;
}

// One halving step of the transposition: lanes l and l ^ H exchange the
// halves of their 2H remaining columns; afterwards v[0..H) holds the half
// this lane keeps (the upper one where l & H), summed over both lanes. The
// recursion over H keeps every index a compile-time constant, so v stays in
// registers.
template <int H>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
  if constexpr (H > 1) halve<H / 2>(v, lane);
}

// The warp's sums of N columns by transposition: on return v[0] of lane k
// (k < N) is the sum over the warp's 32 lanes of their v[k].
template <int N>
__device__ __forceinline__ void transpose_reduce(float (&v)[N], int lane) {
  halve<N / 2>(v, lane);
  if (N < 32) v[0] += __shfl_xor_sync(FULL, v[0], N);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

template <int MODE>
__global__ void __launch_bounds__(NPIX, MIN_BLOCKS)
raster_blend_bwd_kernel(const float* __restrict__ packed, int n_rows,
                        const int32_t* __restrict__ gauss_idx, int n_idx,
                        const int32_t* __restrict__ bounds, int C,
                        int tiles_x, int tiles_y, int row_off,
                        const float* __restrict__ fwd,
                        const float* __restrict__ gout,
                        float* __restrict__ gpacked) {
  using R = Row<MODE>;
  __shared__ __align__(16) float rows[2][CHUNK][LO];
  __shared__ int gid[2][CHUNK];
  __shared__ int lastmax;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = t % tiles_x, ty = t / tiles_x;
  // pixel of this thread inside the tile: warp w is the 8x4 patch at
  // (w % 2, w / 2), lane l its pixel (l % 8, l / 8)
  const int ix = (warp % (TILE / WARP_W)) * WARP_W + lane % WARP_W;
  const int iy = (warp / (TILE / WARP_W)) * WARP_H + lane / WARP_W;
  const float px = (float)(tx * TILE + ix);
  const float py = (float)(ty * TILE + row_off + iy);
  const int out_w = tiles_x * TILE;
  const size_t plane = (size_t)tiles_y * TILE * out_w;
  const size_t pix = (size_t)(ty * TILE + iy) * out_w + tx * TILE + ix;
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

  if (tid == 0) lastmax = -1;
  __syncthreads();
  const int wlast = __reduce_max_sync(FULL, (int)last);
  if (lane == 0) atomicMax(&lastmax, wlast);
  __syncthreads();
  const int start = bounds[t], end = bounds[t + 1];
  const int nchunks = (end - start) / CHUNK;
  const int neff = max(0, min(nchunks, (lastmax + CHUNK) / CHUNK));

  // Staging: thread `tid` copies vectors tid and tid + 256 of a chunk's 512
  // (row e / 8, vector e % 8). A pair outside the tile's range or the index
  // array, or naming a row outside the table, reads as the zero row and
  // takes no gradient (gid -1).
  int g_next[2];
  auto load_idx = [&](int ch) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = start + ch * CHUNK + (tid + h * NPIX) / VPR;
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
      const int e = tid + h * NPIX;
      const int r = e / VPR, v = e % VPR;
      const int g = g_next[h];
      float* dst = &rows[buf][r][v * 4];
      if (g >= 0)
        cp_async16(dst, packed + (size_t)g * LO + v * 4);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      if (v == 0) gid[buf][r] = g;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (neff > 0) {
    load_idx(neff - 1);
    stage(0);
    if (neff > 1) load_idx(neff - 2);
  }

  float tcur = T_fin;
  float suf0 = 0.f, suf1 = 0.f, suf2 = 0.f, suf3 = 0.f;
  for (int ch = neff - 1; ch >= 0; --ch) {
    const int buf = (neff - 1 - ch) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // this chunk's rows are in; every thread is done with the other buffer
    __syncthreads();
    if (ch > 0) {
      stage(buf ^ 1);
      if (ch > 1) load_idx(ch - 2);
    }

    float s_log = 0.f, sw = 0.f, sm = 0.f, sm2 = 0.f, sgw = 0.f;
    for (int j = CHUNK - 1; j >= 0; --j) {
      const float* d = rows[buf][j];
      const float4 q0 = *reinterpret_cast<const float4*>(d);
      const float4 q1 = *reinterpret_cast<const float4*>(d + 4);
      const float4 q2 = *reinterpret_cast<const float4*>(d + 8);
      // past every pixel's last contributor in this warp: nothing to do
      const bool ranked = (float)(ch * CHUNK + j) <= last;
      if (!__any_sync(FULL, ranked)) continue;
      const float opac = q2.w;
      const float t20 = q1.z, t21 = q1.w, t22 = q2.x;
      const float dx = q2.y - px;
      const float dy = q2.z - py;
      // surfel intermediates (unused by gauss3d)
      float kx = 0.f, ky = 0.f, kz = 0.f, lx = 0.f, ly = 0.f, lz = 0.f;
      float qz = 1.f, u = 0.f, v = 0.f;
      bool b3 = false, amask;
      float z, G;
      if (MODE == GAUSS3D) {
        const float rho = q0.x * dx * dx + q0.z * dy * dy
                          + 2.f * q0.y * dx * dy;
        z = q0.w;
        G = expf(-0.5f * fmaxf(rho, 0.f));
        amask = rho >= 0.f;
      } else {
        kx = q0.x - px * t20;
        ky = q0.y - px * t21;
        kz = q0.z - px * t22;
        lx = q0.w - py * t20;
        ly = q1.x - py * t21;
        lz = q1.y - py * t22;
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
      const float oG = opac * G;
      const float a_raw = fminf(oG, ALPHA_MAX);
      const bool contrib = amask && a_raw >= ALPHA_MIN && z >= NEAR_PLANE
                           && ranked;
      if (!__any_sync(FULL, contrib)) continue;

      float v_out[R::N];
#pragma unroll
      for (int k = 0; k < R::N; ++k) v_out[k] = 0.f;
      if (contrib) {
        const float4 q3 = *reinterpret_cast<const float4*>(d + 12);
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
        g_w = g_w + g_n0 * q3.x;
        g_w = g_w + g_n1 * q3.y;
        g_w = g_w + g_n2 * q3.z;
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
        const float g_G = clampm ? g_a * opac : 0.f;
        const float g_opac = clampm ? g_a * G : 0.f;
        const float g_rho = -0.5f * G * g_G;
        if (MODE == GAUSS3D) {
          // rho = a dx^2 + c dy^2 + 2 b dx dy, dx = cx - px; z: column 3
          v_out[0] = g_rho * dx * dx;
          v_out[1] = 2.f * g_rho * dx * dy;
          v_out[2] = g_rho * dy * dy;
          v_out[3] = g_z;
          v_out[4] = g_rho * (2.f * q0.x * dx + 2.f * q0.y * dy);
          v_out[5] = g_rho * (2.f * q0.z * dy + 2.f * q0.y * dx);
          v_out[6] = g_opac;
        } else {
          const float b3f = b3 ? 1.f : 0.f;
          const float b2f = b3 ? 0.f : 1.f;
          const float g_u = b3f * (2.f * u * g_rho + g_z * t20);
          const float g_v = b3f * (2.f * v * g_rho + g_z * t21);
          const float g_t20 = g_z * u * b3f;
          const float g_t21 = g_z * v * b3f;
          const float g_t22 = g_z;
          const float rq = 1.f / qz;  // feeds no comparison
          const float g_qx = g_u * rq;
          const float g_qy = g_v * rq;
          const float g_qzz = -(u * g_u + v * g_v) * rq;
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
          if (c < C) v_out[R::COLOR + c] = g_col[c] * w;
        v_out[R::WET] = T_bef * om >= T_CUTOFF ? w : 0.f;
      }
      transpose_reduce<R::N>(v_out, lane);
      const int g = gid[buf][j];
      if (lane < R::N && g >= 0 && v_out[0] != 0.f) {
        const int col = MODE == GAUSS3D ? gauss3d_column(lane) : lane;
        atomicAdd(&gpacked[(size_t)g * LO + col], v_out[0]);
      }
    }
    suf0 += sw;
    suf1 += sm;
    suf2 += sm2;
    suf3 += sgw;
    tcur = tcur * expf(-s_log);
  }
}

template <int MODE>
int resources(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, raster_blend_bwd_kernel<MODE>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, raster_blend_bwd_kernel<MODE>, NPIX, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = blocks;
  return (int)err;
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

// K2's resources as compiled, for `mode`: out[0] registers per thread,
// out[1] static shared bytes per block, out[2] resident blocks per SM.
// Launches nothing; returns a CUDA error code (0 = ok).
extern "C" int raster_blend_bwd_resources(int mode, int* out) {
  return mode == GAUSS3D ? resources<GAUSS3D>(out) : resources<SURFEL>(out);
}
