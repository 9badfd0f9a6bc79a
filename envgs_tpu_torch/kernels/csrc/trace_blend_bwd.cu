// Kernel K4: backward of the per-tile traced surfel blend (K3, training).
//
// Replaces: envgs_tpu/ops/tracer.py::_bwd_kernel (Pallas, TPU) with
// emit_wet on, together with the pair-gradient transpose that follows it
// there (ops/segsum.gather_transpose): the TPU kernel writes one
// (slots, 128) gradient row per slot and a segmented scan sums them per
// splat; here each slot's gradient row is summed over the tile's rays
// inside the block and added into its splat's row of the (P+1, 32) table
// gradient with atomic adds, and no per-slot array exists. The per-ray
// gradients of the ray origin and direction (the reflected-ray chain into
// the base pass) are written by the thread that owns the ray, once, with
// no atomics.
//
// What bounds it on the card: latency, not bytes and not arithmetic. On
// the train bench scene (an H100, 6370 tiles) reflected rays scatter: of
// the 8.1M (slot, warp) combinations up to a warp's last contributor 0.36M
// hold a contributing ray, 1.8 rays each, and those pay a dependent chain
// of some 350 instructions (a log1pf / expf pair, divisions, the chain into
// mean, tangents, normal and the ray, the reduction's shuffles). The first
// design of this kernel (one block per tile; each of 17 columns reduced by
// five shuffles of its own, one lane adding the sums into a shared block
// with atomicAdd, a flush pass per chunk) spent 2.0 of its 5.6 ms in that
// reduction, 1.5 in the chain and 2.0 in the exact terms of slots that
// contribute nothing, with the warps of a block waiting at every chunk's
// barrier for the one whose rays reach farthest.
//
// Design: one warp per block, eight blocks per 16x16 ray tile: a warp is an
// 8x4 patch of the tile's rays, one thread per ray, the ray in registers,
// and walks its own candidates at its own pace, with no barrier and no
// waiting for the tile's other patches; 32 such blocks are resident on an
// SM, all of them at work. The number of aux channels A is a template
// parameter, so the row has no dead entries. The warp walks the tile's
// slots in reverse from the last contributor of its own rays (known from
// the `last` plane alone), 16 slots at a time: their table rows are staged
// in the warp's shared memory by 16-byte cp.async copies, two sub-chunks
// deep (the next one is in flight while this one is computed; the rows a
// tile's eight warps have in common come from L2). Each thread keeps the
// JAX kernel's suffix accumulators (sum of log(1-a), w, w m, w m^2, g_w w)
// in registers, folded at every 64-slot chunk boundary as the JAX kernel
// folds them, so T before a slot is T_fin * exp(-suffix sum of log(1-a))
// over the same contributing set amask & (rank <= last).
// Ahead of the exact terms stands a bounding test (reach2, in_reach): a
// ray whose line passes a splat's centre farther off than the radius at
// which its alpha falls under 1/255, with margins for float32 rounding,
// cannot contribute, and the test costs a dozen fused multiply-adds without
// division or expf. The 16 tests of a sub-chunk are independent of each
// other, so their latencies overlap; a vote each leaves the slots within
// reach of some ray at or before its last contributor (7% of the walked
// ones on the train bench scene), and only those pay the exact terms, in
// reverse slot order. A slot none of the warp's rays contributes to is
// skipped: every gradient and accumulator update of a non-contributing ray
// is exactly zero. Otherwise the warp reduces the slot's gradient row by
// transposition: the 16 columns every slot has (mean, t_u, t_v, normal,
// opacity, colour) in halving steps of 8, 4, 2, 1 shuffles and one fold,
// after which lane k holds column k; the wet and the aux columns (1 + A
// values) the same way on their own (5 or 6 shuffles), landing on lanes 16
// to 16 + A. All these lanes then add at once into the splat's row of the
// table gradient: one reduction instruction (red.global.add.f32, no return
// value, resolved in L2) per (slot, warp) instead of a shared block, its
// atomics and a flush pass. The per-slot wet (the slot's w where the
// forward's own test T_bef (1 - a) >= 1e-4 passes) goes to column 31.
// Atomics make the order of the float sums vary from run to run.
//
// Arithmetic: built with -fmad=false, as K3. Every term up to the ray's
// own sums rounds as the plain version's, so only the order of the sums
// over rays and slots differs. The one liberty taken is a single
// reciprocal of d.n for the nine quotients of the chain into the normal,
// the mean and the ray, which feed no comparison (9% of the kernel's
// time; the ray gradients then differ from the plain version's in their
// last bits). 64 registers with __launch_bounds__(32, 32) and some 170
// bytes of spills in the chain: 24 blocks an SM at 80 registers are no
// faster, 16 at 120 registers are 18% slower.
// What is left: the walk and its bounding tests are 0.6 ms of 1.1, the
// chain of the 0.36M contributing combinations 0.4 ms, some 1200 issue
// slots each: with 1.8 live lanes its latency, not its arithmetic, is paid.
#include "trace_blend.cuh"

namespace {

constexpr int SUB = 16;  // slots a warp stages and tests together
constexpr int SUBS = CHUNK / SUB;
constexpr int WET_COL = LO - 1;
constexpr int MIN_BLOCKS = 32;  // resident one-warp blocks per SM asked for
// the reduced gradient row: MAIN slots are the table's columns 0..15; the
// extras, 1 + A values (the wet, then the aux channels), are reduced apart
// in a row padded to a power of two and land on lanes MAIN + e
constexpr int MAIN = 16;

// table column of extra e
__device__ __forceinline__ int extra_column(int e) {
  return e == 0 ? WET_COL : C_AUX + e - 1;
}

template <int A> struct Extras {
  static constexpr int N = A == 0 ? 1 : A == 1 ? 2 : 4;
};

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

// The warp's sums of N columns (a power of two) by transposition: on return
// v[0] of lane l is the sum over the warp's 32 lanes of their v[l % N].
template <int N>
__device__ __forceinline__ void transpose_reduce(float (&v)[N], int lane) {
  if constexpr (N > 1) halve<N / 2>(v, lane);
#pragma unroll
  for (int o = N; o < 32; o <<= 1) v[0] += __shfl_xor_sync(FULL, v[0], o);
}

template <int A>
__global__ void __launch_bounds__(32, MIN_BLOCKS)
trace_blend_bwd_kernel(const float* __restrict__ packed, int n_rows,
                       const int32_t* __restrict__ gauss_idx, int n_idx,
                       const float* __restrict__ rays,
                       const int32_t* __restrict__ bounds, int tiles_x,
                       int tiles_y, const float* __restrict__ fwd,
                       const float* __restrict__ gout,
                       float* __restrict__ gpacked,
                       float* __restrict__ grays) {
  constexpr int NX = Extras<A>::N;
  __shared__ __align__(16) float rows[2][SUB][LO];
  __shared__ int gid[2][SUB];
  __shared__ float reach[SUB];
  // one warp a block: patch `warp` of tile t, the 8x4 rays at (warp % 2,
  // warp / 2), lane l its ray (l % 8, l / 8)
  const int t = blockIdx.x / NWARP, warp = blockIdx.x % NWARP;
  const int lane = threadIdx.x;
  const int ix = (warp % (TILE / WARP_W)) * WARP_W + lane % WARP_W;
  const int iy = (warp / (TILE / WARP_W)) * WARP_H + lane / WARP_W;
  const int p = iy * TILE + ix;  // its place in the tile's 256 rays
  const float* ray = rays + (size_t)t * 8 * NRAY + p;
  const float ox = ray[0], oy = ray[NRAY], oz = ray[2 * NRAY];
  const float dx = ray[3 * NRAY], dy = ray[4 * NRAY], dz = ray[5 * NRAY];
  const float dd = dx * dx + dy * dy + dz * dz;
  const float dd_s = dd * (1.f - POS_SLACK);
  const int tx = t % tiles_x, ty = t / tiles_x;
  const int out_w = tiles_x * TILE;
  const size_t plane = (size_t)tiles_y * TILE * out_w;
  const size_t pix = (size_t)(ty * TILE + iy) * out_w + tx * TILE + ix;
  // JAX row order: rgb, dpt, acc, normal(3), dist, aux(A), T, D1, D2, last
  constexpr int R_DPT = 3, R_ACC = 4, R_NRM = 5, R_DIST = 8, R_AUX = 9,
                R_TRANS = 9 + A, R_D1 = 10 + A, R_D2 = 11 + A,
                R_LAST = 12 + A;
  const float last = fwd[R_LAST * plane + pix];
  float g_ox = 0.f, g_oy = 0.f, g_oz = 0.f, g_dx = 0.f, g_dy = 0.f,
        g_dz = 0.f;
  // the last contributor of this warp's rays: it walks no slot past it
  const int wlast = __reduce_max_sync(FULL, (int)last);
  const int start = bounds[t], end = bounds[t + 1];
  const int nsub = min((end - start) / SUB, wlast / SUB + 1);
  if (wlast >= 0 && nsub > 0) {
    const float A_tot = fwd[R_ACC * plane + pix];
    const float D1_tot = fwd[R_D1 * plane + pix];
    const float D2_tot = fwd[R_D2 * plane + pix];
    const float T_fin = fwd[R_TRANS * plane + pix];
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

    // Staging: lane l copies vectors l, l + 32, l + 64, l + 96 of a
    // sub-chunk's 128 (row e / 8, vector e % 8). A slot outside the tile's
    // range or the index array, or naming a row outside the table, reads
    // as the zero row and takes no gradient (gid -1).
    int g_next[SUB / 4];
    auto load_idx = [&](int sc) {
#pragma unroll
      for (int h = 0; h < SUB / 4; ++h) {
        const int i = start + sc * SUB + (lane + h * 32) / VPR;
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
      for (int h = 0; h < SUB / 4; ++h) {
        const int e = lane + h * 32;
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
    load_idx(nsub - 1);
    stage(0);
    if (nsub > 1) load_idx(nsub - 2);

    float tcur = T_fin;
    float suf0 = 0.f, suf1 = 0.f, suf2 = 0.f, suf3 = 0.f;
    float s_log = 0.f, sw = 0.f, sm = 0.f, sm2 = 0.f, sgw = 0.f;
    for (int sc = nsub - 1; sc >= 0; --sc) {
      const int buf = (nsub - 1 - sc) & 1;
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      // this sub-chunk's rows are in; the warp is done with the other buffer
      __syncwarp();
      if (sc > 0) {
        stage(buf ^ 1);
        if (sc > 1) load_idx(sc - 2);
      }
      if (lane < SUB) reach[lane] = reach2(rows[buf][lane]);
      __syncwarp();
      // the slots some ray of the warp may reach at or before its last
      // contributor; the 16 tests are independent and overlap
      const int rank0 = sc * SUB;
      unsigned hit = 0;
#pragma unroll
      for (int k = 0; k < SUB; ++k) {
        const float4 c = *reinterpret_cast<const float4*>(rows[buf][k]);
        const bool may = (float)(rank0 + k) <= last
                         && in_reach(c.x - ox, c.y - oy, c.z - oz, dx, dy, dz,
                                     dd, dd_s, reach[k]);
        if (__any_sync(FULL, may)) hit |= 1u << k;
      }
      while (hit) {  // in reverse slot order
        const int j = 31 - __clz(hit);
        hit &= ~(1u << j);
        const float* d = rows[buf][j];
        const float4 q0 = *reinterpret_cast<const float4*>(d);
        const float4 q1 = *reinterpret_cast<const float4*>(d + 4);
        const float4 q2 = *reinterpret_cast<const float4*>(d + 8);
        const float4 q3 = *reinterpret_cast<const float4*>(d + 12);
        const float cx = q0.x, cy = q0.y, cz = q0.z;
        const float tux = q0.w, tuy = q1.x, tuz = q1.y;
        const float tvx = q1.z, tvy = q1.w, tvz = q2.x;
        const float nx = q2.y, ny = q2.z, nz = q2.w;
        const float opac = q3.x;
        const float dn0 = dx * nx + dy * ny + dz * nz;
        const float dn = fabsf(dn0) < 1e-9f ? 1e-9f : dn0;
        const float num = (cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz;
        const float tt = num / dn;
        const float ex = ox + tt * dx - cx;
        const float ey = oy + tt * dy - cy;
        const float ez = oz + tt * dz - cz;
        const float u = ex * tux + ey * tuy + ez * tuz;
        const float v = ex * tvx + ey * tvy + ez * tvz;
        const float rho = u * u + v * v;
        const float G = expf(-0.5f * rho);
        const float oG = opac * G;
        const float a_raw = fminf(oG, ALPHA_MAX);
        const bool contrib = a_raw >= ALPHA_MIN && tt > T_MIN
                             && fabsf(dn0) >= 1e-9f
                             && (float)(rank0 + j) <= last;
        if (!__any_sync(FULL, contrib)) continue;

        float v_out[MAIN];
        float x_out[NX];
#pragma unroll
        for (int k = 0; k < MAIN; ++k) v_out[k] = 0.f;
#pragma unroll
        for (int k = 0; k < NX; ++k) x_out[k] = 0.f;
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
          g_w = g_w + g_c0 * q3.y;
          g_w = g_w + g_n0 * (nx * flip);
          g_w = g_w + g_c1 * q3.z;
          g_w = g_w + g_n1 * (ny * flip);
          g_w = g_w + g_c2 * q3.w;
          g_w = g_w + g_n2 * (nz * flip);
#pragma unroll
          for (int i = 0; i < A; ++i) g_w = g_w + g_aux[i] * d[C_AUX + i];
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
          const float g_G = clampm ? g_a * opac : 0.f;
          const float g_opac = clampm ? g_a * G : 0.f;
          const float g_rho = -0.5f * G * g_G;
          const float g_u = 2.f * u * g_rho;
          const float g_v = 2.f * v * g_rho;
          const float g_ex = g_u * tux + g_v * tvx;
          const float g_ey = g_u * tuy + g_v * tvy;
          const float g_ez = g_u * tuz + g_v * tvz;
          g_t = g_t + g_ex * dx + g_ey * dy + g_ez * dz;
          const float rdn = 1.f / dn;  // feeds no comparison
          const float g_nx = g_t * ((cx - ox) - tt * dx) * rdn
                             + g_n0 * flip * w;
          const float g_ny = g_t * ((cy - oy) - tt * dy) * rdn
                             + g_n1 * flip * w;
          const float g_nz = g_t * ((cz - oz) - tt * dz) * rdn
                             + g_n2 * flip * w;
          const float gtn_x = g_t * nx * rdn;
          const float gtn_y = g_t * ny * rdn;
          const float gtn_z = g_t * nz * rdn;
          v_out[C_MEAN] = -g_ex + gtn_x;
          v_out[C_MEAN + 1] = -g_ey + gtn_y;
          v_out[C_MEAN + 2] = -g_ez + gtn_z;
          v_out[C_TU] = g_u * ex;
          v_out[C_TU + 1] = g_u * ey;
          v_out[C_TU + 2] = g_u * ez;
          v_out[C_TV] = g_v * ex;
          v_out[C_TV + 1] = g_v * ey;
          v_out[C_TV + 2] = g_v * ez;
          v_out[C_N] = g_nx;
          v_out[C_N + 1] = g_ny;
          v_out[C_N + 2] = g_nz;
          v_out[C_OPAC] = g_opac;
          v_out[C_COLOR] = g_c0 * w;
          v_out[C_COLOR + 1] = g_c1 * w;
          v_out[C_COLOR + 2] = g_c2 * w;
          x_out[0] = T_bef * om >= T_CUTOFF ? w : 0.f;
#pragma unroll
          for (int i = 0; i < A; ++i) x_out[1 + i] = g_aux[i] * w;
          // the ray: o enters e directly and t through (c - o).n; d enters
          // e through t d and t through d.n
          const float gtt_x = g_t * tt * nx * rdn;
          const float gtt_y = g_t * tt * ny * rdn;
          const float gtt_z = g_t * tt * nz * rdn;
          g_ox += g_ex - gtn_x;
          g_oy += g_ey - gtn_y;
          g_oz += g_ez - gtn_z;
          g_dx += g_ex * tt - gtt_x;
          g_dy += g_ey * tt - gtt_y;
          g_dz += g_ez * tt - gtt_z;
        }
        transpose_reduce<MAIN>(v_out, lane);
        transpose_reduce<NX>(x_out, lane);
        const int g = gid[buf][j];
        const float val = lane < MAIN ? v_out[0] : x_out[0];
        if (lane < MAIN + 1 + A && g >= 0 && val != 0.f) {
          const int col = lane < MAIN ? lane : extra_column(lane - MAIN);
          atomicAdd(&gpacked[(size_t)g * LO + col], val);
        }
      }
      if (sc % SUBS == 0) {  // the 64-slot chunk is done: fold its sums
        suf0 += sw;
        suf1 += sm;
        suf2 += sm2;
        suf3 += sgw;
        tcur = tcur * expf(-s_log);
        s_log = sw = sm = sm2 = sgw = 0.f;
      }
    }
  }
  float* gr = grays + (size_t)t * 8 * NRAY + p;
  gr[0] = g_ox;
  gr[NRAY] = g_oy;
  gr[2 * NRAY] = g_oz;
  gr[3 * NRAY] = g_dx;
  gr[4 * NRAY] = g_dy;
  gr[5 * NRAY] = g_dz;
  gr[6 * NRAY] = 0.f;
  gr[7 * NRAY] = 0.f;
}

template <int A>
int resources(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, trace_blend_bwd_kernel<A>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, trace_blend_bwd_kernel<A>, 32, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  return (int)err;
}

}  // namespace

// Launches K4 on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for A outside 0..2.
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
  const cudaStream_t st = (cudaStream_t)stream;
  const int grid = tiles_x * tiles_y * NWARP;
  if (A == 0)
    trace_blend_bwd_kernel<0><<<grid, 32, 0, st>>>(
        packed, n_rows, gauss_idx, n_idx, rays, bounds, tiles_x, tiles_y, fwd,
        gout, gpacked, grays);
  else if (A == 1)
    trace_blend_bwd_kernel<1><<<grid, 32, 0, st>>>(
        packed, n_rows, gauss_idx, n_idx, rays, bounds, tiles_x, tiles_y, fwd,
        gout, gpacked, grays);
  else if (A == 2)
    trace_blend_bwd_kernel<2><<<grid, 32, 0, st>>>(
        packed, n_rows, gauss_idx, n_idx, rays, bounds, tiles_x, tiles_y, fwd,
        gout, gpacked, grays);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K4's resources as compiled, for A aux channels: out[0] registers per
// thread, out[1] static shared bytes per block, out[2] resident blocks
// (of one warp) per SM, out[3] local (spill) bytes per thread. Launches nothing; returns a
// CUDA error code (0 = ok).
extern "C" int trace_blend_bwd_resources(int A, int* out) {
  return A == 0 ? resources<0>(out) : A == 1 ? resources<1>(out)
         : A == 2 ? resources<2>(out) : (int)cudaErrorInvalidValue;
}
