// The env cull's arithmetic for one (tile, chunk) and one (tile, candidate):
// the coarse cone-versus-chunk-sphere test, the per-candidate sphere test
// and direction-space probe, and the 64-bit sort keys of the kept
// candidates. Kept in a header of its own so that a host compiler builds it
// too (tests/test_torch_env_cull.py holds it against the plain version in
// ops/tracer.py on the CPU).
//
// Every expression follows ops/tracer.py::cull_and_sort_torch (coarse_radial
// and _block_cull) operation for operation, in float32 and in its order:
// the library builds with -fmad=false (the host test with
// -ffp-contract=off), so every product and sum is rounded on its own, as the
// plain version's elementwise torch ops are. The 3-term dot products are
// written out left to right, ((a0 b0 + a1 b1) + a2 b2), as the plain
// version writes them (its coarse pass too: no matrix product there).
// sqrtf and the division are IEEE-rounded on both sides (no fast math).
#pragma once
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define EC_FN __host__ __device__ __forceinline__
#else
#define EC_FN static inline
#endif

namespace ec {

constexpr int CHUNK = 64;  // candidates a chunk (ops/raster_blend.CHUNK)
constexpr int NQUAD = 4;   // probe boxes a tile
constexpr int BOX = 10;    // u_c u_a v_c v_a ox_c ox_a oy_c oy_a oz_c oz_a
constexpr int CAND_ROWS = 8;  // mx my mz rad nx ny nz rc

// torch.clamp(x, min=lo): NaN passes through
EC_FN float clamp_min(float x, float lo) { return x != x ? x : (x < lo ? lo : x); }
EC_FN float clamp2(float x, float lo, float hi) {
  return x != x ? x : (x < lo ? lo : (x > hi ? hi : x));
}
EC_FN float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
  return a0 * b0 + a1 * b1 + a2 * b2;
}
EC_FN uint32_t fbits(float x) {
  union { float f; uint32_t u; } v;
  v.f = x + 0.0f;  // -0 -> +0: the order of the non-negative floats
  return v.u;
}

// A ray tile's cone (build_ray_tiles) and its two per-tile dot products.
struct Cone {
  float ap[3], ax[3], tan_half, spread, axap, apap;
};

EC_FN Cone load_cone(const float* apex, const float* axis,
                     const float* tan_half, const float* spread, int t) {
  Cone k;
  for (int i = 0; i < 3; ++i) {
    k.ap[i] = apex[3 * t + i];
    k.ax[i] = axis[3 * t + i];
  }
  k.tan_half = tan_half[t];
  k.spread = spread[t];
  k.axap = dot3(k.ax[0], k.ap[0], k.ax[1], k.ap[1], k.ax[2], k.ap[2]);
  k.apap = dot3(k.ap[0], k.ap[0], k.ap[1], k.ap[1], k.ap[2], k.ap[2]);
  return k;
}

// coarse_radial for one (tile, chunk): the distance from the apex to the
// sphere's centre where the sphere meets the cone, else +inf. The caller
// folds in the chunk's `cact` and the tile's mask.
EC_FN float coarse(const Cone& k, float cx, float cy, float cz, float crad) {
  const float cm2 = dot3(cx, cx, cy, cy, cz, cz);
  const float proj = dot3(k.ax[0], cx, k.ax[1], cy, k.ax[2], cz) - k.axap;
  float d2 = (cm2 - 2.0f * dot3(k.ap[0], cx, k.ap[1], cy, k.ap[2], cz))
             + k.apap;
  d2 = clamp_min(d2, 0.0f);
  const float axis_dist = sqrtf(clamp_min(d2 - proj * proj, 0.0f));
  const float slack = k.spread + crad * (k.tan_half + 1.0f);
  const bool hit = axis_dist <= proj * k.tan_half + slack;
  const bool near = d2 <= slack * slack;
  const bool keep = (hit || near) && (proj + crad > 0.0f);
  return keep ? sqrtf(d2) : INFINITY;
}

// A (tile, chunk) pair's coarse sort key: (radial bits, chunk index), the
// order of a stable sort of the radials (ties to the lower chunk index).
EC_FN uint64_t chunk_key(float radial, int c, int idx_bits) {
  return ((uint64_t)fbits(radial) << idx_bits) | (uint64_t)c;
}

// The tile's probe: frame rows ex, ey, the four quadrant boxes, probe_ok.
struct Probe {
  float ex[3], ey[3], box[NQUAD][BOX];
  bool ok;
};

EC_FN Probe load_probe(const float* frame, const float* box,
                       const uint8_t* ok, int t) {
  Probe q;
  for (int i = 0; i < 3; ++i) {
    q.ex[i] = frame[6 * t + i];
    q.ey[i] = frame[6 * t + 3 + i];
  }
  for (int d = 0; d < NQUAD; ++d)
    for (int i = 0; i < BOX; ++i) q.box[d][i] = box[(t * NQUAD + d) * BOX + i];
  q.ok = ok[t] != 0;
  return q;
}

// A candidate's squared distance from the apex, d2_s; `c` its mean.
EC_FN float dist2(const Cone& k, const float* c) {
  const float relx = c[0] - k.ap[0];
  const float rely = c[1] - k.ap[1];
  const float relz = c[2] - k.ap[2];
  return dot3(relx, relx, rely, rely, relz, relz);
}

// The refine of one candidate of a kept chunk: its sphere test and, with a
// probe, the direction-space footprint rejection; `c` holds the candidate
// table's eight rows (mx my mz rad nx ny nz rc). Returns keep_s and sets
// *radial to sqrt(d2_s).
EC_FN bool refine(const Cone& k, const Probe* q, const float* c, int cid,
                  int P, float* radial) {
  const float relx = c[0] - k.ap[0];
  const float rely = c[1] - k.ap[1];
  const float relz = c[2] - k.ap[2];
  const float cr = c[3];
  const float proj_s = dot3(relx, k.ax[0], rely, k.ax[1], relz, k.ax[2]);
  const float d2_s = dist2(k, c);
  const float axd_s = sqrtf(clamp_min(d2_s - proj_s * proj_s, 0.0f));
  const float slack_s = k.spread + cr;
  const bool hit_s = axd_s <= proj_s * k.tan_half + slack_s;
  const bool near_s = d2_s <= slack_s * slack_s;
  bool keep = (hit_s || near_s) && (proj_s + cr > 0.0f) && (cid < P)
              && (cr > 0.0f);
  if (q != nullptr && keep) {
    const float crc = c[7];
    const float w = proj_s;  // relx ax0 + rely ax1 + relz ax2, the same sum
    const float invw = 1.0f / clamp_min(w, 1e-6f);
    const float u0 = dot3(relx, q->ex[0], rely, q->ex[1], relz, q->ex[2]) * invw;
    const float v0 = dot3(relx, q->ey[0], rely, q->ey[1], relz, q->ey[2]) * invw;
    const float npx = dot3(c[4], q->ex[0], c[5], q->ex[1], c[6], q->ex[2]);
    const float npy = dot3(c[4], q->ey[0], c[5], q->ey[1], c[6], q->ey[2]);
    const float npz = dot3(c[4], k.ax[0], c[5], k.ax[1], c[6], k.ax[2]);
    const float bnu = npx - u0 * npz;
    const float bnv = npy - v0 * npz;
    const float scl = invw * 1.10f;
    const float slu =
        crc * sqrtf(clamp_min(u0 * u0 + 1.0f - bnu * bnu, 0.0f)) * scl;
    const float slv =
        crc * sqrtf(clamp_min(v0 * v0 + 1.0f - bnv * bnv, 0.0f)) * scl;
    const float au0 = fabsf(u0);
    const float av0 = fabsf(v0);
    bool inside = false;
    for (int d = 0; d < NQUAD; ++d) {
      const float* b = q->box[d];
      const float du = fabsf(u0 - b[0] - (b[4] - u0 * b[8]) * invw)
                       - (b[1] + (b[5] + au0 * b[9]) * invw * 1.10f);
      const float dv = fabsf(v0 - b[2] - (b[6] - v0 * b[8]) * invw)
                       - (b[3] + (b[7] + av0 * b[9]) * invw * 1.10f);
      inside = inside || ((du <= slu) && (dv <= slv));
    }
    const bool far = w > 4.0f * (crc + k.spread);
    keep = inside || !(far && q->ok);
  }
  *radial = sqrtf(d2_s);
  return keep;
}

// The sort key of a kept candidate where P >= 2^18 (the plain version's
// stable sort of sqrt(d2_s) over the (rank, lane) layout): radial bits,
// then the chunk's rank in the coarse order, then the lane.
EC_FN uint64_t float_key(float radial, int rank, int lane, int rank_bits) {
  return ((uint64_t)fbits(radial) << (rank_bits + 6))
         | ((uint64_t)rank << 6) | (uint64_t)lane;
}

// The sort key of a kept candidate where P < 2^18: (quantized radial, cid)
// as the plain version packs it; rmax is the tile's largest kept radial.
EC_FN uint64_t quant_key(float radial, float rmax, int cid, int cid_bits) {
  const int qbits = 32 - cid_bits;
  const float top = (float)((1 << qbits) - 2);  // qmax - 1
  const float q = clamp2(radial / clamp_min(rmax, 1e-12f) * top, 0.0f, top);
  return ((uint64_t)(uint32_t)q << cid_bits) | (uint64_t)cid;
}

}  // namespace ec
