// Neumann band-grid kernels for Hopper (sm_90a), bound through ctypes.
//
// They replace the two Pallas kernels of elaina_tpu/ops/pallas_queries.py
// that run on every depth step of a 3D scene with a Neumann set:
//
//   K6 band_neumann_walk_dma_3d (pallas_queries.py:1043, kernel
//      _make_band_neumann_walk_kernel_3d :862)   -> band_neumann_walk_kernel
//   K9 sil_band_dma (pallas_queries.py:622, kernel :563; 3D and 2D)
//                                                -> sil_band_kernel<3 | 2>
//
// the two unfused prim-band queries, which the volumetric source term and
// the unfused Neumann step run:
//
//   K7 band_ray_dma_3d (pallas_queries.py:792, kernel :734)
//                                                -> band_ray_kernel
//   K8 band_ball_dma_3d (pallas_queries.py:1189, kernel :1118)
//                                                -> band_ball_kernel
//
// and the two 2D closest-segment sweeps that serve a Dirichlet set without
// a candidate grid and the chain path of a grid without a coordinate table:
//
//   K13 closest_point_dense_pallas (pallas_queries.py:421, body :392)
//                                                -> closest_point_dense_kernel
//   K12 candidate_band_pallas (pallas_queries.py:499, body :469)
//                                                -> candidate_band_kernel
//
// K7 is K6's walk ray and K8 its in-ball CDF sample: they call the same
// device functions (closest_hit, ball_sample), so the fused and the
// unfused step agree bit for bit wherever their inputs do.  K12 and K13
// take resolve.cu's segment distance (segment.cuh).
//
// The contracts are the TPU kernels'; the TPU shapes are not carried over:
// no per-lane block DMAs, (BL, 128) tiles, one-hot winner picks or
// triangular-matmul prefix sums.  One warp serves one lane and strides
// over the Kp slots of the lane's cell, whose table is planes by slot, so
// each load instruction of the warp reads 128 contiguous bytes (K13, which
// reads one shared set, is one thread a lane instead).  Lanes with cell < 0
// (outside the grid) do no work.  Each launch function enqueues on the
// caller's stream, allocates nothing and returns cudaGetLastError().
// Built with -fmad=false, as resolve.cu: the plain PyTorch versions write
// the same products and sums in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int MAX_ROUNDS = 8;          // Kp <= 256 slots a cell
constexpr float PAD_COORD = 1.0e9f;
constexpr float INV_4PI = 0.07957747154594767f;

__device__ __forceinline__ float dot3(const float* u, const float* v) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

__device__ __forceinline__ void cross3(const float* u, const float* v,
                                       float* out) {
  out[0] = u[1] * v[2] - u[2] * v[1];
  out[1] = u[2] * v[0] - u[0] * v[2];
  out[2] = u[0] * v[1] - u[1] * v[0];
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float edge_d2(const float* q, const float* p0,
                                         const float* p1) {
  float e[3], w[3], dd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e[k] = p1[k] - p0[k];
    w[k] = q[k] - p0[k];
  }
  const float t = fminf(fmaxf(dot3(w, e) / fmaxf(dot3(e, e), 1e-30f), 0.f),
                        1.f);
#pragma unroll
  for (int k = 0; k < 3; ++k) dd[k] = w[k] - t * e[k];
  return dot3(dd, dd);
}

// _tri_d2_tile (pallas_queries.py:208); c = corners a, b, c
__device__ __forceinline__ float tri_d2(const float* q, const float* c) {
  float e1[3], e2[3], w[3], diff[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = c[3 + k] - c[k];
    e2[k] = c[6 + k] - c[k];
    w[k] = q[k] - c[k];
  }
  const float d11 = dot3(e1, e1);
  const float d12 = dot3(e1, e2);
  const float d22 = dot3(e2, e2);
  const float w1 = dot3(w, e1);
  const float w2 = dot3(w, e2);
  const float den = fmaxf(d11 * d22 - d12 * d12, 1e-30f);
  const float u = (d22 * w1 - d12 * w2) / den;
  const float v = (d11 * w2 - d12 * w1) / den;
  const bool inside = u >= 0.f && v >= 0.f && u + v <= 1.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) diff[k] = w[k] - u * e1[k] - v * e2[k];
  const float d2_edge =
      fminf(fminf(edge_d2(q, c, c + 3), edge_d2(q, c + 3, c + 6)),
            edge_d2(q, c + 6, c));
  return inside ? dot3(diff, diff) : d2_edge;
}

// Moller-Trumbore (geometry/primitives.ray_tri_intersect): t on a hit with
// |det| > 1e-12 and t in (1e-6, tmax], else +inf.  Padded slots carry
// identical PAD_COORD corners, so det = 0 and they miss.
__device__ __forceinline__ float mt_hit(const float* o, const float* d,
                                        const float* c, float tmax) {
  float e1[3], e2[3], p[3], tv[3], qv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = c[3 + k] - c[k];
    e2[k] = c[6 + k] - c[k];
    tv[k] = o[k] - c[k];
  }
  cross3(d, e2, p);
  const float det = dot3(e1, p);
  const bool ok = fabsf(det) > 1e-12f;
  const float safe = ok ? det : 1.f;
  const float u = dot3(tv, p) / safe;
  cross3(tv, e1, qv);
  const float v = dot3(d, qv) / safe;
  const float t = dot3(e2, qv) / safe;
  const bool hit = ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 1e-6f &&
                   t <= tmax;
  return hit ? t : inf_f();
}

__device__ __forceinline__ void load_corners(const float* base, int Kp,
                                             int slot, float* c) {
#pragma unroll
  for (int p = 0; p < 9; ++p) c[p] = base[p * Kp + slot];
}

// The Green-weighted in-ball CDF sample over a cell's Kp slots (K6's step
// 1 and K8): weights w = area * max((1/max(d, 1e-4) - 1/R) / 4pi, 0) for
// d < R, total their sum, and the selected slot the count of CDF entries
// <= u_sel * total (Kp: none).  The CDF is an fp32 warp scan (Kogge-Stone
// shuffles) in slot order, one 32-slot round at a time; no tensor-core
// product, so no TF32 rounding moves its boundaries.  Against the plain
// version's cumsum the slot can flip at a boundary under reassociation.
// Warp-uniform results; every lane of the warp calls it.
__device__ __forceinline__ int ball_sample(const float* base, int Kp,
                                           const float* qv, float R,
                                           float u_sel, int lane,
                                           float* w_sel_out,
                                           float* total_out) {
  const int rounds = Kp >> 5;
  float w[MAX_ROUNDS];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_ROUNDS; ++j) {
    w[j] = 0.f;
    if (j < rounds) {
      float cr[9], e1[3], e2[3], x[3];
      load_corners(base, Kp, j * 32 + lane, cr);
      const float dd = sqrtf(tri_d2(qv, cr));
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        e1[k] = cr[3 + k] - cr[k];
        e2[k] = cr[6 + k] - cr[k];
      }
      cross3(e1, e2, x);
      const float area = 0.5f * sqrtf(dot3(x, x));
      const float g = (1.f / fmaxf(dd, 1e-4f) - 1.f / R) * INV_4PI;
      w[j] = dd < R ? area * fmaxf(g, 0.f) : 0.f;
      part += w[j];
    }
  }
  float total = part;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
  const float target = u_sel * total;
  float off = 0.f;
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < MAX_ROUNDS; ++j) {
    if (j < rounds) {
      float x = w[j];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
      }
      const float cdf = off + x;
      cnt += target >= cdf ? 1 : 0;
      off = __shfl_sync(FULL, cdf, 31);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
  const int sel = cnt;                       // warp-uniform, 0..Kp
  float w_own = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_ROUNDS; ++j)
    if (j == (sel >> 5)) w_own = w[j];
  const float w_sel_all = __shfl_sync(FULL, w_own, sel & 31);
  *w_sel_out = sel < Kp ? w_sel_all : 0.f;
  *total_out = total;
  return sel;
}

// The closest ray hit over a cell's Kp slots (K6's walk ray and K7): the
// lexicographic (t, slot) argmin of mt_hit by warp shuffle, so the smallest
// slot wins equal t.  Warp-uniform t (+inf on a miss) and slot (Kp on a
// miss); every lane of the warp calls it.
__device__ __forceinline__ void closest_hit(const float* base, int Kp,
                                            const float* o, const float* d,
                                            float tmax, int lane,
                                            float* t_out, int* slot_out) {
  float best_t = inf_f();
  int best_slot = Kp;
  for (int k = lane; k < Kp; k += 32) {
    float cr[9];
    load_corners(base, Kp, k, cr);
    const float t = mt_hit(o, d, cr, tmax);
    if (t < best_t) {
      best_t = t;
      best_slot = k;
    }
  }
#pragma unroll
  for (int off2 = 16; off2 > 0; off2 >>= 1) {
    const float ot = __shfl_down_sync(FULL, best_t, off2);
    const int os = __shfl_down_sync(FULL, best_slot, off2);
    if (ot < best_t || (ot == best_t && os < best_slot)) {
      best_t = ot;
      best_slot = os;
    }
  }
  *t_out = __shfl_sync(FULL, best_t, 0);
  *slot_out = __shfl_sync(FULL, best_slot, 0);
}

// --------------------------------------------------------------------------
// K9: squared distance to the nearest silhouette entity of the lane's
// SilGrid cell.  3D: entity planes (C, 12, Kp) = p0 | p1 | n1 | n2 (x, y,
// z each), the edge distance: 48 bytes per slot, 3 KB per lane at K = 64,
// ~40 flops per slot.  2D: (C, 6, Kp) = p0 | n1 | n2 (x, y each), the
// vertex distance: 24 bytes per slot, 1.5 KB per lane, ~10 flops per slot.
// Both bound by the loads.  An entity counts when s1 * s2 <= 0 (n1 = 0
// for "always" entities); padded slots pass with d^2 ~ 1e18, which the
// caller maps to "none".  Lanes with cell < 0 get +inf.
// --------------------------------------------------------------------------

template <int DIM>
__global__ void sil_band_kernel(const int32_t* __restrict__ cell,
                                const float* __restrict__ q,
                                const float* __restrict__ coords, int64_t n,
                                int32_t Kp, float* __restrict__ d2_out) {
  constexpr int NP = DIM == 3 ? 12 : 6;
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int64_t c = cell[i];
  if (c < 0) {
    if (lane == 0) d2_out[i] = inf_f();
    return;
  }
  float qv[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) qv[d] = q[DIM * i + d];
  const float* base = coords + c * NP * Kp;
  float best = inf_f();
  for (int k = lane; k < Kp; k += 32) {
    float d2, s1, s2;
    if constexpr (DIM == 3) {
      float p0[3], e[3], w[3], v[3], n1[3], n2[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        p0[d] = base[d * Kp + k];
        e[d] = base[(3 + d) * Kp + k] - p0[d];
        w[d] = qv[d] - p0[d];
        n1[d] = base[(6 + d) * Kp + k];
        n2[d] = base[(9 + d) * Kp + k];
      }
      const float den = fmaxf(dot3(e, e), 1e-30f);
      const float t = fminf(fmaxf(dot3(w, e) / den, 0.f), 1.f);
#pragma unroll
      for (int d = 0; d < 3; ++d) v[d] = w[d] - t * e[d];
      d2 = dot3(v, v);
      s1 = dot3(n1, v);
      s2 = dot3(n2, v);
    } else {
      const float vx = qv[0] - base[k];
      const float vy = qv[1] - base[Kp + k];
      d2 = vx * vx + vy * vy;
      s1 = base[2 * Kp + k] * vx + base[3 * Kp + k] * vy;
      s2 = base[4 * Kp + k] * vx + base[5 * Kp + k] * vy;
    }
    if (s1 * s2 <= 0.f && d2 < best) best = d2;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = fminf(best, __shfl_xor_sync(FULL, best, o));
  if (lane == 0) d2_out[i] = best;
}

// --------------------------------------------------------------------------
// K6: one depth step's Neumann band work for a lane, over its prim-band
// cell's corner planes (C, 9, Kp): 36 bytes per slot, 2.3 KB per lane at
// K = 64, read once from device memory (the winners' reloads hit L1).
//   1. the in-ball CDF sample of ball_sample (total, slot, w_sel);
//   2. the sample point from barycentrics (1 - sqrt(u1), u2 sqrt(u1)) on
//      the selected triangle, its unnormalized plane normal, and
//      side = sign((q - a) . n); no selection gives PAD_COORD corners.
//   3. the visibility ray from o = q + on eps n to the sample point, any
//      hit within dist - eps;
//   4. the walk ray from o along d_walk, closest hit within R
//      (closest_hit), and the hit triangle's unit normal.
// out (n, 15): w_sel, total, sample_pt.xyz, side, plane_n.xyz, occluded,
// walk_hit, walk_t, walk_n.xyz; slot (n,).  Lanes with cell < 0 get zeros,
// walk_t = inf and slot = Kp.
// --------------------------------------------------------------------------

__global__ void band_neumann_walk_kernel(
    const int32_t* __restrict__ cell, const float* __restrict__ q,
    const float* __restrict__ R_in, const uint8_t* __restrict__ on_in,
    const float* __restrict__ nn, const float* __restrict__ u_sel_in,
    const float* __restrict__ u_pt, const float* __restrict__ dw,
    float eps, const float* __restrict__ coords, int64_t n, int32_t Kp,
    float* __restrict__ out, int32_t* __restrict__ slot_out) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  float* o15 = out + 15 * i;
  const int64_t c = cell[i];
  if (c < 0) {
    if (lane < 15) o15[lane] = lane == 11 ? inf_f() : 0.f;
    if (lane == 0) slot_out[i] = Kp;
    return;
  }
  const float* base = coords + c * 9 * Kp;
  const float qv[3] = {q[3 * i], q[3 * i + 1], q[3 * i + 2]};
  const float R = R_in[i];

  // 1. the in-ball CDF sample
  float w_sel, total;
  const int sel = ball_sample(base, Kp, qv, R, u_sel_in[i], lane, &w_sel,
                              &total);

  // 2. the sample point on the selected triangle
  float s[9];
  if (sel < Kp) {
    load_corners(base, Kp, sel, s);
  } else {
#pragma unroll
    for (int p = 0; p < 9; ++p) s[p] = PAD_COORD;
  }
  const float su = sqrtf(u_pt[2 * i]);
  const float b0 = 1.f - su;
  const float b1 = u_pt[2 * i + 1] * su;
  const float b2 = 1.f - b0 - b1;
  float sp[3], e1w[3], e2w[3], nw[3], qa[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sp[k] = s[k] * b0 + s[3 + k] * b1 + s[6 + k] * b2;
    e1w[k] = s[3 + k] - s[k];
    e2w[k] = s[6 + k] - s[k];
    qa[k] = qv[k] - s[k];
  }
  cross3(e1w, e2w, nw);
  const float pside = dot3(qa, nw);
  const float side = pside > 0.f ? 1.f : (pside < 0.f ? -1.f : 0.f);

  // 3. visibility ray
  const float oe = on_in[i] ? eps : 0.f;
  float o[3], ray[3], rd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = qv[k] + oe * nn[3 * i + k];
    ray[k] = sp[k] - o[k];
  }
  const float dist = sqrtf(dot3(ray, ray));
#pragma unroll
  for (int k = 0; k < 3; ++k) rd[k] = ray[k] / fmaxf(dist, 1e-20f);
  const float vis_tmax = dist - eps;
  bool any = false;
  for (int k = lane; k < Kp; k += 32) {
    float cr[9];
    load_corners(base, Kp, k, cr);
    any |= mt_hit(o, rd, cr, vis_tmax) < inf_f();
  }
  const bool occluded = __any_sync(FULL, any);

  // 4. walk ray
  const float dwv[3] = {dw[3 * i], dw[3 * i + 1], dw[3 * i + 2]};
  float best_t;
  int best_slot;
  closest_hit(base, Kp, o, dwv, R, lane, &best_t, &best_slot);
  const bool whit = best_t < inf_f();
  float wc[9], we1[3], we2[3], wcr[3];
  load_corners(base, Kp, best_slot < Kp ? best_slot : Kp - 1, wc);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    we1[k] = wc[3 + k] - wc[k];
    we2[k] = wc[6 + k] - wc[k];
  }
  cross3(we1, we2, wcr);
  const float wlen = sqrtf(fmaxf(dot3(wcr, wcr), 1e-38f));

  if (lane == 0) {
    o15[0] = w_sel;
    o15[1] = total;
    o15[2] = sp[0];
    o15[3] = sp[1];
    o15[4] = sp[2];
    o15[5] = side;
    o15[6] = nw[0];
    o15[7] = nw[1];
    o15[8] = nw[2];
    o15[9] = occluded ? 1.f : 0.f;
    o15[10] = whit ? 1.f : 0.f;
    o15[11] = whit ? best_t : inf_f();
#pragma unroll
    for (int k = 0; k < 3; ++k) o15[12 + k] = whit ? wcr[k] / wlen : 0.f;
    slot_out[i] = sel;
  }
}

// --------------------------------------------------------------------------
// K7: the closest hit of each lane's ray o + t d, t in (1e-6, tmax], over
// its prim-band cell (K6's walk ray alone): 36 bytes per slot of each
// distinct cell, ~45 flops per slot; bound by the loads.  t (n,) is +inf
// and slot (n,) is Kp on a miss and on lanes with cell < 0.
// --------------------------------------------------------------------------

__global__ void band_ray_kernel(const int32_t* __restrict__ cell,
                                const float* __restrict__ o,
                                const float* __restrict__ d,
                                const float* __restrict__ tmax,
                                const float* __restrict__ coords, int64_t n,
                                int32_t Kp, float* __restrict__ t_out,
                                int32_t* __restrict__ slot_out) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int64_t c = cell[i];
  if (c < 0) {
    if (lane == 0) {
      t_out[i] = inf_f();
      slot_out[i] = Kp;
    }
    return;
  }
  const float ov[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const float dv[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  float t;
  int slot;
  closest_hit(coords + c * 9 * Kp, Kp, ov, dv, tmax[i], lane, &t, &slot);
  if (lane == 0) {
    t_out[i] = t;
    slot_out[i] = slot;
  }
}

// --------------------------------------------------------------------------
// K8: the Green-weighted in-ball CDF sample over each lane's prim-band
// cell (K6's step 1 alone): slot (n,) (Kp: none), w_sel and total (n,).
// 36 bytes per slot of each distinct cell, ~80 flops and two square roots
// per slot; bound by the loads.  Lanes with cell < 0 get slot = Kp and
// zeros.
// --------------------------------------------------------------------------

__global__ void band_ball_kernel(const int32_t* __restrict__ cell,
                                 const float* __restrict__ q,
                                 const float* __restrict__ R_in,
                                 const float* __restrict__ u_in,
                                 const float* __restrict__ coords, int64_t n,
                                 int32_t Kp, int32_t* __restrict__ slot_out,
                                 float* __restrict__ w_sel_out,
                                 float* __restrict__ total_out) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int64_t c = cell[i];
  if (c < 0) {
    if (lane == 0) {
      slot_out[i] = Kp;
      w_sel_out[i] = 0.f;
      total_out[i] = 0.f;
    }
    return;
  }
  const float qv[3] = {q[3 * i], q[3 * i + 1], q[3 * i + 2]};
  float w_sel, total;
  const int sel = ball_sample(coords + c * 9 * Kp, Kp, qv, R_in[i], u_in[i],
                              lane, &w_sel, &total);
  if (lane == 0) {
    slot_out[i] = sel;
    w_sel_out[i] = w_sel;
    total_out[i] = total;
  }
}

// --------------------------------------------------------------------------
// K13: the closest of all P segments to each query point q (N, 2), with
// segments a (P, 2) -> b (P, 2): dist = sqrt(min d^2) and the smallest
// index attaining it (a strict < in index order, as the TPU kernel's
// min(where(d2 <= best, cols, P))); when every d^2 overflows, index 0, as
// there.  One thread a lane; a block stages the set through shared memory
// DENSE_TILE segments (32 KB) at a time, and every thread of the block
// reads the same slot (a broadcast).  ~14 flops and one division per
// (lane, segment): bound by the operations (the set and the lanes are a
// few MB, read once).
// --------------------------------------------------------------------------

constexpr int DENSE_TILE = 2048;

__global__ void closest_point_dense_kernel(const float* __restrict__ q,
                                           const float* __restrict__ seg_a,
                                           const float* __restrict__ seg_b,
                                           int64_t n, int32_t P,
                                           float* __restrict__ dist_out,
                                           int32_t* __restrict__ prim_out) {
  __shared__ float4 tile[DENSE_TILE];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float qx = live ? q[2 * i] : 0.f;
  const float qy = live ? q[2 * i + 1] : 0.f;
  float best = inf_f();
  int best_p = P;
  for (int p0 = 0; p0 < P; p0 += DENSE_TILE) {
    const int m = min(DENSE_TILE, P - p0);
    __syncthreads();                     // the previous tile is consumed
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      const int64_t p = p0 + k;
      tile[k] = make_float4(seg_a[2 * p], seg_a[2 * p + 1], seg_b[2 * p],
                            seg_b[2 * p + 1]);
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float4 s = tile[k];
      float t;
      const float d2 = seg_d2(qx - s.x, qy - s.y, s.z - s.x, s.w - s.y, &t);
      if (d2 < best) {
        best = d2;
        best_p = p0 + k;
      }
    }
  }
  if (live) {
    dist_out[i] = sqrtf(best);
    prim_out[i] = best_p < P ? best_p : 0;
  }
}

// --------------------------------------------------------------------------
// K12: the closest segment over each lane's own K gathered candidates:
// q (N, 2), endpoint planes ax, ay, bx, by (N, K) and valid (N, K) ->
// dist = sqrt(min d^2 over valid slots) (inf when none is) and the
// smallest slot attaining it (0 when the min is inf, as the TPU kernel's
// min(where(d2 <= best, cols, K))).  One warp a lane, K10's form: the lanes
// stride the row, whose planes are contiguous, and the winner is the
// lexicographic (d^2, slot) argmin by warp shuffle.  17 bytes and ~14
// flops per (lane, slot): bound by the bytes.
// --------------------------------------------------------------------------

__global__ void candidate_band_kernel(const float* __restrict__ q,
                                      const float* __restrict__ ax_p,
                                      const float* __restrict__ ay_p,
                                      const float* __restrict__ bx_p,
                                      const float* __restrict__ by_p,
                                      const uint8_t* __restrict__ valid,
                                      int64_t n, int32_t K,
                                      float* __restrict__ dist_out,
                                      int32_t* __restrict__ slot_out) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const float qx = q[2 * i];
  const float qy = q[2 * i + 1];
  const int64_t off = i * K;
  float best_d2 = inf_f();
  int best_slot = K;
  for (int k = lane; k < K; k += 32) {
    if (!valid[off + k]) continue;
    const float ax = ax_p[off + k];
    const float ay = ay_p[off + k];
    float t;
    const float d2 = seg_d2(qx - ax, qy - ay, bx_p[off + k] - ax,
                            by_p[off + k] - ay, &t);
    if (d2 < best_d2) {
      best_d2 = d2;
      best_slot = k;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od2 = __shfl_down_sync(FULL, best_d2, o);
    const int os = __shfl_down_sync(FULL, best_slot, o);
    if (od2 < best_d2 || (od2 == best_d2 && os < best_slot)) {
      best_d2 = od2;
      best_slot = os;
    }
  }
  if (lane == 0) {
    dist_out[i] = sqrtf(best_d2);
    slot_out[i] = best_slot < K ? best_slot : 0;
  }
}

template <int DIM>
int sil_band_dim(const void* cell, const void* q, const void* coords,
                 int64_t n, int32_t Kp, void* d2, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + THREADS / 32 - 1) / (THREADS / 32);
  sil_band_kernel<DIM><<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)cell, (const float*)q, (const float*)coords, n, Kp,
      (float*)d2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K9, 3D: coords (C, 12, Kp)
int sil_band_launch(const void* cell, const void* q, const void* coords,
                    int64_t n, int32_t Kp, void* d2, void* stream) {
  return sil_band_dim<3>(cell, q, coords, n, Kp, d2, stream);
}

// K9, 2D: coords (C, 6, Kp)
int sil_band_2d_launch(const void* cell, const void* q, const void* coords,
                       int64_t n, int32_t Kp, void* d2, void* stream) {
  return sil_band_dim<2>(cell, q, coords, n, Kp, d2, stream);
}

int closest_point_dense_launch(const void* q, const void* seg_a,
                               const void* seg_b, int64_t n, int32_t P,
                               void* dist, void* prim, void* stream) {
  if (n == 0) return 0;
  if (P <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  closest_point_dense_kernel<<<(unsigned)blocks, THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const float*)q, (const float*)seg_a, (const float*)seg_b, n, P,
      (float*)dist, (int32_t*)prim);
  return (int)cudaGetLastError();
}

int candidate_band_launch(const void* q, const void* ax, const void* ay,
                          const void* bx, const void* by, const void* valid,
                          int64_t n, int32_t K, void* dist, void* slot,
                          void* stream) {
  if (n == 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + THREADS / 32 - 1) / (THREADS / 32);
  candidate_band_kernel<<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const float*)q, (const float*)ax, (const float*)ay, (const float*)bx,
      (const float*)by, (const uint8_t*)valid, n, K, (float*)dist,
      (int32_t*)slot);
  return (int)cudaGetLastError();
}

int band_neumann_walk_launch(const void* cell, const void* q, const void* R,
                             const void* on, const void* nn,
                             const void* u_sel, const void* u_pt,
                             const void* dw, float eps, const void* coords,
                             int64_t n, int32_t Kp, void* out, void* slot,
                             void* stream) {
  if (n == 0) return 0;
  if (Kp > 32 * MAX_ROUNDS || Kp % 32) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + THREADS / 32 - 1) / (THREADS / 32);
  band_neumann_walk_kernel<<<(unsigned)blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)cell, (const float*)q, (const float*)R,
      (const uint8_t*)on, (const float*)nn, (const float*)u_sel,
      (const float*)u_pt, (const float*)dw, eps, (const float*)coords, n, Kp,
      (float*)out, (int32_t*)slot);
  return (int)cudaGetLastError();
}

int band_ray_launch(const void* cell, const void* o, const void* d,
                    const void* tmax, const void* coords, int64_t n,
                    int32_t Kp, void* t, void* slot, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + THREADS / 32 - 1) / (THREADS / 32);
  band_ray_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cell, (const float*)o, (const float*)d,
      (const float*)tmax, (const float*)coords, n, Kp, (float*)t,
      (int32_t*)slot);
  return (int)cudaGetLastError();
}

int band_ball_launch(const void* cell, const void* q, const void* R,
                     const void* u, const void* coords, int64_t n,
                     int32_t Kp, void* slot, void* w_sel, void* total,
                     void* stream) {
  if (n == 0) return 0;
  if (Kp > 32 * MAX_ROUNDS || Kp % 32) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + THREADS / 32 - 1) / (THREADS / 32);
  band_ball_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cell, (const float*)q, (const float*)R,
      (const float*)u, (const float*)coords, n, Kp, (int32_t*)slot,
      (float*)w_sel, (float*)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
