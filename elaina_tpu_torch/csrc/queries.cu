// Neumann band-grid kernels for Hopper (sm_90a), bound through ctypes.
//
// They replace the two Pallas kernels of elaina_tpu/ops/pallas_queries.py
// that run on every depth step of a 3D scene with a Neumann set:
//
//   K6 band_neumann_walk_dma_3d (pallas_queries.py:1043, kernel
//      _make_band_neumann_walk_kernel_3d :862)   -> band_neumann_walk_kernel
//   K9 sil_band_dma (pallas_queries.py:622, kernel :563; 3D and 2D)
//                                -> sil_band_kernel (3D), sil_band_2d_kernel
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
//   K12 candidate_band_pallas (pallas_queries.py:499, body :469), with
//       the gathers that feed it (elaina_tpu/geometry/grid.py:1271-1292)
//                                                -> candidate_rows_kernel
//
// K7 is K6's walk ray and K8 its in-ball CDF sample: they take the same
// per-slot and per-warp device functions (mt_hit and warp_closest;
// ball_weight and cdf_select) in the same slot order, so the fused and the
// unfused step agree bit for bit wherever their inputs do.  K12 and K13
// take resolve.cu's segment distance (segment.cuh).
//
// The contracts are the TPU kernels'; the TPU shapes are not carried over:
// no per-lane block DMAs, (BL, 128) tiles, one-hot winner picks or
// triangular-matmul prefix sums.  One warp serves one lane at a time and
// strides over the Kp slots of the lane's cell, whose table is planes by
// slot, so each load instruction of the warp reads 128 contiguous bytes
// (K13, which reads one shared set, is one thread for a few lanes
// instead, and K12 one thread a lane; K9-2D serves several lanes a warp;
// K6, K7 and K8 test several lanes a warp and sweep only those with band
// work).  Lanes with
// cell < 0 (outside the grid) do no work.  Each
// launch function enqueues on the caller's stream, allocates nothing and
// returns cudaGetLastError().
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

// The Green-weighted in-ball weight of one slot (K6's step 1 and K8):
// area * max((1/max(d, 1e-4) - 1/R) / 4pi, 0) for d < R, else 0.
__device__ __forceinline__ float ball_weight(const float* qv, const float* cr,
                                            float R) {
  float e1[3], e2[3], x[3];
  const float dd = sqrtf(tri_d2(qv, cr));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = cr[3 + k] - cr[k];
    e2[k] = cr[6 + k] - cr[k];
  }
  cross3(e1, e2, x);
  const float area = 0.5f * sqrtf(dot3(x, x));
  const float g = (1.f / fmaxf(dd, 1e-4f) - 1.f / R) * INV_4PI;
  return dd < R ? area * fmaxf(g, 0.f) : 0.f;
}

// The in-ball CDF sample over a cell's Kp slots from each thread's
// weights w[j] of slot j * 32 + lane (0 for j >= Kp / 32) and their
// sum ``part`` in j order: total the weights' sum, and the selected slot
// the count of CDF entries <= u_sel * total (Kp: none).  The CDF is an
// fp32 warp scan (Kogge-Stone shuffles) in slot order, one 32-slot round
// at a time; no tensor-core product, so no TF32 rounding moves its
// boundaries.  Against the plain version's cumsum the slot can flip at a
// boundary under reassociation.  Warp-uniform results; every lane of the
// warp calls it.
template <int MAXR>
__device__ __forceinline__ int cdf_select(const float* w, float part,
                                          int rounds, int Kp, float u_sel,
                                          int lane, float* w_sel_out,
                                          float* total_out) {
  float total = part;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
  const float target = u_sel * total;
  float off = 0.f;
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < MAXR; ++j) {
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
  for (int j = 0; j < MAXR; ++j)
    if (j == (sel >> 5)) w_own = w[j];
  const float w_sel_all = __shfl_sync(FULL, w_own, sel & 31);
  *w_sel_out = sel < Kp ? w_sel_all : 0.f;
  *total_out = total;
  return sel;
}

// K8's in-ball CDF sample, each slot's corners read once from device
// memory (K6 takes cdf_select over the corners it holds in registers).
template <int MAXR>
__device__ __forceinline__ int ball_sample(const float* base, int Kp,
                                           const float* qv, float R,
                                           float u_sel, int lane,
                                           float* w_sel_out,
                                           float* total_out) {
  const int rounds = Kp >> 5;
  float w[MAXR];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < MAXR; ++j) {
    w[j] = 0.f;
    if (j < rounds) {
      float cr[9];
      load_corners(base, Kp, j * 32 + lane, cr);
      w[j] = ball_weight(qv, cr, R);
      part += w[j];
    }
  }
  return cdf_select<MAXR>(w, part, rounds, Kp, u_sel, lane, w_sel_out,
                          total_out);
}

// The lexicographic (t, slot) argmin of each thread's best hit by warp
// shuffle, so the smallest slot wins equal t: warp-uniform t (+inf on a
// miss) and slot (Kp on a miss).
__device__ __forceinline__ void warp_closest(float best_t, int best_slot,
                                             float* t_out, int* slot_out) {
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

// K7's closest ray hit over a cell's Kp slots, each slot's corners read
// from device memory: mt_hit per slot in slot order with a strict <, then
// warp_closest (K6 runs the same over the corners in its registers).
// Every lane of the warp calls it.
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
  warp_closest(best_t, best_slot, t_out, slot_out);
}

// --------------------------------------------------------------------------
// K9: squared distance to the nearest silhouette entity of the lane's
// SilGrid cell.  An entity counts when s1 * s2 <= 0 (n1 = 0 for "always"
// entities); padded slots pass with d^2 ~ 1e18, which the caller maps to
// "none".  Lanes with cell < 0 get +inf.
//
// 3D: entity planes (C, 12, Kp) = p0 | p1 | n1 | n2 (x, y, z each), the
// edge distance: 48 bytes per slot, 3 KB per lane at K = 64, ~40 flops
// per slot; bound by the loads.  One warp a lane.
// --------------------------------------------------------------------------

__global__ void sil_band_kernel(const int32_t* __restrict__ cell,
                                const float* __restrict__ q,
                                const float* __restrict__ coords, int64_t n,
                                int32_t Kp, float* __restrict__ d2_out) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int64_t c = cell[i];
  if (c < 0) {
    if (lane == 0) d2_out[i] = inf_f();
    return;
  }
  float qv[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) qv[d] = q[3 * i + d];
  const float* base = coords + c * 12 * Kp;
  float best = inf_f();
  for (int k = lane; k < Kp; k += 32) {
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
    const float d2 = dot3(v, v);
    const float s1 = dot3(n1, v);
    const float s2 = dot3(n2, v);
    if (s1 * s2 <= 0.f && d2 < best) best = d2;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = fminf(best, __shfl_xor_sync(FULL, best, o));
  if (lane == 0) d2_out[i] = best;
}

// --------------------------------------------------------------------------
// K9, 2D: the vertex distance over the lane's cell of a 2D SilGrid, 24
// bytes and ~10 flops per slot, 1.5 KB per lane at K = 64.  The table is
// planes by slot, (C, 6, Kp) = p0 | n1 | n2 (x, y each).
//
// What bounds it: on the 2D paths every lane of a 1024^2 frame queries
// it each step, and neighbouring lanes share cells, so the rows come from
// L1 and L2 (1.5 GB a call at wavy8192_u's 1,048,576 lanes against ~61 MB
// of distinct rows).  One warp a lane left each warp one lane's chain of
// dependent loads with little in flight.  So a warp serves SIL_2D_G = 8
// lanes: 4 threads a lane, each reading four consecutive slots of a plane
// in one 16-byte load (a lane's 4 threads read 64 bytes of a plane, so
// each of its six loads touches one line a lane), and a 2-step shuffle
// tree within the lane's threads.  Each of a lane's threads reads its
// live bit, cell and point (the same words, so one transaction).
// ``live`` (n,) (null: every lane) takes a dead walk out before it reads
// its cell: it gets +inf, as a lane outside the grid.  fminf is exact and
// commutative, so the split over threads changes no bit: d^2 is the plain
// version's.  This form was chosen by trial on the card against 1, 2, 4
// and 32 lanes a warp, each with one slot a load and with (x, y) pairs a
// load (every form's time in PERF.md): it and the wide-load forms at 2 and
// 4 lanes a warp ran at 0.15-0.18 ms, near the L2's rate for the rows'
// 1.5 GB; one slot a load at 4 or more lanes a warp, and any form at one
// thread a lane, ran 1.7x to 8.2x slower.
// --------------------------------------------------------------------------

constexpr int SIL_2D_G = 8;  // lanes a warp

__device__ __forceinline__ void sil_slot_2d(float qx, float qy, float px,
                                            float py, float ax, float ay,
                                            float bx, float by,
                                            float* best) {
  const float vx = qx - px;
  const float vy = qy - py;
  const float d2 = vx * vx + vy * vy;
  const float s1 = ax * vx + ay * vy;
  const float s2 = bx * vx + by * vy;
  if (s1 * s2 <= 0.f && d2 < *best) *best = d2;
}

__global__ void __launch_bounds__(THREADS) sil_band_2d_kernel(
    const int32_t* __restrict__ cell, const float* __restrict__ q,
    const float* __restrict__ coords, const uint8_t* __restrict__ live,
    int64_t n, int32_t Kp, float* __restrict__ d2_out) {
  constexpr int T = 32 / SIL_2D_G;           // threads a lane
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / T;
  const int j = threadIdx.x % T;
  float best = inf_f();
  if (i < n && (live == nullptr || live[i])) {
    const int64_t c = cell[i];
    if (c >= 0) {
      const float qx = q[2 * i];
      const float qy = q[2 * i + 1];
      const float* base = coords + c * 6 * Kp;
#pragma unroll 2
      for (int k = 4 * j; k < Kp; k += 4 * T) {
        float4 p[6];
#pragma unroll
        for (int g = 0; g < 6; ++g)
          p[g] = *reinterpret_cast<const float4*>(base + g * Kp + k);
        sil_slot_2d(qx, qy, p[0].x, p[1].x, p[2].x, p[3].x, p[4].x, p[5].x,
                    &best);
        sil_slot_2d(qx, qy, p[0].y, p[1].y, p[2].y, p[3].y, p[4].y, p[5].y,
                    &best);
        sil_slot_2d(qx, qy, p[0].z, p[1].z, p[2].z, p[3].z, p[4].z, p[5].z,
                    &best);
        sil_slot_2d(qx, qy, p[0].w, p[1].w, p[2].w, p[3].w, p[4].w, p[5].w,
                    &best);
      }
    }
  }
#pragma unroll
  for (int o = T / 2; o > 0; o >>= 1)
    best = fminf(best, __shfl_xor_sync(FULL, best, o));
  if (j == 0 && i < n) d2_out[i] = best;
}

// --------------------------------------------------------------------------
// K6: one depth step's Neumann band work for a lane, over its prim-band
// cell's corner planes (C, 9, Kp): 36 bytes per slot, 2.3 KB per lane at
// K = 64.
//   1. the in-ball CDF sample (ball_weight, cdf_select: total, slot,
//      w_sel);
//   2. the sample point from barycentrics (1 - sqrt(u1), u2 sqrt(u1)) on
//      the selected triangle, its unnormalized plane normal, and
//      side = sign((q - a) . n); no selection gives PAD_COORD corners.
//   3. the visibility ray from o = q + on eps n to the sample point, any
//      hit within dist - eps;
//   4. the walk ray from o along d_walk, closest hit within R
//      (warp_closest), and the hit triangle's unit normal.
// out (n, 15): w_sel, total, sample_pt.xyz, side, plane_n.xyz, occluded,
// walk_hit, walk_t, walk_n.xyz; slot (n,).
//
// Bound: at neumann3d_u's shapes most lanes need no band work (the walk
// is dead, or its ball and rays cannot reach the cell's nearest kept
// prim), and the rest ~200 flops and 36 bytes a slot.  So a lane first
// takes the skip test: a lane that is not live (``live``, when given),
// outside the grid (cell < 0), or whose reach R + oe (oe = eps on a
// Neumann lane, else 0: the rays start at q + oe n, so a hit lies within
// R + oe of q) lies below its cell's ``skip_r`` (the band grid's lbound
// less a float margin, geometry/grid.py; when given) writes the outputs
// of a lane without a selection or a hit -- zeros, walk_t = inf and slot
// = Kp -- without reading a corner.  On a live lane every output the step
// reads (slot, w_sel, total, walk_hit, walk_t, walk_n) is then what the
// kernel without the skip gives; occluded, sample_pt, side and plane_n of
// a lane without a selection differ (the visibility ray toward the PAD
// corners is not traced), and the step masks them.  A warp tests BAND_G
// lanes at once and runs the band work of those that need it one after
// the other (G = 4 was chosen by trial on the card among 1, 4, 8 and 32):
// each lane's Kp x 9 corners are read once, into registers
// (MAXR rounds of 32 slots: 18 floats a thread at Kp = 64, 72 at Kp =
// 256), and the CDF, the visibility ray and the walk ray run from there;
// the selected and the hit triangle's corners come by shuffle from the
// thread that holds them.
// --------------------------------------------------------------------------

constexpr int BAND_G = 4;     // lanes a warp tests at once (K6, K7, K8)

// The select-and-shuffle of slot ``slot``'s corners (slot < 32 * MAXR)
// from the thread that holds them, to every thread of the warp.
template <int MAXR>
__device__ __forceinline__ void shfl_corners(const float (*cr)[9], int slot,
                                             float* out) {
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    float v = cr[0][p];
#pragma unroll
    for (int j = 1; j < MAXR; ++j)
      if (j == (slot >> 5)) v = cr[j][p];
    out[p] = __shfl_sync(FULL, v, slot & 31);
  }
}

template <int MAXR>
__device__ __forceinline__ void band_walk_lane(
    int64_t i, int lane, const int32_t* __restrict__ cell,
    const float* __restrict__ q, const float* __restrict__ R_in,
    const uint8_t* __restrict__ on_in, const float* __restrict__ nn,
    const float* __restrict__ u_sel_in, const float* __restrict__ u_pt,
    const float* __restrict__ dw, float eps,
    const float* __restrict__ coords, int32_t Kp, float* __restrict__ out,
    int32_t* __restrict__ slot_out) {
  const int rounds = Kp >> 5;
  const float* base = coords + (int64_t)cell[i] * 9 * Kp;
  float cr[MAXR][9];
#pragma unroll
  for (int j = 0; j < MAXR; ++j) {
    if (j < rounds) {
      load_corners(base, Kp, j * 32 + lane, cr[j]);
    } else {
#pragma unroll
      for (int p = 0; p < 9; ++p) cr[j][p] = 0.f;
    }
  }
  const float qv[3] = {q[3 * i], q[3 * i + 1], q[3 * i + 2]};
  const float R = R_in[i];

  // 1. the in-ball CDF sample
  float w[MAXR];
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < MAXR; ++j) {
    w[j] = 0.f;
    if (j < rounds) {
      w[j] = ball_weight(qv, cr[j], R);
      part += w[j];
    }
  }
  float w_sel, total;
  const int sel = cdf_select<MAXR>(w, part, rounds, Kp, u_sel_in[i], lane,
                                   &w_sel, &total);

  // 2. the sample point on the selected triangle
  float s[9];
  if (sel < Kp) {
    shfl_corners<MAXR>(cr, sel, s);
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
#pragma unroll
  for (int j = 0; j < MAXR; ++j)
    if (j < rounds) any |= mt_hit(o, rd, cr[j], vis_tmax) < inf_f();
  const bool occluded = __any_sync(FULL, any);

  // 4. walk ray
  const float dwv[3] = {dw[3 * i], dw[3 * i + 1], dw[3 * i + 2]};
  float best_t = inf_f();
  int best_slot = Kp;
#pragma unroll
  for (int j = 0; j < MAXR; ++j) {
    if (j < rounds) {
      const float t = mt_hit(o, dwv, cr[j], R);
      if (t < best_t) {
        best_t = t;
        best_slot = j * 32 + lane;
      }
    }
  }
  warp_closest(best_t, best_slot, &best_t, &best_slot);
  const bool whit = best_t < inf_f();
  float wn[3] = {0.f, 0.f, 0.f};
  if (whit) {
    float wc[9], we1[3], we2[3], wcr[3];
    shfl_corners<MAXR>(cr, best_slot, wc);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      we1[k] = wc[3 + k] - wc[k];
      we2[k] = wc[6 + k] - wc[k];
    }
    cross3(we1, we2, wcr);
    const float wlen = sqrtf(fmaxf(dot3(wcr, wcr), 1e-38f));
#pragma unroll
    for (int k = 0; k < 3; ++k) wn[k] = wcr[k] / wlen;
  }

  if (lane == 0) {
    float* o15 = out + 15 * i;
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
    o15[11] = best_t;                    // +inf on a miss
#pragma unroll
    for (int k = 0; k < 3; ++k) o15[12 + k] = wn[k];
    slot_out[i] = sel;
  }
}

template <int MAXR>
__global__ void __launch_bounds__(THREADS) band_neumann_walk_kernel(
    const int32_t* __restrict__ cell, const float* __restrict__ q,
    const float* __restrict__ R_in, const uint8_t* __restrict__ on_in,
    const float* __restrict__ nn, const float* __restrict__ u_sel_in,
    const float* __restrict__ u_pt, const float* __restrict__ dw,
    float eps, const float* __restrict__ coords,
    const float* __restrict__ skip_r, const uint8_t* __restrict__ live,
    int64_t n, int32_t Kp, float* __restrict__ out,
    int32_t* __restrict__ slot_out) {
  const int64_t first =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * BAND_G;
  const int lane = threadIdx.x & 31;
  bool work = false;
  if (lane < BAND_G && first + lane < n) {
    const int64_t i = first + lane;
    const int64_t c = cell[i];
    work = c >= 0 && (live == nullptr || live[i]);
    if (work && skip_r != nullptr)
      work = !(R_in[i] + (on_in[i] ? eps : 0.f) < skip_r[c]);
    if (!work) {
      float* o15 = out + 15 * i;
#pragma unroll
      for (int k = 0; k < 15; ++k) o15[k] = k == 11 ? inf_f() : 0.f;
      slot_out[i] = Kp;
    }
  }
  for (unsigned todo = __ballot_sync(FULL, work); todo; todo &= todo - 1)
    band_walk_lane<MAXR>(first + __ffs(todo) - 1, lane, cell, q, R_in, on_in,
                         nn, u_sel_in, u_pt, dw, eps, coords, Kp, out,
                         slot_out);
}

// --------------------------------------------------------------------------
// K7: the closest hit of each lane's ray o + t d, t in (1e-6, tmax], over
// its prim-band cell (K6's walk ray alone): 36 bytes per slot of each
// distinct cell, ~45 flops per slot.  t (n,) is +inf and slot (n,) is Kp
// on a miss, on lanes with cell < 0, and on the lanes it skips.
//
// Bound: at neumann3d_u's star radii no lane's ray reaches a prim of its
// row (the radii stay below the blob's band lbound), so a sweep of every
// slot of every lane finds nothing.  So, as K6, a lane first takes the
// skip test: a lane that is not live (``live``, when given), outside the
// grid, or whose reach tmax + offset lies below its cell's ``skip_r``
// (when given) writes the outputs of a miss without reading a corner.
// ``offset`` bounds |o - ref|, ref the point whose cell the caller passed
// (the eps of an offset origin): every point of the ray then lies within
// tmax + offset of a point of the cell, and skip_r is the cell's lbound
// less a float margin (geometry/grid.band_skip_radius), so a skipped lane
// has no hit, which is what the sweep gives it.  A warp tests BAND_G lanes
// at once and sweeps those with band work one after the other, each
// slot's corners read once (closest_hit, K6's walk ray in slot order).
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) band_ray_kernel(
    const int32_t* __restrict__ cell, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmax,
    const float* __restrict__ coords, const float* __restrict__ skip_r,
    const uint8_t* __restrict__ live, float offset, int64_t n, int32_t Kp,
    float* __restrict__ t_out, int32_t* __restrict__ slot_out) {
  const int64_t first =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * BAND_G;
  const int lane = threadIdx.x & 31;
  bool work = false;
  if (lane < BAND_G && first + lane < n) {
    const int64_t i = first + lane;
    if (live == nullptr || live[i]) {
      const int64_t c = cell[i];
      work = c >= 0;
      if (work && skip_r != nullptr) work = !(tmax[i] + offset < skip_r[c]);
    }
    if (!work) {
      t_out[i] = inf_f();
      slot_out[i] = Kp;
    }
  }
  for (unsigned todo = __ballot_sync(FULL, work); todo; todo &= todo - 1) {
    const int64_t i = first + __ffs(todo) - 1;
    const float ov[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    const float dv[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
    float t;
    int slot;
    closest_hit(coords + (int64_t)cell[i] * 9 * Kp, Kp, ov, dv, tmax[i],
                lane, &t, &slot);
    if (lane == 0) {
      t_out[i] = t;
      slot_out[i] = slot;
    }
  }
}

// --------------------------------------------------------------------------
// K8: the Green-weighted in-ball CDF sample over each lane's prim-band
// cell (K6's step 1 alone): slot (n,) (Kp: none), w_sel and total (n,).
// 36 bytes per slot of each distinct cell, ~80 flops and two square roots
// per slot.
//
// Bound: at neumann3d_u's star radii few balls reach a prim of their row
// (the radii stay below the blob's band lbound), so a sweep of every slot
// of every lane finds no weight.  So, as K6 and K7, a lane first takes
// the skip test: a lane that is not live (``live``, when given), outside
// the grid (cell < 0), or whose reach R + offset lies below its cell's
// ``skip_r`` (when given) writes slot = Kp, w_sel = 0 and total = 0
// without reading a corner.  These are the sweep's own outputs when no
// slot weighs: every weight is +0 (d >= R), so total is +0, the target
// u * 0 is at or above every CDF entry, the count is Kp and w_sel 0.  The
// ball is centred on the point whose cell was passed, so the depth step
// passes offset 0.  A warp tests BAND_G lanes at once and sweeps those
// with band work one after the other, each slot's corners read once
// (ball_sample, K6's step 1 in slot order).
// --------------------------------------------------------------------------

template <int MAXR>
__global__ void __launch_bounds__(THREADS) band_ball_kernel(
    const int32_t* __restrict__ cell, const float* __restrict__ q,
    const float* __restrict__ R_in, const float* __restrict__ u_in,
    const float* __restrict__ coords, const float* __restrict__ skip_r,
    const uint8_t* __restrict__ live, float offset, int64_t n, int32_t Kp,
    int32_t* __restrict__ slot_out, float* __restrict__ w_sel_out,
    float* __restrict__ total_out) {
  const int64_t first =
      (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * BAND_G;
  const int lane = threadIdx.x & 31;
  bool work = false;
  if (lane < BAND_G && first + lane < n) {
    const int64_t i = first + lane;
    if (live == nullptr || live[i]) {
      const int64_t c = cell[i];
      work = c >= 0;
      if (work && skip_r != nullptr) work = !(R_in[i] + offset < skip_r[c]);
    }
    if (!work) {
      slot_out[i] = Kp;
      w_sel_out[i] = 0.f;
      total_out[i] = 0.f;
    }
  }
  for (unsigned todo = __ballot_sync(FULL, work); todo; todo &= todo - 1) {
    const int64_t i = first + __ffs(todo) - 1;
    const float qv[3] = {q[3 * i], q[3 * i + 1], q[3 * i + 2]};
    float w_sel, total;
    const int sel =
        ball_sample<MAXR>(coords + (int64_t)cell[i] * 9 * Kp, Kp, qv,
                          R_in[i], u_in[i], lane, &w_sel, &total);
    if (lane == 0) {
      slot_out[i] = sel;
      w_sel_out[i] = w_sel;
      total_out[i] = total;
    }
  }
}

// --------------------------------------------------------------------------
// K13: the closest of all P segments to each query point q (N, 2), with
// segments a (P, 2) -> b (P, 2): dist = sqrt(min d^2) and the smallest
// index attaining it (a strict < in index order, as the TPU kernel's
// min(where(d2 <= best, cols, P))); when every d^2 overflows, index 0, as
// there.  In its lane-list form (``active`` given) it sweeps only the
// lanes ``lanes[0, cnt)`` that K1 compacted from ``active``: list position
// p sweeps lane lanes[p] and writes at that lane, and every lane that
// ``active`` leaves out gets dist = +inf and prim = 0 from the same
// launch.  The count is read on the device: the grid is sized by N, and
// a block whose positions all lie past cnt only writes those.
//
// Bound: ~14 flops and one IEEE division per (lane, segment), so the
// operations (the set and the lanes are a few MB, read once).  A block
// takes 32 x DENSE_LPT lanes and stages the set in shared memory with
// cp.async -- the whole set when it has at most DENSE_ONE_TILE segments,
// else DENSE_TILE at a time, two tiles in flight -- turning each segment
// into (ax, ay, ex, ey) and den = max(|e|^2, 1e-30) once (seg_den: the
// plain version's operations on the same inputs, so the same bits).  Each
// of its DENSE_WARPS warps sweeps its own share of each tile for all the
// block's lanes, DENSE_LPT lanes a thread (each shared-memory read feeds
// that many independent chains, which hide the division's latency), and
// the shares meet in shared memory in a lexicographic (d^2, index) min:
// the smallest index attaining the least d^2, as one sweep in index
// order.  Splitting the set over warps keeps the card full when only a
// few lanes are listed.  8 warps of 4 lanes a thread were chosen by trial
// on the card on the bench square.
// --------------------------------------------------------------------------

constexpr int DENSE_LPT = 4;                // lanes a thread
constexpr int DENSE_WARPS = 8;              // warps a block, each a share
constexpr int DENSE_THREADS = 32 * DENSE_WARPS;
constexpr int DENSE_LANES = 32 * DENSE_LPT;  // lanes a block
constexpr int DENSE_ONE_TILE = 4096;        // staged at once up to 80 KB
constexpr int DENSE_TILE = 2048;            // then two 40 KB tiles
constexpr int DENSE_PART_BYTES = DENSE_WARPS * DENSE_LANES * 8;
constexpr int DENSE_SMEM_MAX = 2 * DENSE_TILE * 20 + DENSE_PART_BYTES;

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of segments [p0, p0 + m) into seg[0, m): (ax, ay) into
// .xy and (bx, by) into .zw.  Each thread copies the slots k = tid mod
// DENSE_THREADS, which it later prepares itself.
__device__ __forceinline__ void dense_stage(float4* seg,
                                            const float* __restrict__ seg_a,
                                            const float* __restrict__ seg_b,
                                            int p0, int m) {
  for (int k = threadIdx.x; k < m; k += DENSE_THREADS) {
    cp_async8(&seg[k].x, seg_a + 2 * ((int64_t)p0 + k));
    cp_async8(&seg[k].z, seg_b + 2 * ((int64_t)p0 + k));
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(DENSE_THREADS) closest_point_dense_kernel(
    const float* __restrict__ q, const float* __restrict__ seg_a,
    const float* __restrict__ seg_b, int64_t n, int32_t P, int32_t tile,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ lanes,
    const int32_t* __restrict__ cnt_in, float* __restrict__ dist_out,
    int32_t* __restrict__ prim_out) {
  extern __shared__ float4 dense_smem[];
  const int nbuf = tile < P ? 2 : 1;
  const int warp = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * DENSE_LANES;
  if (active != nullptr) {
    for (int c = threadIdx.x; c < DENSE_LANES; c += DENSE_THREADS) {
      const int64_t p = first + c;
      if (p < n && !active[p]) {
        dist_out[p] = inf_f();
        prim_out[p] = 0;
      }
    }
  }
  const int64_t cnt = active != nullptr ? (int64_t)*cnt_in : n;
  if (first >= cnt) return;                // block-uniform

  // the lanes of the block: list position first + k * 32 + lid
  float qx[DENSE_LPT], qy[DENSE_LPT], best[DENSE_LPT];
  int best_p[DENSE_LPT];
#pragma unroll
  for (int k = 0; k < DENSE_LPT; ++k) {
    const int64_t p = first + k * 32 + lid;
    const int64_t lane =
        p < cnt ? (active != nullptr ? (int64_t)lanes[p] : p) : -1;
    qx[k] = lane >= 0 ? q[2 * lane] : 0.f;
    qy[k] = lane >= 0 ? q[2 * lane + 1] : 0.f;
    best[k] = inf_f();
    best_p[k] = P;
  }

  float4* seg[2] = {dense_smem, dense_smem + tile};
  float* den[2] = {reinterpret_cast<float*>(dense_smem + nbuf * tile),
                   reinterpret_cast<float*>(dense_smem + nbuf * tile) + tile};
  const int ntiles = (P + tile - 1) / tile;
  dense_stage(seg[0], seg_a, seg_b, 0, min(tile, P));
  for (int j = 0; j < ntiles; ++j) {
    const int b = j & 1;
    const int p0 = j * tile;
    const int m = min(tile, P - p0);
    if (j + 1 < ntiles) {      // the next tile's copy runs under this sweep
      dense_stage(seg[b ^ 1], seg_a, seg_b, p0 + tile,
                  min(tile, P - p0 - tile));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    for (int k = threadIdx.x; k < m; k += DENSE_THREADS) {  // own slots
      float4 g = seg[b][k];
      g.z -= g.x;
      g.w -= g.y;
      seg[b][k] = g;
      den[b][k] = seg_den(g.z, g.w);
    }
    __syncthreads();
    const float4* sg = seg[b];
    const float* sd = den[b];
    const int s1 = (int)((int64_t)(warp + 1) * m / DENSE_WARPS);
#pragma unroll 2
    for (int s = (int)((int64_t)warp * m / DENSE_WARPS); s < s1; ++s) {
      const float4 g = sg[s];
      const float dn = sd[s];
#pragma unroll
      for (int k = 0; k < DENSE_LPT; ++k) {
        float t;
        const float d2 = seg_d2_den(qx[k] - g.x, qy[k] - g.y, g.z, g.w, dn,
                                    &t);
        if (d2 < best[k]) {
          best[k] = d2;
          best_p[k] = p0 + s;
        }
      }
    }
    __syncthreads();           // the buffer is restaged two tiles on
  }

  // the warps' shares meet: (d^2, index) lexicographic, warp by warp
  float* part_d2 = reinterpret_cast<float*>(dense_smem) + nbuf * tile * 5;
  int* part_p = reinterpret_cast<int*>(part_d2 + DENSE_WARPS * DENSE_LANES);
#pragma unroll
  for (int k = 0; k < DENSE_LPT; ++k) {
    part_d2[warp * DENSE_LANES + k * 32 + lid] = best[k];
    part_p[warp * DENSE_LANES + k * 32 + lid] = best_p[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < DENSE_LANES; c += DENSE_THREADS) {
    const int64_t p = first + c;
    if (p >= cnt) continue;
    float bd = part_d2[c];
    int bp = part_p[c];
#pragma unroll
    for (int w = 1; w < DENSE_WARPS; ++w) {
      const float d = part_d2[w * DENSE_LANES + c];
      const int i = part_p[w * DENSE_LANES + c];
      if (d < bd || (d == bd && i < bp)) {
        bd = d;
        bp = i;
      }
    }
    const int64_t lane = active != nullptr ? (int64_t)lanes[p] : p;
    dist_out[lane] = sqrtf(bd);
    prim_out[lane] = bp < P ? bp : 0;
  }
}

// --------------------------------------------------------------------------
// K12 with its gathers: the closest segment over each lane's candidate
// row.  q (N, 2), row (N,), cand (R, K) prim ids (-1 padded) and the
// segment table seg (P, 4) = (ax, ay, bx, by) -> dist = sqrt(min d^2
// over the slots with cand >= 0) (+inf when none is) and pid =
// cand[row, s], s the smallest slot attaining the min (slot 0 when the
// min is inf, as the TPU kernel's min(where(d2 <= best, cols, K))).  The
// distance is seg_d2 on the operands the gathered form took (q - a, b -
// a), so it is that form's bit for bit.
//
// Bound: the gathered form read four (N, K) planes and a mask that a
// gather of verts[indices[cand[row]]] had just written (4.6 ms at the
// bare grid's 1M lanes for a 0.39 ms sweep on an H100 80GB HBM3 at 700
// W).  Here a lane reads its row
// of K ids (4 bytes each; neighbouring lanes share rows, so most come
// from L1 and L2) and one float4 of the table per valid slot (the table
// is P x 16 bytes, 32 KB for bench.py's 2,048 segments, so it stays in
// L1 and L2): ~20 bytes and ~14 flops a (lane, slot), so the bytes.  One
// launch serves every lane, one thread a lane: it reads its row four
// slots at a time in int4 loads (one slot a load when K is not a
// multiple of 4) and keeps the least d^2 with a strict < in slot order.
// This form was chosen by trial on the card against 2, 4, 8, 16 and 32
// threads a lane, each reading four slots a load and meeting in a (d^2,
// slot) min by shuffle (every form's time in PERF.md): the fewer threads
// a lane, the faster.
// --------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(THREADS) candidate_rows_kernel(
    const float* __restrict__ q, const int32_t* __restrict__ row,
    const int32_t* __restrict__ cand, const float4* __restrict__ seg,
    int64_t n, int32_t K, float* __restrict__ dist_out,
    int32_t* __restrict__ pid_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float qx = q[2 * i];
  const float qy = q[2 * i + 1];
  const int32_t* cr = cand + (int64_t)row[i] * K;
  float best = inf_f();
  int best_k = K;
  for (int k0 = 0; k0 < K; k0 += V) {
    int c[V];
    if constexpr (V == 4) {
      const int4 v = *reinterpret_cast<const int4*>(cr + k0);
      c[0] = v.x;
      c[1] = v.y;
      c[2] = v.z;
      c[3] = v.w;
    } else {
      c[0] = cr[k0];
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (c[u] < 0) continue;
      const float4 s = __ldg(seg + c[u]);
      float t;
      const float d2 = seg_d2(qx - s.x, qy - s.y, s.z - s.x, s.w - s.y, &t);
      if (d2 < best) {
        best = d2;
        best_k = k0 + u;
      }
    }
  }
  dist_out[i] = sqrtf(best);
  pid_out[i] = cr[best_k < K ? best_k : 0];
}

}  // namespace

extern "C" {

// K9, 3D: coords (C, 12, Kp)
int sil_band_launch(const void* cell, const void* q, const void* coords,
                    int64_t n, int32_t Kp, void* d2, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + THREADS / 32 - 1) / (THREADS / 32);
  sil_band_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cell, (const float*)q, (const float*)coords, n, Kp,
      (float*)d2);
  return (int)cudaGetLastError();
}

// K9, 2D: coords (C, 6, Kp) planes, Kp a multiple of 4 and the table on
// 16 bytes; live may be null.
int sil_band_2d_launch(const void* cell, const void* q, const void* coords,
                       const void* live, int64_t n, int32_t Kp, void* d2,
                       void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n * (32 / SIL_2D_G) + THREADS - 1) / THREADS;
  sil_band_2d_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cell, (const float*)q, (const float*)coords,
      (const uint8_t*)live, n, Kp, (float*)d2);
  return (int)cudaGetLastError();
}

// active, lanes and cnt are all null (every lane) or all given (the
// lane-list form: lanes[0, cnt) lists the set lanes of active, ascending).
int closest_point_dense_launch(const void* q, const void* seg_a,
                               const void* seg_b, int64_t n, int32_t P,
                               const void* active, const void* lanes,
                               const void* cnt, void* dist, void* prim,
                               void* stream) {
  if (n == 0) return 0;
  if (P <= 0) return (int)cudaErrorInvalidValue;
  const int tile = P <= DENSE_ONE_TILE ? P : DENSE_TILE;
  const int smem = (tile < P ? 2 : 1) * tile * 20 + DENSE_PART_BYTES;
  if (smem > 48 * 1024) {       // above the default cap of dynamic smem
    const cudaError_t rc = cudaFuncSetAttribute(
        closest_point_dense_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, DENSE_SMEM_MAX);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int64_t blocks = (n + DENSE_LANES - 1) / DENSE_LANES;
  closest_point_dense_kernel<<<(unsigned)blocks, DENSE_THREADS, smem,
                               (cudaStream_t)stream>>>(
      (const float*)q, (const float*)seg_a, (const float*)seg_b, n, P, tile,
      (const uint8_t*)active, (const int32_t*)lanes, (const int32_t*)cnt,
      (float*)dist, (int32_t*)prim);
  return (int)cudaGetLastError();
}

// cand on 16 bytes when K % 4 == 0 (int4 loads), seg on 16 bytes.
int candidate_rows_launch(const void* q, const void* row, const void* cand,
                          const void* seg, int64_t n, int32_t K, void* dist,
                          void* pid, void* stream) {
  if (n == 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  auto kernel = K % 4 ? candidate_rows_kernel<1> : candidate_rows_kernel<4>;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const int32_t*)row, (const int32_t*)cand,
      (const float4*)seg, n, K, (float*)dist, (int32_t*)pid);
  return (int)cudaGetLastError();
}

// skip_r (C,) and live (n,) may be null: no reach test, every lane live.
int band_neumann_walk_launch(const void* cell, const void* q, const void* R,
                             const void* on, const void* nn,
                             const void* u_sel, const void* u_pt,
                             const void* dw, float eps, const void* coords,
                             const void* skip_r, const void* live, int64_t n,
                             int32_t Kp, void* out, void* slot,
                             void* stream) {
  if (n == 0) return 0;
  if (Kp > 32 * MAX_ROUNDS || Kp % 32) return (int)cudaErrorInvalidValue;
  const int64_t warps = (n + BAND_G - 1) / BAND_G;
  const int64_t blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  auto kernel = Kp <= 64 ? band_neumann_walk_kernel<2>
                         : band_neumann_walk_kernel<MAX_ROUNDS>;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cell, (const float*)q, (const float*)R,
      (const uint8_t*)on, (const float*)nn, (const float*)u_sel,
      (const float*)u_pt, (const float*)dw, eps, (const float*)coords,
      (const float*)skip_r, (const uint8_t*)live, n, Kp, (float*)out,
      (int32_t*)slot);
  return (int)cudaGetLastError();
}

// skip_r (C,) and live (n,) may be null: no reach test, every lane live.
int band_ray_launch(const void* cell, const void* o, const void* d,
                    const void* tmax, const void* coords, const void* skip_r,
                    const void* live, float offset, int64_t n, int32_t Kp,
                    void* t, void* slot, void* stream) {
  if (n == 0) return 0;
  const int64_t warps = (n + BAND_G - 1) / BAND_G;
  const int64_t blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  band_ray_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cell, (const float*)o, (const float*)d,
      (const float*)tmax, (const float*)coords, (const float*)skip_r,
      (const uint8_t*)live, offset, n, Kp, (float*)t, (int32_t*)slot);
  return (int)cudaGetLastError();
}

// skip_r (C,) and live (n,) may be null: no reach test, every lane live.
int band_ball_launch(const void* cell, const void* q, const void* R,
                     const void* u, const void* coords, const void* skip_r,
                     const void* live, float offset, int64_t n, int32_t Kp,
                     void* slot, void* w_sel, void* total, void* stream) {
  if (n == 0) return 0;
  if (Kp > 32 * MAX_ROUNDS || Kp % 32) return (int)cudaErrorInvalidValue;
  const int64_t warps = (n + BAND_G - 1) / BAND_G;
  const int64_t blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  auto kernel = Kp <= 64 ? band_ball_kernel<2> : band_ball_kernel<MAX_ROUNDS>;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cell, (const float*)q, (const float*)R,
      (const float*)u, (const float*)coords, (const float*)skip_r,
      (const uint8_t*)live, offset, n, Kp, (int32_t*)slot, (float*)w_sel,
      (float*)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
