// BVH traversal kernels for Hopper (sm_90a), bound through ctypes.
//
// The BVH route (Problem.load_config(accel="bvh")) builds no grid, and
// every query of a set above CHUNKED_DENSE_MAX prims or entities
// descends its tree.  In the JAX package these descents are not Pallas
// kernels but vmap-ed lax.while_loops, one lane each
// (elaina_tpu/geometry/queries.py):
//
//   B1 _closest_point_bvh_one (queries.py:109; 2D and 3D)
//                                          -> closest_point_bvh_kernel
//   B2 _ray_bvh_one (queries.py:385; closest hit and any hit)
//                                          -> ray_bvh_kernel
//   B3 _sample_in_ball_bvh_one (queries.py:527)
//                                          -> sample_in_ball_bvh_kernel
//   B4 _closest_silhouette_bvh_one (queries.py:295)
//                                          -> closest_silhouette_bvh_kernel
//
// They get hand kernels because their plain form cannot serve on the card:
// a lockstep loop over lanes ends only when the last lane's stack
// empties, a host read each iteration, and each iteration is some forty
// small launches.  Here one thread runs one lane's whole descent (the
// persistent-thread form the JAX docstring names), with its stack in
// local memory (MAX_STACK entries; GeomSet refuses a tree whose depth + 4
// exceeds it, and a descent holds at most depth + 1 entries).
//
// Each kernel keeps its JAX function's rules: a leaf takes its first
// minimum in leaf_prims order and replaces the best only on a strict <;
// the nearer child (box distance dl <= dr, or ray entry tl <= tr) is
// pushed last, so it pops first, and a child is pushed only while its
// box can beat the best; the in-ball descent weighs a node by its
// subtree measure times G(max(box distance, GREEN_R_CLAMP), R), rescales
// u into the branch and multiplies the branch probabilities into the
// pdf.  Lanes that ``live`` (null: every lane) leaves out write what the
// plain versions write for them: d = +inf and prim 0 (B1, B4), no hit,
// t = +inf and prim 0 (B2), prim -1 and pdf 0 (B3).
//
// What bounds them: each lane reads O(depth) nodes and a few leaves of a
// tree that stays in L2 (a 65,536-segment set's tree is ~1.3 MB), so the
// lanes' own inputs and outputs are the bytes that must move; in
// practice the divergent per-lane loops and their dependent loads set
// the time.  This first form is simple and right; making it fast is
// later work.  Built with -fmad=false: the plain PyTorch versions write
// the same products and sums in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_STACK = 64;
constexpr int LEAF = 4;
constexpr float GREEN_R_CLAMP = 1e-4f;
constexpr float TWO_PI = 6.2831854820251465f;    // float32(2 pi)
constexpr float FOUR_PI = 12.566370964050293f;   // float32(4 pi)
constexpr float HALF_PI = 1.5707963705062866f;   // float32(pi / 2)
constexpr float U_MAX = 0.99999988079071044921875f;  // float32(1 - 1e-7)

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

template <int D>
__device__ __forceinline__ float dot(const float* u, const float* v) {
  float s = u[0] * v[0];
#pragma unroll
  for (int k = 1; k < D; ++k) s += u[k] * v[k];
  return s;
}

template <int D>
__device__ __forceinline__ float norm(const float* v) {
  return sqrtf(dot<D>(v, v));
}

// |max(lo - q, q - hi, 0)|: distance from q to the box (0 inside).
template <int D>
__device__ __forceinline__ float box_dist(const float* q, const float* lo,
                                          const float* hi) {
  float v[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    v[k] = fmaxf(fmaxf(lo[k] - q[k], q[k] - hi[k]), 0.f);
  return norm<D>(v);
}

// Segment ab: (distance, t clamped) as primitives.seg_closest_point.
template <int D>
__device__ __forceinline__ float seg_dist(const float* q, const float* a,
                                          const float* b, float* t_out) {
  float e[D], w[D], p[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    e[k] = b[k] - a[k];
    w[k] = q[k] - a[k];
  }
  const float den = fmaxf(dot<D>(e, e), 1e-30f);
  const float t = fminf(fmaxf(dot<D>(w, e) / den, 0.f), 1.f);
#pragma unroll
  for (int k = 0; k < D; ++k) p[k] = q[k] - (a[k] + t * e[k]);
  *t_out = t;
  return norm<D>(p);
}

// Triangle abc: primitives.tri_closest_point's distance (the interior
// projection where its barycentrics are all >= 0, else the first closest
// of the three edge points).
__device__ __forceinline__ float tri_dist(const float* q, const float* a,
                                          const float* b, const float* c) {
  float e1[3], e2[3], w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = b[k] - a[k];
    e2[k] = c[k] - a[k];
    w[k] = q[k] - a[k];
  }
  const float d11 = dot<3>(e1, e1), d12 = dot<3>(e1, e2),
              d22 = dot<3>(e2, e2);
  const float w1 = dot<3>(w, e1), w2 = dot<3>(w, e2);
  const float den = fmaxf(d11 * d22 - d12 * d12, 1e-30f);
  const float u = (d22 * w1 - d12 * w2) / den;
  const float v = (d11 * w2 - d12 * w1) / den;
  const float ww = 1.f - u - v;
  float p[3];
  if (u >= 0.f && v >= 0.f && ww >= 0.f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = q[k] - (a[k] + u * e1[k] + v * e2[k]);
    return norm<3>(p);
  }
  const float* ends[4] = {a, b, c, a};
  float best = inf_f();
  for (int s = 0; s < 3; ++s) {
    float t;
    const float d = seg_dist<3>(q, ends[s], ends[s + 1], &t);
    if (d < best) best = d;
  }
  return best;
}

template <int D>
__device__ __forceinline__ float prim_dist(const float* q, const float* c) {
  if (D == 2) {
    float t;
    return seg_dist<2>(q, c, c + 2, &t);
  }
  return tri_dist(q, c, c + 3, c + 6);
}

// Ray o + t d against a segment (2D) or triangle (3D, Moller-Trumbore):
// hit with t in (1e-6, tmax], as primitives.prim_ray_intersect.
template <int D>
__device__ __forceinline__ bool prim_ray(const float* o, const float* d,
                                         const float* c, float tmax,
                                         float* t_out) {
  if (D == 2) {
    const float ex = c[2] - c[0], ey = c[3] - c[1];
    const float denom = d[0] * (-ey) - d[1] * (-ex);
    const bool ok = fabsf(denom) > 1e-12f;
    const float safe = ok ? denom : 1.f;
    const float aox = c[0] - o[0], aoy = c[1] - o[1];
    const float t = (aox * (-ey) - aoy * (-ex)) / safe;
    const float s = (d[0] * aoy - d[1] * aox) / safe;
    *t_out = t;
    return ok && t > 1e-6f && t <= tmax && s >= 0.f && s <= 1.f;
  }
  float e1[3], e2[3], p[3], tv[3], qv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = c[3 + k] - c[k];
    e2[k] = c[6 + k] - c[k];
    tv[k] = o[k] - c[k];
  }
  p[0] = d[1] * e2[2] - d[2] * e2[1];
  p[1] = d[2] * e2[0] - d[0] * e2[2];
  p[2] = d[0] * e2[1] - d[1] * e2[0];
  const float det = dot<3>(e1, p);
  const bool ok = fabsf(det) > 1e-12f;
  const float safe = ok ? det : 1.f;
  const float u = dot<3>(tv, p) / safe;
  qv[0] = tv[1] * e1[2] - tv[2] * e1[1];
  qv[1] = tv[2] * e1[0] - tv[0] * e1[2];
  qv[2] = tv[0] * e1[1] - tv[1] * e1[0];
  const float v = dot<3>(d, qv) / safe;
  const float t = dot<3>(e2, qv) / safe;
  *t_out = t;
  return ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 1e-6f &&
         t <= tmax;
}

template <int D>
__device__ __forceinline__ float green(float r, float R) {
  if (D == 2) return logf(R / r) / TWO_PI;
  return (1.f / r - 1.f / R) / FOUR_PI;
}

// The slab test of queries.py:377-382: (hit, entry t clamped at 0).
template <int D>
__device__ __forceinline__ bool ray_box(const float* o, const float* d_inv,
                                        const float* lo, const float* hi,
                                        float t_best, float* entry) {
  float tn = 0.f, tf = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float t0 = (lo[k] - o[k]) * d_inv[k];
    const float t1 = (hi[k] - o[k]) * d_inv[k];
    const float mn = fminf(t0, t1), mx = fmaxf(t0, t1);
    tn = k == 0 ? mn : fmaxf(tn, mn);
    tf = k == 0 ? mx : fminf(tf, mx);
  }
  *entry = fmaxf(tn, 0.f);
  return tn <= tf && tf > 0.f && tn < t_best;
}

struct Tree {
  const float* bb_min;    // (M, D)
  const float* bb_max;
  const int32_t* left;    // (M,)
  const int32_t* right;
  const int32_t* leaf;    // (M, LEAF) -1 padded
};

// ---------------------------------------------------------------------------
// B1: closest prim
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
closest_point_bvh_kernel(const float* __restrict__ q,
                         const uint8_t* __restrict__ live, Tree tr,
                         const float* __restrict__ corners, int64_t n,
                         float* __restrict__ out_d,
                         int32_t* __restrict__ out_i) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best = inf_f();
  int32_t best_i = 0;
  if (live == nullptr || live[i]) {
    float qq[D];
#pragma unroll
    for (int k = 0; k < D; ++k) qq[k] = q[i * D + k];
    int32_t stack[MAX_STACK];
    int sp = 1;
    stack[0] = 0;
    while (sp > 0) {
      const int32_t nid = stack[--sp];
      const float bd = box_dist<D>(qq, tr.bb_min + nid * D,
                                   tr.bb_max + nid * D);
      if (!(bd < best)) continue;
      const int32_t l = tr.left[nid];
      if (l < 0) {
        float dm = inf_f();
        int32_t pm = 0;
        bool first = true;
        for (int s = 0; s < LEAF; ++s) {
          const int32_t pid = tr.leaf[nid * LEAF + s];
          const float d = pid >= 0 ? prim_dist<D>(qq, corners + (int64_t)pid
                                                  * D * D)
                                   : inf_f();
          if (first || d < dm) {       // argmin: the first minimum
            dm = d;
            pm = pid;
            first = false;
          }
        }
        if (dm < best) {
          best = dm;
          best_i = pm;
        }
        continue;
      }
      const int32_t r = tr.right[nid];
      const float dl = box_dist<D>(qq, tr.bb_min + l * D, tr.bb_max + l * D);
      const float dr = box_dist<D>(qq, tr.bb_min + r * D, tr.bb_max + r * D);
      const bool lf = dl <= dr;
      if (fmaxf(dl, dr) < best) stack[sp++] = lf ? r : l;
      if (fminf(dl, dr) < best) stack[sp++] = lf ? l : r;
    }
  }
  out_d[i] = best;
  out_i[i] = best_i;
}

// ---------------------------------------------------------------------------
// B2: closest hit or any hit
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
ray_bvh_kernel(const float* __restrict__ o, const float* __restrict__ dir,
               const float* __restrict__ tmax,
               const uint8_t* __restrict__ live, Tree tr,
               const float* __restrict__ corners, int64_t n, int any_hit,
               uint8_t* __restrict__ out_hit, float* __restrict__ out_t,
               int32_t* __restrict__ out_i) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool found = false;
  float best_t = inf_f();
  int32_t best_i = 0;
  if (live == nullptr || live[i]) {
    float oo[D], dd[D], d_inv[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      oo[k] = o[i * D + k];
      dd[k] = dir[i * D + k];
      const float sg = dd[k] > 0.f ? 1.f : (dd[k] < 0.f ? -1.f : 0.f);
      d_inv[k] = fabsf(dd[k]) > 1e-12f ? 1.f / dd[k] : sg * 1e12f + 1e12f;
    }
    best_t = tmax[i];
    int32_t stack[MAX_STACK];
    int sp = 1;
    stack[0] = 0;
    while (sp > 0) {
      const int32_t nid = stack[--sp];
      float entry;
      if (!ray_box<D>(oo, d_inv, tr.bb_min + nid * D, tr.bb_max + nid * D,
                      best_t, &entry))
        continue;
      const int32_t l = tr.left[nid];
      if (l < 0) {
        float tm = inf_f();
        int32_t pm = 0;
        bool hm = false, any = false, first = true;
        for (int s = 0; s < LEAF; ++s) {
          const int32_t pid = tr.leaf[nid * LEAF + s];
          float t = inf_f();
          bool h = false;
          if (pid >= 0) {
            h = prim_ray<D>(oo, dd, corners + (int64_t)pid * D * D, best_t,
                            &t);
            if (!h) t = inf_f();
          }
          any |= h;
          if (first || t < tm) {       // argmin over t: the first minimum
            tm = t;
            pm = pid;
            hm = h;
            first = false;
          }
        }
        if (hm && tm < best_t) {
          best_t = tm;
          best_i = pm;
        }
        found |= any;
        if (found && any_hit) break;   // the rest would process nothing
        continue;
      }
      const int32_t r = tr.right[nid];
      float tl, tr_;
      const bool hl = ray_box<D>(oo, d_inv, tr.bb_min + l * D,
                                 tr.bb_max + l * D, best_t, &tl);
      const bool hr = ray_box<D>(oo, d_inv, tr.bb_min + r * D,
                                 tr.bb_max + r * D, best_t, &tr_);
      const bool lf = tl <= tr_;
      if (lf ? hr : hl) stack[sp++] = lf ? r : l;
      if (lf ? hl : hr) stack[sp++] = lf ? l : r;
    }
  }
  out_hit[i] = found;
  out_t[i] = found ? best_t : inf_f();
  out_i[i] = best_i;
}

// ---------------------------------------------------------------------------
// B3: Green-weighted in-ball sample, one stochastic descent
// ---------------------------------------------------------------------------

template <int D>
__device__ __forceinline__ float node_weight(const float* q, float R,
                                             const Tree& tr,
                                             const float* node_measure,
                                             int32_t nid) {
  const float bd = box_dist<D>(q, tr.bb_min + nid * D, tr.bb_max + nid * D);
  if (!(bd < R)) return 0.f;
  return node_measure[nid] * fmaxf(green<D>(fmaxf(bd, GREEN_R_CLAMP), R),
                                   0.f);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
sample_in_ball_bvh_kernel(const float* __restrict__ q,
                          const float* __restrict__ Rs,
                          const float* __restrict__ us,
                          const uint8_t* __restrict__ live, Tree tr,
                          const float* __restrict__ node_measure,
                          const float* __restrict__ corners,
                          const float* __restrict__ measure, int64_t n,
                          int32_t* __restrict__ out_i,
                          float* __restrict__ out_pdf) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t idx = -1;
  float pdf_area = 0.f;
  if (live == nullptr || live[i]) {
    float qq[D];
#pragma unroll
    for (int k = 0; k < D; ++k) qq[k] = q[i * D + k];
    const float R = Rs[i];
    float uu = us[i];
    float pdf = 1.f;
    int32_t nid = 0;
    bool dead = !(node_weight<D>(qq, R, tr, node_measure, 0) > 0.f);
    while (!dead && tr.left[nid] >= 0) {
      const int32_t l = tr.left[nid], r = tr.right[nid];
      const float wl = node_weight<D>(qq, R, tr, node_measure, l);
      const float wr = node_weight<D>(qq, R, tr, node_measure, r);
      const float tot = wl + wr;
      const float pl = wl / fmaxf(tot, 1e-30f);
      const bool go_left = uu < pl;
      const float pb = go_left ? pl : 1.f - pl;
      uu = go_left ? uu / fmaxf(pl, 1e-30f)
                   : (uu - pl) / fmaxf(1.f - pl, 1e-30f);
      uu = fminf(fmaxf(uu, 0.f), U_MAX);
      nid = go_left ? l : r;
      pdf = pdf * fmaxf(pb, 1e-30f);
      dead = !(tot > 0.f);
    }
    // the leaf's exact weights (a dead lane's node may be internal: its
    // slots are all -1, so nothing weighs)
    float w[LEAF], m[LEAF], cdf[LEAF];
    int32_t pids[LEAF];
    float total = 0.f;
    for (int s = 0; s < LEAF; ++s) {
      const int32_t pid = tr.leaf[nid * LEAF + s];
      pids[s] = pid;
      const int32_t safe = pid < 0 ? 0 : pid;
      m[s] = measure[safe];
      w[s] = 0.f;
      if (pid >= 0) {
        const float d = prim_dist<D>(qq, corners + (int64_t)pid * D * D);
        if (d < R)
          w[s] = m[s] * fmaxf(green<D>(fmaxf(d, GREEN_R_CLAMP), R), 0.f);
      }
      total = s == 0 ? w[s] : total + w[s];
      cdf[s] = total;
    }
    const float target = uu * total;
    int j = 0;
    for (int s = 0; s < LEAF; ++s) j += target >= cdf[s];
    if (j > LEAF - 1) j = LEAF - 1;
    const float w_sel = w[j];
    if (!dead && total > 0.f && w_sel > 0.f) {
      pdf_area = pdf * w_sel / (fmaxf(total, 1e-30f) * fmaxf(m[j], 1e-30f));
      idx = pids[j];
    }
  }
  out_i[i] = idx;
  out_pdf[i] = pdf_area;
}

// ---------------------------------------------------------------------------
// B4: coned-BVH closest silhouette
// ---------------------------------------------------------------------------

struct Entities {
  const float* p0;        // (E, D)
  const float* p1;
  const float* n1;
  const float* n2;
  const uint8_t* always;  // (E,)
};

// The SNCH prune of queries.py:307-322: the node's normal cone (axis,
// cos of its half-angle) and its bounding sphere's view cone from q
// show that every normal keeps one sign of dot(n, v).
template <int D>
__device__ __forceinline__ bool cone_prune(const float* q, const float* lo,
                                           const float* hi, const float* ax,
                                           float cone_cos) {
  float c[D], e[D], w[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    c[k] = 0.5f * (lo[k] + hi[k]);
    e[k] = hi[k] - lo[k];
    w[k] = c[k] - q[k];
  }
  const float r = 0.5f * norm<D>(e);
  const float d_c = norm<D>(w);
  const float theta = acosf(fminf(fmaxf(cone_cos, -1.f), 1.f));
  const float phi = asinf(fminf(fmaxf(r / fmaxf(d_c, 1e-20f), 0.f), 1.f));
  const float ang = acosf(fminf(fmaxf(dot<D>(ax, w) / fmaxf(d_c, 1e-20f),
                                      -1.f), 1.f));
  const bool no_sil = (ang + theta + phi < HALF_PI) ||
                      (ang - theta - phi > HALF_PI);
  return cone_cos > -1.5f && d_c > r && no_sil;
}

template <int D>
__device__ __forceinline__ float entity_dist(const float* q,
                                             const Entities& en, int32_t e) {
  const float* p0 = en.p0 + (int64_t)e * D;
  float v[D];
  float d;
  if (D == 2) {
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = q[k] - p0[k];
    d = norm<D>(v);
  } else {
    const float* p1 = en.p1 + (int64_t)e * D;
    float t;
    d = seg_dist<D>(q, p0, p1, &t);
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = q[k] - (p0[k] + t * (p1[k] - p0[k]));
  }
  const float s1 = dot<D>(en.n1 + (int64_t)e * D, v);
  const float s2 = dot<D>(en.n2 + (int64_t)e * D, v);
  return (en.always[e] || s1 * s2 <= 0.f) ? d : inf_f();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
closest_silhouette_bvh_kernel(const float* __restrict__ q,
                              const uint8_t* __restrict__ live, Tree tr,
                              const float* __restrict__ cone_axis,
                              const float* __restrict__ cone_cos,
                              Entities en, int64_t n,
                              float* __restrict__ out_d) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best = inf_f();
  if (live == nullptr || live[i]) {
    float qq[D];
#pragma unroll
    for (int k = 0; k < D; ++k) qq[k] = q[i * D + k];
    int32_t stack[MAX_STACK];
    int sp = 1;
    stack[0] = 0;
    while (sp > 0) {
      const int32_t nid = stack[--sp];
      const float* lo = tr.bb_min + nid * D;
      const float* hi = tr.bb_max + nid * D;
      if (!(box_dist<D>(qq, lo, hi) < best)) continue;
      if (cone_prune<D>(qq, lo, hi, cone_axis + nid * D, cone_cos[nid]))
        continue;
      const int32_t l = tr.left[nid];
      if (l < 0) {
        for (int s = 0; s < LEAF; ++s) {
          const int32_t e = tr.leaf[nid * LEAF + s];
          if (e >= 0) best = fminf(best, entity_dist<D>(qq, en, e));
        }
        continue;
      }
      const int32_t r = tr.right[nid];
      const float dl = box_dist<D>(qq, tr.bb_min + l * D, tr.bb_max + l * D);
      const float dr = box_dist<D>(qq, tr.bb_min + r * D, tr.bb_max + r * D);
      const bool lf = dl <= dr;
      if (fmaxf(dl, dr) < best) stack[sp++] = lf ? r : l;
      if (fminf(dl, dr) < best) stack[sp++] = lf ? l : r;
    }
  }
  out_d[i] = best;
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

inline Tree make_tree(const void* bb_min, const void* bb_max,
                      const void* left, const void* right, const void* leaf) {
  return Tree{(const float*)bb_min, (const float*)bb_max,
              (const int32_t*)left, (const int32_t*)right,
              (const int32_t*)leaf};
}

}  // namespace

extern "C" {

// B1: q (n, dim), corners (P, dim * dim); live may be null.
int closest_point_bvh_launch(const void* q, const void* live,
                             const void* bb_min, const void* bb_max,
                             const void* left, const void* right,
                             const void* leaf, const void* corners,
                             int64_t n, int32_t dim, void* out_d,
                             void* out_i, void* stream) {
  if (n == 0) return 0;
  const Tree tr = make_tree(bb_min, bb_max, left, right, leaf);
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 2)
    closest_point_bvh_kernel<2><<<blocks_for(n), THREADS, 0, s>>>(
        (const float*)q, (const uint8_t*)live, tr, (const float*)corners, n,
        (float*)out_d, (int32_t*)out_i);
  else if (dim == 3)
    closest_point_bvh_kernel<3><<<blocks_for(n), THREADS, 0, s>>>(
        (const float*)q, (const uint8_t*)live, tr, (const float*)corners, n,
        (float*)out_d, (int32_t*)out_i);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// B2: o, d (n, dim), tmax (n,); any_hit 0 or 1; live may be null.
int ray_bvh_launch(const void* o, const void* d, const void* tmax,
                   const void* live, const void* bb_min, const void* bb_max,
                   const void* left, const void* right, const void* leaf,
                   const void* corners, int64_t n, int32_t dim,
                   int32_t any_hit, void* out_hit, void* out_t, void* out_i,
                   void* stream) {
  if (n == 0) return 0;
  const Tree tr = make_tree(bb_min, bb_max, left, right, leaf);
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 2)
    ray_bvh_kernel<2><<<blocks_for(n), THREADS, 0, s>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const uint8_t*)live, tr, (const float*)corners, n, any_hit,
        (uint8_t*)out_hit, (float*)out_t, (int32_t*)out_i);
  else if (dim == 3)
    ray_bvh_kernel<3><<<blocks_for(n), THREADS, 0, s>>>(
        (const float*)o, (const float*)d, (const float*)tmax,
        (const uint8_t*)live, tr, (const float*)corners, n, any_hit,
        (uint8_t*)out_hit, (float*)out_t, (int32_t*)out_i);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// B3: q (n, dim), R, u (n,), node_measure (M,), measure (P,); live may be
// null.
int sample_in_ball_bvh_launch(const void* q, const void* R, const void* u,
                              const void* live, const void* bb_min,
                              const void* bb_max, const void* left,
                              const void* right, const void* leaf,
                              const void* node_measure, const void* corners,
                              const void* measure, int64_t n, int32_t dim,
                              void* out_i, void* out_pdf, void* stream) {
  if (n == 0) return 0;
  const Tree tr = make_tree(bb_min, bb_max, left, right, leaf);
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 2)
    sample_in_ball_bvh_kernel<2><<<blocks_for(n), THREADS, 0, s>>>(
        (const float*)q, (const float*)R, (const float*)u,
        (const uint8_t*)live, tr, (const float*)node_measure,
        (const float*)corners, (const float*)measure, n, (int32_t*)out_i,
        (float*)out_pdf);
  else if (dim == 3)
    sample_in_ball_bvh_kernel<3><<<blocks_for(n), THREADS, 0, s>>>(
        (const float*)q, (const float*)R, (const float*)u,
        (const uint8_t*)live, tr, (const float*)node_measure,
        (const float*)corners, (const float*)measure, n, (int32_t*)out_i,
        (float*)out_pdf);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// B4: q (n, dim), the entities' tree with its cones (cone_axis (Ms, dim),
// cone_cos (Ms,)) and the entities (p0, p1, n1, n2 (E, dim), always (E,)
// bytes); live may be null.
int closest_silhouette_bvh_launch(const void* q, const void* live,
                                  const void* bb_min, const void* bb_max,
                                  const void* left, const void* right,
                                  const void* leaf, const void* cone_axis,
                                  const void* cone_cos, const void* p0,
                                  const void* p1, const void* n1,
                                  const void* n2, const void* always,
                                  int64_t n, int32_t dim, void* out_d,
                                  void* stream) {
  if (n == 0) return 0;
  const Tree tr = make_tree(bb_min, bb_max, left, right, leaf);
  const Entities en{(const float*)p0, (const float*)p1, (const float*)n1,
                    (const float*)n2, (const uint8_t*)always};
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 2)
    closest_silhouette_bvh_kernel<2><<<blocks_for(n), THREADS, 0, s>>>(
        (const float*)q, (const uint8_t*)live, tr, (const float*)cone_axis,
        (const float*)cone_cos, en, n, (float*)out_d);
  else if (dim == 3)
    closest_silhouette_bvh_kernel<3><<<blocks_for(n), THREADS, 0, s>>>(
        (const float*)q, (const uint8_t*)live, tr, (const float*)cone_axis,
        (const float*)cone_cos, en, n, (float*)out_d);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
