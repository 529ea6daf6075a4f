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
// small launches.  Here each lane's whole descent runs in one launch (the
// persistent-thread form the JAX docstring names).  B2 and B3 run one
// thread a lane with a stack in local memory (MAX_STACK entries; GeomSet
// refuses a tree whose depth + 4 exceeds it, and a descent holds at most
// depth + 1 entries).  B1 and B4 read packed trees, keep their stacks of
// (node, distance) pairs in shared memory, and run four threads a lane in
// 3D (see "The packed trees" below).
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
// practice the per-lane chains of dependent loads set the time: on the
// card B1 in 3D and B4 take about as long as their heaviest 1% of lanes
// alone (PERF.md).  Built with -fmad=false: the plain PyTorch versions
// write the same products and sums in the same order.

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
// The packed trees of B1 and B4 (ops/bvh.py pack_trees, built once for
// each set when it is uploaded): rows of 32-bit words, floats by their
// bits, each row a whole number of 16-byte words read with __ldg.
//
//   node record, NODE_W = 4 D + 4 words, one a node of the tree (a leaf's
//   row holds nothing the descent reads):
//     [lo_l, hi_l, lo_r, hi_r (D each), id_l, id_r, ref_l, ref_r]
//     the children's boxes and node ids; ref is an inner child's node id
//     and ~(leaf number) of a leaf, leaves numbered in node order.
//   prim leaf, LEAF_W words a leaf: 2D four slots of corners [a, b] and
//     then the four prim ids; 3D four slots of [a, b, c, id, 0, 0].  A
//     pad slot has id -1 and zero corners.
//   silhouette node record, SIL_W words a node of the entities' tree:
//     [c (D), r, axis (D), cone_cos, theta, leaf | node record | 0...]:
//     the SNCH cone's constants (c = 0.5 (lo + hi), r = 0.5 |hi - lo|,
//     theta = acos(clamp(cone_cos)), computed once for each tree), the
//     node's own leaf number (-1: inner), then its node record.
//   entity leaf, LEAF x ENT_W words: 3D [p0, p1, n1, n2, flag, 0, 0, 0],
//     2D [p0, n1, n2, flag, 0]; flag 1 always a silhouette, 0 not, -1 pad.
//
// The root's box is read apart (bb_min / bb_max row 0).  A stack entry is
// (ref or node id, the box distance the parent computed), so a pop prunes
// on the stored float (the same box_dist of the same node and query the
// pop used to recompute) without reading the node.  The nearer child is
// not pushed: the descent goes on with it in registers, as a push and
// the pop right after it would (best is the same at both).  The rest of
// the stack is each lane's column of the block's dynamic shared memory,
// stack_size entries deep (the tree's depth + 4); nothing is in local
// memory.  In 3D four threads run one lane: at a leaf each evaluates one
// slot and the first minimum is reduced over (distance, slot) with
// shuffles; at an inner node two pairs of them compute the children's
// box distances; the four keep the same stack pointer and control flow,
// and the first of them writes the stack.  In 2D one thread runs a lane
// (1,048,576 lanes fill the card; four threads a lane took twice as
// long there).  The visit order is the JAX function's, and so is every
// distance and id.

template <int D>
struct Pack {
  static constexpr int NODE_W = 4 * D + 4;
  static constexpr int LEAF_W = D == 2 ? 5 * LEAF : 12 * LEAF;
  static constexpr int CONE_W = D == 2 ? 8 : 12;
  static constexpr int SIL_W = D == 2 ? 20 : 32;
  static constexpr int ENT_W = D == 2 ? 8 : 16;
};

// The form of B1 and B4 in each dimension (timed on the card, PERF.md):
// in 2D one thread a lane, in 3D four, and the threads of a block.  The
// kernels' launch bounds ask for one block an SM at the least, which
// lets ptxas keep every value in registers (with the block size alone it
// spilled a few bytes of the 3D forms to local memory).  A block's
// stacks, MAX_STACK entries a lane at most, fit the 48 KB of dynamic
// shared memory a launch gets without asking.
template <int D>
struct Form {
  static constexpr int LT = D == 3 ? 4 : 1;
  static constexpr int BLOCK = D == 3 ? 128 : 64;
  static constexpr int LANES = BLOCK / LT;
  static_assert(LANES * MAX_STACK * sizeof(int2) <= 48 * 1024,
                "a block's stacks exceed 48 KB of shared memory");
};

__device__ __forceinline__ float f32(int32_t w) { return __int_as_float(w); }

// W words (W a multiple of 4) from p, 16-byte aligned, as four-word loads.
template <int W>
__device__ __forceinline__ void load_words(const int32_t* p, int32_t* w) {
  const int4* v = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const int4 x = __ldg(v + k);
    w[4 * k] = x.x;
    w[4 * k + 1] = x.y;
    w[4 * k + 2] = x.z;
    w[4 * k + 3] = x.w;
  }
}

// The box distance of child c (0 left, 1 right) of a node record's words.
template <int D>
__device__ __forceinline__ float child_dist(const float* q, const int32_t* w,
                                            int c) {
  float lo[D], hi[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    lo[k] = f32(w[c * 2 * D + k]);
    hi[k] = f32(w[c * 2 * D + D + k]);
  }
  return box_dist<D>(q, lo, hi);
}

// (dl, dr) of a node record: LT = 1 computes both; with four threads a
// lane the even ones compute dl, the odd ones dr, and they swap.
template <int D, int LT>
__device__ __forceinline__ void children_dist(const float* q,
                                              const int32_t* w, int sub,
                                              unsigned qmask, float* dl,
                                              float* dr) {
  if (LT == 1) {
    *dl = child_dist<D>(q, w, 0);
    *dr = child_dist<D>(q, w, 1);
    return;
  }
  const int c = sub & 1;
  const float d = child_dist<D>(q, w, c);
  const float o = __shfl_xor_sync(qmask, d, 1);
  *dl = c ? o : d;
  *dr = c ? d : o;
}

// The first minimum of (d, id) over the four threads of a lane, thread s
// holding slot s: the lower slot wins unless the higher one is strictly
// nearer, as a scan over the slots in order that replaces on d < dm.
__device__ __forceinline__ void first_min4(unsigned qmask, int sub, float* d,
                                           int32_t* id) {
  int s = sub;
#pragma unroll
  for (int off = 1; off < LEAF; off <<= 1) {
    const float d_o = __shfl_xor_sync(qmask, *d, off);
    const int32_t id_o = __shfl_xor_sync(qmask, *id, off);
    const int s_o = __shfl_xor_sync(qmask, s, off);
    const bool take = s_o > s ? d_o < *d : !(*d < d_o);
    if (take) {
      *d = d_o;
      *id = id_o;
      s = s_o;
    }
  }
}

// Slot s of a prim leaf: its prim id and q's distance (+inf at a pad).
template <int D>
__device__ __forceinline__ float slot_dist(const float* q, const int32_t* lf,
                                           int s, int32_t* pid) {
  float c[D * D];
  if (D == 2) {
    *pid = __ldg(lf + 4 * LEAF + s);
    if (*pid < 0) return inf_f();
    const int4 v = __ldg(reinterpret_cast<const int4*>(lf) + s);
    c[0] = f32(v.x);
    c[1] = f32(v.y);
    c[2] = f32(v.z);
    c[3] = f32(v.w);
  } else {
    int32_t w[12];
    load_words<12>(lf + 12 * s, w);
    *pid = w[9];
    if (*pid < 0) return inf_f();
#pragma unroll
    for (int k = 0; k < D * D; ++k) c[k] = f32(w[k]);
  }
  return prim_dist<D>(q, c);
}

// The stacks: each lane's column of the block's dynamic shared memory.
extern __shared__ int2 stack_mem[];

template <int LT>
struct LaneStack {
  int col;
  int stride;
  int sp;
  unsigned qmask;
  int sub;
  __device__ __forceinline__ void push(int32_t ref, float d) {
    if (LT == 1 || sub == 0)
      stack_mem[col + sp * stride] = make_int2(ref, __float_as_int(d));
    ++sp;
    if (LT > 1) __syncwarp(qmask);
  }
  __device__ __forceinline__ void pop(int32_t* ref, float* d) {
    const int2 e = stack_mem[col + --sp * stride];
    *ref = e.x;
    *d = __int_as_float(e.y);
  }
};

// ---------------------------------------------------------------------------
// B1: closest prim
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Form<D>::BLOCK, 1)
closest_point_bvh_kernel(const float* __restrict__ q,
                         const uint8_t* __restrict__ live,
                         const float* __restrict__ root_lo,
                         const float* __restrict__ root_hi,
                         const int32_t* __restrict__ nodes,
                         const int32_t* __restrict__ leaves,
                         int32_t n_nodes, int64_t n,
                         int32_t* __restrict__ visits,
                         float* __restrict__ out_d,
                         int32_t* __restrict__ out_i) {
  constexpr int NODE_W = Pack<D>::NODE_W;
  constexpr int LT = Form<D>::LT;
  const int64_t i = ((int64_t)blockIdx.x * Form<D>::BLOCK + threadIdx.x) / LT;
  if (i >= n) return;
  const int sub = threadIdx.x % LT;
  LaneStack<LT> st{(int)(threadIdx.x / LT), Form<D>::LANES, 0,
                   LT == 1 ? 0u : 0xFu << (threadIdx.x & 28), sub};
  float best = inf_f();
  int32_t best_i = 0, nv = 0;
  if (live == nullptr || live[i]) {
    float qq[D];
#pragma unroll
    for (int k = 0; k < D; ++k) qq[k] = q[i * D + k];
    int32_t ref = n_nodes == 1 ? ~0 : 0;
    float dist = box_dist<D>(qq, root_lo, root_hi);
    bool held = true;
    while (held || st.sp > 0) {
      if (!held) st.pop(&ref, &dist);
      held = false;
      if (!(dist < best)) continue;
      ++nv;
      if (ref < 0) {
        const int32_t* lf = leaves + (int64_t)(~ref) * Pack<D>::LEAF_W;
        float dm = inf_f();
        int32_t pm = 0;
        if (LT == 1) {
          for (int s = 0; s < LEAF; ++s) {
            int32_t pid;
            const float d = slot_dist<D>(qq, lf, s, &pid);
            if (s == 0 || d < dm) {    // argmin: the first minimum
              dm = d;
              pm = pid;
            }
          }
        } else {
          dm = slot_dist<D>(qq, lf, sub, &pm);
          first_min4(st.qmask, sub, &dm, &pm);
        }
        if (dm < best) {
          best = dm;
          best_i = pm;
        }
        continue;
      }
      int32_t w[NODE_W];
      load_words<NODE_W>(nodes + (int64_t)ref * NODE_W, w);
      const int32_t rl = w[4 * D + 2], rr = w[4 * D + 3];
      float dl, dr;
      children_dist<D, LT>(qq, w, sub, st.qmask, &dl, &dr);
      const bool lf = dl <= dr;
      if (fmaxf(dl, dr) < best) st.push(lf ? rr : rl, lf ? dr : dl);
      if (fminf(dl, dr) < best) {
        ref = lf ? rl : rr;
        dist = lf ? dl : dr;
        held = true;
      }
    }
  }
  if (sub == 0) {
    out_d[i] = best;
    out_i[i] = best_i;
    if (visits != nullptr) visits[i] = nv;
  }
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

// The SNCH prune of queries.py:307-322: the node's normal cone (axis,
// cos of its half-angle) and its bounding sphere's view cone from q
// show that every normal keeps one sign of dot(n, v).  c, r and theta
// are the node's own (its record's cone words); the two cheap tests
// come first and the transcendentals run only where both hold, which
// changes no result of the conjunction.
template <int D>
__device__ __forceinline__ bool cone_prune(const float* q, const float* c,
                                           float r, const float* ax,
                                           float cone_cos, float theta) {
  float w[D];
#pragma unroll
  for (int k = 0; k < D; ++k) w[k] = c[k] - q[k];
  const float d_c = norm<D>(w);
  if (!(cone_cos > -1.5f && d_c > r)) return false;
  const float phi = asinf(fminf(fmaxf(r / fmaxf(d_c, 1e-20f), 0.f), 1.f));
  const float ang = acosf(fminf(fmaxf(dot<D>(ax, w) / fmaxf(d_c, 1e-20f),
                                      -1.f), 1.f));
  return (ang + theta + phi < HALF_PI) || (ang - theta - phi > HALF_PI);
}

// Slot s of an entity leaf: q's distance where the entity is a
// silhouette from q, +inf elsewhere and at a pad.
template <int D>
__device__ __forceinline__ float entity_dist(const float* q,
                                             const int32_t* lf, int s) {
  constexpr int EW = Pack<D>::ENT_W;
  int32_t w[EW];
  load_words<EW>(lf + s * EW, w);
  const int32_t flag = w[D == 2 ? 6 : 12];
  if (flag < 0) return inf_f();
  float p0[D], n1[D], n2[D], v[D];
  const int o1 = D == 2 ? 2 : 6, o2 = D == 2 ? 4 : 9;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    p0[k] = f32(w[k]);
    n1[k] = f32(w[o1 + k]);
    n2[k] = f32(w[o2 + k]);
  }
  float d;
  if (D == 2) {
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = q[k] - p0[k];
    d = norm<D>(v);
  } else {
    float p1[D], t;
#pragma unroll
    for (int k = 0; k < D; ++k) p1[k] = f32(w[D + k]);
    d = seg_dist<D>(q, p0, p1, &t);
#pragma unroll
    for (int k = 0; k < D; ++k) v[k] = q[k] - (p0[k] + t * (p1[k] - p0[k]));
  }
  const float s1 = dot<D>(n1, v);
  const float s2 = dot<D>(n2, v);
  return (flag || s1 * s2 <= 0.f) ? d : inf_f();
}

template <int D>
__global__ void __launch_bounds__(Form<D>::BLOCK, 1)
closest_silhouette_bvh_kernel(const float* __restrict__ q,
                              const uint8_t* __restrict__ live,
                              const float* __restrict__ root_lo,
                              const float* __restrict__ root_hi,
                              const int32_t* __restrict__ nodes,
                              const int32_t* __restrict__ ents, int64_t n,
                              int32_t* __restrict__ visits,
                              float* __restrict__ out_d) {
  constexpr int CONE_W = Pack<D>::CONE_W;
  constexpr int NODE_W = Pack<D>::NODE_W;
  constexpr int LT = Form<D>::LT;
  const int64_t i = ((int64_t)blockIdx.x * Form<D>::BLOCK + threadIdx.x) / LT;
  if (i >= n) return;
  const int sub = threadIdx.x % LT;
  LaneStack<LT> st{(int)(threadIdx.x / LT), Form<D>::LANES, 0,
                   LT == 1 ? 0u : 0xFu << (threadIdx.x & 28), sub};
  float best = inf_f();
  int32_t nv = 0;
  if (live == nullptr || live[i]) {
    float qq[D];
#pragma unroll
    for (int k = 0; k < D; ++k) qq[k] = q[i * D + k];
    int32_t nid = 0;
    float dist = box_dist<D>(qq, root_lo, root_hi);
    bool held = true;
    while (held || st.sp > 0) {
      if (!held) st.pop(&nid, &dist);
      held = false;
      if (!(dist < best)) continue;
      ++nv;
      const int32_t* rec = nodes + (int64_t)nid * Pack<D>::SIL_W;
      int32_t cw[CONE_W];
      load_words<CONE_W>(rec, cw);
      float c[D], ax[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        c[k] = f32(cw[k]);
        ax[k] = f32(cw[D + 1 + k]);
      }
      if (cone_prune<D>(qq, c, f32(cw[D]), ax, f32(cw[2 * D + 1]),
                        f32(cw[2 * D + 2])))
        continue;
      const int32_t leaf = cw[2 * D + 3];
      if (leaf >= 0) {
        const int32_t* lf = ents + (int64_t)leaf * LEAF * Pack<D>::ENT_W;
        if (LT == 1) {
          for (int s = 0; s < LEAF; ++s)
            best = fminf(best, entity_dist<D>(qq, lf, s));
        } else {
          float d = entity_dist<D>(qq, lf, sub);
          d = fminf(d, __shfl_xor_sync(st.qmask, d, 1));
          d = fminf(d, __shfl_xor_sync(st.qmask, d, 2));
          best = fminf(best, d);
        }
        continue;
      }
      int32_t w[NODE_W];
      load_words<NODE_W>(rec + CONE_W, w);
      const int32_t l = w[4 * D], r = w[4 * D + 1];
      float dl, dr;
      children_dist<D, LT>(qq, w, sub, st.qmask, &dl, &dr);
      const bool lf = dl <= dr;
      if (fmaxf(dl, dr) < best) st.push(lf ? r : l, lf ? dr : dl);
      if (fminf(dl, dr) < best) {
        nid = lf ? l : r;
        dist = lf ? dl : dr;
        held = true;
      }
    }
  }
  if (sub == 0) {
    out_d[i] = best;
    if (visits != nullptr) visits[i] = nv;
  }
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

// Launch a B1 / B4 kernel of dimension D over n lanes, Form<D>::LANES a
// block, with each lane's stack of stack_size (ref, distance) entries in
// dynamic shared memory.
template <int D, typename K, typename... Args>
cudaError_t launch_lanes(K kernel, int64_t n, int32_t stack_size,
                         cudaStream_t s, Args... args) {
  constexpr int64_t lanes = Form<D>::LANES;
  const size_t smem = (size_t)lanes * stack_size * sizeof(int2);
  kernel<<<(unsigned)((n + lanes - 1) / lanes), Form<D>::BLOCK, smem, s>>>(
      args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_b1(const void* q, const void* live, const void* bb_min,
                      const void* bb_max, const void* nodes,
                      const void* leaves, int32_t n_nodes,
                      int32_t stack_size, int64_t n, void* visits,
                      void* out_d, void* out_i, cudaStream_t s) {
  return launch_lanes<D>(
      closest_point_bvh_kernel<D>, n, stack_size, s, (const float*)q,
      (const uint8_t*)live, (const float*)bb_min, (const float*)bb_max,
      (const int32_t*)nodes, (const int32_t*)leaves, n_nodes, n,
      (int32_t*)visits, (float*)out_d, (int32_t*)out_i);
}

template <int D>
cudaError_t launch_b4(const void* q, const void* live, const void* bb_min,
                      const void* bb_max, const void* nodes, const void* ents,
                      int32_t stack_size, int64_t n, void* visits,
                      void* out_d, cudaStream_t s) {
  return launch_lanes<D>(
      closest_silhouette_bvh_kernel<D>, n, stack_size, s, (const float*)q,
      (const uint8_t*)live, (const float*)bb_min, (const float*)bb_max,
      (const int32_t*)nodes, (const int32_t*)ents, n, (int32_t*)visits,
      (float*)out_d);
}

}  // namespace

extern "C" {

// B1: q (n, dim); the prim tree's root box (bb_min, bb_max row 0), node
// records (n_nodes, 4 dim + 4) and prim leaves, as pack_trees lays them
// out; stack_size entries a lane (depth + 4); live and visits (n,) int32
// may be null.
int closest_point_bvh_launch(const void* q, const void* live,
                             const void* bb_min, const void* bb_max,
                             const void* node_pack, const void* leaf_pack,
                             int32_t n_nodes, int32_t stack_size, int64_t n,
                             int32_t dim, void* visits, void* out_d,
                             void* out_i, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 2)
    return (int)launch_b1<2>(q, live, bb_min, bb_max, node_pack, leaf_pack,
                             n_nodes, stack_size, n, visits, out_d, out_i,
                             s);
  if (dim == 3)
    return (int)launch_b1<3>(q, live, bb_min, bb_max, node_pack, leaf_pack,
                             n_nodes, stack_size, n, visits, out_d, out_i,
                             s);
  return (int)cudaErrorInvalidValue;
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

// B4: q (n, dim); the entities' tree's root box (sil_bb_min, sil_bb_max
// row 0), its node records with the cone constants and its entity
// leaves, as pack_trees lays them out; stack_size entries a lane; live
// and visits (n,) int32 may be null.
int closest_silhouette_bvh_launch(const void* q, const void* live,
                                  const void* bb_min, const void* bb_max,
                                  const void* node_pack,
                                  const void* ent_pack, int32_t stack_size,
                                  int64_t n, int32_t dim, void* visits,
                                  void* out_d, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dim == 2)
    return (int)launch_b4<2>(q, live, bb_min, bb_max, node_pack, ent_pack,
                             stack_size, n, visits, out_d, s);
  if (dim == 3)
    return (int)launch_b4<3>(q, live, bb_min, bb_max, node_pack, ent_pack,
                             stack_size, n, visits, out_d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
