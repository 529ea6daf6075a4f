// The point-segment distance that every 2D sweep of the port shares
// (resolve.cu: K2, K10; queries.cu: K12, K13), so they all give the
// distances of the TPU kernels' tiles bit for bit under -fmad=false.

#pragma once

// The segment's |e|^2 term, max(|e|^2, 1e-30): K13 computes it once per
// segment and keeps it beside the segment in shared memory.
static __device__ __forceinline__ float seg_den(float ex, float ey) {
  return fmaxf(ex * ex + ey * ey, 1e-30f);
}

// clip(num / den, 0, 1) for den > 0.  With CLIP, num <= 0 gives 0 and
// num >= den gives 1 without the division: the correctly rounded
// quotient is <= 0 or >= 1 there, so the clip gives the same value (a
// zero's sign aside, which no product with a finite edge carries into a
// squared distance); only 0 < num < den divides (K10, K11).
template <bool CLIP = false>
static __device__ __forceinline__ float clip01_div(float num, float den) {
  if (CLIP) {
    if (num <= 0.f) return 0.f;
    if (num >= den) return 1.f;
  }
  return fminf(fmaxf(num / den, 0.f), 1.f);
}

// Squared distance from q to the segment a + t e, t = clip((w . e) / den,
// 0, 1) with w = q - a and den = seg_den(e); writes t.
template <bool CLIP = false>
static __device__ __forceinline__ float seg_d2_den(float wx, float wy,
                                                   float ex, float ey,
                                                   float den, float* t_out) {
  const float t = clip01_div<CLIP>(wx * ex + wy * ey, den);
  const float dx = wx - t * ex;
  const float dy = wy - t * ey;
  *t_out = t;
  return dx * dx + dy * dy;
}

// The same with den computed here (pallas_queries.py:97-105, :402-410).
template <bool CLIP = false>
static __device__ __forceinline__ float seg_d2(float wx, float wy, float ex,
                                               float ey, float* t_out) {
  return seg_d2_den<CLIP>(wx, wy, ex, ey, seg_den(ex, ey), t_out);
}
