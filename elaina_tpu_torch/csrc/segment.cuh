// The point-segment distance that every 2D sweep of the port shares
// (resolve.cu: K2, K10; queries.cu: K12, K13), so they all give the
// distances of the TPU kernels' tiles bit for bit under -fmad=false.

#pragma once

// Squared distance from q to the segment a + t e, t = clip((w . e) /
// max(|e|^2, 1e-30), 0, 1) with w = q - a (pallas_queries.py:97-105,
// :402-410); writes t.
static __device__ __forceinline__ float seg_d2(float wx, float wy, float ex,
                                               float ey, float* t_out) {
  const float den = fmaxf(ex * ex + ey * ey, 1e-30f);
  const float t = fminf(fmaxf((wx * ex + wy * ey) / den, 0.f), 1.f);
  const float dx = wx - t * ex;
  const float dy = wy - t * ey;
  *t_out = t;
  return dx * dx + dy * dy;
}
