// Dirichlet-resolve kernels for Hopper (sm_90a), bound through ctypes.
//
// They replace the Pallas kernels of elaina_tpu/ops/pallas_resolve.py that
// run on the Dirichlet resolve of every depth step, 2D and 3D:
//
//   K1 compact_lanes    (pallas_resolve.py:594) -> compact_lanes_kernel
//   K2 sweep_resolve    (pallas_resolve.py:194, body _sweep_kernel :113)
//                                              -> sweep_resolve_kernel
//   K3 fetch_colors     (pallas_resolve.py:540, _fetch_colors_impl :481)
//                                              -> fetch_colors_kernel<2>
//   K4 sweep_resolve_3d (pallas_resolve.py:352, body _sweep_kernel_3d :280,
//                        distance pallas_queries.py:208 _tri_d2_tile)
//                                              -> sweep_resolve_3d_kernel
//   K5 fetch_colors3    (pallas_resolve.py:554) -> fetch_colors_kernel<3>
//
// and the chain path's candidate-row sweeps of elaina_tpu/ops/
// pallas_queries.py, which serve the DIRICHLET_SDF channel:
//
//   K10 grid_band_dma_2d (pallas_queries.py:136, body :36)
//                                              -> grid_band_kernel<2>
//   K11 grid_band_dma_3d (pallas_queries.py:316, body :253)
//                                              -> grid_band_kernel<3>
//
// The contracts are the TPU kernels'; the TPU shapes are not carried over:
// a bool mask (N,) replaces the bitmask words, and there are no scalar
// bit scans, block-any flags, one-hot picks or lane chunks.  Each launch
// function enqueues on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// Built with -fmad=false: contracted multiply-adds would move the distance
// in its last bits against the plain PyTorch version; without them the
// segment and triangle math below rounds exactly as the plain version
// does, which writes the same products and sums in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// --------------------------------------------------------------------------
// K1: lane compaction in one launch, a scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016).  Bound by reading the mask (N bytes) and writing the
// ids (4 bytes per set lane, at most cap): ~1.8 MB at 1024^2 lanes, a few
// microseconds of the card's time, so the design is about one launch and
// no per-call scratch.
//
// Each CTA takes a tile of 4,096 lanes by an atomicAdd on a tile counter,
// not by blockIdx, so it only ever waits on tiles whose CTAs already run.
// A thread reads its 16 mask bytes as one uint4, the block scans the
// per-thread counts, and the CTA stages its ids in shared memory.  It
// publishes its count (flag AGG), looks back a warp of predecessors at a
// time until the nearest inclusive prefix (flag INC), publishes its own
// inclusive prefix, and copies its ids out contiguously, those below cap
// only.  The CTA of the last tile writes cnt, the full count.
//
// The workspace (the wrapper's, one per device, zeroed once) is int64:
// word 0 holds the tile counter (low 32 bits) and the call's epoch (high
// 32), then one status word per tile, [epoch:30 | flag:2] << 32 | value,
// read and written whole.  The CTA that draws the last ticket resets the
// counter and advances the epoch in one store: every other CTA of the
// call has drawn its ticket by then, and the next launch on the stream
// starts after this one ends.  A status word of an earlier call carries
// an older epoch and reads as not yet published, so no per-call reset or
// host-side value is needed (a CUDA graph can capture the launch).  The
// counter is shared: the workspace serialises calls on one stream, and
// two calls must never run at once on two streams.
// --------------------------------------------------------------------------

constexpr int CL_THREADS = 256;
constexpr int CL_PER_THREAD = 16;                    // one uint4 of mask
constexpr int CL_TILE = CL_THREADS * CL_PER_THREAD;  // 4,096 lanes
constexpr unsigned ST_AGG = 1, ST_INC = 2;
constexpr unsigned EPOCH_MASK = 0x3fffffffu;

// Exclusive prefix sum of v over the block; *total gets the block sum.
// smem holds 32 ints; the block size is a multiple of 32.
__device__ int block_exclusive_scan(int v, int* smem, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? smem[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    smem[lane] = w;
  }
  __syncthreads();
  const int warp_prefix = warp > 0 ? smem[warp - 1] : 0;
  *total = smem[n_warps - 1];
  __syncthreads();  // smem is reused by the caller's next scan
  return warp_prefix + x - v;
}

// The 4 mask bytes of w as 4 bits, bit k set where byte k is nonzero.
__device__ __forceinline__ unsigned set_bytes(unsigned w) {
  w |= w >> 4;  // fold each byte's bits onto its bit 0
  w |= w >> 2;
  w |= w >> 1;
  w &= 0x01010101u;
  return (w | (w >> 7) | (w >> 14) | (w >> 21)) & 0xfu;
}

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned epoch, unsigned flag,
                                          int value) {
  const unsigned long long v =
      ((unsigned long long)((epoch << 2) | flag) << 32) | (unsigned)value;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__global__ void __launch_bounds__(CL_THREADS)
compact_lanes_kernel(const uint8_t* __restrict__ mask, int64_t n,
                     int32_t cap, int32_t* __restrict__ lanes,
                     int32_t* __restrict__ cnt,
                     unsigned long long* __restrict__ work) {
  __shared__ int ids[CL_TILE];
  __shared__ int smem[32];
  __shared__ unsigned s_tile, s_epoch;
  __shared__ int s_prefix;
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(work, 1ull);
    const unsigned epoch = (unsigned)(t >> 32) & EPOCH_MASK;
    if ((unsigned)t == gridDim.x - 1)  // the last ticket: reset for the next
      atomicExch(work, (unsigned long long)((epoch + 1) & EPOCH_MASK) << 32);
    s_tile = (unsigned)t;
    s_epoch = epoch;
  }
  __syncthreads();
  const unsigned tile = s_tile, epoch = s_epoch;
  const int64_t base = (int64_t)tile * CL_TILE;
  const int64_t first = base + (int64_t)threadIdx.x * CL_PER_THREAD;
  unsigned bits = 0;  // bit j: lane first + j is set
  if (base + CL_TILE <= n && ((uintptr_t)mask & 15) == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(mask + first));
    bits = set_bytes(v.x) | set_bytes(v.y) << 4 | set_bytes(v.z) << 8 |
           set_bytes(v.w) << 12;
  } else {  // the ragged last tile, or a mask view off 16 bytes
    for (int j = 0; j < CL_PER_THREAD; ++j)
      if (first + j < n && mask[first + j]) bits |= 1u << j;
  }
  int total;
  int pos = block_exclusive_scan(__popc(bits), smem, &total);
  for (unsigned b = bits; b; b &= b - 1)
    ids[pos++] = (int)(first + __ffs(b) - 1);

  unsigned long long* status = work + 1;
  if (threadIdx.x < 32) {  // warp 0: publish and look back
    const int lane = threadIdx.x;
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) st_status(status, epoch, ST_INC, total);
    } else {
      if (lane == 0) st_status(status + tile, epoch, ST_AGG, total);
      // lane k reads tile - 1 - k: lane 0 the nearest predecessor
      for (int64_t j = (int64_t)tile - 1 - lane;; j -= 32) {
        unsigned flag = ST_INC;  // before tile 0: an inclusive 0
        int value = 0;
        if (j >= 0) {
          unsigned long long s;
          do {  // wait for this call's word (its CTA is running)
            s = ld_status(status + j);
            const unsigned hi = (unsigned)(s >> 32);
            flag = (hi >> 2) == epoch ? (hi & 3u) : 0u;
          } while (flag == 0);
          value = (int)(unsigned)s;
        }
        const unsigned inc = __ballot_sync(FULL, flag == ST_INC);
        // sum up to and including the nearest inclusive prefix
        const int stop = inc ? __ffs(inc) - 1 : 31;
        prefix += __reduce_add_sync(FULL, lane <= stop ? value : 0);
        if (inc) break;
      }
      if (lane == 0) st_status(status + tile, epoch, ST_INC, prefix + total);
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const int prefix = s_prefix;
  if (tile == gridDim.x - 1 && threadIdx.x == 0) cnt[0] = prefix + total;
  for (int k = threadIdx.x; k < total && prefix + k < cap; k += CL_THREADS)
    lanes[prefix + k] = ids[k];
}

// --------------------------------------------------------------------------
// K2 / K4: the lane-list sweeps.  The wrapper compacts the mask (N,) with
// K1 first; one launch then covers both kinds of lane.  Its warps take the
// list positions [0, cnt), cnt read on the device (no host sync): block b
// a contiguous share of about cnt / gridDim.x positions, its warps one
// position at a time, so neighbouring lanes of the list (neighbouring
// walks, which mostly share a candidate row) run on one SM, where L1
// serves the row's later reads.  Position p sweeps lane lanes[p]: it
// reads row[lane] and q[lane] and writes its results at lane.  Every lane
// off the list gets the plain version's unmasked values from the same
// launch, by a grid-stride pass over the mask.  The grid is sized from
// the card, a full wave of resident blocks (SM count x blocks an SM
// holds), not from N, and never more blocks than N needs.
// --------------------------------------------------------------------------

constexpr int SWEEP_THREADS = 256;
constexpr int SWEEP_WARPS = SWEEP_THREADS / 32;

// Block blockIdx.x's share [*p0, *p1) of the list positions [0, cnt).
__device__ __forceinline__ void list_share(int64_t cnt, int64_t* p0,
                                           int64_t* p1) {
  const int64_t per = (cnt + gridDim.x - 1) / gridDim.x;
  *p0 = min(cnt, (int64_t)blockIdx.x * per);
  *p1 = min(cnt, *p0 + per);
}

// Lexicographic (d^2, slot) argmin over the warp; every lane gets it.
__device__ __forceinline__ void warp_argmin(float* d2, int* slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float od2 = __shfl_xor_sync(FULL, *d2, o);
    const int os = __shfl_xor_sync(FULL, *slot, o);
    if (od2 < *d2 || (od2 == *d2 && os < *slot)) {
      *d2 = od2;
      *slot = os;
    }
  }
}

// --------------------------------------------------------------------------
// K2: exact closest segment among a listed lane's candidate row.  One warp
// per listed lane over the row's coordinate planes (R, 4, Kp) = ax | ay |
// bx | by: each thread reads four neighbouring slots of each plane as one
// float4 (a warp instruction reads 512 contiguous bytes; Kp % 32 == 0
// and the wrapper's check that the table starts on 16 bytes keep every
// plane row on 16 bytes), in slot order, and
// keeps the first least d^2 (strict <).  The warp meets in a lexicographic
// (d^2, slot) argmin by shuffle, which keeps the smallest slot among equal
// d^2 as the TPU kernel's strict < does; then lane 0 recomputes the
// winner's t and side from its slot with the same operations, so they
// carry the bits of the sweep.  Padded slots hold 1e9, so their d^2
// (~1e18) stays finite; when every d^2 overflows (a walk far outside the
// grid) slot 0 wins, as the plain version's argmin gives.  The row reads
// (16 bytes per candidate, 4 KB per lane at K = 256) come mostly from L1
// and L2: the same list sorted by row, or shuffled, ran within 5% of K1's
// order (PERF.md), so the re-reads do not set its time; what does is not
// measured.  Each candidate costs ~20 flops and one IEEE division.  Lanes
// off the list get d = t = side = 0 and pid = -1.
// --------------------------------------------------------------------------

// K2 and K10 take the segment distance of segment.cuh (seg_d2).

__device__ __forceinline__ void seg_take(float qx, float qy, float ax,
                                         float ay, float bx, float by,
                                         int k, float* best, int* slot) {
  float t;
  const float d2 = seg_d2(qx - ax, qy - ay, bx - ax, by - ay, &t);
  if (d2 < *best) {
    *best = d2;
    *slot = k;
  }
}

__global__ void __launch_bounds__(SWEEP_THREADS) sweep_resolve_kernel(
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ lanes,
    const int32_t* __restrict__ cnt_in, const int32_t* __restrict__ row,
    const float* __restrict__ q, const float* __restrict__ coords,
    const int32_t* __restrict__ cand, int64_t n, int32_t K, int32_t Kp,
    float* __restrict__ d_out, float* __restrict__ t_out,
    float* __restrict__ side_out, int32_t* __restrict__ pid_out) {
  const int64_t stride = (int64_t)gridDim.x * SWEEP_THREADS;
  for (int64_t i = (int64_t)blockIdx.x * SWEEP_THREADS + threadIdx.x; i < n;
       i += stride) {
    if (!mask[i]) {
      d_out[i] = 0.f;
      t_out[i] = 0.f;
      side_out[i] = 0.f;
      pid_out[i] = -1;
    }
  }
  const int warp = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  int64_t p0, p1;
  list_share(min((int64_t)*cnt_in, n), &p0, &p1);
  for (int64_t p = p0 + warp; p < p1; p += SWEEP_WARPS) {
    const int64_t i = lanes[p];
    const int64_t r = row[i];
    const float qx = q[2 * i];
    const float qy = q[2 * i + 1];
    const float* ax_p = coords + r * 4 * Kp;
    const float* ay_p = ax_p + Kp;
    const float* bx_p = ay_p + Kp;
    const float* by_p = bx_p + Kp;

    float best = __int_as_float(0x7f800000);  // +inf
    int slot = Kp;
    for (int k = 4 * lid; k < Kp; k += 128) {  // Kp % 4 == 0
      const float4 ax = __ldg(reinterpret_cast<const float4*>(ax_p + k));
      const float4 ay = __ldg(reinterpret_cast<const float4*>(ay_p + k));
      const float4 bx = __ldg(reinterpret_cast<const float4*>(bx_p + k));
      const float4 by = __ldg(reinterpret_cast<const float4*>(by_p + k));
      seg_take(qx, qy, ax.x, ay.x, bx.x, by.x, k, &best, &slot);
      seg_take(qx, qy, ax.y, ay.y, bx.y, by.y, k + 1, &best, &slot);
      seg_take(qx, qy, ax.z, ay.z, bx.z, by.z, k + 2, &best, &slot);
      seg_take(qx, qy, ax.w, ay.w, bx.w, by.w, k + 3, &best, &slot);
    }
    warp_argmin(&best, &slot);
    if (lid == 0) {
      const int s = slot < Kp ? slot : 0;  // every d^2 overflowed
      const float ax = ax_p[s];
      const float ay = ay_p[s];
      const float ex = bx_p[s] - ax;
      const float ey = by_p[s] - ay;
      const float wx = qx - ax;
      const float wy = qy - ay;
      float t;
      seg_d2(wx, wy, ex, ey, &t);
      d_out[i] = sqrtf(best);
      t_out[i] = t;
      side_out[i] = ex * wy - ey * wx;
      pid_out[i] = s < K ? cand[r * K + s] : -1;
    }
  }
}

// --------------------------------------------------------------------------
// K4: exact closest triangle among a listed lane's candidate row.  The 3D
// form of K2 over the (R, 9, Kp) corner planes ax ay az bx by bz cx cy cz:
// 36 bytes per candidate (9 KB per lane at K = 256), read as float4s four
// slots at a time (the table on 16 bytes, as K2's), ~120 flops and up to
// five IEEE divisions per candidate.
// The distance is _tri_d2_tile's: the interior distance from the explicit
// residual w - u e1 - v e2 (no |q - p|^2 cancellation) where the
// projection falls inside, else the least of the three edge distances,
// computed only there.  Winner: lexicographic (d^2, slot) argmin by warp
// shuffle; nine lanes then reload the winner's corners (an L1 hit).
// Lanes off the list get d = 0, pid = -1 and zero corners.
// --------------------------------------------------------------------------

__device__ __forceinline__ float dot3(const float* u, const float* v) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

// Component j of a float4 (j a constant once unrolled).
__device__ __forceinline__ float f4_at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <bool CLIP = false>  // CLIP: clip01_div's (K11)
__device__ __forceinline__ float edge_d2(const float* q, const float* p0,
                                         const float* p1) {
  float e[3], w[3], dd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e[k] = p1[k] - p0[k];
    w[k] = q[k] - p0[k];
  }
  const float t = clip01_div<CLIP>(dot3(w, e), fmaxf(dot3(e, e), 1e-30f));
#pragma unroll
  for (int k = 0; k < 3; ++k) dd[k] = w[k] - t * e[k];
  return dot3(dd, dd);
}

// c: corners a = c[0..2], b = c[3..5], c = c[6..8]
template <bool CLIP = false>
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
  if (u >= 0.f && v >= 0.f && u + v <= 1.f) {  // inside: the plane residual
#pragma unroll
    for (int k = 0; k < 3; ++k) diff[k] = w[k] - u * e1[k] - v * e2[k];
    return dot3(diff, diff);
  }
  return fminf(fminf(edge_d2<CLIP>(q, c, c + 3),
                     edge_d2<CLIP>(q, c + 3, c + 6)),
               edge_d2<CLIP>(q, c + 6, c));
}

__global__ void __launch_bounds__(SWEEP_THREADS) sweep_resolve_3d_kernel(
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ lanes,
    const int32_t* __restrict__ cnt_in, const int32_t* __restrict__ row,
    const float* __restrict__ q, const float* __restrict__ coords,
    const int32_t* __restrict__ cand, int64_t n, int32_t K, int32_t Kp,
    float* __restrict__ d_out, int32_t* __restrict__ pid_out,
    float* __restrict__ corners_out) {
  const int64_t stride = (int64_t)gridDim.x * SWEEP_THREADS;
  const int64_t first = (int64_t)blockIdx.x * SWEEP_THREADS + threadIdx.x;
  for (int64_t i = first; i < n; i += stride) {
    if (!mask[i]) {
      d_out[i] = 0.f;
      pid_out[i] = -1;
    }
  }
  for (int64_t j = first; j < 9 * n; j += stride)  // corners, coalesced
    if (!mask[j / 9]) corners_out[j] = 0.f;
  const int warp = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  int64_t p0, p1;
  list_share(min((int64_t)*cnt_in, n), &p0, &p1);
  for (int64_t p = p0 + warp; p < p1; p += SWEEP_WARPS) {
    const int64_t i = lanes[p];
    const int64_t r = row[i];
    const float qv[3] = {q[3 * i], q[3 * i + 1], q[3 * i + 2]};
    const float* base = coords + r * 9 * Kp;

    float best = __int_as_float(0x7f800000);  // +inf
    int slot = Kp;
    for (int k = 4 * lid; k < Kp; k += 128) {  // Kp % 4 == 0
      float4 c4[9];
#pragma unroll
      for (int pl = 0; pl < 9; ++pl)
        c4[pl] = __ldg(reinterpret_cast<const float4*>(base + pl * Kp + k));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float c[9];
#pragma unroll
        for (int pl = 0; pl < 9; ++pl) c[pl] = f4_at(c4[pl], j);
        const float d2 = tri_d2(qv, c);
        if (d2 < best) {
          best = d2;
          slot = k + j;
        }
      }
    }
    warp_argmin(&best, &slot);
    // every d^2 overflowed (a walk far outside the grid): slot 0, as the
    // plain version's argmin gives, not a read past the row
    slot = slot < Kp ? slot : 0;
    if (lid < 9) corners_out[9 * i + lid] = base[lid * Kp + slot];
    if (lid == 0) {
      d_out[i] = sqrtf(best);
      pid_out[i] = slot < K ? cand[r * K + slot] : -1;
    }
  }
}

// Blocks of a full wave of the kernel on the current device (its SM count
// times the blocks an SM holds at SWEEP_THREADS threads), found once per
// device, and at most the blocks that n lanes need (a warp a lane); -1 if
// the device cannot be read.
template <typename F>
int64_t sweep_blocks(F kernel, int64_t n) {
  static int wave[64];  // one table per kernel
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return -1;
  if (wave[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, SWEEP_THREADS, 0) != cudaSuccess)
      return -1;
    wave[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t need = (n + SWEEP_WARPS - 1) / SWEEP_WARPS;
  return need < wave[dev] ? need : wave[dev];
}

// --------------------------------------------------------------------------
// K10 / K11: the chain path's exact closest segment (DIM 2) or triangle
// (DIM 3) over the candidate row of every lane with row >= 0, no mask and
// no compaction (grid_closest_point_detail, elaina_tpu/geometry/
// grid.py:1226), over the row's DIM*DIM corner planes (R, DIM*DIM, Kp).
// BAND_T threads a lane: each reads four neighbouring slots of each plane
// as one float4 (Kp % 32 == 0 and the wrapper's check that the table
// starts on 16 bytes keep every plane row on 16 bytes), keeps its first
// least d^2 in slot order (strict <) with that candidate's corners in
// registers, and the lane's threads meet in a lexicographic (d^2, slot)
// min by shuffle: the smallest slot among equal d^2, as the TPU kernel's
// strict < per column and its least flat slot give.  The thread that
// swept the winning slot writes it, so no corner is read twice.
// Neighbouring lanes (pixels of one frame row) mostly share a candidate
// row, so L1 and L2 serve its later reads and the instructions of each
// candidate set the time, not the bytes: ~20 flops and an IEEE division
// in 2D, ~120 flops and up to five divisions in 3D.  So t's clip to
// [0, 1] is decided before the division wherever it can be (CLIP of
// segment.cuh): a candidate whose projection falls past an end of the
// segment, or of a triangle's edge, does not divide, and d^2 keeps its
// bits.  1, 2, 4 and 8 threads a lane, with and without that clip, were
// timed at the main paths' shapes (PERF.md): 4 with the clip was the
// fastest in 2D and in 3D.  Lanes with row < 0 get d^2 = +inf, slot 0
// and zero corners; a lane whose every d^2 overflowed gets slot 0 and
// that slot's corners, as the plain version's argmin gives.
// --------------------------------------------------------------------------

constexpr int BAND_T = 4;  // threads a lane

template <int DIM>
__global__ void __launch_bounds__(SWEEP_THREADS) grid_band_kernel(
    const int32_t* __restrict__ row, const float* __restrict__ q,
    const float* __restrict__ coords, int64_t n, int32_t Kp,
    float* __restrict__ d2_out, int32_t* __restrict__ slot_out,
    float* __restrict__ corners_out) {
  constexpr int NP = DIM * DIM;
  const int64_t i =
      ((int64_t)blockIdx.x * SWEEP_THREADS + threadIdx.x) / BAND_T;
  const int sub = threadIdx.x % BAND_T;
  // every thread stays to the shuffle; those past n hold no row
  const int64_t r = i < n ? row[i] : -1;
  const float* base = coords + (r >= 0 ? r : 0) * NP * Kp;

  float best = __int_as_float(0x7f800000);  // +inf
  int slot = Kp;
  float bc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) bc[p] = 0.f;
  if (r >= 0) {
    float qv[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) qv[d] = q[DIM * i + d];
    for (int k = 4 * sub; k < Kp; k += 4 * BAND_T) {  // Kp % 16 == 0
      float4 c4[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        c4[p] = __ldg(reinterpret_cast<const float4*>(base + p * Kp + k));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float c[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) c[p] = f4_at(c4[p], j);
        float d2;
        if constexpr (DIM == 2) {
          float t;
          d2 = seg_d2<true>(qv[0] - c[0], qv[1] - c[1], c[2] - c[0],
                            c[3] - c[1], &t);
        } else {
          d2 = tri_d2<true>(qv, c);
        }
        if (d2 < best) {
          best = d2;
          slot = k + j;
#pragma unroll
          for (int p = 0; p < NP; ++p) bc[p] = c[p];
        }
      }
    }
  }
  const int mine = slot;
#pragma unroll
  for (int o = BAND_T / 2; o > 0; o >>= 1) {  // within the lane's threads
    const float od2 = __shfl_xor_sync(FULL, best, o);
    const int os = __shfl_xor_sync(FULL, slot, o);
    if (od2 < best || (od2 == best && os < slot)) {
      best = od2;
      slot = os;
    }
  }
  if (i >= n) return;
  if (slot >= Kp) {  // no row, or every d^2 overflowed: slot 0
    if (sub == 0) {
      d2_out[i] = best;
      slot_out[i] = 0;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        corners_out[NP * i + p] = r >= 0 ? base[p * Kp] : 0.f;
    }
  } else if (mine == slot) {  // the thread that swept the winner
    d2_out[i] = best;
    slot_out[i] = slot;
    if constexpr (DIM == 2) {
      reinterpret_cast<float4*>(corners_out)[i] =
          make_float4(bc[0], bc[1], bc[2], bc[3]);
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p) corners_out[NP * i + p] = bc[p];
    }
  }
}

template <int DIM>
int grid_band_dim(const void* row, const void* q, const void* coords,
                  int64_t n, int32_t Kp, void* d2, void* slot, void* corners,
                  void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n * BAND_T + SWEEP_THREADS - 1) / SWEEP_THREADS;
  grid_band_kernel<DIM><<<(unsigned)blocks, SWEEP_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)row, (const float*)q, (const float*)coords, n, Kp,
      (float*)d2, (int32_t*)slot, (float*)corners);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// K3 / K5: the corner colors of color row cfi = 2 * pid + (side < 0), on
// masked lanes: NC = 2 segment endpoints (K3) or 3 triangle corners (K5),
// from the (2P, 3 * NC) table.  One thread per lane.  A masked-off lane
// writes its zeros without reading cfi; a set lane reads its row (a
// random-access load: L2 serves the rows of boundary-hugging lanes).  The
// writes bound it: out is (NC, n, 3), corner-major, so each corner's
// colors are a contiguous (n, 3) block and a warp's stores cover 384
// contiguous bytes a corner; 24 MB at 1024^2 lanes for K3 (7 us at the
// H100's 3.35 TB/s).  Rows padded to 16 bytes and read as float4s were
// measured no faster (PERF.md), so the table keeps its 3 * NC floats a
// row.  Rows out of range get 0.
// --------------------------------------------------------------------------

constexpr int COLOR_THREADS = 256;

template <int NC>
__global__ void fetch_colors_kernel(const uint8_t* __restrict__ mask,
                                    const int32_t* __restrict__ cfi,
                                    const float* __restrict__ rows,
                                    int64_t n, int64_t n_rows,
                                    float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float c[3 * NC];
#pragma unroll
  for (int k = 0; k < 3 * NC; ++k) c[k] = 0.f;
  if (mask[i]) {
    const int64_t r = cfi[i];
    if (r >= 0 && r < n_rows) {
#pragma unroll
      for (int k = 0; k < 3 * NC; ++k) c[k] = __ldg(rows + r * (3 * NC) + k);
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    float* o = out + (k * n + i) * 3;
    o[0] = c[3 * k];
    o[1] = c[3 * k + 1];
    o[2] = c[3 * k + 2];
  }
}

template <int NC>
int fetch_colors_nc(const void* mask, const void* cfi, const void* rows,
                    int64_t n, int64_t n_rows, void* out, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = (n + COLOR_THREADS - 1) / COLOR_THREADS;
  fetch_colors_kernel<NC><<<(unsigned)blocks, COLOR_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int32_t*)cfi, (const float*)rows, n,
      n_rows, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// work: int64 (1 + work_tiles,), zeroed before its first call and then
// left to the kernel (see K1 above).
int compact_lanes_launch(const void* mask, int64_t n, int32_t cap,
                         void* lanes, void* cnt, void* work,
                         int64_t work_tiles, void* stream) {
  const int64_t n_tiles = n > 0 ? (n + CL_TILE - 1) / CL_TILE : 1;
  if (n_tiles > work_tiles) return (int)cudaErrorInvalidValue;
  compact_lanes_kernel<<<(unsigned)n_tiles, CL_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)mask, n, cap, (int32_t*)lanes, (int32_t*)cnt,
      (unsigned long long*)work);
  return (int)cudaGetLastError();
}

// lanes, cnt: K1's list of the set lanes of mask (lanes[0, cnt), cap n).
int sweep_resolve_launch(const void* mask, const void* lanes, const void* cnt,
                         const void* row, const void* q, const void* coords,
                         const void* cand, int64_t n, int32_t K, int32_t Kp,
                         void* d, void* t, void* side, void* pid,
                         void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = sweep_blocks(sweep_resolve_kernel, n);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  sweep_resolve_kernel<<<(unsigned)blocks, SWEEP_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int32_t*)lanes, (const int32_t*)cnt,
      (const int32_t*)row, (const float*)q, (const float*)coords,
      (const int32_t*)cand, n, K, Kp, (float*)d, (float*)t, (float*)side,
      (int32_t*)pid);
  return (int)cudaGetLastError();
}

int sweep_resolve_3d_launch(const void* mask, const void* lanes,
                            const void* cnt, const void* row, const void* q,
                            const void* coords, const void* cand, int64_t n,
                            int32_t K, int32_t Kp, void* d, void* pid,
                            void* corners, void* stream) {
  if (n == 0) return 0;
  const int64_t blocks = sweep_blocks(sweep_resolve_3d_kernel, n);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  sweep_resolve_3d_kernel<<<(unsigned)blocks, SWEEP_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (const int32_t*)lanes, (const int32_t*)cnt,
      (const int32_t*)row, (const float*)q, (const float*)coords,
      (const int32_t*)cand, n, K, Kp, (float*)d, (int32_t*)pid,
      (float*)corners);
  return (int)cudaGetLastError();
}

// rows: (n_rows, 6) f32; out: (2, n, 3) f32, endpoint-major
int fetch_colors_launch(const void* mask, const void* cfi, const void* rows,
                        int64_t n, int64_t n_rows, void* out, void* stream) {
  return fetch_colors_nc<2>(mask, cfi, rows, n, n_rows, out, stream);
}

// rows: (n_rows, 9) f32; out: (3, n, 3) f32, corner-major
int fetch_colors3_launch(const void* mask, const void* cfi, const void* rows,
                         int64_t n, int64_t n_rows, void* out, void* stream) {
  return fetch_colors_nc<3>(mask, cfi, rows, n, n_rows, out, stream);
}

// K10: corners (n, 4) ax, ay, bx, by
int grid_band_2d_launch(const void* row, const void* q, const void* coords,
                        int64_t n, int32_t Kp, void* d2, void* slot,
                        void* corners, void* stream) {
  return grid_band_dim<2>(row, q, coords, n, Kp, d2, slot, corners, stream);
}

// K11: corners (n, 9) ax ay az bx by bz cx cy cz
int grid_band_3d_launch(const void* row, const void* q, const void* coords,
                        int64_t n, int32_t Kp, void* d2, void* slot,
                        void* corners, void* stream) {
  return grid_band_dim<3>(row, q, coords, n, Kp, d2, slot, corners, stream);
}

}  // extern "C"
