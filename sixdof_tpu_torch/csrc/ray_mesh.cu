// Ray-mesh first hit (Moller-Trumbore), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
// sixdof_tpu/ops/pallas/raytrace_kernel.py::ray_mesh_intersect_pallas.  Same
// function, not the same blocks:
//
//   for every ray r (origin o, direction d, valid flag) and every triangle
//   (v0, e1 = v1 - v0, e2 = v2 - v0):
//     p = d x e2, det = p.e1, inv_det = 1/det where |det| > 1e-12 else 0,
//     s = o - v0, u = (s.p) inv_det, q = s x e1, v = (q.d) inv_det,
//     t = (q.e2) inv_det;
//     hit iff |det| > 1e-12, u >= -1e-6, v >= -1e-6, u + v <= 1 + 1e-6,
//     t > 1e-6 and the ray is valid.
//   t_out[r] = min t over the hits, +inf without one.
//
// Masked triangles arrive with e1 = e2 = 0 (det = 0, never a hit).
//
// Layout: origins, dirs (N, 3) float32; valid (N,) uint8 (a torch bool);
// tris (T, 9) float32 rows [v0 | e1 | e2]; t_out (N,) float32, filled with
// +inf by the caller.
//
// Design: one thread per ray, its origin, direction and running minimum in
// registers; a block of 128 rays stages chunks of its triangles in shared
// memory and every thread reads them as broadcasts.  The triangle list is
// split across blockIdx.y when there are too few rays to fill the card (the
// capture's heatmap gives a few hundred rays): each block then folds its
// minimum into t_out with an integer atomicMin, which orders non-negative
// floats like the floats themselves.  A minimum is exact in any order, so
// the split changes no bit of the result.
//
// Arithmetic: every product, sum and difference is written with
// __fmul_rn / __fadd_rn / __fsub_rn in the order the plain PyTorch version
// in kernels/raytrace.py uses, and 1/det is IEEE division (__fdiv_rn): nvcc
// may fuse nothing into an FMA, so kernel and plain version agree bit for
// bit, and a ray on a shared edge (u + v = 1 within 1e-6) hits or misses in
// both alike.
//
// Bound on this card: operations.  Each (ray, triangle) pair costs 46 fp32
// operations, one of them a division, on data in registers and shared
// memory; the bytes (each ray and triangle read once, one float written per
// ray) are small beside that.  Binning triangles (a BVH or a grid) and the
// tensor cores are later steps for speed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;            // triangles per shared stage: 256 * 36 B = 9 KB
constexpr int kTargetBlocks = 4 * 132; // about four blocks per SM of an H100
constexpr int kMinTrisPerBlock = 32;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));  // a*b - c*d
}

__global__ void __launch_bounds__(kThreads)
ray_mesh_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                const unsigned char* __restrict__ valid, const float* __restrict__ tris,
                float* __restrict__ t_out, int N, int T, int tris_per_block) {
  __shared__ float tri[kChunk * 9];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int t_begin = blockIdx.y * tris_per_block;
  const int t_end = min(T, t_begin + tris_per_block);
  const bool live = r < N && valid[r] != 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    ox = origins[3 * r];
    oy = origins[3 * r + 1];
    oz = origins[3 * r + 2];
    dx = dirs[3 * r];
    dy = dirs[3 * r + 1];
    dz = dirs[3 * r + 2];
  }
  const float inf = __int_as_float(0x7f800000);
  float best = inf;
  for (int t0 = t_begin; t0 < t_end; t0 += kChunk) {
    const int m = min(kChunk, t_end - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < m * 9; i += kThreads) tri[i] = tris[static_cast<size_t>(t0) * 9 + i];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
      const float* g = tri + 9 * j;
      const float v0x = g[0], v0y = g[1], v0z = g[2];
      const float e1x = g[3], e1y = g[4], e1z = g[5];
      const float e2x = g[6], e2y = g[7], e2z = g[8];
      const float px = cross_term(dy, e2z, dz, e2y);
      const float py = cross_term(dz, e2x, dx, e2z);
      const float pz = cross_term(dx, e2y, dy, e2x);
      const float det = dot3(px, py, pz, e1x, e1y, e1z);
      const bool ok = fabsf(det) > 1e-12f;
      const float inv_det = ok ? __fdiv_rn(1.0f, det) : 0.0f;
      const float sx = __fsub_rn(ox, v0x);
      const float sy = __fsub_rn(oy, v0y);
      const float sz = __fsub_rn(oz, v0z);
      const float u = __fmul_rn(dot3(sx, sy, sz, px, py, pz), inv_det);
      const float qx = cross_term(sy, e1z, sz, e1y);
      const float qy = cross_term(sz, e1x, sx, e1z);
      const float qz = cross_term(sx, e1y, sy, e1x);
      const float v = __fmul_rn(dot3(qx, qy, qz, dx, dy, dz), inv_det);
      const float t = __fmul_rn(dot3(qx, qy, qz, e2x, e2y, e2z), inv_det);
      const bool hit = ok && u >= -1e-6f && v >= -1e-6f && __fadd_rn(u, v) <= 1.000001f &&
                       t > 1e-6f;
      if (hit && t < best) best = t;
    }
  }
  if (live && best < inf) atomicMin(reinterpret_cast<int*>(t_out) + r, __float_as_int(best));
}

}  // namespace

// Launches on @stream and returns cudaGetLastError() (0 = launched).
extern "C" int ray_mesh_intersect(const void* origins, const void* dirs, const void* valid,
                                  const void* tris, void* t_out, int N, int T, void* stream) {
  if (N <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
  const int ray_blocks = (N + kThreads - 1) / kThreads;
  int splits = (kTargetBlocks + ray_blocks - 1) / ray_blocks;
  splits = max(1, min(min(splits, (T + kMinTrisPerBlock - 1) / kMinTrisPerBlock), 65535));
  const int per = (T + splits - 1) / splits;
  splits = (T + per - 1) / per;
  const dim3 grid(ray_blocks, splits);
  ray_mesh_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(tris),
      static_cast<float*>(t_out), N, T, per);
  return static_cast<int>(cudaGetLastError());
}
