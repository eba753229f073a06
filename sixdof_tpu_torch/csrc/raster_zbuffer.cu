// Z-buffer core of the batched triangle rasterizer, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel
// sixdof_tpu/ops/pallas/raster_kernel.py::rasterize_zbuffer_pallas (flat form,
// per-pose candidate counts).  Same function, not the same blocks:
//
//   for every pose b and pixel p = (px, py) (px = column, py = row, integer
//   coordinates), over candidate triangles t < counts[b] in ascending order,
//   evaluate four planes c0*px + c1*py + c2: the barycentrics l0, l1, l2 and
//   the inverse depth iz.  The pixel is inside when min(l0,l1,l2) >= 0 and
//   iz > 1e-12.  Keep the largest iz with a strict '>', so among equal iz the
//   lowest candidate index wins (the Pallas kernel's tie rule).
//   zbuf = 1 / max(iz, 1e-12) or 0 on a miss; tid = winner or -1.
//
// Layout: coef (B, T, 12) float32, per triangle [l0 | l1 | l2 | iz] x
// (c0, c1, c2); counts (B,) int32 (the caller compacts valid triangles to the
// front of each pose, so t >= counts[b] is never read); zbuf (B, H*W) float32,
// tid (B, H*W) int32.
//
// Design: one thread per (pose, pixel); a block of 256 pixels of one pose
// stages chunks of that pose's triangle planes in shared memory and every
// thread reads them as broadcasts.  Plane evaluation is fp32 with explicit
// round-to-nearest multiplies and adds (__fmul_rn / __fadd_rn, never fused
// into an FMA), so the kernel computes exactly what the plain PyTorch
// version in kernels/raster.py computes, and no tensor cores: thin triangles
// carry 1/area-sized coefficients, and reduced-precision plane error reaches
// O(1) barycentric units.
//
// Bound on this card: operations.  Each (pose, pixel, triangle) test is 8
// fp32 multiply/adds plus compares on data that lives in shared memory; the
// bytes moved (coefficients once per pose, two outputs per pixel) are small
// beside that.  Binning triangles by screen tile is the next step for speed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // triangles staged per pass: 256 * 48 B = 12 KB

__device__ __forceinline__ float plane(float c0, float c1, float c2, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c0, px), __fmul_rn(c1, py)), c2);
}

__global__ void __launch_bounds__(kThreads)
raster_zbuffer_kernel(const float4* __restrict__ coef, const int* __restrict__ counts,
                      float* __restrict__ zbuf, int* __restrict__ tid, int T, int H, int W) {
  __shared__ float4 tri[kChunk * 3];
  const int b = blockIdx.y;
  const int P = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int n = min(counts[b], T);
  const float px = static_cast<float>(p % W);
  const float py = static_cast<float>(p / W);
  const float4* cb = coef + static_cast<size_t>(b) * T * 3;

  float best = 0.0f;
  int best_t = -1;
  for (int t0 = 0; t0 < n; t0 += kChunk) {
    const int m = min(kChunk, n - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < m * 3; i += kThreads) tri[i] = cb[static_cast<size_t>(t0) * 3 + i];
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float4 a = tri[3 * j];      // l0.c0 l0.c1 l0.c2 l1.c0
      const float4 c = tri[3 * j + 1];  // l1.c1 l1.c2 l2.c0 l2.c1
      const float4 d = tri[3 * j + 2];  // l2.c2 iz.c0 iz.c1 iz.c2
      const float l0 = plane(a.x, a.y, a.z, px, py);
      const float l1 = plane(a.w, c.x, c.y, px, py);
      const float l2 = plane(c.z, c.w, d.x, px, py);
      const float iz = plane(d.y, d.z, d.w, px, py);
      if (fminf(l0, fminf(l1, l2)) >= 0.0f && iz > 1e-12f && iz > best) {
        best = iz;
        best_t = t0 + j;
      }
    }
  }
  if (p < P) {
    const size_t o = static_cast<size_t>(b) * P + p;
    zbuf[o] = best_t >= 0 ? 1.0f / fmaxf(best, 1e-12f) : 0.0f;
    tid[o] = best_t;
  }
}

}  // namespace

// Launches on @stream and returns cudaGetLastError() (0 = launched).
extern "C" int raster_zbuffer(const void* coef, const void* counts, void* zbuf, void* tid,
                              int B, int T, int H, int W, void* stream) {
  const int P = H * W;
  if (B <= 0 || P <= 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, B);
  raster_zbuffer_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(coef), static_cast<const int*>(counts),
      static_cast<float*>(zbuf), static_cast<int*>(tid), T, H, W);
  return static_cast<int>(cudaGetLastError());
}
