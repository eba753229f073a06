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
// Design: screen-tile binning inside the block, one launch, no global lists
// and no atomics.  One block per (pose, 16x16 pixel tile), one thread per
// pixel; each warp holds an 8x4 region of the tile.  Pixels past the crop's
// ragged edge take part in the scan and write nothing.  The block walks the
// pose's candidates in chunks of 256, one candidate a thread, and rejects
// the triangles that cannot cover any pixel of the tile (the corner test
// below).  The survivors are appended, in ascending candidate order, to a
// list in shared memory with their 48-byte plane rows: a warp ballot,
// __popc, and a prefix over the block's 8 warps.  When the list could
// overflow at the next chunk, or the candidates run out, each warp filters
// the list by the same corner test on its own 8x4 region (one entry a lane,
// a ballot), and its threads test their pixels against the entries that
// pass, lowest index first; then the scan resumes with an empty list.
// Nothing is capped or dropped, so the result is exact for any triangle
// count, and every pixel sees its candidates in ascending order.
//
// The corner test, for a tile or a warp's region (a "tile" below).
// plane() rounds each product and sum to nearest, so for a pixel p of the
// tile |fl(l(p)) - l(p)| <= gamma_3 (|c0| px + |c1| py) + u |c2| <= delta,
// with u = 2^-24, delta = 4u (|c0| x1 + |c1| y1 + |c2|) + FLT_MIN (x1, y1:
// the tile's last column and row inside the crop, so 0 <= px <= x1 and
// 0 <= py <= y1; FLT_MIN covers underflow).  A pixel that
// passes the per-pixel test has fl(l_i(p)) >= 0, so its exact l_i(p) >=
// -delta_i for i = 0, 1, 2.  The test rejects a triangle when, for some i,
// fl(l_i) < -2 delta_i at all four corner pixels of the tile; then the exact
// l_i < -delta_i at every corner, and since l_i is affine its maximum over
// the tile's rectangle is at a corner, so l_i < -delta_i at every pixel of
// the tile: no pixel of the tile can pass, and dropping the triangle
// changes neither zbuf nor tid.  delta is itself computed with
// round-to-nearest operations (relative error ~3u, far inside the margin
// between 4u and gamma_3); an inf or NaN coefficient gives a comparison
// that is false, so such a triangle is kept.  The test needs no vertices,
// so hand-built coefficients work as before.
//
// Numerics: plane evaluation is fp32 with explicit round-to-nearest
// multiplies and adds (__fmul_rn / __fadd_rn, never fused into an FMA), so
// the kernel computes exactly what the plain PyTorch version in
// kernels/raster.py computes: depth bit-equal and tid equal on every pixel.
// No tensor cores: thin triangles carry 1/area-sized coefficients, and
// reduced-precision (TF32) plane error reaches O(1) barycentric units.
//
// Bound on this card: the work these inputs need is 16 fp32 operations per
// (pixel, triangle) pair whose pixel lies in the triangle's screen bounding
// box, and writing zbuf and tid; at the register shapes the writes bound
// it.  The kernel does more: the corner test, about 70 operations per
// (tile, candidate) and per (region, tile survivor), and the per-pixel test
// against every region survivor.  Each block reads its pose's candidates
// once (from L2 after the first tile of the pose).

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;  // one pixel a thread
constexpr int kWarps = kThreads / 32;
constexpr int kRegionW = 8, kRegionH = 4;  // a warp's pixels: 2 x 4 regions a tile
constexpr int kList = 2 * kThreads;      // list capacity: 512 * 48 B = 24 KB
constexpr float kRound = 4.0f * FLT_EPSILON / 2.0f;  // 4 u, u = 2^-24

__device__ __forceinline__ float plane(float c0, float c1, float c2, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c0, px), __fmul_rn(c1, py)), c2);
}

// True when the plane is below -2 delta at all four corners of the tile
// [x0, x1] x [y0, y1] (see the corner test above).  The rounded plane is
// monotone in px and in py (fl(c0 * px) moves with px as c0's sign says,
// and a rounded sum never decreases when a term grows), so the largest of
// the four corner values is at the corner that c0's and c1's signs pick;
// testing that corner alone gives the same answer as testing all four.
__device__ __forceinline__ bool below_tile(float c0, float c1, float c2, float x0, float x1,
                                           float y0, float y1) {
  const float delta = __fadd_rn(
      __fmul_rn(kRound, plane(fabsf(c0), fabsf(c1), fabsf(c2), x1, y1)), FLT_MIN);
  return plane(c0, c1, c2, c0 >= 0.0f ? x1 : x0, c1 >= 0.0f ? y1 : y0) < -2.0f * delta;
}

__global__ void __launch_bounds__(kThreads)
raster_zbuffer_kernel(const float4* __restrict__ coef, const int* __restrict__ counts,
                      float* __restrict__ zbuf, int* __restrict__ tid, int T, int H, int W,
                      int tiles_x) {
  __shared__ float4 list[kList * 3];
  __shared__ int list_id[kList];
  __shared__ int warp_n[kWarps];
  const int b = blockIdx.y;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const float x0 = static_cast<float>(tx0), y0 = static_cast<float>(ty0);
  const float x1 = static_cast<float>(min(tx0 + kTile, W) - 1);
  const float y1 = static_cast<float>(min(ty0 + kTile, H) - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ix0 = tx0 + (warp % 2) * kRegionW, iy0 = ty0 + (warp / 2) * kRegionH;
  const bool region_in_crop = ix0 < W && iy0 < H;
  const float rx0 = static_cast<float>(ix0), ry0 = static_cast<float>(iy0);
  const float rx1 = static_cast<float>(min(ix0 + kRegionW, W) - 1);
  const float ry1 = static_cast<float>(min(iy0 + kRegionH, H) - 1);
  const int ix = ix0 + lane % kRegionW, iy = iy0 + lane / kRegionW;
  const float px = static_cast<float>(ix), py = static_cast<float>(iy);
  const int n = min(counts[b], T);
  const float4* cb = coef + static_cast<size_t>(b) * T * 3;

  float best = 0.0f;
  int best_t = -1;
  int m = 0;  // entries in the list; the same value in every thread
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    // scan: one candidate a thread, kept if it may cover a pixel of the tile
    const int t = t0 + threadIdx.x;
    float4 a = {}, c = {}, d = {};
    bool keep = false;
    if (t < n) {
      a = cb[static_cast<size_t>(t) * 3];      // l0.c0 l0.c1 l0.c2 l1.c0
      c = cb[static_cast<size_t>(t) * 3 + 1];  // l1.c1 l1.c2 l2.c0 l2.c1
      d = cb[static_cast<size_t>(t) * 3 + 2];  // l2.c2 iz.c0 iz.c1 iz.c2
      keep = !(below_tile(a.x, a.y, a.z, x0, x1, y0, y1) ||
               below_tile(a.w, c.x, c.y, x0, x1, y0, y1) ||
               below_tile(c.z, c.w, d.x, x0, x1, y0, y1));
    }
    // append the survivors in ascending candidate order
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int k = warp_n[w];
      before += w < warp ? k : 0;
      total += k;
    }
    if (keep) {
      const int slot = m + before + __popc(ballot & ((1u << lane) - 1u));
      list[slot * 3] = a;
      list[slot * 3 + 1] = c;
      list[slot * 3 + 2] = d;
      list_id[slot] = t;
    }
    m += total;
    // rasterize the list when the next chunk could overflow it, or at the end
    if (m > kList - kThreads || t0 + kThreads >= n) {
      __syncthreads();
      // each warp: the entries that may cover its region, 32 at a time
      for (int j0 = 0; region_in_crop && j0 < m; j0 += 32) {
        const int j = j0 + lane;
        bool mine = false;
        if (j < m) {
          const float4 la = list[3 * j], lc = list[3 * j + 1], ld = list[3 * j + 2];
          mine = !(below_tile(la.x, la.y, la.z, rx0, rx1, ry0, ry1) ||
                   below_tile(la.w, lc.x, lc.y, rx0, rx1, ry0, ry1) ||
                   below_tile(lc.z, lc.w, ld.x, rx0, rx1, ry0, ry1));
        }
        for (unsigned bits = __ballot_sync(0xffffffffu, mine); bits; bits &= bits - 1) {
          const int k = j0 + __ffs(bits) - 1;  // ascending: the lowest index first
          const float4 la = list[3 * k], lc = list[3 * k + 1], ld = list[3 * k + 2];
          const float l0 = plane(la.x, la.y, la.z, px, py);
          const float l1 = plane(la.w, lc.x, lc.y, px, py);
          const float l2 = plane(lc.z, lc.w, ld.x, px, py);
          const float iz = plane(ld.y, ld.z, ld.w, px, py);
          if (fminf(l0, fminf(l1, l2)) >= 0.0f && iz > 1e-12f && iz > best) {
            best = iz;
            best_t = list_id[k];
          }
        }
      }
      m = 0;
    }
    __syncthreads();  // warp_n and the list are rewritten by the next chunk
  }
  if (ix < W && iy < H) {
    const size_t o = static_cast<size_t>(b) * H * W + static_cast<size_t>(iy) * W + ix;
    zbuf[o] = best_t >= 0 ? 1.0f / fmaxf(best, 1e-12f) : 0.0f;
    tid[o] = best_t;
  }
}

}  // namespace

// Launches on @stream and returns cudaGetLastError() (0 = launched).
extern "C" int raster_zbuffer(const void* coef, const void* counts, void* zbuf, void* tid,
                              int B, int T, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, B);
  raster_zbuffer_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(coef), static_cast<const int*>(counts),
      static_cast<float*>(zbuf), static_cast<int*>(tid), T, H, W, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
