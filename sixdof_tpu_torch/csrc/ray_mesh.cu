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
// tris (T, 9) float32 rows [v0 | e1 | e2]; t_out (N,) float32, written for
// every ray (+inf included).
//
// Design: triangle culling inside the block, one launch, no global lists,
// no atomics.  A block of 256 threads owns R = 256 / P consecutive rays, P
// threads a ray (P = 1 for a full frame; up to 32 for a few hundred rays,
// so that the card still gets a few hundred blocks; the wrapper picks P).
// The block reduces its valid rays to a box of directions and checks,
// bitwise, whether they share one origin.  It then scans the triangles in
// chunks of 256, one a thread, and drops each triangle that the test below
// proves no ray of the block can hit.  The survivors go, in ascending order,
// to a list in shared memory (a warp ballot, __popc, and a prefix over the
// 8 warps), each with the terms of the pair test that depend on the origin
// only (s, q, T below), computed once.  When the list could overflow at the
// next chunk, or the triangles run out, every thread tests its ray against
// every P-th entry of the list, and the list is emptied.  At the end the P
// threads of a ray fold their minima with shuffles and one of them writes t.
// Nothing is capped, so the result is exact for any triangle count.  A
// block whose valid rays do not share one origin, or whose directions leave
// the window below, keeps every triangle and computes s, q, T per ray: the
// same kernel on a shorter path.
//
// The box.  [lo, hi] bounds the valid directions componentwise.  When one
// axis k keeps a strict sign sk over the block and its least |d_k| is at
// least 2^-20 of the largest component, the box is taken over d / |d_k|
// instead (rounded; component k is sk exactly): for camera rays the image
// points, whose box is a row strip, far tighter than the unit directions'.
// Every test below is homogeneous in d, so a positive multiple of each ray
// serves; the division's rounding (one ulp a component) is in the margin.
// dmax_i = max(|lo_i|, |hi_i|).
//
// The cull test, for a block with common origin o and a triangle.  Write
// s = o - v0, q = s x e1 and T = q.e2 rounded exactly as the pair test
// rounds them (the very values every ray of the block computes), and for a
// direction d the real linear functions
//   U(d) = s.(d x e2) = d.a, a = e2 x s;   D(d) = e1.(d x e2) = d.n,
//   n = e2 x e1;   V(d) = q.d.
// The pair test computes U_c, D_c, V_c with |U_c - U| <= 5u d.X(e2, s),
// |D_c - D| <= 5u d.X(e2, e1), |V_c - V| <= 3u d.|q| for |d| taken
// componentwise (u = 2^-24; X(a, b)_i = |a_j b_k| + |a_k b_j|; the bounds of
// two roundings in a cross term and three in a dot product).
//  (t) A hit needs fl(T * inv_det) > 1e-6 > 0, so T != 0 and
//      sign(D_c) = sign(T) =: sg, one sign for the whole block.  T = 0 or
//      NaN: no ray of the block can hit; the triangle is dropped.
//  (u) u_c = fl(U_c fl(1/D_c)) >= -1e-6 gives U_c / D_c >= -1e-6 (1 + 3u)
//      >= -eps with eps = 2^-19; times |D_c|: sg (U_c + eps D_c) >= 0.
//  (v) Likewise sg (V_c + eps D_c) >= 0.
//  (w) fl(u_c + v_c) <= fl(1 + 1e-6) = 1 + 2^-20 with u_c, v_c >= -1e-6
//      gives u_c, v_c <= 1.1 and then (U_c + V_c) / D_c <= 1 + 2^-20 + 9u
//      <= 1 + eps: sg ((1 + eps) D_c - U_c - V_c) >= 0.
// So a hit needs sg h_j,c(d) >= 0 for the three edge functions
//   h_0 = U + eps D,  h_1 = V + eps D,  h_2 = (1 + eps) D - U - V,
// whose exact parts are d.N_j with N_0 = a + eps n, N_1 = q + eps n,
// N_2 = (n + eps n) - a - q, and so sum_j mu_j sg h_j,c(d) >= 0 for any
// mu_j >= 0.  A plane test takes such a combination M = sum_j mu_j sg N_j,
// W_M = sum_j mu_j W_j (W_0 = X(e2, s) + eps X(e2, e1), W_1 = |q| +
// eps X(e2, e1), W_2 = X(e2, e1) (1 + eps) + X(e2, s) + |q|), the largest
// value of M.d over the box, H = sum_i max(M_i lo_i, M_i hi_i), and drops
// the triangle when
//   H < -(kappa W_M.dmax + mu),  kappa = 2^-19 = 32u,  mu = 2^-80.
// For every ray of the block, sum_j mu_j sg h_j,c(d) <= H + 17u W_M.dmax +
// mu/2: the pair test's rounding (5u), the box's division (1u), the
// rounding of N_j (5u) and of the combination (3u), and of H (3u); so no
// ray can hit.  kappa is 1.9x the 17u the proof needs, with W_M.dmax
// computed to within 3u.  The combinations tried: each edge alone (mu = e_j:
// the block lies outside one edge's plane), and, with a scaled box, each of
// the box's four side planes moved halfway to the triangle's projection
// (mu_j from the plane's values at the vertices, normalised to at most 1;
// any mu >= 0 is sound, so their rounding needs no bound): the
// separating-axis test of the box against the triangle's image.
// The proof assumes every component of s, e1, e2 and of the valid
// directions is 0 or has a magnitude in [2^-60, 2^40): no product
// overflows, 1/det is a normal number, no product of two inputs
// underflows, and the underflow of later products (each at most 2^-150,
// multiplied by at most 2^60 afterwards) stays under mu/2.  A triangle
// outside that window is kept (a NaN makes T NaN: dropped by (t)), and a
// block with a direction outside it keeps every triangle.  Every operation
// is written with __fmul_rn / __fadd_rn / __fsub_rn / __frcp_rn (no FMA),
// so the test decides exactly as its emulation in kernels/raytrace.py
// (`cull_keep`), which tests/test_torch_ray_binning.py holds against the
// brute force.
//
// Arithmetic of the pair test: every product, sum and difference is written
// with __fmul_rn / __fadd_rn / __fsub_rn in the order the plain PyTorch
// version in kernels/raytrace.py uses, and 1/det is IEEE division
// (__fdiv_rn), so kernel and plain version agree bit for bit, and a ray on a
// shared edge (u + v = 1 within 1e-6) hits or misses in both alike.
//
// Bound on this card: bytes (each ray read once, t written once) unless
// rays meet many triangles: the work these inputs need is 46 fp32
// operations per (ray, triangle) pair whose direction lies inside the
// triangle's enlarged cone, and a full frame has few.  The kernel does more:
// the cull test, about 150 operations per (block, triangle) and some 250
// more where the edges keep it and the side planes are tried, and the pair
// test against every survivor of the block.

#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kList = 512;             // survivors: 512 * 52 B = 26 KB
constexpr int kEntry = 13;             // a survivor: e1 | e2 | s | q | T
constexpr float kEps = 0x1p-19f;       // barycentric slack with its rounding
constexpr float kKappa = 0x1p-19f;     // 32 u: rounding margin of the cull test
constexpr float kMu = 0x1p-80f;        // underflow margin
constexpr float kRange = 0x1p40f;      // |x| of a non-zero input: below kRange ...
constexpr float kTiny = 0x1p-60f;      // ... and at least kTiny
constexpr float kSpread = 0x1p-20f;    // rescale the box when its axis k holds this share

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));  // a*b - c*d
}

__device__ __forceinline__ float abs_term(float a, float b, float c, float d) {
  return __fadd_rn(fabsf(__fmul_rn(a, b)), fabsf(__fmul_rn(c, d)));  // |a*b| + |c*d|
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}

// zero, or a magnitude in [kTiny, kRange) (false for inf and NaN)
__device__ __forceinline__ bool in_window(float x) {
  const float a = fabsf(x);
  return a < kRange && (a >= kTiny || a == 0.0f);
}

// sum_i max(N_i lo_i, N_i hi_i): the largest N.d over the box [lo, hi]
__device__ __forceinline__ float box_max(float nx, float ny, float nz, const float* lo,
                                         const float* hi) {
  return __fadd_rn(__fadd_rn(fmaxf(__fmul_rn(nx, lo[0]), __fmul_rn(nx, hi[0])),
                             fmaxf(__fmul_rn(ny, lo[1]), __fmul_rn(ny, hi[1]))),
                   fmaxf(__fmul_rn(nz, lo[2]), __fmul_rn(nz, hi[2])));
}

// The block's rays as the cull test sees them: the box [lo, hi] holds a
// positive multiple of every valid direction; dmax_i = max(|lo_i|, |hi_i|).
// When scaled, component k of every point of the box is sk (= +-1).
struct Box {
  float lo[3], hi[3], dmax[3];
  float sk;
  int k;
  bool scaled;
};

// True when sg N.d < -(kappa W.dmax + mu) over the whole box
__device__ __forceinline__ bool plane_drops(const float* N, const float* W, const Box& b) {
  const float m = dot3(W[0], W[1], W[2], b.dmax[0], b.dmax[1], b.dmax[2]);
  return box_max(N[0], N[1], N[2], b.lo, b.hi) < -__fadd_rn(__fmul_rn(kKappa, m), kMu);
}

// True when one of the box's four side planes, moved halfway to the
// triangle's projection and written as a non-negative combination of the
// edge functions (normals N, bounds W), proves that no ray of the block can
// hit the triangle (a scaled box only; the cull test above).
__device__ __forceinline__ bool side_planes_drop(const float* s, const float* e1,
                                                 const float* e2, float (*N)[3],
                                                 float (*W)[3], const Box& b) {
  float V[3][3], f[3];  // vertices from the origin; f: their component along sk e_k
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    V[0][i] = -s[i];
    V[1][i] = __fsub_rn(e1[i], s[i]);
    V[2][i] = __fsub_rn(e2[i], s[i]);
  }
  float rf[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    f[j] = __fmul_rn(b.sk, b.k == 0 ? V[j][0] : (b.k == 1 ? V[j][1] : V[j][2]));
    if (!(f[j] > 0.0f)) return false;  // a vertex not in front along e_k
    rf[j] = __frcp_rn(f[j]);
  }
  // edge function j is zero at two vertices; off[j] is the third
  const int off[3] = {1, 2, 0};
  float rden[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* v = V[off[j]];
    rden[j] = __frcp_rn(dot3(N[j][0], N[j][1], N[j][2], v[0], v[1], v[2]));
  }
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i == b.k) continue;
    float pmin = inf, pmax = -inf;  // the triangle's projection on axis i
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float p = __fmul_rn(V[j][i], rf[j]);
      pmin = fminf(pmin, p);
      pmax = fmaxf(pmax, p);
    }
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      // side 0: the triangle beyond hi_i, M = e_i - c sk e_k; side 1: below
      // lo_i, M = -(e_i - c sk e_k); c halfway between box and triangle
      const bool up = side == 0;
      if (up ? !(pmin > b.hi[i]) : !(pmax < b.lo[i])) continue;
      const float c = __fmul_rn(0.5f, up ? __fadd_rn(b.hi[i], pmin) : __fadd_rn(b.lo[i], pmax));
      const float sgn = up ? 1.0f : -1.0f;
      float mu[3], top = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int v = off[j];
        mu[j] = __fmul_rn(__fmul_rn(sgn, __fsub_rn(V[v][i], __fmul_rn(c, f[v]))), rden[j]);
        top = fmaxf(top, mu[j]);
      }
      if (!(mu[0] >= 0.0f && mu[1] >= 0.0f && mu[2] >= 0.0f && top > 0.0f && top < inf))
        continue;
      float M[3], WM[3];
      const float rtop = __frcp_rn(top);
#pragma unroll
      for (int j = 0; j < 3; ++j) mu[j] = __fmul_rn(mu[j], rtop);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        M[a] = __fadd_rn(__fadd_rn(__fmul_rn(mu[0], N[0][a]), __fmul_rn(mu[1], N[1][a])),
                         __fmul_rn(mu[2], N[2][a]));
        WM[a] = __fadd_rn(__fadd_rn(__fmul_rn(mu[0], W[0][a]), __fmul_rn(mu[1], W[1][a])),
                          __fmul_rn(mu[2], W[2][a]));
      }
      if (plane_drops(M, WM, b)) return true;
    }
  }
  return false;
}

// s = o - v0, q = s x e1 and T = q.e2 of the triangle g = [v0 | e1 | e2],
// rounded as the pair test rounds them: @sqT = [s | q | T]
__device__ __forceinline__ void origin_terms(float ox, float oy, float oz, const float* g,
                                             float* sqT) {
  const float* e1 = g + 3;
  sqT[0] = __fsub_rn(ox, g[0]);
  sqT[1] = __fsub_rn(oy, g[1]);
  sqT[2] = __fsub_rn(oz, g[2]);
  sqT[3] = cross_term(sqT[1], e1[2], sqT[2], e1[1]);
  sqT[4] = cross_term(sqT[2], e1[0], sqT[0], e1[2]);
  sqT[5] = cross_term(sqT[0], e1[1], sqT[1], e1[0]);
  sqT[6] = dot3(sqT[3], sqT[4], sqT[5], g[6], g[7], g[8]);
}

// False when no ray of the block (common origin o) can hit the triangle
// g = [v0 | e1 | e2] (the cull test above); @sqT from origin_terms.
__device__ __forceinline__ bool may_hit(const float* g, const float* sqT, const Box& b) {
  const float* s = sqT;
  const float* q = sqT + 3;
  const float T = sqT[6];
  const float* e1 = g + 3;
  const float* e2 = g + 6;
  if (!(T > 0.0f || T < 0.0f)) return false;  // t = 0 or NaN: never > 1e-6
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (!(in_window(s[i]) && in_window(e1[i]) && in_window(e2[i]))) return true;
  const float sg = T > 0.0f ? 1.0f : -1.0f;
  // the edge functions' normals sg N_j and their absolute bounds W_j
  float N[3][3], W[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3, k = (i + 2) % 3;
    const float n = cross_term(e2[j], e1[k], e2[k], e1[j]);  // e2 x e1
    const float a = cross_term(e2[j], s[k], e2[k], s[j]);    // e2 x s
    const float wn = abs_term(e2[j], e1[k], e2[k], e1[j]);   // X(e2, e1)
    const float wa = abs_term(e2[j], s[k], e2[k], s[j]);     // X(e2, s)
    const float en = __fmul_rn(kEps, n), ewn = __fmul_rn(kEps, wn);
    N[0][i] = __fmul_rn(sg, __fadd_rn(a, en));
    W[0][i] = __fadd_rn(wa, ewn);
    N[1][i] = __fmul_rn(sg, __fadd_rn(q[i], en));
    W[1][i] = __fadd_rn(fabsf(q[i]), ewn);
    N[2][i] = __fmul_rn(sg, __fsub_rn(__fsub_rn(__fadd_rn(n, en), a), q[i]));
    W[2][i] = __fadd_rn(__fadd_rn(__fadd_rn(wn, ewn), wa), fabsf(q[i]));
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (plane_drops(N[j], W[j], b)) return false;
  if (b.scaled && side_planes_drop(s, e1, e2, N, W, b)) return false;
  return true;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// [lo, hi] of the block's valid directions @d (NaN components pass, as in
// fminf / fmaxf); @red: a shared buffer of its own for each call
__device__ __forceinline__ void block_box(const float* d, bool live, int lane, int warp,
                                          float (*red)[6], float* lo, float* hi) {
  const float inf = __int_as_float(0x7f800000);
  for (int i = 0; i < 3; ++i) {
    const float a = warp_min(live ? d[i] : inf), c = warp_max(live ? d[i] : -inf);
    if (lane == 0) {
      red[warp][i] = a;
      red[warp][3 + i] = c;
    }
  }
  __syncthreads();
  for (int i = 0; i < 3; ++i) {
    lo[i] = red[0][i];
    hi[i] = red[0][3 + i];
    for (int w = 1; w < kWarps; ++w) {
      lo[i] = fminf(lo[i], red[w][i]);
      hi[i] = fmaxf(hi[i], red[w][3 + i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ray_mesh_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                const unsigned char* __restrict__ valid, const float* __restrict__ tris,
                float* __restrict__ t_out, int N, int T, int log2_p) {
  __shared__ float list[kList * kEntry];
  __shared__ float red_f[2][kWarps][6];
  __shared__ unsigned red_o[kWarps][6];
  __shared__ int warp_n[kWarps];
  const int P = 1 << log2_p;
  const int sub = threadIdx.x & (P - 1);
  const int r = blockIdx.x * (kThreads >> log2_p) + (threadIdx.x >> log2_p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = r < N && valid[r] != 0;
  const float inf = __int_as_float(0x7f800000);
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, o_common[3];
  if (live) {
    for (int i = 0; i < 3; ++i) {
      o[i] = origins[3 * r + i];
      d[i] = dirs[3 * r + i];
    }
  }

  // the block's direction box and origin bits, over its valid rays
  Box b;
  bool common = true;
  block_box(d, live, lane, warp, red_f[0], b.lo, b.hi);
  {
    unsigned omin[3], omax[3];
    for (int i = 0; i < 3; ++i) {
      const unsigned bits = __float_as_uint(o[i]);
      const unsigned c = __reduce_min_sync(0xffffffffu, live ? bits : 0xffffffffu);
      const unsigned e = __reduce_max_sync(0xffffffffu, live ? bits : 0u);
      if (lane == 0) {
        red_o[warp][i] = c;
        red_o[warp][3 + i] = e;
      }
    }
    __syncthreads();
    for (int i = 0; i < 3; ++i) {
      omin[i] = red_o[0][i];
      omax[i] = red_o[0][3 + i];
      for (int w = 1; w < kWarps; ++w) {
        omin[i] = min(omin[i], red_o[w][i]);
        omax[i] = max(omax[i], red_o[w][3 + i]);
      }
      common = common && omin[i] == omax[i];
    }
    o_common[0] = __uint_as_float(omin[0]);
    o_common[1] = __uint_as_float(omin[1]);
    o_common[2] = __uint_as_float(omin[2]);
  }
  if (!(b.lo[0] <= b.hi[0])) {  // no valid ray with a number for a direction: no hits
    if (sub == 0 && r < N) t_out[r] = inf;
    return;
  }
  // directions outside the window the proof covers: no cull
  const bool window = in_window(d[0]) && in_window(d[1]) && in_window(d[2]);
  common = __syncthreads_and(!live || window) && common;
  // the box of a positive multiple of each direction, d / |d_k|, when one
  // axis k keeps one strict sign over the block and holds at least kSpread
  // of the largest component: for camera rays d / d_z, the rays' image
  // points, a far tighter box than the unit directions'
  b.k = 0;
  float gk = 0.0f;  // the least |d_k| over the block
  for (int i = 0; i < 3; ++i) {
    const float c = b.lo[i] > 0.0f ? b.lo[i] : (b.hi[i] < 0.0f ? -b.hi[i] : 0.0f);
    if (c > gk) {
      gk = c;
      b.k = i;
    }
  }
  b.sk = (b.k == 0 ? b.lo[0] : (b.k == 1 ? b.lo[1] : b.lo[2])) > 0.0f ? 1.0f : -1.0f;
  const float top = max3(fmaxf(fabsf(b.lo[0]), fabsf(b.hi[0])),
                         fmaxf(fabsf(b.lo[1]), fabsf(b.hi[1])),
                         fmaxf(fabsf(b.lo[2]), fabsf(b.hi[2])));
  b.scaled = gk > 0.0f && gk >= __fmul_rn(kSpread, top);
  if (b.scaled) {
    float dd[3];
    const float dk = fabsf(b.k == 0 ? d[0] : (b.k == 1 ? d[1] : d[2]));
    for (int i = 0; i < 3; ++i) dd[i] = __fdiv_rn(d[i], dk);
    block_box(dd, live, lane, warp, red_f[1], b.lo, b.hi);
  }
  for (int i = 0; i < 3; ++i) b.dmax[i] = fmaxf(fabsf(b.lo[i]), fabsf(b.hi[i]));
  const float cx = o_common[0], cy = o_common[1], cz = o_common[2];

  float best = inf;
  int m = 0;  // entries in the list; the same value in every thread
  for (int t0 = 0; t0 < T; t0 += kThreads) {
    // scan: one triangle a thread, kept if a ray of the block may hit it
    const int t = t0 + threadIdx.x;
    float g[9], sqT[7];
    bool keep = false;
    if (t < T) {
#pragma unroll
      for (int i = 0; i < 9; ++i) g[i] = tris[static_cast<size_t>(t) * 9 + i];
      keep = true;
      if (common) {
        origin_terms(cx, cy, cz, g, sqT);
        keep = may_hit(g, sqT, b);
      }
    }
    // append the survivors in ascending triangle order: e1 | e2 | s | q | T
    // (with a common origin s, q and T are every ray's own; without one the
    // entry holds v0 in place of s and the pair test computes the rest)
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
      float* e = list + kEntry * (m + before + __popc(ballot & ((1u << lane) - 1u)));
#pragma unroll
      for (int i = 0; i < 6; ++i) e[i] = g[3 + i];
#pragma unroll
      for (int i = 0; i < 7; ++i) e[6 + i] = common ? sqT[i] : (i < 3 ? g[i] : 0.0f);
    }
    m += total;
    // test the list when the next chunk could overflow it, or at the end
    if (m > kList - kThreads || t0 + kThreads >= T) {
      __syncthreads();
      for (int j = sub; live && j < m; j += P) {
        const float* e = list + kEntry * j;
        const float e1x = e[0], e1y = e[1], e1z = e[2];
        const float e2x = e[3], e2y = e[4], e2z = e[5];
        const float px = cross_term(d[1], e2z, d[2], e2y);
        const float py = cross_term(d[2], e2x, d[0], e2z);
        const float pz = cross_term(d[0], e2y, d[1], e2x);
        const float det = dot3(px, py, pz, e1x, e1y, e1z);
        const bool ok = fabsf(det) > 1e-12f;
        const float inv_det = ok ? __fdiv_rn(1.0f, det) : 0.0f;
        float sx = e[6], sy = e[7], sz = e[8], qx = e[9], qy = e[10], qz = e[11], tq = e[12];
        if (!common) {
          sx = __fsub_rn(o[0], sx);  // the entry holds v0
          sy = __fsub_rn(o[1], sy);
          sz = __fsub_rn(o[2], sz);
          qx = cross_term(sy, e1z, sz, e1y);
          qy = cross_term(sz, e1x, sx, e1z);
          qz = cross_term(sx, e1y, sy, e1x);
          tq = dot3(qx, qy, qz, e2x, e2y, e2z);
        }
        const float u = __fmul_rn(dot3(sx, sy, sz, px, py, pz), inv_det);
        const float v = __fmul_rn(dot3(qx, qy, qz, d[0], d[1], d[2]), inv_det);
        const float tt = __fmul_rn(tq, inv_det);
        const bool hit = ok && u >= -1e-6f && v >= -1e-6f && __fadd_rn(u, v) <= 1.000001f &&
                         tt > 1e-6f;
        if (hit && tt < best) best = tt;
      }
      m = 0;
    }
    __syncthreads();  // warp_n and the list are rewritten by the next chunk
  }
  // the P threads of a ray hold its minimum in parts
  for (int o2 = P >> 1; o2; o2 >>= 1) best = fminf(best, __shfl_xor_sync(0xffffffffu, best, o2));
  if (sub == 0 && r < N) t_out[r] = live ? best : inf;
}

}  // namespace

// Launches on @stream and returns cudaGetLastError() (0 = launched).
// @log2_p: log2 of the threads a ray (0..5).  Ray offsets (3 r + i) and the
// triangle walk (t0 + 256) are int: N <= (2^31 - 1) / 3 and T <= 2^31 - 257,
// which the wrapper (kernels/raytrace.py) enforces.  The survivor list never
// overflows: it is tested whenever it holds more than kList - kThreads.
extern "C" int ray_mesh_intersect(const void* origins, const void* dirs, const void* valid,
                                  const void* tris, void* t_out, int N, int T, int log2_p,
                                  void* stream) {
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  if (log2_p < 0 || log2_p > 5 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rays_per_block = kThreads >> log2_p;
  const int blocks = (N + rays_per_block - 1) / rays_per_block;
  ray_mesh_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origins), static_cast<const float*>(dirs),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(tris),
      static_cast<float*>(t_out), N, T, log2_p);
  return static_cast<int>(cudaGetLastError());
}
