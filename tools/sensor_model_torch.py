"""RGB-D sensor degradation model for the evaluation scenes, without OpenCV.

The port's copy of `tools/sensor_model.py`: the same functions, signatures
and numpy draws in the same order, so a seeded `RandomState` degrades a
frame the same way.  Each OpenCV call there is a numpy routine here that
reproduces OpenCV's float32 arithmetic on an x86-64 CPU with AVX2 and
FMA, where OpenCV's filters take their 8-lane AVX2 paths:

- `gaussian_blur` = `cv2.GaussianBlur(img, (0, 0), sigma)` on float32:
  OpenCV's kernel size and bit-exact kernel, the separable row then
  column pass with BORDER_REFLECT_101, and the order and fused
  multiply-adds of OpenCV's vector loops and scalar tails for 3-, 5- and
  7-or-more-tap kernels (bit-equal on rows of a multiple of 8 floats, as
  every generated frame's; in the scalar tail of other rows about one
  pixel in 10^4 ends 1 ulp apart);
- `dilate` / `erode` = `cv2.dilate` / `cv2.erode` by a full square kernel
  (OpenCV's default border never wins), uint8 or float32, `iterations`
  as OpenCV folds them into one larger square;
- `fill_circle` = `cv2.circle(img, center, radius, color, -1)`: OpenCV's
  integer midpoint `Circle` rasteriser for filled LINE_8 circles;
- `filter2d` = `cv2.filter2D(img, -1, kernel)` on float32: correlation
  about the kernel's centre over its non-zero taps with
  BORDER_REFLECT_101.  OpenCV takes a DFT for kernels of 130 taps or
  more (13x13 and up); there the direct sum here lands within 2 ulp of it.

Host-side fixture code, as in the JAX package: it runs once a frame when
`tools/make_demo_scene_torch.py` writes a scene, not in the pipeline.
The draw-order and artifact notes of `tools/sensor_model.py` hold here.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

SIMD_LANES = 8  # float32 lanes of OpenCV's AVX2 filter loops


def _fma(a, b, c):
    """float32 fused multiply-add (the product and sum exact in float64)."""
    return (a.astype(np.float64) * np.float64(b) + c).astype(np.float32)


def _reflect101(img, r, axis):
    n = img.shape[axis]
    idx = np.abs(np.arange(-r, n + r))
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    return np.take(img, idx, axis=axis)


def gaussian_kernel(sigma):
    """OpenCV's float32 Gaussian for float images: n = round(8 sigma + 1) | 1
    taps, the bit-exact (getGaussianKernelBitExact) weights cast to float32."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    h = (n - 1) // 2
    x = np.arange(1 - n, 1 - n + 2 * h, 2, dtype=np.float64)
    vals = np.exp((x * x) * (-0.125 / (float(sigma) * float(sigma))))
    total = 0.0
    for v in vals:
        total += v
    mul = 1.0 / (total * 2.0 + 1.0)
    k = np.empty(n)
    k[:h] = vals * mul
    k[h + 1:] = k[:h][::-1]
    k[h] = mul
    return k.astype(np.float32)


def _lanes(width, unroll):
    """Per-column regions of one of OpenCV's loops over @width floats:
    0 vector, 1 the unrolled scalar tail (@unroll at a time), 2 singles."""
    nv = width // SIMD_LANES * SIMD_LANES
    nu = nv + (width - nv) // unroll * unroll
    i = np.arange(width)
    return np.where(i < nv, 0, np.where(i < nu, 1, 2))


def _row_pass(p, k, width, cn):
    """The row filter on the reflect-padded rows @p (flattened channels)."""
    n, r = len(k), len(k) // 2

    def tap(j):
        return p[:, (r + j) * cn:(r + j) * cn + width]

    def pair(j):
        return (tap(-j) + tap(j)).astype(np.float32)

    if n >= 7:  # RowVec_32f: fused chain from the first tap, scalar tail unfused
        fused = np.zeros((p.shape[0], width), np.float32)
        for j in range(n):
            fused = _fma(tap(j - r), k[j], fused)
        plain = (tap(-r) * k[0]).astype(np.float32)
        for j in range(1, n):
            plain = (plain + tap(j - r) * k[j]).astype(np.float32)
        region = _lanes(width, 4)
        return np.where(region < 2, fused, plain)
    # SymmRowSmallVec_32f: the first pair's product, the centre, the next pair
    fused = (pair(1) * k[r + 1]).astype(np.float32)
    fused = _fma(tap(0), k[r], fused)
    for j in range(2, r + 1):
        fused = _fma(pair(j), k[r + j], fused)
    if n == 3:
        single = _fma(pair(1), k[r + 1], (tap(0) * k[r]).astype(np.float32))
    else:
        single = (tap(0) * k[r]).astype(np.float32)
        for j in range(1, r + 1):
            single = (single + pair(j) * k[r + j]).astype(np.float32)
    region = _lanes(width, 2)
    return np.where(region < 2, fused, single)


def _column_pass(q, k, height):
    """The symmetric column filter on the reflect-padded rows @q."""
    r = len(k) // 2

    def pair(j):
        return (q[r - j:r - j + height] + q[r + j:r + j + height]).astype(np.float32)

    fused = (q[r:r + height] * k[r]).astype(np.float32)
    for j in range(1, r + 1):
        fused = _fma(pair(j), k[r + j], fused)
    if len(k) == 3:
        return fused
    plain = (q[r:r + height] * k[r]).astype(np.float32)
    for j in range(1, r + 1):
        plain = (plain + pair(j) * k[r + j]).astype(np.float32)
    return np.where(_lanes(q.shape[1], 4) == 0, fused, plain)


def gaussian_blur(img, sigma):
    """`cv2.GaussianBlur(img, (0, 0), sigma)` of a float32 (H,W) or (H,W,C)
    image (H and W larger than the kernel's radius)."""
    img = np.ascontiguousarray(img, dtype=np.float32)
    k = gaussian_kernel(sigma)
    if len(k) == 1:
        return img.copy()
    r = len(k) // 2
    H, W = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    rows = _row_pass(_reflect101(img, r, 1).reshape(H, -1), k, W * cn, cn)
    return _column_pass(_reflect101(rows, r, 0), k, H).reshape(img.shape)


def filter2d(img, kernel):
    """`cv2.filter2D(img, -1, kernel)` of a float32 (H,W) or (H,W,C) image by
    an odd square float32 kernel, anchored at its centre."""
    img = np.ascontiguousarray(img, dtype=np.float32)
    kernel = np.asarray(kernel, dtype=np.float32)
    n = kernel.shape[0]
    r = n // 2
    H, W = img.shape[:2]
    cn = 1 if img.ndim == 2 else img.shape[2]
    width = W * cn
    p = _reflect101(_reflect101(img, r, 0), r, 1).reshape(H + 2 * r, -1)
    fused = np.zeros((H, width), np.float32)
    plain = None
    for y, x in zip(*np.nonzero(kernel)):  # row-major, as OpenCV collects them
        a = p[y:y + H, x * cn:x * cn + width]
        c = kernel[y, x]
        fused = _fma(a, c, fused)
        plain = (a * c).astype(np.float32) if plain is None \
            else (plain + a * c).astype(np.float32)
    if plain is None:
        return np.zeros_like(img)
    return np.where(_lanes(width, 4) == 0, fused, plain).reshape(img.shape)


def _morph(img, ksize, iterations, op):
    size = ksize + (iterations - 1) * (ksize - 1)  # OpenCV's folded square
    img = np.asarray(img)
    if img.dtype == np.uint8:
        fill = 0 if op is ndimage.maximum_filter else 255
    else:
        fill = -np.inf if op is ndimage.maximum_filter else np.inf
    footprint = (size, size) + (1,) * (img.ndim - 2)
    return op(img, size=footprint, mode="constant", cval=fill)


def dilate(img, ksize=3, iterations=1):
    """`cv2.dilate(img, np.ones((ksize, ksize)), iterations=iterations)`."""
    return _morph(img, ksize, iterations, ndimage.maximum_filter)


def erode(img, ksize=3, iterations=1):
    """`cv2.erode(img, np.ones((ksize, ksize)), iterations=iterations)`."""
    return _morph(img, ksize, iterations, ndimage.minimum_filter)


def fill_circle(img, center, radius, color):
    """`cv2.circle(img, center, radius, color, -1)` in place: OpenCV's
    integer Circle rasteriser (filled, LINE_8, no shift).  @center: (x, y)."""
    H, W = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < W - radius and radius <= cy < H - radius

    def hline(y, x1, x2):
        img[y, x1:x2 + 1] = color

    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            hline(y11, x11, x12)
            hline(y12, x11, x12)
            hline(y21, x21, x22)
            hline(y22, x21, x22)
        elif x11 < W and x12 >= 0 and y21 < H and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, W - 1)
            for y in (y11, y12):
                if 0 <= y < H:
                    hline(y, x11, x12)
            if x21 < W and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, W - 1)
                for y in (y21, y22):
                    if 0 <= y < H:
                        hline(y, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


def degrade_rgb(color01: np.ndarray, rng: np.random.RandomState,
                strength: float = 1.0) -> np.ndarray:
    """Photometric degradation of a float [0,1] HxWx3 image."""
    img = color01.astype(np.float32)
    gain = float(2.0 ** (rng.uniform(-0.35, 0.35) * strength))
    gamma = float(1.0 + rng.uniform(-0.15, 0.20) * strength)
    wb = (1.0 + rng.uniform(-0.08, 0.08, size=3) * strength).astype(np.float32)
    img = np.clip(img * gain * wb[None, None], 0.0, 1.0) ** gamma
    sigma_blur = 0.6 * strength
    if sigma_blur > 1e-3:
        img = gaussian_blur(img, sigma_blur)
    # shot noise scales with sqrt(signal); read noise is additive
    shot = rng.randn(*img.shape).astype(np.float32) * (0.015 * strength) * np.sqrt(
        np.clip(img, 0.01, 1.0))
    read = rng.randn(*img.shape).astype(np.float32) * (0.008 * strength)
    img = np.clip(img + shot + read, 0.0, 1.0)
    # uint8 round trip (the on-disk format)
    return np.round(img * 255.0).astype(np.float32) / 255.0


def degrade_depth(depth_m: np.ndarray, rng: np.random.RandomState,
                  strength: float = 1.0) -> np.ndarray:
    """Depth-sensor degradation of a float meters HxW map (0 = invalid)."""
    d = depth_m.astype(np.float32).copy()
    H, W = d.shape
    valid = d > 0

    # axial noise: sigma(z) = 1.2mm + 1.9mm * (z - 0.4)^2  (Khoshelham-style)
    sigma = (0.0012 + 0.0019 * (d - 0.4) ** 2) * strength
    d = np.where(valid, d + rng.randn(H, W).astype(np.float32) * sigma, 0.0)

    # depth discontinuities: both dropout and flying (mixture) pixels
    big = np.where(valid, d, 1e3)  # invalid = "far": invalid/valid borders count as edges
    gx = np.abs(np.diff(big, axis=1, append=big[:, -1:]))
    gy = np.abs(np.diff(big, axis=0, append=big[-1:, :]))
    edge = np.maximum(gx, gy) > 0.012
    edge = dilate(edge.astype(np.uint8), 3) > 0
    u = rng.rand(H, W)
    drop = edge & valid & (u < 0.40 * strength)
    fly = edge & valid & (u > 1.0 - 0.12 * strength)
    if fly.any():
        dmin = erode(np.where(valid, d, 1e3).astype(np.float32), 5)
        dmax = dilate(np.where(valid, d, 0.0).astype(np.float32), 5)
        alpha = rng.rand(H, W).astype(np.float32)
        dfly = dmin * alpha + dmax * (1.0 - alpha)
        ok = (dfly > 0) & (dfly < 1e3)
        d = np.where(fly & ok, dfly, d)
    d = np.where(drop, 0.0, d)

    # blob holes: specular / IR-absorptive patches
    n_holes = int(rng.poisson(3.0 * strength))
    hole = np.zeros((H, W), np.uint8)
    for _ in range(n_holes):
        cy, cx = int(rng.randint(0, H)), int(rng.randint(0, W))
        r = int(rng.randint(3, 14))
        fill_circle(hole, (cx, cy), r, 1)
    d = np.where(hole > 0, 0.0, d)

    # mm quantization (the on-disk uint16 format)
    return np.round(np.clip(d, 0.0, 65.535) * 1000.0).astype(np.float32) / 1000.0


def perturb_K(K: np.ndarray, rng: np.random.RandomState,
              strength: float = 1.0) -> np.ndarray:
    """True intrinsics K' for rendering, vs the nominal K the dataset reports
    (~0.4% focal error and ~2 px principal-point error)."""
    Kp = np.asarray(K, np.float64).copy()
    Kp[0, 0] *= 1.0 + rng.uniform(-0.004, 0.004) * strength
    Kp[1, 1] *= 1.0 + rng.uniform(-0.004, 0.004) * strength
    Kp[0, 2] += rng.uniform(-2.0, 2.0) * strength
    Kp[1, 2] += rng.uniform(-2.0, 2.0) * strength
    return Kp


def sequence_drift(n_frames: int, rng: np.random.RandomState,
                   strength: float = 1.0) -> np.ndarray:
    """Per-frame auto-exposure drift gains for a whole sequence: a bounded
    random walk in log2-gain.  Returns (n_frames,) gains in about [0.7, 1.4]."""
    lg = 0.0
    gains = np.empty(n_frames, np.float32)
    for i in range(n_frames):
        lg = 0.90 * lg + rng.randn() * 0.06 * strength
        gains[i] = 2.0 ** np.clip(lg, -0.5, 0.5)
    return gains


def motion_kernel(flow_px, strength: float = 1.0):
    """The motion-blur kernel of `motion_blur_rgb` (None below 1 px)."""
    flow = np.asarray(flow_px, np.float64) * 0.6 * strength
    length = float(np.hypot(*flow))
    if length < 1.0:
        return None
    n = int(np.ceil(length)) | 1  # odd kernel size
    n = min(n, 31)
    kern = np.zeros((n, n), np.float32)
    c = n // 2
    # draw the motion segment through the kernel center
    dx, dy = flow / max(length, 1e-6)
    for s in np.linspace(-length / 2, length / 2, 4 * n):
        x = int(round(c + s * dx))
        y = int(round(c + s * dy))
        if 0 <= x < n and 0 <= y < n:
            kern[y, x] += 1.0
    kern /= kern.sum()
    return kern


def motion_blur_rgb(color01: np.ndarray, flow_px: np.ndarray,
                    strength: float = 1.0) -> np.ndarray:
    """Directional blur from inter-frame image motion: a line kernel of the
    motion's direction and ~60% of its length.  Below 1 px a no-op."""
    kern = motion_kernel(flow_px, strength)
    if kern is None:
        return color01
    return filter2d(color01.astype(np.float32), kern)


def degrade_mask(mask: np.ndarray, rng: np.random.RandomState,
                 strength: float = 1.0) -> np.ndarray:
    """Segmenter-style mask error: one erode-or-dilate step plus edge noise."""
    m = (mask > 0).astype(np.uint8)
    it = 1 + int(rng.rand() < 0.3 * strength)
    if rng.rand() < 0.5:
        m = dilate(m, 3, iterations=it)
    else:
        m = erode(m, 3, iterations=it)
    # salt noise along the boundary
    edge = dilate(m, 5) - erode(m, 5)
    flip = (rng.rand(*m.shape) < 0.15 * strength) & (edge > 0)
    m = np.where(flip, 1 - m, m)
    return (m * 255).astype(np.uint8)
