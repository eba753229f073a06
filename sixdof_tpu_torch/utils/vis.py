"""Debug drawing: posed 3-D box, xyz axes, depth visualisation, image grid.

Port of `sixdof_tpu/utils/vis.py` in numpy.  The JAX package draws its lines
with OpenCV (`cv2.line`, `cv2.arrowedLine`, anti-aliased, 2 or 3 px thick);
here a line is the set of pixels whose centre lies within half its
thickness (rounded up) plus half a pixel of the segment, blended by a
one-pixel coverage ramp beyond that, as OpenCV's thick lines are a filled,
anti-aliased band with round ends.
The pixels drawn are OpenCV's to within a pixel, not bit for bit.
`make_grid_image` and `depth_to_vis` are bit-equal to the JAX package.
`cv_draw_text` is not ported: it needs OpenCV's Hershey font.
"""
from __future__ import annotations

import numpy as np

from .colormap import apply_jet


def depth_to_vis(depth, zmin=None, zmax=None, mode="rgb", inverse=True):
    depth = np.asarray(depth, dtype=np.float64)
    if zmin is None:
        zmin = depth.min()
    if zmax is None:
        zmax = depth.max()
    if inverse:
        invalid = depth < 0.001
        vis = zmin / (depth + 1e-8)
        vis[invalid] = 0
    else:
        depth = depth.clip(zmin, zmax)
        invalid = (depth == zmin) | (depth == zmax)
        denom = max(zmax - zmin, 1e-12)
        vis = (depth - zmin) / denom
        vis[invalid] = 1
    if mode == "gray":
        return (vis * 255).clip(0, 255).astype(np.uint8)
    if mode == "rgb":
        return apply_jet((vis * 255).clip(0, 255).astype(np.uint8))[..., ::-1]
    raise RuntimeError(mode)


def project_3d_to_2d(pt, K, ob_in_cam):
    pt = np.asarray(pt, dtype=np.float64).reshape(4, 1)
    projected = K @ (ob_in_cam @ pt)[:3, :]
    projected = projected.reshape(-1)
    projected = projected / projected[2]
    return projected[:2].round().astype(int)


def _draw_line(img, p0, p1, color, thickness):
    """Draw the segment p0-p1 (integer pixel coordinates) into @img in
    place, @thickness px wide with round ends and an anti-aliased edge:
    pixel centres within half the thickness (rounded up to a whole pixel,
    as OpenCV rounds it) plus 0.5 px of the segment take @color, those up
    to a pixel further a linear blend.  Returns the (rows, cols) slices of
    @img it may have changed, or None when the line misses the image."""
    H, W = img.shape[:2]
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    half = (thickness + thickness % 2) / 2.0  # OpenCV widens an odd line by half a pixel
    reach = half + 1.5
    lo = np.floor(np.minimum(p0, p1) - reach)
    hi = np.ceil(np.maximum(p0, p1) + reach)
    x0, y0 = int(max(lo[0], 0)), int(max(lo[1], 0))
    x1, y1 = int(min(hi[0], W - 1)), int(min(hi[1], H - 1))
    if x0 > x1 or y0 > y1:
        return None
    ys, xs = np.mgrid[y0 : y1 + 1, x0 : x1 + 1]
    q = np.stack([xs, ys], axis=-1).astype(np.float64) - p0
    d = p1 - p0
    dd = float(d @ d)
    s = np.clip((q @ d) / dd, 0.0, 1.0) if dd > 0 else np.zeros(xs.shape)
    dist = np.linalg.norm(q - s[..., None] * d, axis=-1)
    cover = np.clip(half + 1.5 - dist, 0.0, 1.0)[..., None]
    win = (slice(y0, y1 + 1), slice(x0, x1 + 1))
    old = img[win].astype(np.float64)
    col = np.asarray(color, dtype=np.float64).reshape(1, 1, -1)
    img[win] = np.rint(old + (col - old) * cover).astype(img.dtype)
    return win


def draw_xyz_axis(color, ob_in_cam, scale=0.1, K=np.eye(3), thickness=3, transparency=0,
                  is_input_rgb=False):
    """The object's x, y and z axes, @scale long, in red, green and blue
    (BGR order unless @is_input_rgb); the pixels a line changes are blended
    with @transparency."""
    red, green, blue = (255, 0, 0), (0, 255, 0), (0, 0, 255)
    if not is_input_rgb:
        red, blue = blue, red
    origin = project_3d_to_2d(np.array([0, 0, 0, 1.0]), K, ob_in_cam)
    tmp = color.copy()
    for k, col in enumerate((red, green, blue)):
        end = np.array([0, 0, 0, 1.0])
        end[k] = scale
        pt = project_3d_to_2d(end, K, ob_in_cam)
        tmp1 = tmp.copy()
        win = _draw_line(tmp1, origin, pt, col, thickness)
        if win is None:
            continue
        a, b = tmp[win], tmp1[win]  # a is a view: blending writes into tmp
        mask = np.linalg.norm(b.astype(float) - a.astype(float), axis=-1) > 0
        a[mask] = (a[mask] * transparency + b[mask] * (1 - transparency)).astype(tmp.dtype)
    return tmp


def draw_posed_3d_box(K, img, ob_in_cam, bbox, line_color=(0, 255, 0), linewidth=2):
    """The 12 edges of the box @bbox (2x3 min/max corners) posed by
    @ob_in_cam, drawn into @img in place."""
    xmin, ymin, zmin = bbox.min(axis=0)
    xmax, ymax, zmax = bbox.max(axis=0)

    def draw_line3d(start, end, img):
        pts = np.stack([start, end], axis=0)
        pts = (ob_in_cam[:3, :3] @ pts.T).T + ob_in_cam[:3, 3]
        projected = (K @ pts.T).T
        uv = np.round(projected[:, :2] / projected[:, 2:3]).astype(int)
        _draw_line(img, uv[0], uv[1], line_color, linewidth)
        return img

    for y in [ymin, ymax]:
        for z in [zmin, zmax]:
            img = draw_line3d(np.array([xmin, y, z]), np.array([xmax, y, z]), img)
    for x in [xmin, xmax]:
        for z in [zmin, zmax]:
            img = draw_line3d(np.array([x, ymin, z]), np.array([x, ymax, z]), img)
    for x in [xmin, xmax]:
        for y in [ymin, ymax]:
            img = draw_line3d(np.array([x, y, zmin]), np.array([x, y, zmax]), img)
    return img


def make_grid_image(imgs, nrow, padding=5, pad_value=255):
    """(B,H,W,C) list/array -> tiled grid image (numpy form of
    torchvision.utils.make_grid)."""
    imgs = [np.asarray(im) for im in imgs]
    H = max(im.shape[0] for im in imgs)
    W = max(im.shape[1] for im in imgs)
    n = len(imgs)
    ncol = nrow
    nrow_out = (n + ncol - 1) // ncol
    out = np.full(
        (padding + nrow_out * (H + padding), padding + ncol * (W + padding), 3),
        pad_value, dtype=np.uint8,
    )
    for i, im in enumerate(imgs):
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, axis=-1)
        r, c = divmod(i, ncol)
        y = padding + r * (H + padding)
        x = padding + c * (W + padding)
        out[y : y + im.shape[0], x : x + im.shape[1]] = im.astype(np.uint8)
    return out
