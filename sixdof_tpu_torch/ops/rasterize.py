"""Batched triangle rasterization for render-and-compare pose estimation.

Port of `sixdof_tpu/ops/rasterize.py`: renders B pose hypotheses of one mesh
straight into their crop windows with z-buffering, perspective-correct
attribute planes (vertex colours, or UVs and a bilinear texture lookup),
Lambertian shading (w_ambient=0.8, w_diffuse=0.5, light +z, or unlit) and
z-buffer backprojection for xyz.  Pixels sample at integer
coordinates (u = column at the pixel centre), as ops/warp.py does.

The z-buffer core is kernel K1 (`kernels/raster.py`).  Triangles that fail
the validity test (or face away, with backface culling) are compacted to
the back of each pose's list by a stable sort, so the kernel reads only
`counts[b]` candidates; z-buffering is order-independent and the stable
order keeps the lowest-index tie rule, so this is exact.  Every triangle
count runs this flat form; the JAX package's banded form (T >= 4096) is a
TPU layout choice and is not ported.

No gradients are needed (the reference renders under inference_mode).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.raster import rasterize_zbuffer, rasterize_zbuffer_plain

ZNEAR = 0.001
# Lambertian shading as the reference renders it (Utils.py:133,201-212)
W_AMBIENT, W_DIFFUSE = 0.8, 0.5
LIGHT_DIR = (0.0, 0.0, 1.0)


class MeshArrays(NamedTuple):
    """Device-resident mesh in raster-ready form (see make_mesh_arrays)."""

    pos: torch.Tensor  # (V,3) f32 object-frame vertices
    faces: torch.Tensor  # (T,3) int64
    vnormals: torch.Tensor  # (V,3) f32 unit vertex normals
    vertex_color: Optional[torch.Tensor]  # (V,3) f32 in [0,1], or None when textured
    uv: Optional[torch.Tensor] = None  # (V,2) f32, V flipped (1 - v)
    tex: Optional[torch.Tensor] = None  # (Ht,Wt,3) f32 in [0,1]


def make_mesh_arrays(mesh, device, max_tex_size=None) -> MeshArrays:
    """TriMesh -> MeshArrays (reference Utils.py:104-130 make_mesh_tensors).

    A mesh with uv and a texture renders textured: the texture V coordinate
    is flipped (uv[:,1] = 1 - v) as the reference does, and a texture whose
    larger side exceeds @max_tex_size is shrunk by that factor first
    (OpenCV's INTER_LINEAR on uint8, `io/readers.py::resize_linear_u8`).
    Otherwise vertex colours; meshes without colours get uniform grey
    128/255."""
    f32 = dict(dtype=torch.float32, device=device)
    vertex_color = uv = tex = None
    if mesh.texture is not None and mesh.uv is not None:
        img = np.asarray(mesh.texture)
        if max_tex_size is not None and max(img.shape[:2]) > max_tex_size:
            from ..io.readers import resize_linear_u8

            img = resize_linear_u8(img, max_tex_size / max(img.shape[:2]))
        tex = torch.as_tensor(img, **f32) / 255.0
        uv_np = np.array(mesh.uv, dtype=np.float32)
        uv_np[:, 1] = 1.0 - uv_np[:, 1]
        uv = torch.as_tensor(uv_np, **f32)
    else:
        vc = mesh.vertex_colors
        if vc is None:
            vc = np.tile(np.array([[128.0, 128.0, 128.0]]), (len(mesh.vertices), 1))
        vc = np.asarray(vc, dtype=np.float32)
        if vc.max() > 1.0:
            vc = vc / 255.0
        vertex_color = torch.as_tensor(vc, **f32)
    return MeshArrays(
        pos=torch.as_tensor(np.asarray(mesh.vertices), **f32),
        faces=torch.as_tensor(np.asarray(mesh.faces), dtype=torch.int64, device=device),
        vnormals=torch.as_tensor(np.asarray(mesh.vertex_normals), **f32),
        vertex_color=vertex_color, uv=uv, tex=tex,
    )


def _sample_texture(tex, uv):
    """Bilinear texture sample; @uv: (...,2) in [0,1]; @tex: (Ht,Wt,3).
    Returns (...,3)."""
    Ht, Wt = tex.shape[:2]
    x = torch.clamp(uv[..., 0], 0.0, 1.0) * (Wt - 1)
    y = torch.clamp(uv[..., 1], 0.0, 1.0) * (Ht - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=Wt - 1)
    y1 = torch.clamp(y0 + 1, max=Ht - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x1] * fx * (1 - fy)
            + tex[y1, x0] * (1 - fx) * fy + tex[y1, x1] * fx * fy)


def _tri_setup(uv_crop, z_cam, faces, znear=ZNEAR):
    """Per-triangle plane coefficients, batched over poses.

    @uv_crop: (B,V,2); @z_cam: (B,V).  Returns (coef (B,T,4,3), valid (B,T)):
    rows [l0,l1,l2,inv_z], each [A,B,C] with value A*px + B*py + C.
    """
    v0 = uv_crop[:, faces[:, 0]]
    v1 = uv_crop[:, faces[:, 1]]
    v2 = uv_crop[:, faces[:, 2]]
    z0, z1, z2 = z_cam[:, faces[:, 0]], z_cam[:, faces[:, 1]], z_cam[:, faces[:, 2]]
    area = (v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1]) - (
        v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0])
    nonzero = torch.abs(area) > 1e-12
    valid = nonzero & (z0 > znear) & (z1 > znear) & (z2 > znear)
    inv_area = torch.where(valid, 1.0 / torch.where(nonzero, area, 1.0), 0.0)

    def edge_coef(a, b):
        ex = b[..., 0] - a[..., 0]
        ey = b[..., 1] - a[..., 1]
        return torch.stack([-ey, ex, ey * a[..., 0] - ex * a[..., 1]], dim=-1)

    c0 = edge_coef(v1, v2) * inv_area[..., None]
    c1 = edge_coef(v2, v0) * inv_area[..., None]
    c2 = edge_coef(v0, v1) * inv_area[..., None]
    iz = c0 * (1.0 / z0)[..., None] + c1 * (1.0 / z1)[..., None] + c2 * (1.0 / z2)[..., None]
    return torch.stack([c0, c1, c2, iz], dim=2), valid


def _attr_plane_table(vertex_attr, faces, z_cam, coef):
    """Per-pose screen-space attribute planes, flat rows [A(D)|B(D)|C(D)]
    with attr(p) = z(p) * (A px + B py + C); the last row (index T) is zeros
    for misses.  @vertex_attr: (B,V,D); @z_cam: (B,V); @coef: (B,T,4,3).
    Returns (B, T+1, 3D)."""
    a = vertex_attr[:, faces]  # (B,T,3,D)
    z = torch.clamp(z_cam[:, faces], min=1e-12)[..., None]  # (B,T,3,1)
    planes = torch.einsum("btkc,btkd->btcd", coef[:, :, :3, :], a / z)  # (B,T,3,D)
    flat = planes.reshape(*planes.shape[:2], -1)
    return torch.cat([flat, torch.zeros_like(flat[:, :1])], dim=1)


def zbuffer_setup(mesh: MeshArrays, poses, K, crop_tfs, backface_cull=False, znear=ZNEAR):
    """Vertex projection, triangle planes, culling and the valid-first
    compaction that feeds kernel K1.

    Returns dict: p_cam (B,V,3), z (B,V), coef (B,T,4,3), coef_c (B,T,4,3)
    compacted and contiguous, counts (B,) int32, order (B,T) int64 (compacted
    index -> original triangle id)."""
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    p_cam = torch.matmul(mesh.pos, R.transpose(1, 2)) + t[:, None]  # (B,V,3)
    z_all = p_cam[..., 2]
    uvw = torch.matmul(p_cam, K.T)
    uv = uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=znear)
    uvh = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    uv_all = torch.matmul(uvh, crop_tfs.transpose(1, 2))[..., :2]
    faces = mesh.faces
    coef, valid = _tri_setup(uv_all, z_all, faces, znear)
    if backface_cull:
        # camera-space facing test: outward normal vs the view ray to v0
        v0 = p_cam[:, faces[:, 0]]
        n = torch.linalg.cross(p_cam[:, faces[:, 1]] - v0, p_cam[:, faces[:, 2]] - v0, dim=-1)
        valid = valid & ((n * v0).sum(dim=-1) < 0.0)
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    coef_c = torch.take_along_dim(coef, order[..., None, None], dim=1).contiguous()
    return dict(p_cam=p_cam, z=z_all, coef=coef, coef_c=coef_c,
                counts=valid.sum(dim=1).to(torch.int32), order=order)


@torch.no_grad()
def render_batch(mesh: MeshArrays, poses, K, crop_tfs=None, out_hw=(160, 160), znear=ZNEAR,
                 tri_chunk=64, pose_chunk=32, pallas_tri_chunk=128, get_normal=False,
                 use_light=True, w_ambient=W_AMBIENT, w_diffuse=W_DIFFUSE, light_dir=LIGHT_DIR,
                 use_pallas=None, backface_cull=False, band_min_tris=4096, pallas_tile=2048,
                 plain_raster=False):
    """Render B hypotheses into their crop windows.

    JAX's parameters in its order.  @tri_chunk, @pose_chunk,
    @pallas_tri_chunk, @band_min_tris and @pallas_tile size the JAX
    package's XLA and Pallas tiles; they are accepted and unused (K1 tiles
    itself).  @use_pallas=False takes the plain raster, as it takes JAX's
    XLA scan; None or True the kernel on a CUDA tensor.
    @poses: (B,4,4) object-in-camera (OpenCV convention); @K: (3,3);
    @crop_tfs: (B,3,3) full-image -> crop pixel transform, or None.
    @znear: triangles with a vertex nearer than this are dropped.
    @use_light: Lambertian shading, colour * (w_ambient + w_diffuse *
    clip(n . -light_dir)), the diffuse term interpolated per vertex; else
    the bare vertex or texture colour.
    @plain_raster: run the z-buffer through its plain PyTorch version even on
    the card (the comparison run of chip_smoke.py); by default a CUDA tensor
    goes through kernel K1.
    Returns dict: color (B,H,W,3) in [0,1], depth (B,H,W) camera z,
    xyz_map (B,H,W,3) camera frame, alpha (B,H,W), normal (optional).
    """
    B = poses.shape[0]
    H, W = out_hw
    dev = poses.device
    poses = poses.float()
    K = K.float()
    if crop_tfs is None:
        crop_tfs = torch.eye(3, dtype=torch.float32, device=dev).repeat(B, 1, 1)
    crop_tfs = crop_tfs.float()
    setup = zbuffer_setup(mesh, poses, K, crop_tfs, backface_cull, znear)
    order = setup["order"]

    # per-pose shading channels -> attribute plane table: uv (textured) or
    # colour, then the diffuse term, then normals
    n_cam_v = torch.matmul(mesh.vnormals, poses[:, :3, :3].transpose(1, 2))  # (B,V,3)
    textured = mesh.tex is not None
    base = mesh.uv if textured else mesh.vertex_color
    n_base = base.shape[-1]
    chans = [base[None].expand(B, -1, -1)]
    if use_light:
        light = torch.tensor(light_dir, dtype=torch.float32, device=dev)
        light = light / torch.linalg.norm(light)
        # per-vertex diffuse term, interpolated like the colours
        nv = n_cam_v / torch.clamp(torch.linalg.norm(n_cam_v, dim=-1, keepdim=True), min=1e-12)
        chans.append(torch.clamp((nv * (-light)).sum(dim=-1), 0.0, 1.0)[..., None])
    if get_normal:
        chans.append(n_cam_v)
    table = _attr_plane_table(torch.cat(chans, dim=-1), mesh.faces, setup["z"], setup["coef"])

    raster = rasterize_zbuffer_plain if plain_raster or use_pallas is False \
        else rasterize_zbuffer
    zflat, tid_c = raster(setup["coef_c"], setup["counts"], H, W)
    hit = tid_c >= 0
    tid = torch.gather(order, 1, torch.clamp(tid_c, min=0).long())  # original triangle ids

    # shading: one row gather of the plane table per pixel
    P = H * W
    pid = torch.arange(P, device=dev)
    px = (pid % W).float()
    py = torch.div(pid, W, rounding_mode="floor").float()
    ids = torch.where(hit, tid, mesh.faces.shape[0])  # misses read the zero row
    D = table.shape[-1] // 3
    g = torch.gather(table, 1, ids[..., None].expand(-1, -1, 3 * D))  # (B,P,3D)
    attr = (g[..., :D] * px[:, None] + g[..., D:2 * D] * py[:, None] + g[..., 2 * D:]) \
        * zflat[..., None]
    alpha = hit.float()
    color = _sample_texture(mesh.tex, attr[..., :2]) if textured else attr[..., :3]
    o = n_base
    if use_light:
        diffuse = attr[..., o:o + 1]
        o += 1
        color = color * w_ambient + diffuse * color * w_diffuse
    color = torch.clamp(color, 0.0, 1.0) * alpha[..., None]

    # xyz by backprojection: xyz = z * (crop_tf @ K)^-1 (px,py,1)
    Minv = torch.linalg.inv_ex(torch.matmul(crop_tfs, K)).inverse  # (B,3,3), no host sync
    pix = torch.stack([px, py, torch.ones_like(px)], dim=-1)  # (P,3)
    ray = torch.matmul(pix, Minv.transpose(1, 2))  # (B,P,3)
    xyz = ray * zflat[..., None]

    out = {
        "color": color.reshape(B, H, W, 3),
        "depth": zflat.reshape(B, H, W),
        "xyz_map": xyz.reshape(B, H, W, 3),
        "alpha": alpha.reshape(B, H, W),
    }
    if get_normal:
        normal = attr[..., o:o + 3]
        normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-12)
        out["normal"] = normal.reshape(B, H, W, 3)
    return out
