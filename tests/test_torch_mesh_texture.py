"""Textured meshes: the port's OBJ texture I/O (io/mesh_io.py) and textured
rendering (ops/rasterize.py) against the JAX package on the CPU.

Tolerances:
- OBJ files both ways, the texture resize and the raster-ready arrays:
  equal (the same host arithmetic);
- the texture lookup `_sample_texture` on the same uv: 1e-6 (float32
  products in another order; 1.2e-7 measured);
- textured renders: depth and coverage as in test_torch_rasterize.py
  (vertex math in another order: XLA fuses multiply-adds on the CPU, torch
  does not, and depth moves up to ~3e-5 m for a 1-ulp change of a pose);
  colour within 1e-3 on a smooth texture, where that uv error moves colour
  by at most ~1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sixdof_tpu.io import mesh_io as jm
from sixdof_tpu.ops import rasterize as jr
from sixdof_tpu.ops.geometry import compute_crop_window_tf_batch as j_crop
from sixdof_tpu.ops.lie import so3_exp_map as j_exp
from sixdof_tpu_torch.io import mesh_io as tm
from sixdof_tpu_torch.ops import rasterize as tr

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "demo_data", "synth_box", "mesh", "model_scaled_down.obj")
K_IMG = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)
MAX_COVER_DIFF = 0.002


def _textured(kind="random", size=(48, 64), seed=0):
    """synth_box's box, centred, with seeded per-vertex uv and a texture:
    random texels, or smooth ramps (colour linear in uv)."""
    m = jm.load_mesh(MESH)
    m.vertices = m.vertices - (m.vertices.max(0) + m.vertices.min(0)) / 2
    rng = np.random.RandomState(seed)
    H, W = size
    if kind == "random":
        tex = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    else:
        yy, xx = np.mgrid[0:H, 0:W]
        tex = np.stack([xx * 255 // (W - 1), yy * 255 // (H - 1),
                        (xx + yy) * 255 // (H + W - 2)], -1).astype(np.uint8)
    return m.vertices, m.faces, rng.rand(len(m.vertices), 2), tex


def test_port_reads_what_jax_writes(tmp_path):
    v, f, uv, tex = _textured()
    jm.save_obj(str(tmp_path / "box.obj"), jm.TriMesh(v, f, uv=uv, texture=tex))
    ref = jm.load_obj(str(tmp_path / "box.obj"))
    got = tm.load_obj(str(tmp_path / "box.obj"))
    np.testing.assert_array_equal(got.uv, ref.uv)
    np.testing.assert_array_equal(got.texture, ref.texture)
    np.testing.assert_array_equal(got.texture, tex)
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.faces, ref.faces)


def test_jax_reads_what_port_writes(tmp_path):
    v, f, uv, tex = _textured(seed=1)
    mesh = tm.TriMesh(v, f, uv=uv, texture=tex)
    assert mesh.export(str(tmp_path / "box.obj")) == str(tmp_path / "box.obj")
    assert open(tmp_path / "box.mtl").read() == "newmtl material_0\nmap_Kd box_tex.png\n"
    ref = jm.load_obj(str(tmp_path / "box.obj"))
    np.testing.assert_array_equal(ref.uv, uv)
    np.testing.assert_array_equal(ref.texture, tex)
    # the PNG holds RGB in that order (JAX writes through PIL)
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "box_tex.png")), tex)
    # and the port reads its own file back
    back = tm.load_mesh(str(tmp_path / "box.obj"))
    np.testing.assert_array_equal(back.uv, uv)
    np.testing.assert_array_equal(back.texture, tex)


@pytest.mark.parametrize("mode", ["L", "RGBA"])
def test_grey_and_rgba_textures_read_as_rgb(tmp_path, mode):
    v, f, uv, tex = _textured(seed=2)
    jm.save_obj(str(tmp_path / "box.obj"), jm.TriMesh(v, f, uv=uv, texture=tex))
    Image.fromarray(tex).convert(mode).save(tmp_path / "box_tex.png")
    ref, got = jm.load_obj(str(tmp_path / "box.obj")), tm.load_obj(str(tmp_path / "box.obj"))
    np.testing.assert_array_equal(got.texture, ref.texture)


def test_jpeg_texture_raises(tmp_path):
    """A JPEG texture, once refused, now reads as the JAX loader's PIL
    convert("RGB") reads it."""
    v, f, uv, tex = _textured(seed=3)
    jm.save_obj(str(tmp_path / "box.obj"), jm.TriMesh(v, f, uv=uv, texture=tex))
    Image.fromarray(tex).save(tmp_path / "box_tex.jpg", format="JPEG")
    (tmp_path / "box.mtl").write_text("newmtl material_0\nmap_Kd box_tex.jpg\n")
    ref = jm.load_obj(str(tmp_path / "box.obj"))  # PIL's convert("RGB")
    got = tm.load_obj(str(tmp_path / "box.obj"))
    np.testing.assert_array_equal(got.texture, ref.texture)
    np.testing.assert_array_equal(got.uv, ref.uv)


def test_save_ply_mesh_and_cloud_match_jax(tmp_path):
    v, f, _, _ = _textured()
    vc = np.random.RandomState(4).randint(0, 256, (len(v), 3))
    for name, ref, got in (
            ("mesh", jm.TriMesh(v, f, vertex_colors=vc), tm.TriMesh(v, f, vertex_colors=vc)),
            ("cloud", jm.PointCloud(v, colors=vc / 255.0, normals=v),
             tm.PointCloud(v, colors=vc / 255.0, normals=v))):
        jm.save_ply(str(tmp_path / f"{name}_jax.ply"), ref)
        tm.save_ply(str(tmp_path / f"{name}_port.ply"), got)
        assert (tmp_path / f"{name}_port.ply").read_bytes() == \
            (tmp_path / f"{name}_jax.ply").read_bytes()
    tm.save_mesh(str(tmp_path / "m.ply"), tm.TriMesh(v, f, vertex_colors=vc))
    back = tm.load_mesh(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(back.faces, f)
    with pytest.raises(ValueError, match="unsupported"):
        tm.save_mesh(str(tmp_path / "m.stl"), back)


@pytest.mark.parametrize("max_tex_size", [None, 1000, 40, 32, 17])
def test_make_mesh_arrays_textured(max_tex_size):
    """uv V-flipped, vertex colour None, the texture (shrunk by OpenCV's
    INTER_LINEAR above max_tex_size; 32 is an exact halving) as float32."""
    v, f, uv, tex = _textured(size=(48, 64))
    ref = jr.make_mesh_arrays(jm.TriMesh(v, f, uv=uv, texture=tex), max_tex_size=max_tex_size)
    got = tr.make_mesh_arrays(tm.TriMesh(v, f, uv=uv, texture=tex), "cpu",
                              max_tex_size=max_tex_size)
    assert got.vertex_color is None and ref.vertex_color is None
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(ref.uv))
    np.testing.assert_array_equal(got.tex.numpy(), np.asarray(ref.tex))
    if max_tex_size is not None and max_tex_size < 64:
        assert max(got.tex.shape[:2]) == max_tex_size
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(got.vnormals.numpy(), np.asarray(ref.vnormals))


def test_sample_texture_matches_jax():
    _, _, _, tex = _textured()
    t = tex.astype(np.float32) / 255.0
    uv = np.random.RandomState(5).uniform(-0.1, 1.1, (4, 50, 2)).astype(np.float32)
    ref = np.asarray(jax.jit(jr._sample_texture)(jnp.asarray(t), jnp.asarray(uv)))
    got = tr._sample_texture(torch.tensor(t), torch.tensor(uv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _poses(seed, n):
    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = np.asarray(j_exp(jnp.asarray(rng.randn(n, 3) * 1.5, dtype=jnp.float32)))
    poses[:, :3, 3] = np.c_[rng.randn(n, 2) * 0.01, 0.5 + rng.rand(n) * 0.1]
    return poses


@pytest.mark.parametrize("use_light", [True, False], ids=["lit", "unlit"])
@pytest.mark.parametrize("textured", [True, False], ids=["textured", "vertex_colour"])
def test_render_batch_textured_and_unlit_match_jax(textured, use_light):
    v, f, uv, tex = _textured("smooth")
    vc = np.random.RandomState(6).randint(0, 256, (len(v), 3))
    if textured:
        ja = jr.make_mesh_arrays(jm.TriMesh(v, f, uv=uv, texture=tex))
        ta = tr.make_mesh_arrays(tm.TriMesh(v, f, uv=uv, texture=tex), "cpu")
    else:
        ja = jr.make_mesh_arrays(jm.TriMesh(v, f, vertex_colors=vc))
        ta = tr.make_mesh_arrays(tm.TriMesh(v, f, vertex_colors=vc), "cpu")
    poses = _poses(7, 5)
    hw = (40, 48)
    tfs = np.asarray(j_crop(jnp.asarray(poses), jnp.asarray(K_IMG), 1.2, (48, 40), 0.1))
    light = (0.3, -0.2, 1.0)
    ref = jr.render_batch(ja, jnp.asarray(poses), jnp.asarray(K_IMG), jnp.asarray(tfs),
                          out_hw=hw, use_pallas=False, use_light=use_light, w_ambient=0.7,
                          w_diffuse=0.6, light_dir=light, get_normal=True)
    got = tr.render_batch(ta, torch.tensor(poses), torch.tensor(K_IMG), torch.tensor(tfs),
                          out_hw=hw, use_light=use_light, w_ambient=0.7, w_diffuse=0.6,
                          light_dir=light, get_normal=True)
    a_ref, a_got = np.asarray(ref["alpha"]), got["alpha"].numpy()
    assert a_got.mean() > 0.1
    same = a_ref == a_got
    assert 1 - same.mean() <= MAX_COVER_DIFF
    for k, tol in (("depth", 5e-4), ("xyz_map", 5e-4), ("color", 1e-3), ("normal", 1e-3)):
        np.testing.assert_allclose(got[k].numpy()[same], np.asarray(ref[k])[same], atol=tol,
                                   err_msg=k)
    # unlit colour is the bare texture or vertex colour: never shaded above it
    if not use_light and not textured:
        assert got["color"].max() <= vc.max() / 255.0 + 1e-6
