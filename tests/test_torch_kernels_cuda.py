"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Skips without CUDA.  Imports no JAX, so it runs on a machine
without it:  python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py"""
import os

import numpy as np
import pytest
import torch

from sixdof_tpu_torch.io.mesh_io import load_mesh
from sixdof_tpu_torch.kernels import raster as k1
from sixdof_tpu_torch.kernels import raytrace as k2
from sixdof_tpu_torch.ops.geometry import compute_crop_window_tf_batch
from sixdof_tpu_torch.ops.hypotheses import make_rotation_grid
from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays, render_batch, zbuffer_setup
from torch_raster_cases import ADVERSARIAL, adversarial_case, empty_case
from torch_ray_cases import HAND_PLACED, scene_case, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "demo_data", "synth_box", "mesh", "model_scaled_down.obj")
K_IMG = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1]], np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,cull", [(252, (96, 96), True), (64, (160, 160), True),
                                       (16, (160, 160), False), (3, (37, 53), True)])
def test_raster_kernel_matches_plain(card, B, hw, cull):
    mesh = load_mesh(MESH)
    mesh.vertices -= (mesh.vertices.max(0) + mesh.vertices.min(0)) / 2
    arrays = make_mesh_arrays(mesh, card)
    grid = make_rotation_grid()[:B].copy()
    grid[:, :3, 3] = np.array([0.0, 0.0, 0.55]) + np.random.RandomState(B).uniform(
        -0.02, 0.02, (B, 3))
    poses = torch.tensor(grid, device=card)
    K = torch.tensor(K_IMG, device=card)
    tfs = compute_crop_window_tf_batch(poses, K, 1.2, (hw[1], hw[0]), 0.1)
    s = zbuffer_setup(arrays, poses, K, tfs, backface_cull=cull)
    before = k1.rasterize_zbuffer.launches
    zk, tk = k1.rasterize_zbuffer(s["coef_c"], s["counts"], *hw)
    assert k1.rasterize_zbuffer.launches == before + 1
    zp, tp = k1.rasterize_zbuffer_plain(s["coef_c"], s["counts"], *hw)
    torch.cuda.synchronize()
    assert (tk >= 0).double().mean() > 0.05
    assert torch.equal(zk, zp)  # the same fp32 operations in the same order
    assert torch.equal(tk, tp)  # ascending candidates, strict '>': the same winner
    rk = render_batch(arrays, poses, K, tfs, out_hw=hw, backface_cull=cull)
    rp = render_batch(arrays, poses, K, tfs, out_hw=hw, backface_cull=cull, plain_raster=True)
    for key in rk:
        assert torch.equal(rk[key], rp[key]), key


@pytest.mark.cuda
def test_raster_kernel_on_a_textured_mesh_at_the_scorer_shape(card):
    """K1 at the scorer trainer's shape (B=48, 160x160, no culling) on the
    box with seeded uv and a seeded 256x256 texture: every render output
    equal to the plain raster's."""
    from sixdof_tpu_torch.io.mesh_io import TriMesh
    from sixdof_tpu_torch.parallel import train as tr

    mesh = load_mesh(MESH)
    v = mesh.vertices - (mesh.vertices.max(0) + mesh.vertices.min(0)) / 2
    rng = np.random.RandomState(9)
    arrays = make_mesh_arrays(TriMesh(v, mesh.faces, uv=rng.rand(len(v), 2),
                                      texture=rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)),
                              card)
    cfg = tr.TrainConfig(n_hypotheses=12)
    _, hyp = tr.scorer_hypotheses(tr.scorer_draws(torch.Generator(card).manual_seed(0), cfg),
                                  0.1, 12)
    K = torch.tensor(K_IMG, device=card)
    tfs = compute_crop_window_tf_batch(hyp, K, 1.2, (160, 160), 0.1)
    before = k1.rasterize_zbuffer.launches
    rk = render_batch(arrays, hyp, K, tfs, out_hw=(160, 160))
    assert k1.rasterize_zbuffer.launches == before + 1
    rp = render_batch(arrays, hyp, K, tfs, out_hw=(160, 160), plain_raster=True)
    assert rk["alpha"].mean() > 0.05
    for key in rk:
        assert torch.equal(rk[key], rp[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["refiner", "scorer"])
def test_trainer_batches_through_k1_match_plain(card, net):
    """The trainer's batches at its shapes (32 pairs, or 4 scenes x 12, at
    160x160, clutter and sensor model on): two K1 launches, and the batch
    bit-equal to the same draws through the plain raster."""
    from sixdof_tpu_torch.parallel import train as tr

    mesh = load_mesh(MESH)
    mesh.vertices -= (mesh.vertices.max(0) + mesh.vertices.min(0)) / 2
    arrays = make_mesh_arrays(mesh, card)
    cfg = tr.TrainConfig(batch_size=32, p_occlusion=0.5, p_sensor=0.5, occ_sub=0.85,
                         n_hypotheses=12)
    draw, make = ((tr.refiner_draws, tr.make_refiner_batch) if net == "refiner"
                  else (tr.scorer_draws, tr.make_scorer_batch))
    draws = draw(torch.Generator(card).manual_seed(1), cfg)
    K = torch.tensor(K_IMG, device=card)
    before = k1.rasterize_zbuffer.launches
    kern = make(draws, arrays, K, 0.1, cfg)
    assert k1.rasterize_zbuffer.launches == before + 2
    plain = make(draws, arrays, K, 0.1, cfg, plain_raster=True)
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*ADVERSARIAL, "empty"])
def test_raster_kernel_matches_plain_on_hand_placed_triangles(card, name):
    """The binning rule's edges (tests/torch_raster_cases.py): slivers one ulp
    wide, triangles larger than the crop, vertices on tile borders and pixel
    centres, exact ties across tiles, empty poses, ragged crops."""
    coef, counts, H, W = empty_case(card) if name == "empty" else adversarial_case(name, card)
    zk, tk = k1.rasterize_zbuffer(coef, counts, H, W)
    zp, tp = k1.rasterize_zbuffer_plain(coef, counts, H, W)
    torch.cuda.synchronize()
    assert (tp >= 0).any()
    assert torch.equal(zk, zp)
    assert torch.equal(tk, tp)


@pytest.mark.cuda
def test_raster_kernel_list_refills(card):
    """More survivors in one tile than the shared list holds (512): every
    candidate covers the whole crop, so the list is rasterized and refilled
    many times; ties between equal planes go to the lowest index."""
    rng = np.random.RandomState(3)
    T = 2000
    coef = torch.zeros((2, T, 4, 3), device=card)
    coef[:, :, :3, 2] = 1.0  # l0 = l1 = l2 = 1: inside everywhere
    iz = torch.tensor(rng.randint(1, 50, (2, T)) / 7.0, dtype=torch.float32, device=card)
    coef[:, :, 3, 2] = iz
    coef[:, :, 3, 0] = torch.tensor(rng.randint(-2, 3, (2, T)) * 1e-3, device=card)
    counts = torch.tensor([T, 1337], dtype=torch.int32, device=card)
    zk, tk = k1.rasterize_zbuffer(coef, counts, 40, 24)
    zp, tp = k1.rasterize_zbuffer_plain(coef, counts, 40, 24)
    torch.cuda.synchronize()
    assert torch.equal(zk, zp) and torch.equal(tk, tp)


@pytest.mark.cuda
def test_raster_kernel_rejects_bad_inputs(card):
    coef = torch.zeros((2, 5, 4, 3), device=card)
    counts = torch.full((2,), 5, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        k1.rasterize_zbuffer(coef.double(), counts, 8, 8)
    with pytest.raises(ValueError):
        k1.rasterize_zbuffer(coef, counts.long(), 8, 8)
    with pytest.raises(ValueError):
        k1.rasterize_zbuffer(coef.transpose(1, 2), counts, 8, 8)
    z, t = k1.rasterize_zbuffer(coef, counts, 8, 8)  # all-zero planes: iz = 0, never inside
    assert (t == -1).all() and (z == 0).all()


def _k2_case(card, n_rays, seed, mask_every=0):
    """model.obj posed by the annotated pose of frame 0 (colour camera, mm),
    rays from the camera centre around the object; every @mask_every-th ray
    and triangle masked."""
    from sixdof_tpu_torch.ops.raytrace import mesh_to_tri_verts

    scene = os.path.join(REPO, "demo_data", "synth_box")
    mesh = load_mesh(os.path.join(scene, "mesh", "model.obj"))
    gt = np.loadtxt(os.path.join(scene, "annotated_poses", "0000.txt"))
    gt[:3, 3] *= 1000.0
    mesh.transform(gt)
    tri, tri_mask = mesh_to_tri_verts(mesh.vertices, mesh.faces)
    rng = np.random.RandomState(seed)
    dirs = mesh.vertices.mean(axis=0) + rng.randn(n_rays, 3) * 30.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ray_mask = np.ones(n_rays, bool)
    if mask_every:
        ray_mask[::mask_every] = False
        tri_mask[::mask_every] = False
    tris = k2.pack_tris(torch.tensor(tri, device=card), torch.tensor(tri_mask, device=card))
    d = torch.tensor(dirs, dtype=torch.float32, device=card)
    return torch.zeros_like(d), d, torch.tensor(ray_mask, device=card), tris


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,mask_every", [(587, 0), (8192, 11), (1, 0), (129, 3),
                                               (40000, 0)])
def test_ray_mesh_kernel_matches_plain(card, n_rays, mask_every):
    o, d, m, tris = _k2_case(card, n_rays, seed=n_rays, mask_every=mask_every)
    before = k2.ray_mesh_intersect.launches
    tk = k2.ray_mesh_intersect(o, d, m, tris)
    assert k2.ray_mesh_intersect.launches == before + 1
    tp = k2.ray_mesh_intersect_plain(o, d, m, tris)
    torch.cuda.synchronize()
    assert torch.isfinite(tk).any() or n_rays == 1
    assert torch.equal(tk, tp)  # the same fp32 operations in the same order
    assert torch.isinf(tk[~m]).all()


@pytest.fixture(scope="module")
def crust():
    """The point-click path's crust: create_mesh of mesh/model.ply (64^3
    grid, 169,900 triangles) posed by the annotated pose of frame 0 in the
    colour camera (mm)."""
    from sixdof_tpu_torch.app.defect_projection import create_mesh
    from sixdof_tpu_torch.io.mesh_io import load_point_cloud

    scene = os.path.join(REPO, "demo_data", "synth_box")
    mesh = create_mesh(load_point_cloud(os.path.join(scene, "mesh", "model.ply")))
    gt = np.loadtxt(os.path.join(scene, "annotated_poses", "0000.txt"))
    gt[:3, 3] *= 1000.0
    return mesh.transform(gt)


@pytest.mark.cuda
@pytest.mark.parametrize("origin", ["camera", "inside"])
def test_ray_mesh_kernel_matches_plain_on_a_crust(card, crust, origin):
    """Every 8th pixel of the frame from the camera centre, and the same
    directions from the crust's centre (every ray starts inside it, so
    every block keeps triangles on all sides)."""
    from sixdof_tpu_torch.ops.raytrace import mesh_to_tri_verts

    assert len(crust.faces) == 169_900
    tri, tri_mask = mesh_to_tri_verts(crust.vertices, crust.faces)
    tris = k2.pack_tris(torch.tensor(tri, device=card), torch.tensor(tri_mask, device=card))
    ys, xs = np.mgrid[0:480:8, 0:640:8]
    dirs = np.stack([(xs - K_IMG[0, 2]) / K_IMG[0, 0], (ys - K_IMG[1, 2]) / K_IMG[1, 1],
                     np.ones_like(xs, dtype=np.float32)], axis=-1).reshape(-1, 3)
    d = torch.tensor(dirs / np.linalg.norm(dirs, axis=1, keepdims=True), dtype=torch.float32,
                     device=card)
    o = torch.zeros_like(d)
    if origin == "inside":
        o += torch.tensor(crust.vertices.mean(axis=0), dtype=torch.float32, device=card)
    m = torch.ones(len(d), dtype=torch.bool, device=card)
    tk = k2.ray_mesh_intersect(o, d, m, tris)
    tp = k2.ray_mesh_intersect_plain(o, d, m, tris)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp)
    hits = int(torch.isfinite(tk).sum())
    assert hits == len(d) if origin == "inside" else hits > 0


@pytest.mark.cuda
def test_ray_mesh_kernel_edge_cases(card):
    o, d, m, tris = _k2_case(card, 300, seed=1)
    empty = tris[:0].contiguous()
    assert torch.isinf(k2.ray_mesh_intersect(o, d, m, empty)).all()
    none = k2.ray_mesh_intersect(o[:0], d[:0], m[:0], tris)
    assert none.shape == (0,)
    with pytest.raises(ValueError):
        k2.ray_mesh_intersect(o.double(), d, m, tris)
    with pytest.raises(ValueError):
        k2.ray_mesh_intersect(o, d, m.float(), tris)
    with pytest.raises(ValueError):
        k2.ray_mesh_intersect(o, d, m, tris[:, :8])
    with pytest.raises(ValueError):
        k2.ray_mesh_intersect(o, d.t().contiguous().t(), m, tris)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*HAND_PLACED, "scene"])
def test_ray_mesh_kernel_matches_plain_on_hand_placed_rays(card, name):
    """The cull test's edges (tests/torch_ray_cases.py): grazing rays with
    |det| just above 1e-12, hits inside the 1e-6 slack, blocks outside one
    edge each, shared edges and vertices, ulp-thin slivers, rays from inside
    the mesh, masked triangles and rays, a list refilled past 512 entries,
    rays that do not share an origin, and the frame at every 4th pixel."""
    case = scene_case(4) if name == "scene" else HAND_PLACED[name]()
    o, d, m, tris = to_torch(case, card)
    before = k2.ray_mesh_intersect.launches
    tk = k2.ray_mesh_intersect(o, d, m, tris)
    assert k2.ray_mesh_intersect.launches == before + 1
    tp = k2.ray_mesh_intersect_plain(o, d, m, tris)
    torch.cuda.synchronize()
    assert torch.equal(tk, tp)
    assert torch.isinf(tk[~m]).all()


@pytest.mark.cuda
def test_ray_mesh_kernel_counts_one_launch_a_call(card):
    o, d, m, tris = _k2_case(card, 587, seed=2)
    before = k2.ray_mesh_intersect.launches
    for _ in range(5):
        k2.ray_mesh_intersect(o, d, m, tris)
    torch.cuda.synchronize()
    assert k2.ray_mesh_intersect.launches == before + 5


@pytest.mark.cuda
def test_ray_mesh_kernel_resources(card, tmp_path):
    """nvcc's report for K2 (printed): registers, stack and shared memory.
    Shared memory stays under the 48 KB a block gets without opting in, and
    the registers leave room for two blocks of 256 threads an SM."""
    import re
    import subprocess

    from sixdof_tpu_torch.kernels import build

    out = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(tmp_path / "k2.so"),
                          k2.LIBRARY.source], capture_output=True, text=True, check=True)
    report = out.stdout + out.stderr
    print(report)
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
    smem = [int(n) for n in re.findall(r"(\d+) bytes smem", report)]
    assert regs and max(regs) <= 128
    assert smem and max(smem) <= 48 * 1024
