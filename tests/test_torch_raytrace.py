"""Ray-mesh kernel K2's plain PyTorch version and the port's ray trace
against the JAX package: its XLA path (`ray_mesh_intersect(use_pallas=False)`)
and the Pallas kernel run in interpret mode, on the same numpy inputs.

Tolerance: hit masks equal; t to rtol 1e-6 (both sides do the same fp32
Moller-Trumbore, with the three-term dot products possibly summed in another
order)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.io.mesh_io import load_mesh as jload_mesh
from sixdof_tpu.ops import raytrace as jrt
from sixdof_tpu.ops.pallas.raytrace_kernel import pack_rays, pack_tris, ray_mesh_intersect_pallas
from sixdof_tpu_torch.io.mesh_io import TriMesh, load_mesh
from sixdof_tpu_torch.kernels import raytrace as k2
from sixdof_tpu_torch.ops import raytrace as trt

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
T_RTOL = 1e-6


def quad_mesh(z=2.0, half=1.0):
    v = np.array([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]])
    return TriMesh(v, np.array([[0, 1, 2], [0, 2, 3]]))


def sphere_mesh(n_lat=16, n_lon=24, r=50.0, center=(0.0, 0.0, 400.0)):
    """Closed UV sphere (mm scale, in front of the camera)."""
    verts = [[0, 0, r], [0, 0, -r]]
    for i in range(1, n_lat):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                          r * np.cos(th)])
    verts = np.asarray(verts) + np.asarray(center)
    ring = lambda i, j: 2 + (i - 1) * n_lon + (j % n_lon)  # noqa: E731
    faces = []
    for j in range(n_lon):
        faces.append([0, ring(1, j), ring(1, j + 1)])
        faces.append([1, ring(n_lat - 1, j + 1), ring(n_lat - 1, j)])
        for i in range(1, n_lat - 1):
            a, b, c, d = ring(i, j), ring(i, j + 1), ring(i + 1, j), ring(i + 1, j + 1)
            faces += [[a, c, b], [b, c, d]]
    return TriMesh(verts, np.asarray(faces))


def box_scene():
    """synth_box model.obj (mm) posed by the annotated pose of frame 0 in the
    colour camera, as the capture traces it."""
    mesh = load_mesh(os.path.join(SCENE, "mesh", "model.obj"))
    gt = np.loadtxt(os.path.join(SCENE, "annotated_poses", "0000.txt"))
    gt[:3, 3] *= 1000.0
    mesh.transform(gt)
    return mesh


def make_case(name, seed):
    """(origins, dirs, ray_mask, tri_verts, tri_mask) float32/bool numpy."""
    rng = np.random.RandomState(seed)
    if name == "quad":
        mesh, n = quad_mesh(), 300
        dirs = rng.randn(n, 3)
        dirs[:, 2] = np.abs(dirs[:, 2]) + 0.5
        origins = np.zeros((n, 3))
        # rays through the shared diagonal edge and the corners
        dirs[:8] = [[0, 0, 1], [0.25, 0.25, 1], [-0.25, -0.25, 1], [0.5, 0.5, 2], [1, 1, 2],
                    [-1, 1, 2], [1, -1, 2], [0.5, -0.5, 1]]
    elif name == "sphere":
        mesh, n = sphere_mesh(), 400
        dirs = rng.randn(n, 3) * [0.1, 0.1, 0.0] + [0, 0, 1]
        origins = rng.randn(n, 3) * 2.0
    else:
        mesh, n = box_scene(), 600
        c = mesh.vertices.mean(axis=0)
        dirs = (c + rng.randn(n, 3) * 25.0) / np.linalg.norm(c)
        origins = np.zeros((n, 3))
    dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    tri, _ = trt.mesh_to_tri_verts(mesh.vertices, mesh.faces)
    ray_mask = rng.rand(n) > 0.15
    tri_mask = rng.rand(len(tri)) > 0.1
    return (origins.astype(np.float32), dirs.astype(np.float32), ray_mask, tri, tri_mask)


def _jax_xla(o, d, m, tri, tm):
    return np.asarray(jrt.ray_mesh_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(m),
                                             jnp.asarray(tri), jnp.asarray(tm),
                                             use_pallas=False))


def _jax_pallas(o, d, m, tri, tm):
    n = len(o)
    rays_p = pack_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(m), tile=256)
    tris_p = pack_tris(jnp.asarray(tri), jnp.asarray(tm), tri_chunk=64)
    return np.asarray(ray_mesh_intersect_pallas(rays_p, tris_p, tile=256, tri_chunk=64,
                                                interpret=True))[:n]


def _port(o, d, m, tri, tm):
    tris = k2.pack_tris(torch.from_numpy(tri), torch.from_numpy(tm))
    return k2.ray_mesh_intersect_plain(torch.from_numpy(o), torch.from_numpy(d),
                                       torch.from_numpy(m), tris).numpy()


def _assert_same_hits(got, ref):
    hit = np.isfinite(ref)
    assert (np.isfinite(got) == hit).all(), np.nonzero(np.isfinite(got) != hit)
    assert hit.sum() > 10
    np.testing.assert_allclose(got[hit], ref[hit], rtol=T_RTOL)


@pytest.mark.parametrize("name", ["quad", "sphere", "box"])
@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_plain_matches_jax(name, ref):
    case = make_case(name, seed=len(name))
    want = (_jax_xla if ref == "xla" else _jax_pallas)(*case)
    got = _port(*case)
    _assert_same_hits(got, want)
    assert np.isinf(got[~case[2]]).all()  # masked rays never hit


def test_masked_triangles_never_hit():
    o, d, m, tri, tm = make_case("quad", seed=3)
    got = _port(o, d, np.ones_like(m), tri, np.zeros_like(tm))
    assert np.isinf(got).all()
    # the quad's first triangle masked: rays that only it would stop pass
    keep = np.array([False, True])
    t1 = _port(o, d, np.ones_like(m), tri, keep)
    t_all = _port(o, d, np.ones_like(m), tri, np.ones(2, bool))
    assert np.isfinite(t_all).sum() > np.isfinite(t1).sum() > 0


def test_pack_tris_matches_pallas_layout():
    _, _, _, tri, tm = make_case("box", seed=5)
    want = np.asarray(pack_tris(jnp.asarray(tri), jnp.asarray(tm), tri_chunk=256))
    want = want.reshape(-1, 16)[: len(tri), :9]
    got = k2.pack_tris(torch.from_numpy(tri), torch.from_numpy(tm)).numpy()
    np.testing.assert_array_equal(got, want)


def test_ops_wrapper_and_chunking():
    """The ops-level entry packs and dispatches (a CPU tensor takes the plain
    version, no launch is counted), and chunking over RAY_CHUNK rays changes
    nothing."""
    o, d, m, tri, tm = make_case("sphere", seed=7)
    reps = (k2.RAY_CHUNK * 2 + 37) // len(o) + 1
    o, d, m = np.tile(o, (reps, 1)), np.tile(d, (reps, 1)), np.tile(m, reps)
    before = k2.ray_mesh_intersect.launches
    t = trt.ray_mesh_intersect(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(m),
                               torch.from_numpy(tri), torch.from_numpy(tm)).numpy()
    assert k2.ray_mesh_intersect.launches == before
    np.testing.assert_array_equal(t.reshape(reps, -1), np.tile(t[: len(o) // reps], (reps, 1)))
    _assert_same_hits(t, _jax_xla(o, d, m, tri, tm))


def test_mesh_to_tri_verts_matches_jax():
    j = jload_mesh(os.path.join(SCENE, "mesh", "model.obj"))
    t = load_mesh(os.path.join(SCENE, "mesh", "model.obj"))
    for a, b in zip(jrt.mesh_to_tri_verts(j.vertices, j.faces),
                    trt.mesh_to_tri_verts(t.vertices, t.faces)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
