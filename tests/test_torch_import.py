"""The PyTorch port stands alone: no JAX, no JAX package, no host libraries
the card does not have, and no silent CPU fallback."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ["jax", "flax", "orbax", "tensorstore", "sixdof_tpu", "cv2", "PIL", "imageio",
             "zstandard", "h5py", "open3d", "dash", "plotly", "matplotlib"]


def test_import_graph_has_no_jax_or_host_libraries():
    # a subprocess: tests/conftest.py imports jax into this process
    code = f"""
import importlib, pkgutil, sys
import sixdof_tpu_torch
for m in pkgutil.walk_packages(sixdof_tpu_torch.__path__, "sixdof_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
import run_torch
sys.path.insert(0, "tools")
import train_torch_networks
import run_bop_torch
import convert_scene_to_bop_torch
import run_object_field_torch
import extract_field_mesh_torch
import profile_torch_field
import precompile_torch
import measure_cold_start_torch
run_bop_torch.main, convert_scene_to_bop_torch.main  # their imports run inside main
bad = [n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r}]
print("BAD", bad)
print("N", sum(n.startswith("sixdof_tpu_torch") for n in sys.modules))
print("CKPT", "sixdof_tpu_torch.models.checkpoint" in sys.modules)
print("SLICE", all(m in sys.modules for m in ("sixdof_tpu_torch.app.web_vis",
                                              "sixdof_tpu_torch.ops.features",
                                              "sixdof_tpu_torch.ops.marching",
                                              "sixdof_tpu_torch.utils.vis")))
print("TRAINER", all(m in sys.modules for m in ("sixdof_tpu_torch.parallel.train",
                                                "sixdof_tpu_torch.parallel.augment",
                                                "sixdof_tpu_torch.parallel.procgen")))
print("LIVE", all(m in sys.modules for m in ("sixdof_tpu_torch.io.bop_reader",
                                             "sixdof_tpu_torch.io.kinect_tools",
                                             "sixdof_tpu_torch.utils.logging_utils")))
print("FIELD", "sixdof_tpu_torch.models.object_field" in sys.modules)
print("STARTUP", callable(precompile_torch.main) and callable(measure_cold_start_torch.main))
print("JPEG", "sixdof_tpu_torch.io.jpeg" in sys.modules)
print("H5_MULTI", all(m in sys.modules for m in ("sixdof_tpu_torch.io.h5_dataset",
                                                 "sixdof_tpu_torch.models.pose_data",
                                                 "sixdof_tpu_torch.parallel.sharding")))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("N ")[1].split()[0])
    assert n >= 35  # every submodule was imported
    assert "CKPT True" in out.stdout  # the checkpoint loader among them
    assert "SLICE True" in out.stdout  # and the viewer, features, marching, drawings
    assert "TRAINER True" in out.stdout  # and the trainer, with the training tool
    assert "LIVE True" in out.stdout  # the BOP reader, the Kinect tools, with their tools
    assert "FIELD True" in out.stdout  # the neural object field, with its tools
    assert "STARTUP True" in out.stdout  # the start-up tools
    assert "H5_MULTI True" in out.stdout  # the H5 path and the data axis
    assert "JPEG True" in out.stdout  # the JPEG decoder


def test_jpeg_path_runs_without_jax_or_host_libraries(tmp_path):
    """The JPEG decoder on every fixture (its digests equal the manifest's),
    the BOP reader on a converted synth_box whose frames are the JPEG
    fixtures, the offline reader and an OBJ with the JPEG texture load no
    forbidden module."""
    code = f"""
import glob, hashlib, json, os, shutil, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, "tools")
import convert_scene_to_bop_torch
from sixdof_tpu_torch.io.bop_reader import BopSceneReader
from sixdof_tpu_torch.io.jpeg import read_jpeg_color, read_jpeg_rgb
from sixdof_tpu_torch.io.mesh_io import load_obj
from sixdof_tpu_torch.io.readers import DataReader
fixtures = "tests/data/jpeg"
manifest = json.load(open(os.path.join(fixtures, "MANIFEST.json")))
sha = lambda img: hashlib.sha256(img.tobytes()).hexdigest()
same = [sha(read_jpeg_color(os.path.join(fixtures, rel))) == e["cv2"]["sha256"]
        and sha(read_jpeg_rgb(os.path.join(fixtures, rel))) == e["pil"]["sha256"]
        for rel, e in manifest["files"].items()]
scene = convert_scene_to_bop_torch.main("demo_data/synth_box", {str(tmp_path)!r})
for png in glob.glob(os.path.join(scene, "rgb", "*.png")):
    os.remove(png)
for jpg in glob.glob(os.path.join(fixtures, "rgb", "*.jpg")):
    shutil.copy(jpg, os.path.join(scene, "rgb"))
frame = BopSceneReader(scene, shorter_side=120).get_color(0)
DataReader("demo_data/synth_box", 1, 120).get_color(0)
shutil.copy(os.path.join(fixtures, "texture.jpg"), {str(tmp_path)!r})
open(os.path.join({str(tmp_path)!r}, "q.mtl"), "w").write("newmtl m\\nmap_Kd texture.jpg\\n")
open(os.path.join({str(tmp_path)!r}, "q.obj"), "w").write(
    "mtllib q.mtl\\nv 0 0 0\\nv 1 0 0\\nv 0 1 0\\nvt 0 0\\nvt 1 0\\nvt 0 1\\nf 1/1 2/2 3/3\\n")
tex = load_obj(os.path.join({str(tmp_path)!r}, "q.obj")).texture
print("FIXTURES", len(same), all(same))
print("FRAME", frame.shape)
print("TEXTURE", sha(tex) == manifest["files"]["texture.jpg"]["pil"]["sha256"])
print("BAD", [n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r}])
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FIXTURES 19 True" in out.stdout and "FRAME (120, 160, 3)" in out.stdout, out.stdout
    assert "TEXTURE True" in out.stdout and "BAD []" in out.stdout, out.stdout


def test_bop_tools_run_without_jax_or_host_libraries(tmp_path):
    """The converter and the BOP campaign, run on synth_box (one frame, a
    reduced grid, on the CPU), load no forbidden module."""
    code = f"""
import sys
import torch
torch.set_num_threads(1)  # beside the suite's other workers
sys.path.insert(0, "tools")
import convert_scene_to_bop_torch, run_bop_torch
scene = convert_scene_to_bop_torch.main("demo_data/synth_box", {str(tmp_path)!r})
out = run_bop_torch.main(scene, frames=1, shorter_side=120, prune_to=4, max_hypotheses=8,
                         device="cpu")
print("FRAMES", out["frames"])
print("BAD", [n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r}])
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "FRAMES 1" in out.stdout and "BAD []" in out.stdout, out.stdout


def test_field_tools_run_without_jax_or_host_libraries(tmp_path):
    """The field campaign and its resume, run on 2 frames of synth_box_recon
    at a tiny grid on the CPU, load no forbidden module."""
    code = f"""
import sys
import torch
torch.set_num_threads(1)  # beside the suite's other workers
sys.path.insert(0, "tools")
import extract_field_mesh_torch, run_object_field_torch
from sixdof_tpu_torch.models.object_field import HashGridSpec, ObjectFieldConfig
spec = HashGridSpec(n_levels=4, base_res=4, finest_res=16, log2_hashmap_size=10)
kw = dict(resolution=16, device="cpu", ckpt_dir={str(tmp_path)!r}, spec=spec, max_frames=2)
out, _ = run_object_field_torch.main("demo_data/synth_box_recon", {str(tmp_path / "m.obj")!r},
    steps=10, cfg=ObjectFieldConfig(n_rand=32, n_samples=4, n_samples_around_depth=4), **kw)
again, _ = extract_field_mesh_torch.main("demo_data/synth_box_recon",
    {str(tmp_path / "again.obj")!r}, **kw)
print("STEPS", out["steps"], again["steps"])
print("BAD", [n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r}])
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "STEPS 10 10" in out.stdout and "BAD []" in out.stdout, out.stdout


def test_h5_files_need_h5py(monkeypatch, tmp_path):
    """Without h5py, opening or writing an H5 file raises ImportError naming
    it (never an empty dataset); a transform-only dataset needs no file."""
    monkeypatch.setitem(sys.modules, "h5py", None)  # `import h5py` now raises
    from sixdof_tpu_torch.io import h5_dataset as h5

    for cls in (h5.PairH5Dataset, h5.TripletH5Dataset, h5.ScoreMultiPairH5Dataset,
                h5.PoseRefinePairH5Dataset):
        with pytest.raises(ImportError, match="h5py"):
            cls(h5_file=str(tmp_path / "pairs.h5"))
        assert len(cls(mode="test")) == 1
    with pytest.raises(ImportError, match="h5py"):
        h5.write_pair_h5(str(tmp_path / "out.h5"), {})
    with pytest.raises(ImportError, match="h5py"):
        h5.PairH5Dataset().load_sample("ob_0")


def test_entry_points_raise_without_cuda(monkeypatch):
    import torch

    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import TriMesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    v = np.eye(3)
    mesh = TriMesh(np.vstack([v, [0, 0, 0]]), [[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]])
    with pytest.raises(RuntimeError, match="CUDA"):
        FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh)
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

    for predictor in (PoseRefinePredictor, ScorePredictor):
        with pytest.raises(RuntimeError, match="CUDA"):
            predictor()
    from sixdof_tpu_torch.models import object_field as of

    depth = np.full((1, 8, 8), 0.3)
    with pytest.raises(RuntimeError, match="CUDA"):
        of.ObjectFieldRunner(of.ObjectFieldConfig(), np.eye(3), np.zeros((1, 8, 8, 3), np.uint8),
                             depth, np.ones((1, 8, 8), np.uint8), np.eye(4)[None])
    with pytest.raises(RuntimeError, match="CUDA"):
        of.OccupancyGrid(np.zeros((4, 3)))
    from sixdof_tpu_torch.models.pose_data import BatchPoseData

    with pytest.raises(RuntimeError, match="CUDA"):
        BatchPoseData(rgbAs=np.zeros((1, 2, 2, 3))).device()
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchPoseData(rgbAs=torch.zeros((1, 2, 2, 3))).pin_memory()
    on_cpu = BatchPoseData(rgbAs=np.zeros((1, 2, 2, 3))).device("cpu")
    assert on_cpu.rgbAs.device.type == "cpu" and on_cpu.rgbAs.dtype == torch.float32


def test_kernel_wrapper_dispatch(monkeypatch):
    """CPU tensors take the plain version; a CUDA tensor never falls back."""
    import torch

    from sixdof_tpu_torch.kernels import build, raster

    coef = torch.zeros((1, 2, 4, 3))
    coef[:, :, 0, 2] = -1.0  # never inside
    counts = torch.tensor([2], dtype=torch.int32)
    z, t = raster.rasterize_zbuffer(coef, counts, 4, 4)
    assert (z == 0).all() and (t == -1).all()
    before = raster.rasterize_zbuffer.launches
    monkeypatch.setattr(build, "nvcc", lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))
    monkeypatch.setattr(raster.LIBRARY, "lib", None)

    class FakeCuda:  # a tensor that claims to be on the card
        device = torch.device("cuda")
        shape = coef.shape
        dtype = torch.float32

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return 0

    fake_counts = torch.tensor([2], dtype=torch.int32)
    with pytest.raises((RuntimeError, ValueError)):
        raster.rasterize_zbuffer(FakeCuda(), fake_counts, 4, 4)
    assert raster.rasterize_zbuffer.launches == before


def test_ray_kernel_wrapper_dispatch(monkeypatch):
    """K2: CPU tensors take the plain version; a CUDA tensor never falls
    back (it launches the kernel or raises), and nothing builds at import."""
    import torch

    from sixdof_tpu_torch.kernels import build, raytrace

    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    tv = torch.tensor([[[-1.0, -1.0, 2.0], [1.0, -1.0, 2.0], [0.0, 1.0, 2.0]]])
    tris = raytrace.pack_tris(tv, torch.ones(1, dtype=torch.bool))
    t = raytrace.ray_mesh_intersect(o, d, torch.ones(2, dtype=torch.bool), tris)
    assert t[0] == 2.0 and torch.isinf(t[1])
    assert raytrace.LIBRARY.lib is None
    before = raytrace.ray_mesh_intersect.launches
    monkeypatch.setattr(build, "nvcc", lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))

    class FakeCuda:  # a tensor that claims to be on the card
        device = torch.device("cuda")
        shape = (2, 3)
        dtype = torch.float32

        def is_contiguous(self):
            return True

    with pytest.raises((RuntimeError, ValueError)):
        raytrace.ray_mesh_intersect(FakeCuda(), d, torch.ones(2, dtype=torch.bool), tris)
    assert raytrace.ray_mesh_intersect.launches == before


def test_chip_smoke_exits_nonzero_without_cuda(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    # alone, without the repository around it
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
