"""The BOP path of the port against the JAX package: the scene reader
(`sixdof_tpu_torch/io/bop_reader.py`) on a written fixture and on converted
demo scenes, the converter (`tools/convert_scene_to_bop_torch.py`) against
`tools/convert_scene_to_bop.py`, and the reader additions
(`DataReader.get_video_name` / `get_xyz_map`,
`FoundationPose.compute_add_err_to_gt_pose`)."""
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from sixdof_tpu.io.bop_reader import BopSceneReader as JBop
from sixdof_tpu.io.readers import DataReader as JReader
from sixdof_tpu_torch.io.bop_reader import BopSceneReader as TBop
from sixdof_tpu_torch.io.png import read_png
from sixdof_tpu_torch.io.readers import DataReader

cv2 = pytest.importorskip("cv2")

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import convert_scene_to_bop as jconvert  # noqa: E402
from tools import convert_scene_to_bop_torch as tconvert  # noqa: E402


def _write_bop_scene(root):
    """A two-frame BOP scene with two instances (obj 3 hides part of obj 7)
    and obj 7's model with a discrete symmetry."""
    from sixdof_tpu.io.mesh_io import TriMesh, save_mesh

    scene = os.path.join(root, "test", "000001")
    models = os.path.join(root, "models")
    for sub in ("rgb", "depth", "mask_visib", "mask"):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)
    os.makedirs(models, exist_ok=True)
    H, W = 60, 80
    cam, gt, gt_info = {}, {}, {}
    for fid in (0, 1):
        rgb = np.full((H, W, 3), 40, dtype=np.uint8)
        rgb[10:30, 20:50] = [200, 50, 50]
        rgb[fid, :] = [1, 2, 3]
        cv2.imwrite(f"{scene}/rgb/{fid:06d}.png", rgb[..., ::-1])
        depth = np.zeros((H, W), dtype=np.uint16)
        depth[10:30, 20:50] = 5000 + 7 * fid  # * 0.1 scale / 1000 = 0.5 m
        depth[0, 0] = 5  # under 1 mm
        cv2.imwrite(f"{scene}/depth/{fid:06d}.png", depth)
        m0 = np.zeros((H, W), dtype=np.uint8)
        m0[12:20, 22:30] = 255
        m1 = np.zeros((H, W), dtype=np.uint8)
        m1[10:30, 20:50] = 255
        m1_vis = m1.copy()
        m1_vis[12:20, 22:30] = 0  # hidden by instance 0
        cv2.imwrite(f"{scene}/mask_visib/{fid:06d}_000000.png", m0)
        if fid == 0:  # frame 1 falls back to the amodal mask
            cv2.imwrite(f"{scene}/mask_visib/{fid:06d}_000001.png", m1_vis)
        cv2.imwrite(f"{scene}/mask/{fid:06d}_000001.png", m1)
        cam[str(fid)] = {"cam_K": [300.0, 0, 40, 0, 300.0, 30, 0, 0, 1], "depth_scale": 0.1}
        gt[str(fid)] = [
            {"obj_id": 3, "cam_R_m2c": list(np.eye(3).reshape(-1)), "cam_t_m2c": [0, 0, 450.0]},
            {"obj_id": 7, "cam_R_m2c": list(np.eye(3).reshape(-1)),
             "cam_t_m2c": [10.0, -5.0, 500.0 + fid]},
        ]
        gt_info[str(fid)] = [{"visib_fract": 1.0}, {"visib_fract": 0.8}]
    for name, payload in (("scene_camera", cam), ("scene_gt", gt), ("scene_gt_info", gt_info)):
        with open(f"{scene}/{name}.json", "w") as f:
            json.dump(payload, f)
    v = np.array([[0, 0, 0], [40.0, 0, 0], [0, 40.0, 0], [0, 0, 40.0]])
    fcs = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    save_mesh(f"{models}/obj_000007.ply", TriMesh(v, fcs))
    save_mesh(f"{models}/obj_000003.ply", TriMesh(v * 0.5 + 3.0, fcs))
    flip = [-1.0, 0, 0, 0, 0, -1.0, 0, 0, 0, 0, 1.0, 20.0, 0, 0, 0, 1.0]
    with open(f"{models}/models_info.json", "w") as f:
        json.dump({"7": {"diameter": 69.28, "symmetries_discrete": [flip]},
                   "3": {"diameter": 50.0, "symmetries_continuous": [
                       {"axis": [0, 0, 1], "offset": [0, 0, 0]}]}}, f)
    return scene


def _assert_same_value(a, b):
    if b is None or isinstance(b, (int, float, str)):
        assert a == b
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype, (np.asarray(a).dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _assert_readers_equal(t, j):
    assert len(t) == len(j) and t.get_video_name() == j.get_video_name()
    assert (t.ob_id, t.color_H, t.color_W, t.downscale) == (j.ob_id, j.color_H, j.color_W,
                                                            j.downscale)
    for i in range(len(j)):
        for name in ("get_K", "get_color", "get_depth", "get_mask", "get_gt_pose",
                     "get_visib_fract", "get_occ_mask"):
            _assert_same_value(getattr(t, name)(i), getattr(j, name)(i))
        _assert_same_value(t.get_mask(i, visib_only=False), j.get_mask(i, visib_only=False))
    tm, jm = t.get_gt_mesh(), j.get_gt_mesh()
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    _assert_same_value(t.get_model_diameter(), j.get_model_diameter())
    for step in (5, 45):
        _assert_same_value(t.get_symmetry_tfs(step), j.get_symmetry_tfs(step))


@pytest.mark.parametrize("shorter_side", [None, 30, 45])
@pytest.mark.parametrize("ob_id", [None, 7])
def test_reader_matches_jax_on_fixture(tmp_path, shorter_side, ob_id):
    scene = _write_bop_scene(str(tmp_path))
    _assert_readers_equal(TBop(scene, ob_id=ob_id, shorter_side=shorter_side),
                          JBop(scene, ob_id=ob_id, shorter_side=shorter_side))


def test_reader_raises_on_jpeg_frames(tmp_path):
    """JPEG frames, once refused, now read as the JAX reader's cv2.imread
    reads them: the fixture's frames re-saved as JPEG (frame 0 at cv2's
    default quality, frame 1 by PIL at 4:4:4), every getter equal."""
    scene = _write_bop_scene(str(tmp_path))
    for fid in (0, 1):
        png_path = f"{scene}/rgb/{fid:06d}.png"
        bgr = cv2.imread(png_path)
        os.remove(png_path)
        if fid == 0:
            cv2.imwrite(f"{scene}/rgb/{fid:06d}.jpg", bgr)
        else:
            from PIL import Image

            Image.fromarray(bgr[..., ::-1]).save(f"{scene}/rgb/{fid:06d}.jpg", subsampling=0)
    _assert_readers_equal(TBop(scene, shorter_side=45), JBop(scene, shorter_side=45))
    np.testing.assert_array_equal(TBop(scene).get_color(1), JBop(scene).get_color(1))


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """synth_box and synth_occl converted by both tools."""
    out = {}
    for scene in ("synth_box", "synth_occl"):
        root = tmp_path_factory.mktemp(scene)
        src = os.path.join(REPO, "demo_data", scene)
        out[scene] = (tconvert.main(src, str(root / "port"), obj_id=1),
                      jconvert.main(src, str(root / "jax"), obj_id=1))
    return out


@pytest.mark.parametrize("scene", ["synth_box", "synth_occl"])
def test_converter_tree_matches_jax(converted, scene):
    port, jax_ = converted[scene]
    files = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)  # noqa: E731
                                for d, _, fs in os.walk(root) for f in fs)
    port_root, jax_root = (os.path.dirname(os.path.dirname(p)) for p in (port, jax_))
    assert files(port_root) == files(jax_root)
    for rel in files(port_root):
        a, b = os.path.join(port_root, rel), os.path.join(jax_root, rel)
        if rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif rel.endswith(".png"):
            ref = cv2.imread(b, -1)
            np.testing.assert_array_equal(read_png(a), ref, err_msg=rel)
            np.testing.assert_array_equal(cv2.imread(a, -1), ref, err_msg=rel)
        else:  # the model's PLY
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("shorter_side", [None, 240])
def test_reader_matches_jax_on_converted_scene(converted, shorter_side):
    _, jax_scene = converted["synth_box"]
    _assert_readers_equal(TBop(jax_scene, shorter_side=shorter_side),
                          JBop(jax_scene, shorter_side=shorter_side))


def test_data_reader_additions_match_jax():
    scene = os.path.join(REPO, "demo_data", "synth_box")
    t, j = DataReader(scene, shorter_side=120), JReader(scene, shorter_side=120)
    assert t.get_video_name() == j.get_video_name() == "synth_box"
    got, want = t.get_xyz_map(1), j.get_xyz_map(1)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_add_err_to_gt_pose_matches_jax():
    from sixdof_tpu.estimater import FoundationPose as JFP
    from sixdof_tpu.io.mesh_io import load_mesh as jload
    from sixdof_tpu_torch.estimater import FoundationPose as TFP
    from sixdof_tpu_torch.io.mesh_io import load_mesh as tload
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

    path = os.path.join(REPO, "demo_data", "synth_box", "mesh", "model_scaled_down.obj")
    jm, tm = jload(path), tload(path)
    stub = types.SimpleNamespace(cfg={})  # the engine only sets its culling flag here
    jest = JFP(model_pts=jm.vertices, model_normals=jm.vertex_normals, mesh=jm,
               refiner=stub, scorer=stub)
    test = TFP(model_pts=tm.vertices, model_normals=tm.vertex_normals, mesh=tm, device="cpu",
               refiner=PoseRefinePredictor("cpu", cfg={"input_resize": (32, 32)}),
               scorer=ScorePredictor("cpu", cfg={"input_resize": (32, 32)}))
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, :3, 3] = np.random.RandomState(0).randn(3, 3) * 0.01
    np.testing.assert_array_equal(test.compute_add_err_to_gt_pose(poses), -np.ones(3))
    jest.gt_pose = test.gt_pose = poses[0] + 0.001
    np.testing.assert_array_equal(test.compute_add_err_to_gt_pose(poses),
                                  jest.compute_add_err_to_gt_pose(poses))
