"""tools/eval_register_torch.py against tools/eval_register.py's
computations on synth_box frame 0 on the CPU.  The JAX tool runs at
import, so its steps are rebuilt here from its own calls (DataReader,
preprocess_depth, depth2xyzmap, so3_exp_map on RandomState(deg) draws,
refine_poses_jit, adds_err, ScorePredictor.predict) on the same inputs.
Both sides take the reduced setup of tests/torch_parity_setup.py: the
bundled weights in float32 (the port's loaded from a checkpoint written
by parallel/train.py::save_params), 64x64 crops and 64 hypotheses of the
grid.

Tolerances: refined rotations within 0.5 deg and translations within
2e-4 m of JAX's (the register parity tests'), ADD-S within 2e-4 m;
the rank of the truly best hypothesis equal, or the hypotheses between
the two ranks tied with it within bf16 score noise (2^-8 relative)."""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity_setup import CFG, N_HYPOTHESES, load_predictors, rot_deg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import eval_register_torch as er  # noqa: E402

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SCENE = os.path.join(REPO, "demo_data", "synth_box")
ROT_DEG_TOL, TRANS_M_TOL, ADDS_M_TOL = 0.5, 2e-4, 2e-4
BF16_REL = 2.0 ** -8


def reduce_grid(est):
    """Every third pose of the 252-pose grid, 64 of them (both packages)."""
    step = len(est.rot_grid) // N_HYPOTHESES
    est.rot_grid = est.rot_grid[::step][:N_HYPOTHESES]
    return est


def write_candidate(out_dir, tr, ts, refiner_cfg=None):
    """The port's float32 predictors' weights as a trainer checkpoint."""
    from sixdof_tpu_torch.parallel.train import save_params

    save_params(str(out_dir), "refiner", tr.model, refiner_cfg)
    save_params(str(out_dir), "scorer", ts.model)
    return str(out_dir)


@contextlib.contextmanager
def reduced_port(mp):
    """The port's engine at 64 hypotheses and its predictors at 64x64 crops
    in float32, loading whatever checkpoint the tool names."""
    from sixdof_tpu_torch import estimater
    from sixdof_tpu_torch.models import predict

    base = estimater.FoundationPose

    class Reduced(base):
        def __init__(self, **kw):
            super().__init__(**kw)
            reduce_grid(self)

    def sized(cls):
        return lambda device=None, ckpt_dir=None: cls(device, cfg=CFG, ckpt_dir=ckpt_dir,
                                                      compute_dtype=torch.float32)

    for name in ("PoseRefinePredictor", "ScorePredictor"):
        mp.setattr(predict, name, sized(getattr(predict, name)))
    mp.setattr(estimater, "FoundationPose", Reduced)
    yield


@pytest.fixture(scope="module")
def predictors():
    return load_predictors()


@pytest.fixture(scope="module")
def port(predictors, tmp_path_factory):
    """The tool's main on the reduced setup: (returned results, stdout)."""
    _, _, tr, ts = predictors
    cand = write_candidate(tmp_path_factory.mktemp("cand"), tr, ts)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, reduced_port(mp), contextlib.redirect_stdout(out):
        mp.delenv("OCC_SUB", raising=False)
        res = er.main(SCENE, weights_dir=cand, device="cpu")
    return res, out.getvalue()


@pytest.fixture(scope="module")
def jax_side(predictors):
    """eval_register.py's set-up and refine, on the JAX package."""
    import jax.numpy as jnp

    from sixdof_tpu.estimater import FoundationPose
    from sixdof_tpu.io.mesh_io import load_mesh
    from sixdof_tpu.io.readers import DataReader
    from sixdof_tpu.models.predict import refine_poses_jit
    from sixdof_tpu.ops.depth_filter import preprocess_depth
    from sixdof_tpu.ops.geometry import depth2xyzmap

    jr, js, _, _ = predictors

    class Args:
        debug = 0
        box = None
        mesh = None
        voxel_size = None

    reader = DataReader(base_dir=SCENE, shorter_side=None, zfar=np.inf, arguments=Args())
    mesh = load_mesh(f"{SCENE}/mesh/model_scaled_down.obj")
    est = reduce_grid(FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals,
                                     mesh=mesh, refiner=jr, scorer=js))
    color, depth = reader.get_color(0), reader.get_depth(0)
    pose_c_gt = reader.get_gt_pose(0) @ np.linalg.inv(est.get_tf_to_centered_mesh())
    depth_f = preprocess_depth(jnp.asarray(depth, dtype=jnp.float32))
    xyz_map = depth2xyzmap(depth_f, jnp.asarray(reader.color_K, dtype=jnp.float32))
    rgb01 = jnp.asarray(color, dtype=jnp.float32) / 255.0
    K = jnp.asarray(reader.color_K, dtype=jnp.float32)

    def refine(poses, iters):
        return np.asarray(refine_poses_jit(
            jr.model, jr.params, est.mesh_tensors, jnp.asarray(poses, dtype=jnp.float32), rgb01,
            xyz_map, K, float(est.diameter), 1.2, 0.02, 0.3490658503988659, iterations=iters,
            out_hw=CFG["input_resize"], occ_sub=False))

    return dict(est=est, reader=reader, color=color, depth_f=depth_f, pose_c_gt=pose_c_gt,
                refine=refine, scorer=js)


def _close(got, ref):
    """Largest rotation (deg) and translation (m) differences of two pose sets."""
    rot = max(rot_deg(a[:3, :3], b[:3, :3]) for a, b in zip(got, ref))
    trans = float(np.abs(np.asarray(got)[:, :3, 3] - np.asarray(ref)[:, :3, 3]).max())
    return rot, trans


def test_basin_matches_jax(port, jax_side):
    import jax.numpy as jnp

    from sixdof_tpu.metrics import rotation_angle_deg
    from sixdof_tpu.ops.lie import so3_exp_map

    res, _ = port
    gt = jax_side["pose_c_gt"]
    assert [r["deg"] for r in res["basin"]] == [5, 10, 20, 30, 45]
    for rec in res["basin"]:
        deg = rec["deg"]
        perts = []  # eval_register.py's draws, verbatim
        rng = np.random.RandomState(deg)
        for _ in range(8):
            ax = rng.randn(3)
            ax = ax / np.linalg.norm(ax) * np.deg2rad(deg)
            dR = np.eye(4)
            dR[:3, :3] = np.asarray(so3_exp_map(jnp.asarray(ax[None])))[0]
            p = gt.copy()
            p[:3, :3] = dR[:3, :3] @ p[:3, :3]
            p[:3, 3] += rng.uniform(-0.01, 0.01, 3)
            perts.append(p)
        np.testing.assert_allclose(rec["start"], np.stack(perts), atol=1e-6)
        out = jax_side["refine"](np.stack(perts), 5)
        assert np.abs(out - rec["start"]).max() > 1e-3  # the refiner moved them
        rot, trans = _close(rec["poses"], out)
        assert rot <= ROT_DEG_TOL and trans <= TRANS_M_TOL, (deg, rot, trans)
        errs = [rotation_angle_deg(o[:3, :3], gt[:3, :3]) for o in out]
        np.testing.assert_allclose(rec["rot_deg"], errs, atol=ROT_DEG_TOL)
        np.testing.assert_allclose(rec["t_mm"],
                                   [np.linalg.norm(o[:3, 3] - gt[:3, 3]) * 1000 for o in out],
                                   atol=TRANS_M_TOL * 1000)


def _jax_grid(jax_side):
    from sixdof_tpu.metrics import adds_err, rotation_angle_deg

    est, reader, gt = jax_side["est"], jax_side["reader"], jax_side["pose_c_gt"]
    mask = reader.get_mask(jax_side["color"], 0).astype(bool)
    center = est.guess_translation(depth=np.asarray(jax_side["depth_f"]), mask=mask,
                                   K=reader.color_K)
    poses0 = est.rot_grid.copy()
    poses0[:, :3, 3] = center
    refined = jax_side["refine"](poses0, 5)
    adds = np.array([adds_err(p, gt, np.asarray(est.pts)) for p in refined])
    rots = np.array([rotation_angle_deg(p[:3, :3], gt[:3, :3]) for p in refined])
    return center, refined, adds, rots


@pytest.fixture(scope="module")
def jax_grid(jax_side):
    return _jax_grid(jax_side)


def test_refined_grid_matches_jax(port, jax_grid):
    res, _ = port
    center, refined, adds, rots = jax_grid
    grid = res["grid"]
    assert grid["poses"].shape == (N_HYPOTHESES, 4, 4)
    np.testing.assert_allclose(grid["center"], center, atol=1e-6)
    rot, trans = _close(grid["poses"], refined)
    assert rot <= ROT_DEG_TOL and trans <= TRANS_M_TOL, (rot, trans)
    np.testing.assert_allclose(grid["adds"], adds, atol=ADDS_M_TOL)
    np.testing.assert_allclose(grid["rots"], rots, atol=ROT_DEG_TOL)
    summary = res["summary"]["grid"]
    assert summary["best_adds_idx"] == int(adds.argmin())
    assert summary["n_rot_lt10"] == int((rots < 10).sum())


def _tied(scores, order, rank_a, rank_b):
    """The hypotheses ranked from @rank_a to @rank_b score within bf16 noise."""
    lo, hi = sorted((rank_a, rank_b))
    s = scores[order[lo:hi + 1]]
    return float(s.max() - s.min()) <= BF16_REL * float(np.abs(s).max())


def test_ranking_matches_jax(port, jax_side, jax_grid):
    res, _ = port
    _, refined, adds, rots = jax_grid
    est = jax_side["est"]
    scores, _ = jax_side["scorer"].predict(
        mesh=est.mesh, rgb=jax_side["color"], depth=jax_side["depth_f"],
        K=jax_side["reader"].color_K, ob_in_cams=refined, mesh_tensors=est.mesh_tensors,
        mesh_diameter=est.diameter)
    scores = np.asarray(scores)
    order = np.argsort(-scores)
    jax_rank = list(order).index(int(adds.argmin()))
    rank = res["ranking"]
    assert rank["true_best_rank"] == jax_rank or _tied(
        rank["scores"], rank["order"], rank["true_best_rank"], jax_rank), \
        (rank["true_best_rank"], jax_rank)
    for r, top in enumerate(rank["top"]):
        assert top["rank"] == r
        assert top["idx"] == int(order[r]) or _tied(scores, order, r,
                                                    list(order).index(top["idx"]))
        assert abs(top["score"] - scores[top["idx"]]) <= BF16_REL * abs(scores[top["idx"]])
        assert abs(top["adds_mm"] - adds[top["idx"]] * 1000) <= ADDS_M_TOL * 1000
        assert abs(top["rot_deg"] - rots[top["idx"]]) <= ROT_DEG_TOL


def test_main_prints_the_jax_tools_lines_and_one_json_line(port):
    res, out = port
    lines = out.splitlines()
    assert lines[0] == "=== refiner basin (rot_err before -> after 5 iters) ==="
    assert [x.split("deg")[0].strip() for x in lines[1:6]] == ["5", "10", "20", "30", "45"]
    assert all(" -> rot after: med " in x and "| t med " in x for x in lines[1:6])
    assert lines[6] == "=== refined grid quality ==="
    assert lines[7].startswith("  best ADD-S: ") and lines[8].startswith("  # hyps with rot<10deg")
    assert lines[9] == "=== ranking (hybrid) ==="
    assert [x.split(":")[0] for x in lines[10:15]] == [f"  rank{r}" for r in range(5)]
    assert lines[15] == f"  rank of true-best hyp: {res['ranking']['true_best_rank']}"
    summary = json.loads(lines[16])
    assert len(lines) == 17 and summary == json.loads(json.dumps(res["summary"]))
    assert summary["occ_sub"] is False and summary["device"] == "cpu"
    assert set(summary) == {"scene", "weights_dir", "occ_sub", "device", "basin", "grid",
                            "ranking", "seconds"}
    assert summary["grid"]["hypotheses"] == N_HYPOTHESES


def test_occ_sub_switch_reaches_every_refine(monkeypatch):
    """OCC_SUB=1 (the JAX tool's bool(int(...))) reaches the basin's and the
    grid's refine; an explicit occ_sub, a float ceiling too, as it is."""
    seen = []

    def refine(probe, poses, iterations=5, occ_sub=False, plain_raster=False):
        seen.append(occ_sub)
        return np.asarray(poses, dtype=np.float32)

    class Est:
        device = torch.device("cpu")

    def ranking(probe, grid):
        return dict(top=[], true_best_rank=0, order=np.arange(1), scores=np.zeros(1))

    gt = np.eye(4)
    probe = er.Probe(est=Est(), refiner=None, scorer=None, color=None, depth_f=None,
                     xyz_map=None, rgb01=None, K=None, mask=None, pose_c_gt=gt, model_pts=None)
    grid = dict(center=np.zeros(3), poses=np.tile(gt, (1, 1, 1)), adds=np.zeros(1),
                rots=np.zeros(1))
    monkeypatch.setattr(er, "load", lambda *a: probe)
    monkeypatch.setattr(er, "refine", refine)
    monkeypatch.setattr(er, "refined_grid", lambda p, occ_sub=False: seen.append(occ_sub)
                        or grid)
    monkeypatch.setattr(er, "ranking", ranking)
    monkeypatch.setenv("OCC_SUB", "1")
    with contextlib.redirect_stdout(io.StringIO()):
        assert er.main(device="cpu")["summary"]["occ_sub"] is True
        assert seen == [True] * 6
        seen.clear()
        er.main(occ_sub=0.85, device="cpu")
    assert seen == [0.85] * 6 and all(type(s) is float for s in seen)


def test_imports_without_running():
    """Importing the tool runs nothing: no output, no device asked for,
    no engine module loaded, its functions there."""
    code = """
import sys
sys.path.insert(0, "tools")
import eval_register_torch as er
print("LOADED", [m for m in ("sixdof_tpu_torch.estimater", "sixdof_tpu_torch.models.predict")
                 if m in sys.modules])
print("API", all(callable(getattr(er, f)) for f in ("main", "basin", "refined_grid", "ranking")))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["LOADED []", "API True"]
