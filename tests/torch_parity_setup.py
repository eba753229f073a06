"""The pose servers of both packages on one demo scene, for the parity
tests of the scenes other than synth_box (tests/test_torch_parity_scenes.py,
tests/test_torch_parity_clutter.py): the bundled weights through the JAX
predictors, converted for the port by `sixdof_tpu_torch/models/weights.py`,
in float32, with 64x64 crops, 32x32 coarse renders and a reduced grid."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sixdof_tpu.estimater import FoundationPose as JFP
from sixdof_tpu.io.mesh_io import load_mesh as j_load
from sixdof_tpu.models.predict import PoseRefinePredictor as JRef
from sixdof_tpu.models.predict import ScorePredictor as JSc
from sixdof_tpu_torch.estimater import FoundationPose as TFP
from sixdof_tpu_torch.io.mesh_io import load_mesh as t_load
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.models.predict import PoseRefinePredictor as TRef
from sixdof_tpu_torch.models.predict import ScorePredictor as TSc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 64 hypotheses and 5 register iterations: at 16 or 32 hypotheses the top
# pose of synth_box_sensor, or the order of synth_clutter's near-equal
# scores, can differ between the packages; the file's time is set by JAX's
# compiles, not by these counts
N_HYPOTHESES, REG_ITERS, TRACK_ITERS = 64, 5, 2
CFG = {"input_resize": (64, 64)}


def rot_deg(R1, R2):
    chord = np.linalg.norm(R1 - R2) / (2.0 * np.sqrt(2.0))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, chord))))


def load_predictors():
    """(JAX refiner, JAX scorer, port refiner, port scorer), bundled weights."""
    os.environ["SIXDOF_AOT_CACHE"] = ""
    jr = JRef(cfg=CFG, ckpt_dir=os.path.join(REPO, "weights", "refiner"),
              compute_dtype=jnp.float32)
    js = JSc(cfg=CFG, ckpt_dir=os.path.join(REPO, "weights", "scorer"),
             compute_dtype=jnp.float32)
    tr = TRef("cpu", cfg=CFG, params=jax.tree.map(np.asarray, jr.params),
              compute_dtype=torch.float32)
    ts = TSc("cpu", cfg=CFG, params=jax.tree.map(np.asarray, js.params),
             compute_dtype=torch.float32)
    return jr, js, tr, ts


def engines(predictors, scene, debug_dir):
    """Both FoundationPose engines on @scene's mesh, the same reduced grid;
    and the scene's reader at shorter side 240."""
    jr, js, tr, ts = predictors
    path = os.path.join(REPO, "demo_data", scene, "mesh", "model_scaled_down.obj")
    jm, tm = j_load(path), t_load(path)
    kw = dict(prune_to=4, coarse_hw=(32, 32))
    jest = JFP(model_pts=jm.vertices, model_normals=jm.vertex_normals, mesh=jm, scorer=js,
               refiner=jr, debug_dir=str(debug_dir), **kw)
    test = TFP(model_pts=tm.vertices, model_normals=tm.vertex_normals, mesh=tm, device="cpu",
               refiner=tr, scorer=ts, **kw)
    step = len(jest.rot_grid) // N_HYPOTHESES
    jest.rot_grid = jest.rot_grid[::step][:N_HYPOTHESES]
    test.rot_grid = test.rot_grid[::step][:N_HYPOTHESES]
    return jest, test, DataReader(os.path.join(REPO, "demo_data", scene), shorter_side=240)


def register_both(jest, test, reader):
    """Register frame 0 in both packages; returns (JAX pose, port pose)."""
    K = reader.color_K
    color, depth = reader.get_color(0), reader.get_depth(0)
    mask = reader.get_mask(color, 0).astype(bool)
    pj = jest.register(K=K, rgb=color, depth=depth, ob_mask=mask, iteration=REG_ITERS)
    pt = test.register(K=K, rgb=color, depth=depth, ob_mask=mask, iteration=REG_ITERS)
    return pj, pt
