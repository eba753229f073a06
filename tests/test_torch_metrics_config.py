"""Pose metrics and pose-path configuration of the port against the JAX package."""
import dataclasses

import numpy as np
import pytest
import torch

from sixdof_tpu import metrics as jmet
from sixdof_tpu.config import PipelineConfig as JConfig
from sixdof_tpu.ops.lie import so3_exp_map
from sixdof_tpu_torch import metrics as tmet
from sixdof_tpu_torch.config import PipelineConfig as TConfig

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def test_pipeline_config_defaults_match_jax():
    j, t = JConfig(), TConfig()
    shared = ({f.name for f in dataclasses.fields(TConfig)}
              & {f.name for f in dataclasses.fields(JConfig)})
    assert {"est_refine_iter", "track_refine_iter", "input_resize", "test_scene_dir"} <= shared
    for name in shared:
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("seed", [0, 1])
def test_add_adds(seed):
    rng = np.random.RandomState(seed)
    pts = rng.randn(300, 3) * 0.05
    a, b = np.eye(4), np.eye(4)
    a[:3, :3] = np.asarray(so3_exp_map(rng.randn(3) * 0.3))
    a[:3, 3] = rng.randn(3) * 0.01
    b[:3, 3] = [0.5, 0, 0.5]
    assert tmet.add_err(a, b, pts) == jmet.add_err(a, b, pts)
    assert tmet.adds_err(a, b, pts) == pytest.approx(jmet.adds_err(a, b, pts), abs=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_auc_and_rotation_angle(seed):
    rng = np.random.RandomState(seed)
    errs = np.abs(rng.randn(40)) * 0.004
    for max_val in (0.0097, 0.1):
        assert tmet.compute_auc(errs, max_val=max_val) == pytest.approx(
            jmet.compute_auc(errs, max_val=max_val), abs=1e-12)
    R1 = np.asarray(so3_exp_map(rng.randn(3) * 0.5), dtype=np.float64)
    R2 = np.asarray(so3_exp_map(rng.randn(3) * 0.5), dtype=np.float64)
    assert tmet.rotation_angle_deg(R1, R2) == jmet.rotation_angle_deg(R1, R2)
