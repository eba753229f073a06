"""The track step's frame decode and depth filters: the port's `track_pose`
against the JAX track program (`sixdof_tpu/models/predict.py::track_pose_jit`).

XLA compiles a division by a constant into a multiply by the constant's
float32 reciprocal, so the compiled program's `depth_mm / 1000.0` and
`rgb / 255.0` are multiplies.  The port decodes the same way
(`unpack_rgbd`): bit-equal over every input value.  Erosion's 1 mm test then
sees the same depth, so the filtered depth that both track steps return has
the same non-zero pattern; the values agree to 1e-6 m (XLA sums the
bilateral window in another order, ROADMAP.md)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sixdof_tpu.io.mesh_io import load_mesh as j_load
from sixdof_tpu.models import predict as jp
from sixdof_tpu.ops.rasterize import make_mesh_arrays as j_arrays
from sixdof_tpu_torch.io.mesh_io import load_mesh
from sixdof_tpu_torch.io.readers import DataReader
from sixdof_tpu_torch.models import predict as tp
from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays as t_arrays

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "demo_data", "synth_box")
DEPTH_ATOL_M = 1e-6
HW = (32, 32)  # crop size of the (seeded) refiner: the depth does not depend on it


def _every_value_frame():
    """A (256,256,5) packed frame: every uint16 depth once, every uint8
    colour value in every channel."""
    depth = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    rgb = np.stack([np.tile(np.arange(256, dtype=np.uint8), (256, 1))] * 3, axis=-1)
    rgb[..., 1] = rgb[..., 1].T
    return tp.pack_rgbd(rgb, depth)


@jax.jit
def _jax_decode(rgbd_u8):
    """The first lines of track_pose_jit (sixdof_tpu/models/predict.py),
    compiled as that program compiles them."""
    rgb01 = rgbd_u8[..., :3].astype(jnp.float32) / 255.0
    depth_mm = jax.lax.bitcast_convert_type(rgbd_u8[..., 3:5], jnp.uint16)
    return rgb01, depth_mm.reshape(rgbd_u8.shape[:2]).astype(jnp.float32) / 1000.0


def test_decode_bit_equal_to_the_jax_track_program():
    frame = _every_value_frame()
    rj, dj = (np.asarray(x) for x in _jax_decode(jnp.asarray(frame)))
    rt, dt = (x.numpy() for x in tp.unpack_rgbd(torch.from_numpy(frame)))
    np.testing.assert_array_equal(dt.view(np.uint32), dj.view(np.uint32))
    np.testing.assert_array_equal(rt.view(np.uint32), rj.view(np.uint32))
    assert len(np.unique(dt)) == 65536 and len(np.unique(rt)) == 256
    # a true division is what the compiled program does not do
    assert (np.arange(65536, dtype=np.float32) / np.float32(1000.0) != dj.ravel()).sum() > 30000


@pytest.fixture(scope="module")
def track_inputs():
    reader = DataReader(SCENE)
    path = os.path.join(SCENE, "mesh", "model_scaled_down.obj")
    meshes = j_arrays(j_load(path)), t_arrays(load_mesh(path), "cpu")
    K = reader.color_K.astype(np.float32)
    pose = reader.get_gt_pose(0).astype(np.float32)[None]
    frames = []
    for i in (1, 2):
        depth = np.clip(reader.get_depth(i) * 1000.0, 0, 65535).astype(np.uint16)
        frames.append(tp.pack_rgbd(np.ascontiguousarray(reader.get_color(i)), depth))
    return meshes, K, pose, frames


def test_filtered_depth_matches_the_jax_track_program(track_inputs):
    (jm, tm), K, pose, frames = track_inputs
    jr = jp.PoseRefinePredictor(cfg={"input_resize": HW}, compute_dtype=jnp.float32)
    tr = tp.PoseRefinePredictor("cpu", cfg={"input_resize": HW}, seed=0,
                                compute_dtype=torch.float32)
    scalars = (0.1, 1.2, 0.02, 0.3490658503988659)
    for frame in frames:
        _, dj = jp.track_pose_jit(jr.model, jr.params, jm, jnp.asarray(pose), jnp.asarray(frame),
                                  jnp.asarray(K), *scalars, iterations=1, out_hw=HW)
        _, dt = tp.track_pose(tr.model, tm, torch.from_numpy(pose), torch.from_numpy(frame),
                              torch.from_numpy(K), *scalars, iterations=1, out_hw=HW,
                              compute_dtype=torch.float32)
        dj, dt = np.asarray(dj), dt.numpy()
        assert (dj > 0).mean() > 0.5  # most of the frame survives the filters
        np.testing.assert_array_equal(dt > 0, dj > 0)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=DEPTH_ATOL_M)
