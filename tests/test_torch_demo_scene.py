"""tools/make_demo_scene_torch.py against tools/make_demo_scene.py on the
CPU at a reduced frame (96x128) and 2 frames, for every variant the demo
data has (box, clutter, occl, recon, and box and clutter with the sensor
model), held to the gates of chip_smoke.py's phase `scene`
(tools/make_demo_scene_torch.py::SCENE_GATES): poses, configs, meshes,
model.ply, the background cloud, the heatmap and the masks bit-equal;
depth, RGB and the scene clouds within the float32 raster rounding the
gates state.  Also the command line's variant inference."""
import filecmp
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_demo_scene as jscene  # noqa: E402
import make_demo_scene_torch as tscene  # noqa: E402
import sensor_model as jsm  # noqa: E402

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

H, W, N = 96, 128, 2


@pytest.mark.parametrize("variant,sensor", [("box", False), ("clutter", False),
                                            ("occl", False), ("recon", False),
                                            ("box", True), ("clutter", True)])
def test_port_scene_matches_jax_tool(tmp_path, variant, sensor):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jscene.main(a, N, H=H, W=W, variant=variant, sensor=sensor)
    stats = {}
    tscene.main(b, N, H=H, W=W, variant=variant, sensor=sensor, device="cpu", stats=stats)
    diff = tscene.compare_scenes(a, b, N)
    assert tscene.scene_breaches(diff) == [], diff
    assert filecmp.cmp(f"{a}/configs/icp_parameters.json", f"{b}/configs/icp_parameters.json",
                       shallow=False)
    assert stats["frames"] == N and set(stats["seconds"]) == {"render", "sensor", "write"}
    K = np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]])
    want = jsm.perturb_K(K, np.random.RandomState(0)) if sensor else K
    np.testing.assert_array_equal(stats["K_render"], want)


@pytest.mark.parametrize("argv,want", [
    (["demo_data/synth_box"], ("demo_data/synth_box", 6, "box", False)),
    (["out/synth_clutter_sensor", "6"], ("out/synth_clutter_sensor", 6, "clutter", True)),
    (["out/synth_occl", "3"], ("out/synth_occl", 3, "occl", False)),
    (["out/synth_box_recon", "40"], ("out/synth_box_recon", 40, "recon", False)),
    (["out/x", "2", "box_sensor"], ("out/x", 2, "box", True)),
    (["out/x", "2", "clutter", "--sensor", "--device", "cpu"], ("out/x", 2, "clutter", True)),
])
def test_command_line_infers_the_variant(argv, want):
    got = tscene.parse_args(argv)
    assert (got["out_dir"], got["n_frames"], got["variant"], got["sensor"]) == want
