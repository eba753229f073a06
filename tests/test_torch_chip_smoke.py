"""chip_smoke.py rehearsed on the CPU at a tiny size: every phase runs (K1
and K2 through their plain versions, the pose server twice on the bundled
weights, the accuracy phase, the capture path and the run loop twice) and
the kernels line has the keys the card run reports."""
import json
import os
import sys

import torch

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms"}


def test_chip_smoke_rehearsal_on_cpu(capsys):
    sys.path.insert(0, REPO)
    import chip_smoke

    kernels = chip_smoke.run("cpu", small=True)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    phases = [x.get("phase") for x in lines]
    assert phases.count("k1") == 5 and "pose" in phases
    assert phases.count("k2") == 4 and "capture" in phases
    assert phases.index("pose") < phases.index("accuracy") < phases.index("capture")
    assert lines[-1] == {"kernels": kernels}
    assert [k["name"] for k in kernels] == ["raster_zbuffer", "ray_mesh_intersect"]
    for k in kernels:
        assert KEYS <= set(k) and k["route"] == "cuda" and k["bound_by"] in ("bytes",
                                                                             "operations")
        assert os.path.exists(os.path.join(REPO, k["source"]))
        path, line = k["replaces"].split(":")
        assert "pallas_call" in open(os.path.join(REPO, path)).read().splitlines()[int(line) - 1]
        assert k["max_abs_err"] == 0.0 and k["library_ms"] is None
    k1 = [x for x in lines if x.get("phase") == "k1"]
    assert [x["triangles"] for x in k1] == [1280] * 4 + [5120]
    assert all(x["tid_mismatch"] == 0 and x["max_abs_depth_err"] == 0.0 for x in k1)
    assert all(0 < x["mean_region_survivors"] <= x["mean_tile_survivors"] <= x["mean_count"]
               for x in k1)
    assert all(0 < x["bound_ms"] <= x["brute_bound_ms"] for x in k1)
    pose = next(x for x in lines if x.get("phase") == "pose")
    assert len(pose["adds_m"]) == 3 and max(pose["vs_plain_rot_deg"]) == 0.0
    k2 = [x for x in lines if x.get("phase") == "k2"]
    assert [x["shape"] for x in k2] == ["heatmap", "max_defect_rays", "full_frame",
                                        "mixed_origins"]
    assert k2[0]["rays"] == 587 and k2[0]["triangles"] == 1280
    assert all(x["bit_equal"] and x["hits_equal"] and x["hits"] > 0 for x in k2)
    assert all(0 < x["bound_ms"] <= x["brute_bound_ms"] for x in k2)
    assert all(0 < x["cone_pairs"] <= x["pairs"] for x in k2)
    # the cull keeps few triangles a block of the heatmap's rays and of the
    # frame's, all of them where the rays share no origin
    assert all(k2[i]["survivors_per_block"]["mean"] < 0.2 * 1280 for i in (0, 2))
    assert k2[3]["survivors_per_block"] == {"mean": 1280.0, "max": 1280}
    # accuracy: at this size the phase only runs and reports, beside the JAX
    # package's values and the ceilings the card run holds
    acc = next(x for x in lines if x.get("phase") == "accuracy")
    assert acc["frames"] == 3
    m = acc["metrics"]
    for name, ceiling in chip_smoke.ACCURACY_CEILINGS.items():
        assert m[name]["ceiling"] == ceiling and m[name]["card"] is not None
    for name in ("adds_mean_m", "add_mean_m", "adds_auc_0.1d", "rot_err_deg_mean",
                 "icp_fitness", "icp_adds_mm", "defect_pts", "defect_surface_median_dist_mm"):
        assert isinstance(m[name]["jax_parity_r5"], float) or name == "defect_pts", name
    assert m["defect_pts"]["jax_parity_r5"] == 587
    assert {"register_adds_m_mean", "track_adds_m_mean", "register_rot_err_deg_mean",
            "track_t_err_m_mean"} <= set(m)
    cap = next(x for x in lines if x.get("phase") == "capture")
    assert cap["a"]["refine_fitness"] >= 0.9 and cap["a"]["defect_points"] > 0
    assert [c["frame"] for c in cap["b"]["captures"]] == [0, 2]
    assert cap["vs_plain"]["loop_tf_max_abs_diff"] == 0.0
