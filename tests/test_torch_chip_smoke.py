"""chip_smoke.py rehearsed on the CPU at a tiny size: every phase runs (K1
and K2 through their plain versions, the pose server twice on the bundled
weights, the accuracy phase, the capture path and the run loop twice, the
loop at --debug 2 and in viewer mode, the point-click path on a crust, the
--icp registration, the trainer, the JPEG decoder, the BOP campaign (on a
JPEG scene too), the live-camera loop
against a stand-in Kinect, the neural object field, the H5 path and the
multi-device path on gloo ranks of the CPU, its model axis too, the
start-up timeline in a fresh process, the parity artifact and the
evaluation of weights) and the kernels line has the keys
the card run reports; a phase that fails stops the script before its
result."""
import json
import os
import sys

import pytest
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
    assert phases.count("k1") == 7 and "pose" in phases
    assert phases.count("k2") == 4 and "capture" in phases
    assert phases.index("pose") < phases.index("accuracy") < phases.index("capture") \
        < phases.index("debug") < phases.index("viewer") < phases.index("point_click") \
        < phases.index("icp_global") < phases.index("train_k1") < phases.index("train") \
        < phases.index("jpeg") < phases.index("bop") < phases.index("live") \
        < phases.index("field") < phases.index("h5") < phases.index("multi") < phases.index("cold")
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
    assert [x["triangles"] for x in k1[:6]] == [1280] * 4 + [5120, 1280]
    assert [x["shape"] for x in k1[5:]] == ["register_full_grid", "full_grid_decimated_5000"]
    assert 0.7 * 5000 <= k1[6]["triangles"] <= 5000  # decimate_mesh's landing band
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
    # --debug 2: the staged register's images, decoded
    dbg = next(x for x in lines if x.get("phase") == "debug")
    assert set(dbg["files"]) == {"vis_refiner.png", "track_vis/0001.png",
                                 "overlay/overlay_0.png"}
    assert dbg["staged_register_s"] > 0 and dbg["fused_register_s"] > 0
    # the viewer: the button pressed after frame 0 captured on frame 1
    view = next(x for x in lines if x.get("phase") == "viewer")
    assert view["captures"] == [0, 1] and view["updates"][0]["page_has_button"]
    assert view["updates"][1]["seq"] > view["updates"][0]["seq"]
    assert all(u["points"] == u["state_points"] > 0 for u in view["updates"])
    # the point-click path on the crust, and the heatmap's rays against it
    pc = [x for x in lines if x.get("phase") == "point_click"]
    assert [x["shape"] for x in pc] == ["clicks", "heatmap"]
    assert all(x["bit_equal"] and x["hits"] > 0 and x["triangles"] > 1000 for x in pc)
    assert pc[0]["points_bit_equal"] and pc[1]["same_rays_as_cpu"]
    assert kernels[1]["launches"] == pc[0]["launches"] == 0  # the CPU takes plain K2
    # --icp: no valid RANSAC trial on synth_box in any of the 10 attempts
    icp = next(x for x in lines if x.get("phase") == "icp_global")
    assert icp["icp"]["valid_trials"] == [0] * 10 and icp["icp"]["fitness"] == 0.0
    assert icp["from_annotated"]["fitness"] >= 0.9
    assert {"fpfh", "ransac", "icp", "total"} <= set(icp["icp"]["seconds"])
    # the trainer: K1 at its two shapes (no culling), its batches through K1
    # and the plain raster alike (both plain here), a textured box written,
    # read back and rendered, training steps, the checkpoint round trip
    tk1 = [x for x in lines if x.get("phase") == "train_k1"]
    assert [(x["shape"], x["B"]) for x in tk1] == [("train_refiner", 2), ("train_scorer", 8)]
    assert all(x["tid_mismatch"] == 0 and x["max_abs_depth_err"] == 0.0 for x in tk1)
    batches, training = (next(x for x in lines if x.get("part") == p)
                         for p in ("batches", "training"))
    assert all(batches["batches_bit_equal"].values()) and len(batches["batches_bit_equal"]) == 4
    assert batches["textured"]["uv_texture_equal"] and batches["textured"]["render_bit_equal"]
    assert set(batches["overfit"]) == {"jax_test_setting", "trainer_setting"}
    assert batches["overfit"]["jax_test_setting"]["batch"] == 8
    steps = training["steps"]
    assert steps["refiner"]["steps"] == steps["scorer"]["steps"] == 3
    assert all(0 < steps[n]["batch_share"] < 1 for n in steps)
    assert all(steps[n][k]["calls"] == 2 and steps[n][k]["launches"] is None
               for n in steps for k in ("step_profile", "batch_profile"))
    assert training["k1_launches"] == 0  # the CPU renders through the plain raster
    assert training["checkpoint"] == {"outputs_bit_equal": True, "register_pose_finite": True}
    assert set(training["first_loss"]["refiner"]) == {"bundled", "from_scratch"}
    # the JPEG decoder: every fixture's digests as the manifest's, frame 0
    # timed as JPEG and PNG, the JPEG texture of an OBJ
    jpg = next(x for x in lines if x.get("phase") == "jpeg")
    assert jpg["fixtures"] == len(jpg["files"]) == 19 and jpg["texture_equal"]
    assert all(v == {"cv2": True, "pil": True} for v in jpg["files"].values())
    assert jpg["frame"]["shape"] == [480, 640, 3] and jpg["frame"]["calls"] == 3
    assert jpg["frame"]["jpeg_ms"] > 0 and jpg["frame"]["png_ms"] > 0
    # the BOP campaign: synth_box converted and run, then with its model
    # subdivided to 20,480 triangles (decimated by the tool), then with its
    # frames as JPEG beside the JAX package's numbers on them
    bop = [x for x in lines if x.get("phase") == "bop"]
    assert [(x["name"], x["prune_to"]) for x in bop] == [
        ("synth_box", 0), ("synth_box", 4), ("synth_box_20480", 0), ("synth_box_20480", 4),
        ("synth_box_jpeg", 0), ("synth_box_jpeg", 4)]
    assert bop[4]["jax_jpeg_scene"]["frames"] == 6 and bop[5]["jax_jpeg_scene"] is None
    assert bop[4]["png_frame0_pose"] == bop[0]["frame0_pose"]
    assert bop[4]["vs_png_frame0_rot_deg"] >= 0 and bop[5]["vs_png_frame0_trans_m"] >= 0
    assert bop[2]["model_triangles"] == 20480
    assert set(bop[0]["ceilings"]) == {"adds_mean_m", "rot_err_deg_mean"}
    assert set(bop[1]["ceilings"]) == {"adds_mean_m"}
    assert all(x["frames"] == 2 and x["registered_frames"] == 1 and x["k1_launches"] == 0
               and set(x["jax_parity_r5"]) >= {"adds_mean_m", "adds_auc_0.1d"} for x in bop)
    # the live loop: the background captured first, frame 0 served to the
    # heatmap's poll and to frame 0, captures on frames 0 and 2, the same
    # results through the plain versions
    live = next(x for x in lines if x.get("phase") == "live")
    assert live["served"] == ["background", 0, 0, 1, 2]
    assert [c["frame"] for c in live["captures"]] == [0, 2] and live["background_saved"]
    assert live["camera_stopped"] and len(live["adds_m"]) == 3
    assert max(live["vs_plain_rot_deg"]) == 0.0 and live["capture_tf_max_abs_diff"] == 0.0
    # the neural object field: the tool's campaign on 4 frames of
    # synth_box_recon at a tiny grid, its stages, the step split, and frame
    # 0 registered on the extracted mesh
    field = next(x for x in lines if x.get("phase") == "field")
    assert field["steps"] == 10 and field["frames"] == 4 and field["n_vertices"] > 0
    assert field["textured_mesh"].endswith("_textured.obj") and "chamfer_ok" in field
    assert set(field["stage_seconds"]) == {"rays", "train", "extract", "colour", "write", "bake",
                                           "write_textured"}
    assert all(field[k] > 0 for k in ("draw_ms", "forward_backward_ms", "adam_ms"))
    assert field["register_pose_finite"] and 0 < field["register_triangles"] <= 5000
    assert field["register_k1_launches"] == 0  # the CPU renders through the plain raster
    # the H5 path: PNG blobs bit-equal, transform_batch on the "card" (the
    # CPU here) and the CPU equal, the file written and read back (h5py is
    # here)
    h5 = next(x for x in lines if x.get("phase") == "h5")
    assert h5["pairs"] == 2 and h5["ori"] == [540, 720] and h5["png_bit_equal"]
    assert h5["rgb_bit_equal"] and h5["xyz_max_abs_diff"] == 0.0 and h5["select_by_indices_ok"]
    assert h5["h5py"] and h5["open_h5"] == "written and read back equal"
    assert all(h5[k] > 0 for k in ("png_round_trip_ms", "transform_ms", "png_bytes"))
    # the multi-device path: 2 gloo ranks on the data axis, then the
    # trainers split over a model axis on (1, 2) and (2, 2) meshes, every
    # part against rank 0's unsharded run, the ranks agreeing
    multi = next(x for x in lines if x.get("phase") == "multi")
    assert multi["backend"] == "gloo" and multi["ranks_per_card"] == 2
    assert not multi["measures_scaling"]
    parts = multi["parts"]
    assert list(parts) == ["register", "capture", "train", "field", "model", "model2d"]
    assert [parts[p]["mesh"] for p in parts] == [[2, 1]] * 4 + [[1, 2], [2, 2]]
    for part in parts.values():
        n = part["mesh"][0] * part["mesh"][1]
        assert len(part["data_axis_s"]) == n and part["seconds"] > 0
        assert part["k1_launches"] == part["k2_launches"] == [0] * n  # plain versions here
        assert (min(part["model_axis_s"]) > 0) == (part["mesh"][1] > 1)
    reg, cap = parts["register"]["checks"], parts["capture"]["checks"]
    assert reg["ranks_same_pose"] and reg["vs_unsharded_rot_deg"] <= chip_smoke.POSE_ROT_DEG_MAX
    assert cap["ranks_same"] and cap["hits_same"] and cap["padded"] == [4, 588]
    assert parts["capture"]["rays"] == 587 and cap["hits"] > 0
    for part, name in ((p, n) for p in ("train", "model", "model2d") for n in ("refiner",
                                                                               "scorer")):
        t = parts[part]["checks"][name]
        assert t["ranks_same_losses"] and t["first_grad_diff_of_max"] <= chip_smoke.MULTI_GRAD_REL
        assert t["trunk_grad_max"] > 0 and t["replicated_equal_over_model"]
        assert t["params_equal_over_data"]
        assert len(parts[part][name]["losses"]) == chip_smoke.MULTI_TRAIN_STEPS
        if part != "train":
            assert t["ckpt_same_names_shapes"] and t["ckpt_loads"] and t["ckpt_equals_gathered"]
            assert t["ckpt_held_split_entries"] > 0
            assert t["ckpt_held_max_abs_diff"] <= t["ckpt_bound"]
    assert parts["field"]["checks"]["field"]["loss_max_rel_diff"] <= chip_smoke.MULTI_LOSS_RTOL
    # the start-up path: one fresh process with the warm-up, its timeline
    # from interpreter start to the second register
    cold = next(x for x in lines if x.get("phase") == "cold")
    assert list(cold["runs"]) == ["b"]
    b = cold["runs"]["b"]
    assert b["precompile"] and not b["cold_build"] and b["device"] == "cpu"
    labels = [label for label, _ in b["marks"]]
    assert labels == ["imports (numpy, torch, the package)", "viewer", "mesh", "checkpoints",
                      "engine", "reader", "precompile started", "heatmap", "frame 0 loaded",
                      "first pose", "first defect cloud", "capture 2 start", "capture 2 end",
                      "second register"]
    times = [t for _, t in b["marks"]]
    assert times == sorted(times) and b["time_to_first_pose_s"] == times[9]
    assert 0 < b["time_to_first_pose_s"] < b["time_to_first_defect_cloud_s"]
    assert b["process_wall_s"] > b["time_to_first_defect_cloud_s"]
    assert list(b["precompile_record"]["seconds"]) == ["build", "register", "track", "capture"]
    assert b["precompile_record"]["launches"] == {} and b["loop_k1_launches"] == 0
    assert 0 <= b["warmup_beside_setup_s"] <= b["warmup_s"] and b["register_waited_s"] >= 0
    assert set(b["capture_s"]) == {"2"} and b["second_register_s"] > 0
    # the parity artifact: synth_box and the two network-mode rows at the
    # rehearsal's size beside PARITY_r5.json, the rank0 probe, the artifact
    # line with the JAX artifact's keys (and the device)
    assert phases.index("cold") < phases.index("parity") < phases.index("parity_artifact") \
        < phases.index("sweep") < phases.index("flops") < phases.index("evaluate_k1") \
        < phases.index("evaluate")
    parity = next(x for x in lines if x.get("phase") == "parity")
    assert list(parity["scenes"]) == ["synth_box"] and parity["device"] == "cpu"
    assert list(parity["network_mode"]) == ["synth_box", "synth_clutter"]
    assert parity["network_mode"]["synth_box"]["rot_err_deg_mean"]["jax_r5"] > 170
    assert parity["clutter_rank0"]["rank0_rot_deg"]["jax_r5"] < 6
    assert parity["failed"] == [] and parity["k1_launches"] == parity["k2_launches"] == 0
    art = next(x for x in lines if x.get("phase") == "parity_artifact")["artifact"]
    with open(os.path.join(REPO, "PARITY_r5.json")) as f:
        jax_keys = list(json.load(f))
    assert [k for k in art if k != "device"] == jax_keys
    assert art["tag"] == "r1" and art["weights_dir"] == "weights_torch"
    assert art["clutter_rank0"]["prune_to"] == 64 and art["scenes"]["synth_box"]["frames"] == 2
    # evaluating weights: the register diagnostics on the bundled networks,
    # the basin through the plain raster alike, K1 at the basin's B=8 shape;
    # phase train's nets as a candidate with a 0.85 gate ceiling
    ek1 = next(x for x in lines if x.get("phase") == "evaluate_k1")
    assert (ek1["shape"], ek1["B"], ek1["H"]) == ("basin", 8, 32)
    assert ek1["tid_mismatch"] == 0 and ek1["max_abs_depth_err"] == 0.0
    ev = next(x for x in lines if x.get("phase") == "evaluate")
    assert [b["deg"] for b in ev["register"]["basin"]] == [5, 10, 20, 30, 45]
    assert ev["register"]["grid"]["hypotheses"] == 8 and len(ev["register"]["ranking"]["top"]) == 5
    assert ev["basin_vs_plain"]["degs"] == [5, 20]
    assert max(ev["basin_vs_plain"]["rot_deg"]) == max(ev["basin_vs_plain"]["trans_m"]) == 0.0
    assert all(ev["checks"].values()) and set(ev["checks"]) == {
        "eval_keys", "floor_breaches", "rank0_keys", "rank0_occ_sub", "refine_occ_sub"}
    cand = ev["candidate"]
    assert cand["occ_sub_seen"] == ["0.85"] and cand["refine_calls"] > 2
    assert cand["clutter_rank0"]["occ_sub"] == 0.85
    assert set(cand["network_rot_err_deg_mean"]) == {"synth_box_network",
                                                     "synth_clutter_network"}
    assert kernels[0]["launches"] == kernels[1]["launches"] == 0


def test_bop_ceilings_are_parity_checks():
    """The bop phase holds each scene to tools/parity_check.py's
    THRESHOLDS."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from tools.parity_check import THRESHOLDS

    assert set(chip_smoke.BOP_CEILINGS) == set(THRESHOLDS)
    for scene, ceilings in chip_smoke.BOP_CEILINGS.items():
        assert ceilings == {k: THRESHOLDS[scene][k] for k in ceilings}


def test_a_failing_phase_stops_the_script(monkeypatch, capsys):
    """On the card, main() lets a phase's error through (a non-zero exit)
    and prints no result line."""
    sys.path.insert(0, REPO)
    import chip_smoke

    def fail(*_, **__):
        raise RuntimeError("the viewer did not serve its page")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "_nvidia_smi", lambda: "a card, 700.00 W")
    monkeypatch.setattr(chip_smoke, "run", fail)
    with pytest.raises(RuntimeError, match="viewer"):
        chip_smoke.main()
    assert '"ok"' not in capsys.readouterr().out


def test_point_click_phase_fails_on_a_kernel_disagreement(monkeypatch):
    """phase point_click holds K2 (here a stand-in one ulp off) to its plain
    version on the crust."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from sixdof_tpu_torch.kernels import raytrace as k2

    def off_by_one_ulp(o, d, m, tris):
        t = k2.ray_mesh_intersect_plain(o, d, m, tris)
        return torch.nextafter(t, torch.full_like(t, float("inf")))

    monkeypatch.setattr(k2, "ray_mesh_intersect", off_by_one_ulp)
    scene = os.path.join(REPO, "demo_data", "synth_box")
    with pytest.raises(RuntimeError, match="disagrees"):
        chip_smoke.phase_point_click(torch.device("cpu"), scene, small=True, n_time=1)


def test_train_phase_fails_on_a_kernel_disagreement(monkeypatch):
    """phase train holds the trainer's batches through K1 (here a stand-in
    one ulp off in depth) to the same draws through the plain raster."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from sixdof_tpu_torch.config import PipelineConfig
    from sixdof_tpu_torch.kernels import raster
    from sixdof_tpu_torch.ops import rasterize

    def off_by_one_ulp(coef, counts, H, W):
        z, t = raster.rasterize_zbuffer_plain(coef, counts, H, W)
        return torch.nextafter(z, torch.full_like(z, float("inf"))), t

    monkeypatch.setattr(rasterize, "rasterize_zbuffer", off_by_one_ulp)
    cfg = PipelineConfig(shorter_side=120, input_resize=(32, 32), prune_to=4,
                         coarse_hw=(16, 16))
    with pytest.raises(RuntimeError, match="trainer batches through K1 disagree"):
        chip_smoke.phase_train(torch.device("cpu"), cfg,
                               os.path.join(REPO, "demo_data", "synth_box"), small=True)


@pytest.mark.parametrize("down_sample", [8.0, 6.0])
def test_rehearsal_refinement_matches_jax(down_sample):
    """The rehearsal's refine_pose_with_icp of synth_box frame 0 from the
    annotated pose (chip_smoke._icp_parameters' cut: 1000 target points, 4
    restarts of 5 iterations) in the port and in the JAX package, at the
    first-frame downsample the rehearsal once used (8 mm) and the one it
    uses (6 mm): the same fitness and transformation (1e-4, mm) at both;
    at 8 mm the JAX package's own refinement ends below the rehearsal's
    0.9 fitness gate, at 6 mm both clear it."""
    sys.path.insert(0, REPO)
    import numpy as np

    import chip_smoke
    from sixdof_tpu.app.icp_pipeline import refine_pose_with_icp as jrefine
    from sixdof_tpu.io.readers import DataReader as JReader
    from sixdof_tpu_torch.app.icp_pipeline import refine_pose_with_icp as trefine
    from sixdof_tpu_torch.io.readers import DataReader as TReader

    scene = os.path.join(REPO, "demo_data", "synth_box")
    results = []
    for reader, refine, kw in ((JReader(scene), jrefine, {}),
                               (TReader(scene), trefine, {"device": "cpu"})):
        params = chip_smoke._icp_parameters(reader.parameters, True)
        params["preprocess_source"]["down_sample"] = down_sample
        init = reader.color_to_depth @ reader.scale_translation_to_millimeters(
            reader.get_gt_pose(0))
        results.append(refine(reader.get_source(0), reader.target, reader.background, init,
                              params, **kw)[1])
    jax_res, port_res = results
    assert abs(port_res.fitness - jax_res.fitness) <= 1e-6
    np.testing.assert_allclose(port_res.transformation, jax_res.transformation, atol=1e-4)
    if down_sample == 8.0:
        assert jax_res.fitness < chip_smoke.CAPTURE_MIN_FITNESS
    else:
        assert min(jax_res.fitness, port_res.fitness) >= chip_smoke.CAPTURE_MIN_FITNESS


def test_cold_phase_fails_when_the_warm_up_changes_a_result(monkeypatch, capsys):
    """phase cold holds the run with the warm-up (b) to the run without it
    (a) bit for bit: (b) here one ulp off in one pose fails the phase, and
    the script prints no result."""
    sys.path.insert(0, REPO)
    import numpy as np

    import chip_smoke

    arrays = {"poses": np.tile(np.eye(4), (6, 1, 1)), "icp_frames": np.array([0, 2, 4]),
              "icp_tfs": np.tile(np.eye(4), (3, 1, 1)), "icp_fitness": np.ones(3),
              "cloud_sizes": np.array([5, 5, 5]), "clouds": np.zeros((15, 3))}
    run = {"precompile_record": {"seconds": dict.fromkeys(("build", "register", "track",
                                                           "capture"), 0.1),
                                 "launches": {"rasterize_zbuffer": 10, "ray_mesh_intersect": 1}},
           "loop_k1_launches": 22, "loop_k2_launches": 3}

    def cold_run(name, scene, flags, env, out_dir, small):
        out = {k: v.copy() for k, v in arrays.items()}
        if name == "b":
            out["poses"][3, 0, 3] = np.nextafter(0.0, 1.0)
        return dict(run), out, 1.0

    monkeypatch.setattr(chip_smoke, "_cold_run", cold_run)
    monkeypatch.setattr(chip_smoke, "_tool", lambda *_: ({}, 1.0))
    cfg = chip_smoke._config(False)
    with pytest.raises(RuntimeError, match="with and without the warm-up disagree"):
        chip_smoke.phase_cold(torch.device("cuda"), cfg, "synth_box", small=False)
    out = capsys.readouterr().out
    assert '"a_vs_b_bit_equal": false' in out and '"ok"' not in out
