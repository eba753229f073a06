"""Accuracy parity harness of the port: `tools/parity_check.py` on the
port's engine and the `weights_torch/` checkpoints.

Replays a scene through register (frame 0) and track (every later frame),
scores the per-frame poses against `annotated_poses/` (ADD-S, ADD, the
ADD-S AUC to 0.1 diameter, rotation and translation error), runs the
classical refinement on frame 0 from the registered pose (the ICP pose's
errors and fitness) and the defect ray trace (defect points and their
median distance to the posed mesh's vertices), and prints one JSON
summary, with the JAX tool's fields.  `all` runs the five 6-frame demo
scenes; PARITY_ASSERT=1 turns a breached ceiling (`THRESHOLDS`, the JAX
tool's) into a non-zero exit.  WEIGHTS_DIR picks another checkpoint
directory (`<dir>/{refiner,scorer}.npz`), SCORE_MODE forces the scorer's
mode.

    python tools/parity_check_torch.py [scene_dir | all] [n_frames] [--device cpu]
"""
from __future__ import annotations

import json
import logging
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCENES = ("synth_box", "synth_clutter", "synth_box_sensor", "synth_clutter_sensor", "synth_occl")

# The JAX tool's accuracy ceilings, about twice its healthy numbers: a
# breach is a regression, not noise.
THRESHOLDS = {
    "synth_box": dict(adds_mean_m=0.005, icp_adds_mm=4.0,
                      defect_surface_median_dist_mm=5.0, rot_err_deg_mean=6.0),
    "synth_box_sensor": dict(adds_mean_m=0.006, icp_adds_mm=5.0,
                             defect_surface_median_dist_mm=5.0, rot_err_deg_mean=6.0),
    "synth_clutter": dict(adds_mean_m=0.006, icp_adds_mm=3.0,
                          defect_surface_median_dist_mm=6.0, rot_err_deg_mean=6.0),
    "synth_clutter_sensor": dict(adds_mean_m=0.006, icp_adds_mm=6.0,
                                 defect_surface_median_dist_mm=6.0, rot_err_deg_mean=7.0),
    "synth_occl": dict(adds_mean_m=0.008, icp_adds_mm=5.0,
                       defect_surface_median_dist_mm=6.0, rot_err_deg_mean=15.0),
}


def check_thresholds(name, result):
    """Returns a list of breach strings (empty = scene within its ceilings)."""
    breaches = []
    for metric, ceiling in THRESHOLDS.get(name, {}).items():
        v = result.get(metric)
        if v is not None and v >= 0 and v > ceiling:
            breaches.append(f"{name}: {metric}={v:.4g} > {ceiling}")
    return breaches


def make_engine(mesh, device):
    """The engine the harness scores: the app's defaults on the
    WEIGHTS_DIR checkpoints (default weights_torch/), SCORE_MODE applied."""
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

    wdir = os.path.join(REPO, os.environ.get("WEIGHTS_DIR", "weights_torch"))

    def ckpt(net):
        path = os.path.join(wdir, f"{net}.npz")
        return path if os.path.exists(path) else None

    scfg = {"score_mode": os.environ["SCORE_MODE"]} if os.environ.get("SCORE_MODE") else None
    return FoundationPose(
        model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh, device=device,
        refiner=PoseRefinePredictor(device, ckpt_dir=ckpt("refiner")),
        scorer=ScorePredictor(device, cfg=scfg, ckpt_dir=ckpt("scorer")))


def main(scene_dir, n_frames=None, device=None):
    """The harness on @scene_dir's first @n_frames frames (all by default)
    on @device (None = the card).  Prints and returns the summary dict."""
    from scipy.spatial import cKDTree

    from sixdof_tpu_torch.app.defect_projection import ray_tracing
    from sixdof_tpu_torch.app.icp_pipeline import refine_pose_with_icp
    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.metrics import add_err, adds_err, compute_auc, rotation_angle_deg

    logging.disable(logging.INFO)
    dev = resolve_device(device)

    class Args:
        debug = 0
        box = None
        mesh = None
        voxel_size = None

    reader = DataReader(base_dir=scene_dir, shorter_side=None, zfar=np.inf, arguments=Args())
    mesh = load_mesh(f"{scene_dir}/mesh/model_scaled_down.obj")
    est = make_engine(mesh, dev)
    model_pts = np.asarray(est.pts) + est.model_center

    n = n_frames or len(reader)
    adds, adds_all, rot_errs, t_errs = [], [], [], []
    poses_out = []
    for i in range(min(n, len(reader))):
        color = reader.get_color(i)
        depth = reader.get_depth(i)
        if i == 0:
            mask = reader.get_mask(color, i).astype(bool)
            pose = est.register(K=reader.color_K, rgb=color, depth=depth, ob_mask=mask,
                                iteration=5)
        else:
            pose = est.track_one(rgb=color, depth=depth, K=reader.color_K, iteration=2)
        poses_out.append(pose)
        gt = reader.get_gt_pose(i)
        if gt is not None:
            adds.append(adds_err(pose, gt, model_pts))
            adds_all.append(add_err(pose, gt, model_pts))
            rot_errs.append(rotation_angle_deg(pose[:3, :3], gt[:3, :3]))
            t_errs.append(float(np.linalg.norm(pose[:3, 3] - gt[:3, 3])))

    # classical refinement on frame 0 (mm)
    source = reader.get_source(0)
    init_tf = reader.color_to_depth @ reader.scale_translation_to_millimeters(poses_out[0])
    _, icp_result, _, _ = refine_pose_with_icp(source, reader.target, reader.background,
                                               init_tf.copy(), reader.parameters, device=dev)
    icp_metrics = {}
    gt0 = reader.get_gt_pose(0)
    if gt0 is not None:
        gt_mm = reader.color_to_depth @ reader.scale_translation_to_millimeters(gt0)
        icp_pose = np.linalg.inv(icp_result.transformation)  # object -> scene (mm)
        icp_metrics["icp_rot_err_deg"] = rotation_angle_deg(icp_pose[:3, :3], gt_mm[:3, :3])
        icp_metrics["icp_t_err_mm"] = float(np.linalg.norm(icp_pose[:3, 3] - gt_mm[:3, 3]))
        icp_metrics["icp_adds_mm"] = adds_err(icp_pose, gt_mm,
                                              model_pts * 1000.0 - est.model_center * 1000.0)

    # the defect projection lands on the mesh surface
    heatmap = reader.get_heatmap(reader.get_color(0))[0]
    tm = reader.target_mesh.copy()
    tm.transform(np.linalg.inv(icp_result.transformation))
    pcd, tmesh = ray_tracing(reader.base_dir, tm, heatmap, reader.color_pinhole, 0.75,
                             device=dev)
    surf_dist = -1.0
    if len(pcd) > 0:
        d, _ = cKDTree(tmesh.vertices).query(pcd.points, k=1, workers=-1)
        surf_dist = float(np.median(d))

    diam = est.diameter
    out = {
        "frames": len(poses_out),
        "adds_mean_m": float(np.mean(adds)) if adds else -1,
        "add_mean_m": float(np.mean(adds_all)) if adds_all else -1,
        "adds_auc_0.1d": compute_auc(adds, max_val=0.1 * diam) if adds else -1,
        "rot_err_deg_mean": float(np.mean(rot_errs)) if rot_errs else -1,
        "t_err_m_mean": float(np.mean(t_errs)) if t_errs else -1,
        **icp_metrics,
        "icp_fitness": icp_result.fitness,
        "icp_rmse_mm": icp_result.inlier_rmse,
        "defect_pts": len(pcd),
        "defect_surface_median_dist_mm": surf_dist,
        "mesh_diameter_m": diam,
    }
    print(json.dumps(out, indent=1))
    return out


def run_all(n_frames=None, device=None, scenes=SCENES):
    """`main` on each demo scene present; returns {scene: summary}."""
    results = {}
    for name in scenes:
        d = os.path.join(REPO, "demo_data", name)
        if os.path.exists(d):
            print(f"== {name} ==")
            results[name] = main(d, n_frames, device=device)
    print(json.dumps({k: {m: v[m] for m in ("adds_mean_m", "adds_auc_0.1d", "icp_adds_mm",
                                            "defect_surface_median_dist_mm")}
                      for k, v in results.items()}, indent=1))
    return results


def cli(argv):
    """The JAX tool's command line (plus --device); returns the exit code."""
    device = None
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    scene = argv[0] if argv else os.path.join(REPO, "demo_data", "synth_box")
    nf = int(argv[1]) if len(argv) > 1 else None
    if scene == "all":
        results = run_all(nf, device)
    else:
        results = {os.path.basename(scene.rstrip("/")): main(scene, nf, device=device)}
    if os.environ.get("PARITY_ASSERT"):
        breaches = [b for k, v in results.items() for b in check_thresholds(k, v)]
        if breaches:
            print("PARITY FLOOR BREACHED:\n  " + "\n  ".join(breaches), file=sys.stderr)
            return 1
        print("parity floors: all scenes within thresholds" if scene == "all"
              else "parity floors: scene within thresholds")
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
