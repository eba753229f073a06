"""Registration diagnostics of a set of weights on the port: the refiner's
convergence basin, the refined rotation grid's best accuracy, and where
the scorer ranks the truly best hypothesis.

The port's counterpart of `tools/eval_register.py`, on one frame (frame 0)
of a demo scene, against its annotated pose (per the centred mesh):

  basin        8 perturbations of the true pose at each of 5, 10, 20, 30
               and 45 deg (axis and translation offset drawn from
               RandomState(deg)), refined for 5 iterations: the rotation
               error after, its median and largest, the translation's median
  refined_grid the full rotation grid at `guess_translation`'s centre,
               refined for 5 iterations: each pose's ADD-S and rotation error
  ranking      the hybrid scores of the refined grid (`ScorePredictor.
               predict`): the top five, and the rank of the hypothesis with
               the least ADD-S

Every refine goes through `models/predict.py::refine_poses` at the
refiner's crop size (160x160 for every bundled or trained checkpoint, the
JAX tool's size), so through raster kernel K1 on the card.  `main` prints
the JAX tool's lines, then one JSON line with the same numbers.

    python tools/eval_register_torch.py [scene] [--device cpu]

WEIGHTS_DIR names the checkpoint directory (`<dir>/{refiner,scorer}.npz`,
default weights_torch); OCC_SUB=1 refines with the visibility substitution
(A/B against the default 0).
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BASIN_DEGS = (5, 10, 20, 30, 45)
BASIN_SAMPLES = 8
ITERATIONS = 5
TOP = 5  # ranks the ranking reports
# the JAX tool's refine arguments: crop ratio, translation normaliser (m),
# rotation normaliser (20 deg in rad)
CROP_RATIO, TRANS_NORMALIZER, ROT_NORMALIZER = 1.2, 0.02, 0.3490658503988659


@dataclass
class Probe:
    """One frame of a scene on the device, with the engine and the
    predictors the diagnostics refine and score with."""
    est: object  # the port's FoundationPose on the scene's mesh
    refiner: object
    scorer: object
    color: np.ndarray  # (H,W,3) uint8
    depth_f: object  # (H,W) filtered depth on the device
    xyz_map: object  # (H,W,3) on the device
    rgb01: object  # (H,W,3) float [0,1] on the device
    K: np.ndarray
    mask: np.ndarray  # (H,W) bool
    pose_c_gt: np.ndarray  # the annotated pose per the centred mesh
    model_pts: np.ndarray  # the engine's centred model points


def load(scene_dir, weights_dir="weights_torch", device=None):
    """Frame 0 of @scene_dir and the networks of @weights_dir (a directory
    under the repo, or an absolute one, holding refiner.npz and
    scorer.npz), on @device (None = the card).  Raises where a network's
    checkpoint is missing: a seeded network is no candidate."""
    import torch

    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor
    from sixdof_tpu_torch.ops.depth_filter import preprocess_depth
    from sixdof_tpu_torch.ops.geometry import depth2xyzmap

    logging.disable(logging.INFO)
    dev = resolve_device(device)

    class Args:
        debug = 0
        box = None
        mesh = None
        voxel_size = None

    wdir = os.path.join(REPO, weights_dir)
    reader = DataReader(base_dir=scene_dir, shorter_side=None, zfar=np.inf, arguments=Args())
    mesh = load_mesh(f"{scene_dir}/mesh/model_scaled_down.obj")
    ref = PoseRefinePredictor(dev, ckpt_dir=wdir)
    sc = ScorePredictor(dev, ckpt_dir=wdir)
    for name, pred in (("refiner", ref), ("scorer", sc)):
        if pred.ckpt_path is None:
            raise FileNotFoundError(f"no {name} checkpoint under {wdir} ({name}.npz)")
    est = FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh,
                         refiner=ref, scorer=sc, device=dev)
    color = reader.get_color(0)
    depth = reader.get_depth(0)
    K = torch.as_tensor(reader.color_K, dtype=torch.float32, device=dev)
    depth_f = preprocess_depth(torch.as_tensor(depth, dtype=torch.float32, device=dev))
    rgb01 = torch.as_tensor(color, dtype=torch.float32, device=dev) / 255.0
    return Probe(est=est, refiner=ref, scorer=sc, color=color, depth_f=depth_f,
                 xyz_map=depth2xyzmap(depth_f, K), rgb01=rgb01, K=reader.color_K,
                 mask=reader.get_mask(color, 0).astype(bool),
                 pose_c_gt=reader.get_gt_pose(0) @ np.linalg.inv(est.get_tf_to_centered_mesh()),
                 model_pts=np.asarray(est.pts))


def refine(probe, poses, iterations=ITERATIONS, occ_sub=False, plain_raster=False):
    """@iterations refine steps of the (N,4,4) @poses (per the centred
    mesh) with the JAX tool's arguments; @occ_sub is passed on as it is
    (False | True | a float gate ceiling).  @plain_raster: through K1's
    plain version.  Returns the (N,4,4) float32 poses."""
    import torch

    from sixdof_tpu_torch.models import predict

    est, ref = probe.est, probe.refiner
    dev = est.device
    out = predict.refine_poses(
        ref.model, est.mesh_tensors, torch.as_tensor(np.asarray(poses), dtype=torch.float32,
                                                     device=dev),
        probe.rgb01, probe.xyz_map, torch.as_tensor(probe.K, dtype=torch.float32, device=dev),
        float(est.diameter), CROP_RATIO, TRANS_NORMALIZER, ROT_NORMALIZER, int(iterations),
        out_hw=tuple(ref.cfg["input_resize"]), occ_sub=occ_sub, plain_raster=plain_raster,
        compute_dtype=ref.compute_dtype)
    return out.cpu().numpy()


def perturbations(pose_c_gt, deg):
    """The JAX tool's 8 perturbations of @pose_c_gt at @deg: a rotation of
    @deg about an axis drawn from RandomState(@deg) (so3_exp_map in
    float32, as JAX computes it), then a translation offset drawn from
    U(-1 cm, 1 cm) per axis.  Returns (8,4,4) float64."""
    import torch

    from sixdof_tpu_torch.ops.lie import so3_exp_map

    rng = np.random.RandomState(deg)
    out = []
    for _ in range(BASIN_SAMPLES):
        ax = rng.randn(3)
        ax = ax / np.linalg.norm(ax) * np.deg2rad(deg)
        dR = so3_exp_map(torch.as_tensor(ax[None], dtype=torch.float32))[0].numpy()
        p = pose_c_gt.copy()
        p[:3, :3] = dR @ p[:3, :3]
        p[:3, 3] += rng.uniform(-0.01, 0.01, 3)
        out.append(p)
    return np.stack(out)


def basin(probe, occ_sub=False, degs=BASIN_DEGS, plain_raster=False):
    """The refiner's basin: for each angle of @degs, its perturbations
    refined for 5 iterations.  Returns a record per angle: the start and
    refined poses, each refined pose's rotation error (deg) and
    translation error (mm)."""
    from sixdof_tpu_torch.metrics import rotation_angle_deg

    gt = probe.pose_c_gt
    records = []
    for deg in degs:
        start = perturbations(gt, deg)
        out = refine(probe, start, ITERATIONS, occ_sub, plain_raster)
        records.append(dict(
            deg=deg, start=start, poses=out,
            rot_deg=[rotation_angle_deg(o[:3, :3], gt[:3, :3]) for o in out],
            t_mm=[float(np.linalg.norm(o[:3, 3] - gt[:3, 3]) * 1000) for o in out]))
    return records


def refined_grid(probe, occ_sub=False):
    """The full rotation grid at the mask's guessed centre, refined for 5
    iterations.  Returns dict(center, poses (N,4,4), adds (N,) in m, rots
    (N,) in deg), each against the annotated pose."""
    from sixdof_tpu_torch.metrics import adds_err, rotation_angle_deg

    est, gt = probe.est, probe.pose_c_gt
    center = est.guess_translation(depth=probe.depth_f.cpu().numpy(), mask=probe.mask,
                                   K=probe.K)
    poses0 = est.rot_grid.copy()
    poses0[:, :3, 3] = center
    refined = refine(probe, poses0, ITERATIONS, occ_sub)
    adds = np.array([adds_err(p, gt, probe.model_pts) for p in refined])
    rots = np.array([rotation_angle_deg(p[:3, :3], gt[:3, :3]) for p in refined])
    return dict(center=center, poses=refined, adds=adds, rots=rots)


def ranking(probe, grid):
    """The scorer's hybrid scores of @grid's refined poses (`refined_grid`)
    and where its ranking puts them.  Returns dict(scores, order, top: the
    first TOP ranks' index, score, ADD-S (mm) and rotation error,
    true_best_rank: the rank of the hypothesis with the least ADD-S)."""
    est, sc = probe.est, probe.scorer
    scores, _ = sc.predict(mesh=est.mesh, rgb=probe.color, depth=probe.depth_f, K=probe.K,
                           ob_in_cams=grid["poses"], mesh_tensors=est.mesh_tensors,
                           mesh_diameter=est.diameter)
    scores = scores.cpu().numpy()
    order = np.argsort(-scores)
    adds, rots = grid["adds"], grid["rots"]
    return dict(scores=scores, order=order,
                top=[dict(rank=r, idx=int(order[r]), score=float(scores[order[r]]),
                          adds_mm=float(adds[order[r]] * 1000), rot_deg=float(rots[order[r]]))
                     for r in range(min(TOP, len(order)))],
                true_best_rank=int(list(order).index(int(adds.argmin()))))


def main(scene="synth_box", weights_dir="weights_torch", occ_sub=None, device=None):
    """The three diagnostics on frame 0 of demo scene @scene (a name under
    demo_data/, or a path) with the networks of @weights_dir; @occ_sub None
    reads OCC_SUB (0 or 1).  Prints the JAX tool's lines and one JSON line;
    returns dict(basin, grid, ranking, summary), summary being that line."""
    import torch

    if occ_sub is None:
        occ_sub = bool(int(os.environ.get("OCC_SUB", "0")))
    probe = load(os.path.join(REPO, "demo_data", scene), weights_dir, device)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if probe.est.device.type == "cuda":
            torch.cuda.synchronize(probe.est.device)
        return out, time.perf_counter() - t0

    records, basin_s = timed(basin, probe, occ_sub)
    print("=== refiner basin (rot_err before -> after 5 iters) ===")
    for r in records:
        print(f"  {r['deg']:3d}deg -> rot after: med {np.median(r['rot_deg']):.1f} "
              f"max {np.max(r['rot_deg']):.1f} | t med {np.median(r['t_mm']):.1f}mm")
    grid, grid_s = timed(refined_grid, probe, occ_sub)
    adds, rots = grid["adds"], grid["rots"]
    print("=== refined grid quality ===")
    print(f"  best ADD-S: {adds.min()*1000:.2f}mm (idx {adds.argmin()}), "
          f"best rot: {rots.min():.1f}deg")
    print(f"  # hyps with rot<10deg: {(rots < 10).sum()}, <20deg: {(rots < 20).sum()}")
    rank, ranking_s = timed(ranking, probe, grid)
    print("=== ranking (hybrid) ===")
    for t in rank["top"]:
        print(f"  rank{t['rank']}: idx {t['idx']} score {t['score']:.3f} "
              f"ADD-S {t['adds_mm']:.2f}mm rot {t['rot_deg']:.1f}deg")
    print(f"  rank of true-best hyp: {rank['true_best_rank']}")
    summary = {
        "scene": scene, "weights_dir": weights_dir, "occ_sub": occ_sub,
        "device": str(probe.est.device),
        "basin": [dict(deg=r["deg"], rot_after_med_deg=float(np.median(r["rot_deg"])),
                       rot_after_max_deg=float(np.max(r["rot_deg"])),
                       t_after_med_mm=float(np.median(r["t_mm"]))) for r in records],
        "grid": dict(hypotheses=len(rots), best_adds_mm=float(adds.min() * 1000),
                     best_adds_idx=int(adds.argmin()), best_rot_deg=float(rots.min()),
                     n_rot_lt10=int((rots < 10).sum()), n_rot_lt20=int((rots < 20).sum())),
        "ranking": dict(top=rank["top"], true_best_rank=rank["true_best_rank"]),
        "seconds": dict(basin=basin_s, grid=grid_s, ranking=ranking_s),
    }
    print(json.dumps(summary), flush=True)
    return dict(basin=records, grid=grid, ranking=rank, summary=summary)


def cli(argv):
    """The JAX tool's command line (a scene name), plus --device."""
    device = None
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    main(argv[0] if argv else "synth_box", os.environ.get("WEIGHTS_DIR", "weights_torch"),
         device=device)
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
