"""FLOP accounting of the port's register cascade and track step, at
`tools/flops_report.py`'s shapes: synth_box frame 0 at shorter side 288,
prune_to 64, the 252-hypothesis grid, the bundled networks.

Counts with `torch.utils.flop_counter.FlopCounterMode` over real calls on
the device: `FoundationPose.register` (the whole cascade and its depth
polish), the fused cascade alone, one `track_one`, and the cascade's four
stages called apart under FLOPS.json's stage names (2 coarse refine
iterations and the coarse score over the full grid at the coarse size, 3
fine refine iterations and the fine score of the 64 survivors).  Beside
each count, at those shapes, it prints FLOPS.json's figure for the same
program (the JAX package's, from XLA's cost analysis) and the ratio.

What FlopCounterMode counts: aten's matrix products and convolutions
(mm, addmm, bmm, baddbmm, convolution, attention), at 2 FLOPs a
multiply-add.  What it does not count, and this report adds no estimate
for: elementwise and reduction work (the normalisations, activations,
depth filters, warps, ICP's sums) and kernels K1 and K2, which run
through ctypes outside aten.  XLA's figure counts elementwise work too.

    python tools/flops_report_torch.py [scene_dir] [--out FILE] [--device cpu]

Prints one JSON line; with --out also writes it there.
"""
from __future__ import annotations

import json
import logging
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NOT_COUNTED = ("elementwise and reduction operations; kernels K1 (raster) and K2 (ray-mesh), "
               "launched through ctypes outside aten; no estimate is added for either")
STAGES = ("coarse_refine_2it_full_grid", "coarse_score_full_grid", "fine_refine_3it_top64",
          "fine_score_top64")


def count(fn):
    """(FLOPs, {aten op: FLOPs}) of one call of @fn under FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    by_op = {str(k).split(".")[-1]: int(v) for k, v in fc.get_flop_counts()["Global"].items()}
    return int(fc.get_total_flops()), by_op


def stage_calls(est, rgb, depth, K, prune_to=64):
    """{stage name: a call} of the register cascade's four stages, on
    hypotheses at the grid's size and the survivors' (identity rotations
    at 0.55 m: the count depends on the shapes only)."""
    import torch

    from sixdof_tpu_torch.models.predict import refine_poses, score_poses, to_rgb01
    from sixdof_tpu_torch.ops.geometry import depth2xyzmap

    dev = est.device
    ref, sc = est.refiner, est.scorer
    n_hypo = len(est.rot_grid)
    K_t = torch.as_tensor(K, dtype=torch.float32, device=dev)
    rgb01 = to_rgb01(rgb, dev)
    xyz_map = depth2xyzmap(torch.as_tensor(depth, dtype=torch.float32, device=dev), K_t)
    diam = float(est.diameter)
    chw = est.coarse_hw or tuple(ref.cfg["input_resize"])
    fhw, shw = tuple(ref.cfg["input_resize"]), tuple(sc.cfg["input_resize"])

    def poses(k):
        p = torch.eye(4, device=dev).repeat(k, 1, 1)
        p[:, 2, 3] = 0.55
        return p

    def refine(k, iters, hw):
        return lambda: refine_poses(
            ref.model, est.mesh_tensors, poses(k), rgb01, xyz_map, K_t, diam,
            float(ref.cfg["crop_ratio"]), float(ref.cfg["trans_normalizer"]),
            float(ref.cfg["rot_normalizer"]), iters, out_hw=hw,
            normalize_xyz=bool(ref.cfg["normalize_xyz"]), rot_rep=ref.cfg["rot_rep"],
            backface_cull=est.backface_cull, occ_sub=ref.cfg.get("occ_sub", False),
            compute_dtype=ref.compute_dtype, trans_rep=ref.cfg["trans_rep"])

    def score(k, hw):
        return lambda: score_poses(
            sc.model, est.mesh_tensors, poses(k), rgb01, xyz_map, K_t, diam,
            float(sc.cfg["crop_ratio"]), out_hw=hw, normalize_xyz=bool(sc.cfg["normalize_xyz"]),
            mode=sc.cfg.get("score_mode", "hybrid"), backface_cull=est.backface_cull,
            compute_dtype=sc.compute_dtype)

    return dict(zip(STAGES, (refine(n_hypo, 2, chw), score(n_hypo, chw),
                             refine(prune_to, 3, fhw), score(prune_to, shw))))


def main(scene_dir=None, shorter_side=288, device=None, out=None, refiner=None, scorer=None,
         n_hypotheses=None, prune_to=64):
    """The report (a dict, printed as one JSON line and written to @out).
    @refiner/@scorer: the predictors (default the bundled networks);
    @n_hypotheses: keep that many of the grid (default all 252)."""
    import torch

    from sixdof_tpu_torch.app.run import _ckpt
    from sixdof_tpu_torch.device import resolve_device
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.io.readers import DataReader
    from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

    logging.disable(logging.INFO)
    dev = resolve_device(device)
    scene_dir = scene_dir or os.path.join(REPO, "demo_data", "synth_box")
    reader = DataReader(scene_dir, shorter_side=shorter_side)
    mesh = load_mesh(f"{scene_dir}/mesh/model_scaled_down.obj")
    est = FoundationPose(
        model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh, device=dev,
        refiner=refiner or PoseRefinePredictor(dev, ckpt_dir=_ckpt(None, "refiner")),
        scorer=scorer or ScorePredictor(dev, ckpt_dir=_ckpt(None, "scorer")), prune_to=prune_to)
    if n_hypotheses:
        est.rot_grid = est.rot_grid[:: len(est.rot_grid) // n_hypotheses][:n_hypotheses]
    color, depth = reader.get_color(0), reader.get_depth(0)
    mask = reader.get_mask(color, 0).astype(bool)
    K = reader.color_K

    with torch.inference_mode():
        register, register_ops = count(lambda: est.register(K=K, rgb=color, depth=depth,
                                                            ob_mask=mask, iteration=5))
        track, track_ops = count(lambda: est.track_one(rgb=reader.get_color(1),
                                                       depth=reader.get_depth(1), K=K,
                                                       iteration=2))
        depth_f = est._filtered_depth(depth)
        hypotheses = est.generate_random_pose_hypo(K, color, depth_f.cpu().numpy(), mask)
        cascade, cascade_ops = count(lambda: est._cascade(hypotheses, color, depth_f, K, 5))
        stages = {name: count(fn) for name, fn in
                  stage_calls(est, color, depth, K, prune_to).items()}

    xla = {}
    path = os.path.join(REPO, "FLOPS.json")
    if os.path.exists(path) and (shorter_side, prune_to, len(est.rot_grid)) == (288, 64, 252):
        with open(path) as f:
            xla = json.load(f)

    def row(flops, xla_flops, ops=None):
        r = {"flops": flops, "xla_flops": xla_flops,
             "ratio_to_xla": flops / xla_flops if xla_flops else None}
        if ops is not None:
            r["by_op"] = ops
        return r

    report = {
        "scene": os.path.basename(scene_dir.rstrip("/")), "shorter_side": shorter_side,
        "prune_to": prune_to, "n_hypotheses": int(len(est.rot_grid)), "device": dev.type,
        "counter": "torch.utils.flop_counter.FlopCounterMode", "not_counted": NOT_COUNTED,
        "register": row(register, xla.get("register_flops"), register_ops),
        "register_cascade": row(cascade, None, cascade_ops),
        "track": row(track, xla.get("track_flops"), track_ops),
        "register_stages": {name: row(fl, xla.get("register_stages", {}).get(name, {})
                                      .get("flops"), ops)
                            for name, (fl, ops) in stages.items()},
    }
    report["register_stage_sum_flops"] = sum(fl for fl, _ in stages.values())
    line = json.dumps(report)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return report


if __name__ == "__main__":
    argv = sys.argv[1:]
    opts = {}
    for flag in ("--out", "--device"):
        if flag in argv:
            k = argv.index(flag)
            opts[flag[2:]] = argv[k + 1]
            argv = argv[:k] + argv[k + 2:]
    main(argv[0] if argv else None, **opts)
