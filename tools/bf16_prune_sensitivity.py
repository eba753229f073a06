#!/usr/bin/env python3
"""Where bf16 rounding moves register's prune, and where the port's register
departs from the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python tools/bf16_prune_sensitivity.py [--scene synth_occl]
        [--prune_to 64] [--frames N] [--out DIR] [--frame0_from LOG]

Runs the BOP campaign on the converted demo scene (tools/bop_jax_reference.py:
the bundled networks in bf16, the app's width, the first N frames, default
all) three ways: the JAX package as it runs (its register cascade one jitted
program); the JAX package with the coarse prune's scorer network run eagerly,
op by op (the same arithmetic rounded at other points; every other stage the
jitted one); and the port on the CPU.  For each: the mean ADD-S and the
rotation error of every frame.  Then it takes frame 0's register apart, the
JAX cascade run stage by stage on the inputs it was given (its top pose
equals the one program's) beside the port's:
- the coarse poses (the full grid after the coarse refine): how far the
  port's lie from JAX's, and how many of each lie within 15 deg of the truth;
- the coarse scores: the gap at the cut (the prune_to-th best against the
  next), how far the port's scores and JAX's eager ones lie from JAX's, and
  how many hypotheses their kept sets differ by;
- the cascade's top pose, in deg from the truth: each package's own, each
  package's fine stage fed the other's kept set, JAX's fed the kept set of
  its eager scorer and of the port's scorer on JAX's coarse poses;
- each package's depth polish (the estimator's last step) applied to each
  package's top pose.
With --frame0_from LOG (chip_smoke.py's output) it runs instead both
packages' campaigns with frame 0's pose set to the one that chip_smoke.py's
phase `bop` registered for --scene at --prune_to (the card's), and tracks
the other frames from it: the rotation error of every frame.
Prints one JSON line.  Needs JAX and the orbax weights/ (the JAX side), so it
runs where the tests run, not on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def frame0_pose(log, scene, prune_to):
    """Frame 0's pose in chip_smoke.py's phase `bop` line for @scene at
    @prune_to, from its output @log."""
    import numpy as np

    with open(log) as f:
        for line in f:
            if line.startswith("{") and '"phase": "bop"' in line:
                r = json.loads(line)
                if r["name"] == scene and r["prune_to"] == prune_to:
                    return np.asarray(r["frame0_pose"], dtype=np.float64)
    raise ValueError(f"{log} has no phase bop line of {scene} at prune_to {prune_to}")


def replay(scene, prune_to, frames, out, pose0):
    """Both packages' campaigns with frame 0's pose set to @pose0 (object in
    camera), the others tracked from it; the rotation error of each frame."""
    import numpy as np

    import bop_jax_reference
    from sixdof_tpu import estimater as jest
    from sixdof_tpu import metrics as jmetrics
    from sixdof_tpu_torch import estimater as test
    from sixdof_tpu_torch import metrics as tmetrics

    rot = {"jax": [], "port": []}

    def rotation(package, fn):
        def f(R, R_gt):
            rot[package].append(fn(R, R_gt))
            return rot[package][-1]
        return f

    def given_pose(self, *_):
        # the polish is register's last step; the estimator keeps its output
        # as the tracked pose of the centred mesh
        return (pose0 @ np.linalg.inv(self.get_tf_to_centered_mesh())).astype(np.float32)

    patches = [(jmetrics, "rotation_angle_deg", rotation("jax", jmetrics.rotation_angle_deg)),
               (tmetrics, "rotation_angle_deg", rotation("port", tmetrics.rotation_angle_deg)),
               (jest.FoundationPose, "_depth_polish", given_pose),
               (test.FoundationPose, "_depth_polish", given_pose)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        return {r["package"]: {"adds_mean_m": r["adds_mean_m"],
                               "rot_err_deg_mean": r["rot_err_deg_mean"],
                               "rot_err_deg": rot[r["package"]]}
                for r in bop_jax_reference.main([scene], prune_to, out, frames, "bfloat16",
                                                port=True)}
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def main(scene="synth_occl", prune_to=64, frames=None, out=None, frame0_from=None):
    os.environ["SIXDOF_AOT_CACHE"] = ""
    import inspect

    import jax
    import numpy as np
    import torch

    import bop_jax_reference
    from sixdof_tpu import estimater as jest
    from sixdof_tpu import metrics as jmetrics
    from sixdof_tpu.models import predict as jp
    from sixdof_tpu_torch import estimater as test
    from sixdof_tpu_torch import metrics as tmetrics
    from sixdof_tpu_torch.models import predict as tp

    out = out or os.path.join(REPO, "build", "bf16_prune_sensitivity")
    if frame0_from:
        pose0 = frame0_pose(frame0_from, scene, prune_to)
        result = {"scene": scene, "prune_to": prune_to, "frame0_pose": pose0.tolist(),
                  "replay": replay(scene, prune_to, frames, out, pose0)}
        print(json.dumps(result))
        return result
    rot_angle = jmetrics.rotation_angle_deg
    rec = {"rot_jax": [], "rot_port": [], "gt": [], "eager": False, "jax": {}, "port": [], "in_port": False,
           "polish": {}}

    # --- hooks: per-frame rotation errors, the register calls, the polish
    def rotation(package, fn):
        def f(R, R_gt):
            rec["gt"].append(np.asarray(R_gt, dtype=np.float64))
            rec["rot_" + package].append(fn(R, R_gt))
            return rec["rot_" + package][-1]
        return f

    orig_score, orig_refine = jp.score_poses_jit, jp.refine_poses_jit
    make_ab = jax.jit(jp._make_AB, static_argnames=("out_hw", "normalize_xyz",
                                                    "invalid_z_thresh", "backface_cull"))
    depth_score = jax.jit(jp._depth_alignment_score)

    def eager_score(*a, **k):
        """score_poses_jit (models/predict.py) with its network run eagerly."""
        c = inspect.signature(orig_score.__wrapped__).bind(*a, **k)
        c.apply_defaults()
        c = c.arguments
        A, B, _, rend = make_ab(c["mesh"], c["poses"], c["rgb01"], c["xyz_map"], c["K"],
                                c["crop_ratio"], c["mesh_diameter"], out_hw=c["out_hw"],
                                normalize_xyz=c["normalize_xyz"], invalid_z_thresh=0.1,
                                backface_cull=c["backface_cull"])
        s = 0.0
        if c["mode"] in ("network", "hybrid"):
            net = c["model"].apply({"params": c["params"]}, A, B, L=c["poses"].shape[0])
            s = s + net["score_logit"].reshape(-1) + 100.0
        if c["mode"] in ("depth", "hybrid"):
            s = s + depth_score(A, B, rend, c["poses"], c["mesh_diameter"])
        return s

    def staged(args, kw, eager=False):
        """The JAX cascade stage by stage (register_pipeline_jit's body, each
        stage its own jitted program); with @eager the coarse prune's scorer
        network runs eagerly.  Returns (its output, the stage calls)."""
        calls = []

        def record(kind, fn):
            def f(*a, **k):
                first = not any(c[0] == kind for c in calls)
                r = (eager_score if eager and kind == "score" and first else fn)(*a, **k)
                calls.append((kind, a, k, r))
                return r
            return f

        jp.score_poses_jit, jp.refine_poses_jit = record("score", orig_score), \
            record("refine", orig_refine)
        try:
            return jp.register_pipeline_jit.__wrapped__(*args, **kw), calls
        finally:
            jp.score_poses_jit, jp.refine_poses_jit = orig_score, orig_refine

    orig_exec = jest.FoundationPose._get_register_exec

    def get_exec(self, n_hypo, H, W, iteration):
        comp = None if rec["eager"] else orig_exec(self, n_hypo, H, W, iteration)

        def call(*a, **k):
            ref, sc = self.refiner, self.scorer
            args = (ref.model, a[0], sc.model, a[1], *a[2:])
            kw = {**self._register_pipeline_kwargs(iteration), **k}
            res = staged(args, kw, eager=True)[0] if rec["eager"] else comp(*a, **k)
            rec["jax"].setdefault("eager" if rec["eager"] else "jit", (args, kw, res))
            return res
        return call

    orig_treg, orig_tref, orig_tscore = test.register_pipeline, tp.refine_poses, tp.score_poses

    def port_register(*a, **k):
        rec["in_port"] = not rec["port"]
        try:
            return orig_treg(*a, **k)
        finally:
            rec["in_port"] = False

    def port_record(kind, fn):
        def f(*a, **k):
            r = fn(*a, **k)
            if rec["in_port"]:
                rec["port"].append((kind, a, k, r))
            return r
        return f

    def polish(package, fn):
        def f(self, *a):
            r = fn(self, *a)
            rec["polish"].setdefault(package, (self, a, r))
            return r
        return f

    patches = [(jmetrics, "rotation_angle_deg", rotation("jax", jmetrics.rotation_angle_deg)),
               (tmetrics, "rotation_angle_deg", rotation("port", tmetrics.rotation_angle_deg)),
               (jest.FoundationPose, "_get_register_exec", get_exec),
               (test, "register_pipeline", port_register),
               (tp, "refine_poses", port_record("refine", orig_tref)),
               (tp, "score_poses", port_record("score", orig_tscore)),
               (jest.FoundationPose, "_depth_polish",
                polish("jax", jest.FoundationPose._depth_polish)),
               (test.FoundationPose, "_depth_polish",
                polish("port", test.FoundationPose._depth_polish))]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    campaign = {}
    try:
        for variant, eager, port in (("jax", False, True), ("jax_eager_prune", True, False)):
            rec["eager"] = eager
            for r in bop_jax_reference.main([scene], prune_to, out, frames, "bfloat16", port):
                name = "port" if r["package"] == "port" else variant
                campaign[name] = {"adds_mean_m": r["adds_mean_m"],
                                  "rot_err_deg_mean": r["rot_err_deg_mean"],
                                  "rot_err_deg": rec["rot_" + r["package"]][-r["frames"]:]}
        R_gt = rec["gt"][0]

        def rot_err(pose):
            return float(rot_angle(np.asarray(pose, dtype=np.float64)[:3, :3], R_gt))

        # --- frame 0, stage by stage
        args, kw, program = rec["jax"]["jit"]
        (j_sorted, _), jcalls = staged(args, kw)
        jr_c, js_c, jr_f, js_f = jcalls[:4]
        pr_c, ps_c, pr_f, ps_f = rec["port"][:4]
        jc, pc = np.asarray(jr_c[3]), pr_c[3].cpu().numpy()
        jsc, psc = np.asarray(js_c[3]), ps_c[3].float().cpu().numpy()

        def kept(s):
            return np.argsort(-s, kind="stable")[:prune_to]

        def bound(fn, call, poses):
            b = inspect.signature(fn).bind(*call[1], **call[2]).arguments
            return dict(b, poses=poses)

        def jax_fine(poses):
            p = orig_refine(**bound(orig_refine.__wrapped__, jr_f, jax.numpy.asarray(poses)))
            s = np.asarray(orig_score(**bound(orig_score.__wrapped__, js_f, p)))
            return np.asarray(p)[int(np.argmax(s))]

        def port_fine(poses):
            p = orig_tref(**bound(orig_tref, pr_f, torch.tensor(np.asarray(poses))))
            s = orig_tscore(**bound(orig_tscore, ps_f, p)).float().numpy()
            return p.cpu().numpy()[int(np.argmax(s))]

        jk, pk = kept(jsc), kept(psc)
        s_eager = np.asarray(eager_score(*js_c[1], **js_c[2]))
        s_port_on_jax = orig_tscore(**bound(orig_tscore, ps_c, torch.tensor(jc)))
        s_port_on_jax = s_port_on_jax.float().numpy()
        ek, qk = kept(s_eager), kept(s_port_on_jax)
        dR = [float(rot_angle(a[:3, :3].astype(np.float64), b[:3, :3].astype(np.float64)))
              for a, b in zip(jc, pc)]
        top = {"jax": np.asarray(j_sorted)[0],
               "port": pr_f[3].cpu().numpy()[int(np.argmax(ps_f[3].float().numpy()))]}
        sorted_jsc = np.sort(jsc)[::-1]
        frame0 = {
            "staged_top_equals_program": bool(np.array_equal(np.asarray(j_sorted)[0],
                                                             np.asarray(program[0])[0])),
            "coarse_pose_diff_deg": {"median": float(np.median(dR)), "max": float(max(dR))},
            "coarse_within_15deg": {"jax": int(sum(rot_err(p) < 15 for p in jc)),
                                    "port": int(sum(rot_err(p) < 15 for p in pc)),
                                    "of": int(len(jc))},
            "coarse_score_range_jax": [float(jsc.min()), float(jsc.max())],
            "gap_at_cut_jax": float(sorted_jsc[prune_to - 1] - sorted_jsc[prune_to]),
            "score_abs_diff_median": {
                "port_vs_jax": float(np.median(np.abs(psc - jsc))),
                "port_scorer_on_jax_poses_vs_jax": float(np.median(np.abs(s_port_on_jax - jsc))),
                "jax_eager_vs_jax": float(np.median(np.abs(s_eager - jsc)))},
            "kept_symmetric_difference": {
                "port_vs_jax": len(set(jk) ^ set(pk)),
                "port_scorer_on_jax_poses_vs_jax": len(set(qk) ^ set(jk)),
                "jax_eager_vs_jax": len(set(ek) ^ set(jk))},
            "cascade_top_rot_deg": {
                "jax": rot_err(top["jax"]), "port": rot_err(top["port"]),
                "jax_fine_on_port_kept": rot_err(jax_fine(pc[pk])),
                "port_fine_on_jax_kept": rot_err(port_fine(jc[jk])),
                "jax_fine_on_jax_eager_kept": rot_err(jax_fine(jc[ek])),
                "jax_fine_on_port_scorer_kept": rot_err(jax_fine(jc[qk]))},
        }
        polished = {}
        for package, (est, a, _) in rec["polish"].items():
            for which, pose in top.items():
                polished[f"{package}_polish_on_{which}_top"] = rot_err(
                    est._depth_polish(np.asarray(pose, dtype=np.float32), *a[1:]))
        frame0["polished_rot_deg"] = polished
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    result = {"scene": scene, "prune_to": prune_to, "campaign": campaign, "frame0": frame0}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="synth_occl")
    ap.add_argument("--prune_to", type=int, default=64)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--frame0_from", default=None,
                    help="chip_smoke.py's output: replay the campaigns from its frame 0 pose")
    a = ap.parse_args()
    main(a.scene, a.prune_to, a.frames, a.out, a.frame0_from)
