#!/usr/bin/env python3
"""Finish a field campaign from its checkpoint on the PyTorch/CUDA port:
extract the mesh and its metrics (`tools/extract_field_mesh.py` on the port).

    python tools/extract_field_mesh_torch.py [scene_dir] [out_mesh.obj]

If a campaign of tools/run_object_field_torch.py dies after training, the
checkpoint it saved (`<scene>/field_ckpt/field.npz`) still holds the fitted
field: this tool rebuilds the runner on the scene's frames, loads it, and
runs the extraction, chamfer and texture-bake tail of the campaign without
training.  Writes `<scene>/field_ckpt/campaign.json` (`resumed_from_ckpt`
true).  FIELD_LOG2 gives the table size the campaign used; FIELD_CPU=1
runs on the CPU, else the CUDA card.
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def main(scene_dir, out_mesh=None, resolution=128, device=None, ckpt_dir=None, spec=None,
         max_frames=None):
    """Returns (the campaign.json dict, the runner).  @spec: the hash grid
    the field was trained with (default `HashGridSpec()` at FIELD_LOG2, as
    the campaign's)."""
    from run_object_field_torch import bake, load_frames, mesh_metrics

    from sixdof_tpu_torch.io.mesh_io import save_mesh
    from sixdof_tpu_torch.models.object_field import (
        HashGridSpec, ObjectFieldConfig, ObjectFieldRunner,
    )
    if spec is None:
        spec = HashGridSpec(log2_hashmap_size=int(os.environ["FIELD_LOG2"])) \
            if os.environ.get("FIELD_LOG2") else HashGridSpec()
    ckpt = ckpt_dir or f"{scene_dir}/field_ckpt"
    runner = ObjectFieldRunner(ObjectFieldConfig(), *load_frames(scene_dir, max_frames),
                               spec=spec, device=device)
    runner.load_weights(ckpt)
    print(f"restored step {runner.global_step}")

    mesh = runner.extract_mesh(resolution=resolution)
    mesh = runner.color_mesh(mesh)
    mesh = runner.mesh_to_real_world(mesh)
    out_mesh = out_mesh or f"{scene_dir}/mesh/model_free.obj"
    save_mesh(out_mesh, mesh)

    result = {"scene": os.path.basename(scene_dir.rstrip("/")),
              "steps": int(runner.global_step), "mesh": out_mesh,
              "n_vertices": int(len(mesh.vertices)), "resumed_from_ckpt": True}
    result.update(mesh_metrics(scene_dir, mesh))
    bake(runner, mesh, out_mesh, result)
    with open(f"{ckpt}/campaign.json", "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return result, runner


if __name__ == "__main__":
    from sixdof_tpu_torch.utils.logging_utils import set_logging_format

    set_logging_format()
    scene = sys.argv[1] if len(sys.argv) > 1 else os.path.join(REPO, "demo_data", "synth_box_recon")
    out = sys.argv[2] if len(sys.argv) > 2 else None
    main(scene, out, device="cpu" if os.environ.get("FIELD_CPU") else None)
