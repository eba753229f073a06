#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's app loop on a recorded scene.

    python3 run_torch.py --max_frames 6               # viewer on http://0.0.0.0:8050
    python3 run_torch.py --no_server --max_frames 6 --capture_every 2
    python3 run_torch.py --no_server --max_frames 2 --debug 2

Registers the object on frame 0, refines it with ICP and projects the defect
heatmap onto the CAD mesh, then tracks every later frame with a capture
event every `--capture_every` frames and whenever the viewer's Capture New
Data button is pressed (`sixdof_tpu_torch/app/run.py`).  The viewer serves
while the loop runs, unless `--no_server`.  `--debug 2` registers through
the staged path and writes the drawings and overlays under `--debug_dir`.
Runs on the CUDA card unless `--device cpu` is given.  The JAX app is
`run.py`.
"""
import sys

from sixdof_tpu_torch.app.run import cli

if __name__ == "__main__":
    cli(sys.argv[1:])
    sys.exit(0)
