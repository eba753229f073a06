"""Pose-path configuration: the app defaults the pose server reads.

Own copy of the pose fields of `sixdof_tpu/config.py::PipelineConfig`
(the run loop's argparse defaults).  The ICP/capture configuration tree
belongs to the capture slice and is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class PipelineConfig:
    test_scene_dir: str = "demo_data/synth_box"
    est_refine_iter: int = 5
    track_refine_iter: int = 2
    shorter_side: Optional[int] = None
    input_resize: Tuple[int, int] = (160, 160)
    # the app's FoundationPose arguments (sixdof_tpu/app/run.py defaults)
    prune_to: int = 64
    coarse_hw: Tuple[int, int] = (96, 96)
