"""Typed configuration: the app defaults and the per-scene ICP parameters.

Own copy of `sixdof_tpu/config.py`: `PipelineConfig` holds the run loop's
argparse defaults (the pose fields, plus the loop's capture cadence,
readback pipeline depth, frame cap and debug level), and `IcpConfig` the
`configs/icp_parameters.json` tree with the precedence
CLI > per-scene JSON > defaults.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class PlaneRemovalConfig:
    distance_threshold: float = 2.0
    num_iterations: int = 100


@dataclass
class MeshSmoothingConfig:
    """preprocess_source's mesh branch: surface smoothing + resampling."""

    radius: float = 5.0
    number_of_iterations: int = 10
    number_of_points: int = 3000


@dataclass
class PreprocessSourceConfig:
    down_sample: float = 2.0
    plane_removal: PlaneRemovalConfig = field(default_factory=PlaneRemovalConfig)
    fpfh_radius: float = 20.0
    fpfh_max_nn: int = 100
    mesh: MeshSmoothingConfig = field(default_factory=MeshSmoothingConfig)


@dataclass
class PreprocessTargetConfig:
    max_pcd: int = 6000
    fpfh_radius: float = 20.0
    fpfh_max_nn: int = 100


@dataclass
class GlobalRegistrationConfig:
    distance_threshold: float = 10.0
    edge_length_checker: float = 0.9
    angle_threshold: float = 0.52
    ransac_iterations: int = 4000
    ransac_confidence: float = 0.999


@dataclass
class IcpConfig:
    """The icp_parameters.json schema."""

    debug_vis: bool = False
    box: bool = True
    mesh: bool = False
    voxel_size: float = 2.0
    preprocess_target: PreprocessTargetConfig = field(default_factory=PreprocessTargetConfig)
    preprocess_source: PreprocessSourceConfig = field(default_factory=PreprocessSourceConfig)
    execute_global_registration: GlobalRegistrationConfig = field(
        default_factory=GlobalRegistrationConfig
    )
    refine_distance_threshold: float = 5.0
    fitness_threshold: float = 0.9
    rmse_threshold: float = 2.0
    n_restarts: int = 50
    max_iter: int = 30

    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            d = json.load(f)
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d):
        cfg = cls()
        cfg.debug_vis = d.get("debug_vis", cfg.debug_vis)
        cfg.box = d.get("box", cfg.box)
        cfg.mesh = d.get("mesh", cfg.mesh)
        cfg.voxel_size = d.get("voxel_size", cfg.voxel_size)
        pt = d.get("preprocess_target", {})
        cfg.preprocess_target = PreprocessTargetConfig(
            max_pcd=pt.get("max_pcd", 6000),
            fpfh_radius=pt.get("fpfh_radius", 20.0),
            fpfh_max_nn=pt.get("fpfh_max_nn", 100),
        )
        ps = d.get("preprocess_source", {})
        pr = ps.get("plane_removal", {})
        ms = ps.get("mesh", {})
        cfg.preprocess_source = PreprocessSourceConfig(
            down_sample=ps.get("down_sample", 2.0),
            plane_removal=PlaneRemovalConfig(
                distance_threshold=pr.get("distance_threshold", 2.0),
                num_iterations=pr.get("num_iterations", 100),
            ),
            fpfh_radius=ps.get("fpfh_radius", 20.0),
            fpfh_max_nn=ps.get("fpfh_max_nn", 100),
            mesh=MeshSmoothingConfig(
                radius=ms.get("radius", 5.0),
                number_of_iterations=ms.get("number_of_iterations", 10),
                number_of_points=ms.get("number_of_points", 3000),
            ),
        )
        gr = d.get("execute_global_registration", {})
        checkers = gr.get("correspondence_checkers", [{"value": 0.9}])
        rc = gr.get("ransac_criteria", {})
        cfg.execute_global_registration = GlobalRegistrationConfig(
            distance_threshold=gr.get("distance_threshold", 10.0),
            edge_length_checker=checkers[0].get("value", 0.9) if checkers else 0.9,
            angle_threshold=gr.get("angle_threshold", 0.52),
            ransac_iterations=rc.get("iterations", 4000),
            ransac_confidence=rc.get("confidence", 0.999),
        )
        rr = d.get("refine_registration", {})
        cfg.refine_distance_threshold = rr.get("distance_threshold", 5.0)
        ri = d.get("run_icp", {})
        cfg.fitness_threshold = ri.get("fitness_threshold", 0.9)
        cfg.rmse_threshold = ri.get("rmse_threshold", 2.0)
        cfg.n_restarts = ri.get("n_restarts", 50)
        cfg.max_iter = ri.get("max_iter", 30)
        return cfg

    def to_reference_dict(self):
        """Back to the icp_parameters.json nesting the pipeline functions read."""
        return {
            "debug_vis": self.debug_vis,
            "box": self.box,
            "mesh": self.mesh,
            "voxel_size": self.voxel_size,
            "preprocess_target": dataclasses.asdict(self.preprocess_target),
            "preprocess_source": dataclasses.asdict(self.preprocess_source),
            "execute_global_registration": {
                "distance_threshold": self.execute_global_registration.distance_threshold,
                "correspondence_checkers": [
                    {"value": self.execute_global_registration.edge_length_checker}
                ],
                "angle_threshold": self.execute_global_registration.angle_threshold,
                "ransac_criteria": {
                    "iterations": self.execute_global_registration.ransac_iterations,
                    "confidence": self.execute_global_registration.ransac_confidence,
                },
            },
            "refine_registration": {"distance_threshold": self.refine_distance_threshold},
            "run_icp": {
                "fitness_threshold": self.fitness_threshold,
                "rmse_threshold": self.rmse_threshold,
                "n_restarts": self.n_restarts,
                "max_iter": self.max_iter,
            },
        }

    def apply_cli_overrides(self, args):
        """CLI > JSON precedence."""
        if getattr(args, "debug", 0) >= 3:
            self.debug_vis = True
        if getattr(args, "box", None) is not None:
            self.box = args.box
        if getattr(args, "mesh", None) is not None:
            self.mesh = args.mesh
        if getattr(args, "voxel_size", None) is not None:
            self.voxel_size = args.voxel_size
        return self


@dataclass
class PipelineConfig:
    test_scene_dir: str = "demo_data/synth_box"
    est_refine_iter: int = 5
    track_refine_iter: int = 2
    shorter_side: Optional[int] = None
    # the JAX app's reader switches: a recorded scene (demo) or the live
    # Kinect, a background captured at start; icp is parsed and unused, as
    # in the JAX loop
    demo: bool = True
    icp: bool = False
    capture_background: bool = False
    input_resize: Tuple[int, int] = (160, 160)
    # the app's FoundationPose arguments (sixdof_tpu/app/run.py defaults)
    prune_to: int = 64
    coarse_hw: Tuple[int, int] = (96, 96)
    prune_schedule: str = ""  # "ITERSxKEEP,..." coarse stages; "" = prune_to's cut
    polish_top: int = 0
    polish_iters: int = 2
    track_crop: int = 1
    depth_polish: int = 1
    track_polish: int = 1
    # checkpoints: None = weights_torch/<net> when it exists, else a seed
    refiner_ckpt: Optional[str] = None
    scorer_ckpt: Optional[str] = None
    # the run loop (sixdof_tpu/app/run.py CLI): debug >= 1 syncs every
    # tracked pose to the host; 0 with track_pipeline > 0 keeps the pose
    # chain on the device and dispatches captures from it
    debug: int = 1
    capture_every: Optional[int] = None
    track_pipeline: int = 3
    max_frames: Optional[int] = None
