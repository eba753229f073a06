"""Application loop: pose registration + tracking + ICP + defect projection.

Port of `sixdof_tpu/app/run.py` on one device:

- frame 0: register -> mm scale + extrinsic compose -> refine_pose_with_icp
  -> ray_tracing of the defect heatmap onto the ICP-posed mesh;
- later frames: track_one; a capture event (restart ICP + defect ray trace
  in one device program) every `--capture_every` frames and whenever the
  viewer's Capture New Data button was pressed.  With `--debug 0` and
  `--track_pipeline > 0` the pose chain stays on the device: tracked poses
  are read back `track_pipeline` frames late, capture events are dispatched
  from the device pose (capture_event_async) and consumed four frames
  later; otherwise every frame syncs and captures run synchronously
  (capture_event).  Poses go to `{debug_dir}/ob_in_cam/`.
- the viewer (app/web_vis.py) serves the accumulated defect clouds (depth
  camera, mm), the posed mesh and the heatmap overlay of the last capture
  while the loop runs, on 0.0.0.0:8050 unless `--no_server`;
- `--debug >= 1` draws the posed box and axes on every frame (every frame
  syncs); `--debug >= 2` writes them to `{debug_dir}/track_vis/`, the
  overlays to `{debug_dir}/overlay/`, registers through the staged path
  and writes its refiner crops to `{debug_dir}/vis_refiner.png`.  The JAX
  app's OpenCV window (a display) has no counterpart.

The frames come from the recorded scene `--test_scene_dir` (`--demo`, the
default) or, with `--no-demo`, from the live Azure Kinect
(`io/readers.py::KinectReader`, which needs `pykinect_azure`; with
`--capture_background true` it captures the empty scene's cloud first).
What the viewer shows is also kept on a `LoopState` the caller may pass.
With `--precompile 1` (the default) the engine's warm-up thread
(`FoundationPose.precompile_async`) starts once the reader exists: it
builds the kernel libraries and runs register's cascade, a track step and
one capture program at the scene's shapes while the heatmap and the first
frame are read; frame 0's register, the track steps and the capture
entries join it, and an error in it fails the run.  The networks load `--refiner_ckpt` and `--scorer_ckpt`, by default the numpy
export of the bundled weights (`weights_torch/`, written by
`tools/export_torch_weights.py`) when it exists, else they start from a
seed, as the JAX app does with `weights/`.
"""
from __future__ import annotations

import argparse
import logging
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..config import PipelineConfig
from ..device import resolve_device
from ..estimater import FoundationPose
from ..io.mesh_io import TriMesh, load_mesh
from ..io.png import write_png_rgb8
from ..io.readers import DataReader, KinectReader
from ..models.predict import PoseRefinePredictor, ScorePredictor
from ..utils.logging_utils import set_seed
from ..utils.profiling import StageTimer
from ..utils.vis import draw_posed_3d_box, draw_xyz_axis
from . import web_vis
from .defect_projection import (compute_rays, create_heatmap_overlay, heatmap_to_points,
                                ray_tracing, save_overlay)
from .icp_pipeline import (CaptureContext, capture_event, capture_event_async,
                           preprocess_source, refine_pose_with_icp)

HEATMAP_THRESHOLD = 0.75
WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "weights_torch")


def transform_object(pcd_or_mesh, transformation):
    out = pcd_or_mesh.copy()
    out.transform(transformation)
    return out


def oriented_bounds(mesh):
    """PCA oriented bounding box (trimesh.bounds.oriented_bounds
    equivalent): returns (to_origin 4x4, extents 3)."""
    pts = np.asarray(mesh.vertices)
    c = pts.mean(axis=0)
    q = pts - c
    _, vecs = np.linalg.eigh(q.T @ q)
    R = vecs[:, ::-1].T  # rows = principal axes, major first
    if np.linalg.det(R) < 0:
        R[2] *= -1
    local = q @ R.T
    mn, mx = local.min(axis=0), local.max(axis=0)
    to_origin = np.eye(4)
    to_origin[:3, :3] = R
    to_origin[:3, 3] = -(R @ c) - (mn + mx) / 2
    return to_origin, mx - mn


@dataclass
class LoopState:
    """What the viewer shows, updated where the JAX app calls
    `update_dash_data`: the accumulated defect clouds (depth camera, mm),
    the mesh posed by the latest ICP result, and the frame and registration
    result of frame 0's ICP refinement and of each capture; the viewer's
    bound (host, port) while it serves; the loop's per-stage host wall
    times; and the start-up timeline: (label, time.perf_counter()) marks
    from the viewer's start to the first defect cloud, then each capture's
    start and end."""

    intersection_pcds: list = field(default_factory=list)
    target_mesh: TriMesh = None
    captures: list = field(default_factory=list)  # (frame, RegistrationResult)
    viewer_address: tuple = None
    stages: dict = field(default_factory=dict)  # StageTimer.summary() at the end
    marks: list = field(default_factory=list)  # (label, perf_counter seconds)

    def mark(self, label):
        self.marks.append((label, time.perf_counter()))

    def update(self, intersection_pcds, target_mesh):
        self.intersection_pcds = intersection_pcds
        self.target_mesh = target_mesh


def main(args, device=None, refiner=None, scorer=None, plain_raytrace=False, state=None,
         viewer_address=("0.0.0.0", 8050)):
    """Run the loop over the scene's frames; returns the per-frame wall times
    (seconds).  @device: None = the card (or `args.device`); @refiner/@scorer:
    predictors to use instead of those the arguments name; @plain_raytrace:
    K2's plain version (a comparison run); @state: a LoopState to fill;
    @viewer_address: where the viewer listens unless `args.no_server` (port
    0 picks a free port, recorded in `state.viewer_address`).  The viewer
    stops when the loop ends."""
    dev = resolve_device(device or getattr(args, "device", None))
    state = state if state is not None else LoopState()
    capture_queue = queue.Queue()  # POST /capture -> the loop
    server = None
    if not args.no_server:
        # no data queue: the page polls GET /data, and nothing waits on wake signals
        server = web_vis.make_server(None, capture_queue, *viewer_address)
        state.viewer_address = server.server_address[:2]
        threading.Thread(target=server.serve_forever, name="defect-viewer", daemon=True).start()
        state.mark("viewer")
    try:
        return _loop(args, dev, refiner, scorer, plain_raytrace, state, capture_queue)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            state.viewer_address = None


def _loop(args, dev, refiner, scorer, plain_raytrace, state, capture_queue):
    mesh = load_mesh(getattr(args, "mesh_file", None)
                     or f"{args.test_scene_dir}/mesh/model_scaled_down.obj")
    debug = args.debug
    debug_dir = args.debug_dir
    os.makedirs(f"{debug_dir}/track_vis", exist_ok=True)
    os.makedirs(f"{debug_dir}/ob_in_cam", exist_ok=True)
    to_origin, extents = oriented_bounds(mesh)
    bbox = np.stack([-extents / 2, extents / 2], axis=0).reshape(2, 3)
    state.mark("mesh")

    if refiner is None:
        refiner = PoseRefinePredictor(dev, ckpt_dir=_ckpt(args.refiner_ckpt, "refiner"))
    if scorer is None:
        scorer = ScorePredictor(dev, ckpt_dir=_ckpt(args.scorer_ckpt, "scorer"))
    state.mark("checkpoints")
    est = build_engine(args, dev, mesh, refiner, scorer)
    state.mark("engine")
    if args.demo:
        reader = DataReader(args.test_scene_dir, shorter_side=args.shorter_side, zfar=np.inf,
                            arguments=args)
    else:
        logging.info("live demo")
        reader = KinectReader(args.test_scene_dir, capture_background=args.capture_background,
                              shorter_side=args.shorter_side, zfar=np.inf, arguments=args)
    state.mark("reader")
    if getattr(args, "precompile", 1):
        est.precompile_async(reader.color_K, (reader.color_H, reader.color_W),
                             iteration=args.est_refine_iter,
                             track_iteration=args.track_refine_iter,
                             icp_parameters=reader.parameters)
        state.mark("precompile started")

    intersection_pcds = []
    frame_times = []
    pending_poses = deque()  # (frame, PendingPose) awaiting host readback
    pending_captures = deque()  # (frame, PendingPose, PendingCapture)
    timer = StageTimer()
    previous_transformation = np.eye(4)
    delta_pose = np.eye(4)
    current_transformation = np.eye(4)
    target_mesh_copy = None
    capture_ctx = None
    overlay_path = os.path.join(web_vis.ASSETS_DIR, "overlay.png")

    def drain_pending(keep_frame=None, leave=0):
        """Write queued async poses to ob_in_cam in frame order, down to
        @leave entries; a queued pose for @keep_frame is returned instead."""
        kept = None
        while len(pending_poses) > leave:
            j, h = pending_poses.popleft()
            if j == keep_frame:
                kept = h.numpy()
            else:
                np.savetxt(f"{debug_dir}/ob_in_cam/{j:04d}.txt", h.numpy())
        return kept

    def to_initial_tf(pose):
        """FoundationPose metres/colour camera -> ICP millimetres/depth camera."""
        return np.dot(reader.color_to_depth, reader.scale_translation_to_millimeters(pose))

    def publish():
        """What the viewer shows: its payload, then the caller's state."""
        web_vis.update_dash_data(intersection_pcds, target_mesh_copy)
        state.update(intersection_pcds, target_mesh_copy)

    def heatmap_overlay(i):
        """The heatmap and its overlay on frame @i, saved for the viewer."""
        with timer.stage("overlay"):
            heatmap, color_original, heatmap_vis, _ = reader.get_heatmap(reader.get_color(i))
            overlay = create_heatmap_overlay(color_original, heatmap_vis)
            save_overlay(overlay, overlay_path)
        return heatmap, overlay

    def consume_capture(frame, initial_transformation, current_result, new_pcd):
        """Fold one capture's result into the loop state (the JAX app's
        capture branch and drain_captures share this)."""
        nonlocal previous_transformation, delta_pose, current_transformation, \
            target_mesh_copy
        current_transformation = current_result.transformation
        delta_pose = np.linalg.inv(initial_transformation) @ np.linalg.inv(
            current_transformation)
        target_mesh_copy = transform_object(reader.target_mesh,
                                            np.linalg.inv(current_transformation))
        relative_transformation = np.linalg.inv(current_transformation) @ previous_transformation
        for pcd in intersection_pcds:
            pcd.transform(relative_transformation)
        new_pcd.transform(reader.color_to_depth)
        intersection_pcds.append(new_pcd)
        previous_transformation = current_transformation
        state.captures.append((frame, current_result))
        publish()

    def drain_captures(now=None):
        """Consume finished async capture events in frame order; entries
        younger than 4 frames stay in flight unless @now is None."""
        while pending_captures:
            if now is not None and now - pending_captures[0][0] < 4:
                break
            j, pp, pcap = pending_captures.popleft()
            current_result, new_pcd = pcap.result()
            consume_capture(j, to_initial_tf(pp.numpy()), current_result, new_pcd)

    reader.update()
    heatmap, overlay = heatmap_overlay(0)
    state.mark("heatmap")
    max_frames = min(args.max_frames or len(reader), len(reader))  # a live reader has no end
    pipeline_depth = args.track_pipeline
    async_mode = debug < 1 and pipeline_depth > 0
    i = 0
    while i < max_frames:
        logging.info(f"i: {i}")
        t0 = time.perf_counter()
        with timer.stage("read"):  # the next camera frame, or the PNG decode
            reader.update()
            color = reader.get_color(i)
            depth = reader.get_depth(i)
        if color is None or depth is None:  # a live reader before its first frame
            continue
        if i == 0:
            mask = reader.get_mask(color, i).astype(bool)
            state.mark("frame 0 loaded")
            with timer.stage("register"):
                pose = est.register(K=reader.color_K, rgb=color, depth=depth, ob_mask=mask,
                                    iteration=args.est_refine_iter)
            state.mark("first pose")
            initial_transformation = to_initial_tf(pose)
            with timer.stage("icp_refine"):
                _, initial_icp_result, _, target_processed = refine_pose_with_icp(
                    reader.get_source(i), reader.target, reader.background,
                    initial_transformation, reader.parameters, device=dev)
            delta_pose = np.linalg.inv(initial_transformation) @ np.linalg.inv(
                initial_icp_result.transformation)
            current_transformation = initial_icp_result.transformation
            capture_ctx = CaptureContext(target_processed, reader.target_mesh,
                                         reader.color_to_depth, device=dev,
                                         plain_raytrace=plain_raytrace)
            target_mesh_copy = transform_object(
                reader.target_mesh, np.linalg.inv(initial_icp_result.transformation))
            with timer.stage("ray_tracing"):
                defect_pcd, _ = ray_tracing(reader.base_dir, target_mesh_copy, heatmap,
                                            reader.color_pinhole,
                                            heatmap_threshold=HEATMAP_THRESHOLD, device=dev,
                                            plain_raytrace=plain_raytrace)
            defect_pcd.transform(reader.color_to_depth)
            intersection_pcds.append(defect_pcd)
            state.mark("first defect cloud")
            if debug >= 2:
                save_overlay(overlay, f"{debug_dir}/overlay/overlay_{i}.png")
            previous_transformation = initial_icp_result.transformation
            state.captures.append((0, initial_icp_result))
            publish()
        else:
            with timer.stage("track"):
                out = est.track_one(rgb=color, depth=depth, K=reader.color_K,
                                    iteration=args.track_refine_iter, sync=not async_mode)
            drain_captures(now=i)
            if async_mode:
                pending_poses.append((i, out))
                drain_pending(leave=pipeline_depth)
                pose = None  # the dead-reckoning pose has no consumer until
                # the next capture resolves
            else:
                drain_pending()
                pose = out
                initial_transformation = to_initial_tf(pose)

            detect_defect = False
            if not capture_queue.empty():
                capture_queue.get()
                detect_defect = True
                logging.info("New Defect Detection initiated!")
            if args.capture_every and i % args.capture_every == 0:
                detect_defect = True
            if detect_defect:
                heatmap, overlay = heatmap_overlay(i)
                state.mark(f"capture {i} start")
                with timer.stage("capture"):
                    source_processed, _, _ = preprocess_source(
                        reader.get_source(i), reader.background, reader.parameters, i=i)
                    if debug >= 2:
                        save_overlay(overlay, f"{debug_dir}/overlay/overlay_{i}.png")
                    pix = heatmap_to_points(heatmap, HEATMAP_THRESHOLD)
                    if pix:
                        rays, intensities = compute_rays(pix, reader.color_pinhole)
                        ray_mask = np.ones(len(rays), dtype=bool)
                    else:
                        # one placeholder ray, masked out: no defect point
                        rays = np.array([[0.0, 0.0, 1.0]])
                        intensities = np.zeros(1)
                        ray_mask = np.zeros(1, dtype=bool)
                    if async_mode:
                        pcap = capture_event_async(
                            source_processed, out.device_pose(),
                            est.get_tf_to_centered_mesh(), reader.parameters,
                            rays, ray_mask, intensities, ctx=capture_ctx)
                        pending_captures.append((i, out, pcap))
                    else:
                        current_result, new_pcd = capture_event(
                            source_processed, target_processed, initial_transformation,
                            reader.parameters, reader.target_mesh, rays, ray_mask,
                            intensities, reader.color_to_depth, ctx=capture_ctx)
                        consume_capture(i, initial_transformation, current_result, new_pcd)
                state.mark(f"capture {i} dispatched" if async_mode else f"capture {i} end")
            elif pose is not None:
                current_transformation = np.linalg.inv(initial_transformation @ delta_pose)

        if pose is not None:
            np.savetxt(f"{debug_dir}/ob_in_cam/{i:04d}.txt", pose.reshape(4, 4))
        frame_times.append(time.perf_counter() - t0)

        if debug >= 1:
            with timer.stage("draw"):
                center_pose = pose @ np.linalg.inv(to_origin)
                vis = draw_posed_3d_box(reader.color_K, img=color.copy(), ob_in_cam=center_pose,
                                        bbox=bbox)
                vis = draw_xyz_axis(vis, ob_in_cam=center_pose, scale=0.1, K=reader.color_K,
                                    thickness=3, transparency=0, is_input_rgb=True)
                if debug >= 2:
                    write_png_rgb8(f"{debug_dir}/track_vis/{i:04d}.png", vis)
        i += 1

    drain_captures()  # consume any in-flight capture event
    drain_pending()  # drain the readback pipeline
    reader.stop_camera()
    timer.log()
    state.stages = timer.summary()
    if frame_times:
        fps = 1.0 / np.mean(frame_times[1:]) if len(frame_times) > 1 else 1.0 / frame_times[0]
        logging.info(f"frames: {len(frame_times)}  mean FPS (excl. frame 0): {fps:.2f}")
    return frame_times


def build_engine(args, dev, mesh, refiner, scorer):
    """The loop's FoundationPose for @mesh from the command line @args (its
    switches, the rotation grid capped to `--max_hypotheses`)."""
    est = FoundationPose(model_pts=mesh.vertices, model_normals=mesh.vertex_normals, mesh=mesh,
                         scorer=scorer, refiner=refiner, device=dev, debug=args.debug,
                         debug_dir=args.debug_dir, prune_to=args.prune_to or None,
                         prune_schedule=_parse_prune_schedule(args.prune_schedule),
                         track_crop=bool(args.track_crop), polish_top=args.polish_top,
                         polish_iters=args.polish_iters, depth_polish=bool(args.depth_polish),
                         track_polish=bool(args.track_polish))
    if args.max_hypotheses and len(est.rot_grid) > args.max_hypotheses:
        step = len(est.rot_grid) // args.max_hypotheses
        est.rot_grid = est.rot_grid[::step][: args.max_hypotheses]
        logging.info(f"rotation grid capped to {len(est.rot_grid)} hypotheses")
    logging.info("Estimator initialization done")
    return est


def _ckpt(path, net):
    """@path, or the bundled export's file for @net when it exists."""
    default = os.path.join(WEIGHTS_DIR, f"{net}.npz")
    return path or (default if os.path.exists(default) else None)


def build_parser():
    """The JAX app's CLI, less what the port does not run; defaults come
    from `PipelineConfig`."""
    pc = PipelineConfig()

    def str2bool(v):
        if isinstance(v, bool) or v is None:
            return v
        if v.lower() in ("1", "true", "yes", "y", "on"):
            return True
        if v.lower() in ("0", "false", "no", "n", "off"):
            return False
        raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")

    parser = argparse.ArgumentParser()
    code_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--mesh_file", type=str, default=None,
                        help="CAD mesh override (default: "
                             "{test_scene_dir}/mesh/model_scaled_down.obj)")
    parser.add_argument("--test_scene_dir", type=str, default=f"{code_dir}/{pc.test_scene_dir}")
    parser.add_argument("--est_refine_iter", type=int, default=pc.est_refine_iter)
    parser.add_argument("--track_refine_iter", type=int, default=pc.track_refine_iter)
    parser.add_argument("--debug", type=int, default=pc.debug,
                        help="0 with --track_pipeline > 0: poses stay on the device and "
                             "captures run asynchronously; >= 1: every frame syncs")
    parser.add_argument("--debug_dir", type=str, default=f"{code_dir}/debug")
    parser.add_argument("--shorter_side", type=int, default=pc.shorter_side)
    parser.add_argument("--demo", action="store_true", default=pc.demo,
                        help="replay the recorded scene --test_scene_dir (the default)")
    parser.add_argument("--no-demo", dest="demo", action="store_false",
                        help="capture from the live Azure Kinect (needs pykinect_azure); "
                             "--test_scene_dir then holds its configs, mesh and background")
    parser.add_argument("--icp", default=pc.icp, type=str2bool,
                        help="parsed and unused by the loop, as in the JAX app")
    parser.add_argument("--info", default=True, type=str2bool,
                        help="parsed and unused by the loop, as in the JAX app")
    parser.add_argument("--box", type=str2bool, default=None)
    parser.add_argument("--mesh", type=str2bool, default=None)
    parser.add_argument("--capture_background", type=str2bool, default=pc.capture_background,
                        help="with --no-demo: capture the empty scene's cloud at start and "
                             "save it as background/box.ply")
    parser.add_argument("--voxel_size", type=float, default=None)
    parser.add_argument("--max_frames", type=int, default=pc.max_frames)
    parser.add_argument("--capture_every", type=int, default=pc.capture_every,
                        help="trigger a defect capture every N frames")
    parser.add_argument("--no_server", action="store_true",
                        help="no viewer (default: it serves on http://0.0.0.0:8050)")
    parser.add_argument("--prune_to", type=int, default=pc.prune_to,
                        help="keep this many hypotheses after 2 coarse iterations "
                             "(0 = the full grid for all iterations)")
    parser.add_argument("--max_hypotheses", type=int, default=None,
                        help="cap the rotation grid")
    parser.add_argument("--precompile", type=int, default=1,
                        help="warm up at start (1 = on): a background thread builds the "
                             "kernels and runs register, a track step and a capture once at "
                             "the scene's shapes; the first register, track and capture "
                             "join it")
    parser.add_argument("--track_pipeline", type=int, default=pc.track_pipeline,
                        help="tracked-pose readback pipeline depth (0 = sync every frame)")
    parser.add_argument("--refiner_ckpt", type=str, default=pc.refiner_ckpt,
                        help="refiner checkpoint (.npz export or .pth; default: "
                             "weights_torch/refiner.npz when it exists, else a seed)")
    parser.add_argument("--scorer_ckpt", type=str, default=pc.scorer_ckpt,
                        help="scorer checkpoint (as --refiner_ckpt)")
    parser.add_argument("--prune_schedule", type=str, default=pc.prune_schedule,
                        help="coarse pruning stages as 'ITERSxKEEP,...' (e.g. '1x128,1x64'); "
                             "overrides --prune_to's single two-iteration cut")
    parser.add_argument("--polish_top", type=int, default=pc.polish_top,
                        help="refine this many best hypotheses further after the final "
                             "score and rank them alongside the originals (0 = off)")
    parser.add_argument("--polish_iters", type=int, default=pc.polish_iters,
                        help="refine iterations per polished hypothesis")
    parser.add_argument("--track_crop", type=int, default=pc.track_crop,
                        help="upload only a window around the tracked pose (1 = on)")
    parser.add_argument("--depth_polish", type=int, default=pc.depth_polish,
                        help="ICP-polish the registered pose against the masked observed "
                             "cloud (1 = on)")
    parser.add_argument("--track_polish", type=int, default=pc.track_polish,
                        help="the same polish, guarded, after every track step (1 = on)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' on request)")
    return parser


def _parse_prune_schedule(spec: str):
    """'1x128,1x64' -> ((1, 128), (1, 64)); empty/None -> None."""
    if not spec:
        return None
    stages = []
    for part in spec.split(","):
        iters, keep = part.lower().split("x")
        stages.append((int(iters), int(keep)))
    return tuple(stages)


def cli(argv=None):
    logging.basicConfig(level=logging.INFO, format="[%(funcName)s()] %(message)s")
    args = build_parser().parse_args(argv)
    set_seed(0)
    return main(args)
