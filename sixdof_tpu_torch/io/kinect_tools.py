"""Azure-Kinect toolkit: calibration dumps and capture campaigns.

Port of `sixdof_tpu/io/kinect_tools.py` (the functional API: start the
device, fetch and save its intrinsics and extrinsics, grab frames with
retries, save frames, the background and PVNet-style capture campaigns).
Every entry point that touches the camera imports `pykinect_azure` and
raises without it.  Files follow the scene layout `io/readers.py` reads;
PNGs are written by `io/png.py` (colour as cv2.imwrite writes a BGR frame,
depth as 16-bit millimetres).  The live preview windows need OpenCV's
`imshow` and raise here.
"""
from __future__ import annotations

import glob
import json
import logging
import os
import time

import numpy as np

from .mesh_io import PointCloud, save_point_cloud
from .png import write_png_gray16
from .readers import write_color_png


def _pykinect():
    try:
        import pykinect_azure as pykinect
    except ImportError as e:
        raise RuntimeError("Azure-Kinect capture requires pykinect_azure; offline scenes do "
                           "not") from e
    pykinect.initialize_libraries()
    return pykinect


def initialize_kinect():
    """Start the device at BGRA32 / 720p colour and NFOV 2x2-binned depth."""
    pykinect = _pykinect()
    device_config = pykinect.default_configuration
    device_config.color_format = pykinect.K4A_IMAGE_FORMAT_COLOR_BGRA32
    device_config.color_resolution = pykinect.K4A_COLOR_RESOLUTION_720P
    device_config.depth_mode = pykinect.K4A_DEPTH_MODE_NFOV_2X2BINNED
    device = pykinect.start_device(config=device_config)
    time.sleep(1)
    return device, device_config


def get_extrinsics(device, device_config):
    """(color_to_depth, depth_to_color) 4x4 from the device's calibration."""
    calib = device.get_calibration(device_config.depth_mode, device_config.color_resolution)
    ext_cd = calib.color_calibration.extrinsics
    color_to_depth = np.eye(4)
    color_to_depth[:3, :3] = np.array(ext_cd.rotation).reshape(3, 3)
    color_to_depth[:3, 3] = np.array(ext_cd.translation).reshape(3)
    return color_to_depth, np.linalg.inv(color_to_depth)


def save_extrinsics(base_dir, color_to_depth, depth_to_color):
    """Write configs/camera_extrinsics.json; returns its path."""
    data = {key: {"rotation_matrix": np.asarray(tf)[:3, :3].tolist(),
                  "translation_vector": [np.asarray(tf)[:3, 3].tolist()]}
            for key, tf in (("color_to_depth", color_to_depth),
                            ("depth_to_color", depth_to_color))}
    os.makedirs(f"{base_dir}/configs", exist_ok=True)
    path = f"{base_dir}/configs/camera_extrinsics.json"
    with open(path, "w") as f:
        json.dump(data, f, indent=4)
    logging.info(f"Extrinsic parameters saved to {path}")
    return path


def get_intrinsics(device, device_config):
    """(color_K, depth_K) 3x3 from the device's calibration."""
    calib = device.get_calibration(device_config.depth_mode, device_config.color_resolution)
    cp, dp = calib.color_params, calib.depth_params
    color_K = np.array([[cp.fx, 0, cp.cx], [0, cp.fy, cp.cy], [0, 0, 1]])
    depth_K = np.array([[dp.fx, 0, dp.cx], [0, dp.fy, dp.cy], [0, 0, 1]])
    return color_K, depth_K


def save_intrinsics(base_dir, color_K, depth_K, color_wh=(1280, 720), depth_wh=(320, 288)):
    """Write configs/camera_intrinsics.json; returns its path."""
    data = {
        "color": {"fx": color_K[0][0], "fy": color_K[1][1], "cx": color_K[0][2],
                  "cy": color_K[1][2], "width": color_wh[0], "height": color_wh[1]},
        "depth": {"fx": depth_K[0][0], "fy": depth_K[1][1], "cx": depth_K[0][2],
                  "cy": depth_K[1][2], "width": depth_wh[0], "height": depth_wh[1]},
    }
    os.makedirs(f"{base_dir}/configs", exist_ok=True)
    path = f"{base_dir}/configs/camera_intrinsics.json"
    with open(path, "w") as f:
        json.dump(data, f, indent=4)
    logging.info(f"Intrinsic parameters saved to {path}")
    return path


def capture_frame(device):
    """(color, depth, points) of one capture, retried until all three
    arrive."""
    capture = device.update()
    ret_d, depth = capture.get_depth_image()
    ret_c, color = capture.get_color_image()
    ret_p, points = capture.get_pointcloud()
    while not (ret_c and ret_d and ret_p):
        logging.error("Failed to get image or point cloud.")
        capture = device.update()
        ret_d, depth = capture.get_depth_image()
        ret_c, color = capture.get_color_image()
        ret_p, points = capture.get_pointcloud()
    return color, depth, points


def save_frame(save_dir, color, depth, points, frame_id):
    """rgb/rgb_<id>.png, depth/depth_<id>.png (16-bit mm) and
    pcd/cloud_<id>.ply under @save_dir."""
    for sub in ("rgb", "depth", "pcd"):
        os.makedirs(f"{save_dir}/{sub}", exist_ok=True)
    write_color_png(f"{save_dir}/rgb/rgb_{frame_id:04d}.png", color)
    write_png_gray16(f"{save_dir}/depth/depth_{frame_id:04d}.png",
                     np.asarray(depth).astype(np.uint16))
    save_point_cloud(f"{save_dir}/pcd/cloud_{frame_id:04d}.ply", PointCloud(points))


def capture_background(device, base_dir, countdown=5):
    """After a countdown, save the empty scene's cloud as
    background/box.ply; returns its path."""
    logging.info("Please make sure the scene is empty.")
    for i in range(countdown, 0, -1):
        print(f"Capturing background in {i} seconds...")
        time.sleep(1)
    _, _, points = capture_frame(device)
    os.makedirs(f"{base_dir}/background", exist_ok=True)
    path = f"{base_dir}/background/box.ply"
    save_point_cloud(path, PointCloud(points))
    logging.info(f"Background saved to {path}")
    return path


def continuous_capture(base_dir, n_frames=100, interval_s=0.0):
    """Save the intrinsics, then @n_frames frames @interval_s apart."""
    device, device_config = initialize_kinect()
    color_K, depth_K = get_intrinsics(device, device_config)
    save_intrinsics(base_dir, color_K.tolist(), depth_K.tolist())
    for i in range(n_frames):
        color, depth, points = capture_frame(device)
        save_frame(base_dir, color, depth, points, i)
        if interval_s:
            time.sleep(interval_s)
    device.stop_cameras()
    device.close()


def dump_calibration(base_dir="."):
    """Save the device's intrinsics and extrinsics under @base_dir/configs."""
    device, device_config = initialize_kinect()
    color_K, depth_K = get_intrinsics(device, device_config)
    save_intrinsics(base_dir, color_K.tolist(), depth_K.tolist())
    c2d, d2c = get_extrinsics(device, device_config)
    save_extrinsics(base_dir, c2d, d2c)
    device.stop_cameras()
    device.close()


def display_color_image(color_image):
    """The JAX toolkit's live preview window; there is no window here."""
    raise RuntimeError("display_color_image shows the frame in an OpenCV imshow window, "
                       "which the port does not open; save the frames instead")


def display_depth_image(depth_image):
    """The JAX toolkit's depth preview window; there is no window here."""
    raise RuntimeError("display_depth_image shows the frame in an OpenCV imshow window, "
                       "which the port does not open; save the frames instead")


def countdown(seconds, message="Resuming in"):
    for i in range(seconds, 0, -1):
        logging.info(f"{message} {i} seconds...")
        time.sleep(1)


def handle_pause(frame_count, start_frame, interval, dim_frame, dim_interval):
    """A @dim_interval pause every @dim_frame frames, else @interval."""
    if (frame_count - start_frame + 1) % dim_frame == 0:
        logging.info("DIM LIGHT - pausing...")
        countdown(dim_interval, message="Resuming in")
    else:
        countdown(interval, message="Next capture in")


def _saved_frames(save_dir):
    """The saved colour frames: the flat layout (rgb_*.png), then the scene
    layout (rgb/rgb_*.png)."""
    return sorted(glob.glob(f"{save_dir}/rgb_*.png")) + sorted(
        glob.glob(f"{save_dir}/rgb/rgb_*.png"))


def get_last_frame_id(save_dir):
    """The id of the last saved colour frame, -1 when there is none."""
    files = _saved_frames(save_dir)
    if not files:
        return -1
    return int(os.path.splitext(os.path.basename(files[-1]))[0].split("_")[-1])


def save_info_json(save_dir, color_k_matrix):
    """info.json: each saved colour frame's K; returns its path."""
    info = {os.path.basename(f): {"K": np.asarray(color_k_matrix).tolist()}
            for f in _saved_frames(save_dir)}
    path = os.path.join(save_dir, "info.json")
    with open(path, "w") as f:
        json.dump(info, f, indent=2)
    return path


def capture_save(device, base_dir, frame_count=1, show=False):
    """Capture one frame and save it as frame @frame_count."""
    color, depth, points = capture_frame(device)
    if color is None or depth is None or points is None:
        logging.error("Failed to capture image or point cloud.")
        return False
    if show:
        display_color_image(color)
    save_frame(base_dir, color, depth, points, frame_count)
    return True


def pvnet_data_capture(device, device_config, save_dir, total_captures, interval=0,
                       dim_light_frame=10, dim_interval=0, show=False):
    """A PVNet-style capture campaign: save the calibration, resume after
    the last saved frame, capture @total_captures frames with the dim-light
    pauses, then write info.json."""
    c2d, d2c = get_extrinsics(device, device_config)
    save_extrinsics(save_dir, c2d, d2c)
    color_K, depth_K = get_intrinsics(device, device_config)
    save_intrinsics(save_dir, color_K.tolist(), depth_K.tolist())
    logging.info("Starting data capture...")
    start_frame = get_last_frame_id(save_dir) + 1
    for frame_count in range(start_frame, start_frame + total_captures):
        color, depth, points = capture_frame(device)
        save_frame(save_dir, color, depth, points, frame_count)
        logging.info(f"Captured and saved frame {frame_count}/{start_frame + total_captures - 1}")
        if show:
            display_color_image(color)
        handle_pause(frame_count, start_frame, interval, dim_light_frame, dim_interval)
    save_info_json(save_dir, color_K)
    logging.info("Data capture complete.")


if __name__ == "__main__":
    import sys

    dump_calibration(sys.argv[1] if len(sys.argv) > 1 else ".")
