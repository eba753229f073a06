"""BOP-format scene reader (the YCB-V / T-LESS / LineMOD directory layout).

Port of `sixdof_tpu/io/bop_reader.py`.  One scene of a BOP dataset:

  <scene_dir>/
    rgb/000000.png            (or .jpg, as BOP's train_pbr splits store them)
    depth/000000.png          (uint16; metres = value * depth_scale / 1000)
    mask_visib/000000_000000.png   (per frame and ground-truth instance)
    mask/000000_000000.png         (the amodal mask, optional)
    scene_camera.json         {"0": {"cam_K": [9], "depth_scale": s}, ...}
    scene_gt.json             {"0": [{"cam_R_m2c": [9], "cam_t_m2c": [3] mm,
                                      "obj_id": k}], ...}
    scene_gt_info.json        {"0": [{"visib_fract": f, ...}]}

  <models_dir>/ (for the dataset)
    obj_000001.ply ...
    models_info.json          {"1": {"diameter": mm, "symmetries_discrete":
                               [[16 floats]...], "symmetries_continuous": ...}}

Everything is converted at the boundary to the pipeline's conventions, as
`DataReader` gives them: metres, the OpenCV camera frame, (4,4) float
poses.  PNGs decode through `io/png.py` and JPEGs through `io/jpeg.py`,
both as ``cv2.imread`` does; resizes are OpenCV's INTER_NEAREST
(`io/readers.py::resize_nearest`).
"""
from __future__ import annotations

import glob
import json
import logging
import os

import numpy as np

from ..ops.geometry import symmetry_tfs_from_info
from .jpeg import read_jpeg_color
from .mesh_io import load_mesh
from .png import read_png, read_png_color
from .readers import resize_nearest


def _read_frame(path):
    """A colour frame as (H,W,3) uint8 BGR (``cv2.imread(path)``)."""
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        return read_jpeg_color(path)
    return read_png_color(path)


class BopSceneReader:
    """Per-frame getters over one BOP scene directory.

    @ob_id: the BOP object id this reader follows (a scene holds several
    instances; the first ground-truth object when None); @models_dir: the
    dataset's models (by default `models`, `models_eval` or `models_fine`
    beside the scenes tree); @shorter_side: resize frames so that their
    shorter side has this many pixels.
    """

    def __init__(self, scene_dir, ob_id=None, models_dir=None, shorter_side=None, zfar=np.inf):
        self.scene_dir = scene_dir
        self.zfar = zfar
        self.color_files = sorted(glob.glob(f"{scene_dir}/rgb/*.png")
                                  + glob.glob(f"{scene_dir}/rgb/*.jpg"))
        if not self.color_files:
            raise FileNotFoundError(f"no rgb frames under {scene_dir}/rgb")
        self.scene_camera = self._load_json("scene_camera", required=True)
        self.scene_gt = self._load_json("scene_gt")
        self.scene_gt_info = self._load_json("scene_gt_info")
        self.frame_ids = [int(os.path.splitext(os.path.basename(p))[0])
                          for p in self.color_files]
        self.ob_id = ob_id if ob_id is not None else self._first_object_id()
        self.models_dir = models_dir or self._guess_models_dir()

        self.color_H, self.color_W = _read_frame(self.color_files[0]).shape[:2]
        self.downscale = 1.0
        if shorter_side is not None:
            self.downscale = shorter_side / min(self.color_H, self.color_W)
            self.color_H = int(self.color_H * self.downscale)
            self.color_W = int(self.color_W * self.downscale)
        self.models_info = {}
        if self.models_dir and os.path.exists(f"{self.models_dir}/models_info.json"):
            with open(f"{self.models_dir}/models_info.json") as f:
                self.models_info = {int(k): v for k, v in json.load(f).items()}

    def _load_json(self, name, required=False):
        path = f"{self.scene_dir}/{name}.json"
        if not required and not os.path.exists(path):
            return {}
        with open(path) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def _first_object_id(self):
        if self.scene_gt:
            first = self.scene_gt[min(self.scene_gt)]
            if first:
                return int(first[0]["obj_id"])
        return None

    def _guess_models_dir(self):
        """The BOP convention: <dataset_root>/models beside the scenes tree."""
        cur = os.path.abspath(self.scene_dir)
        for _ in range(4):
            cur = os.path.dirname(cur)
            for name in ("models", "models_eval", "models_fine"):
                cand = os.path.join(cur, name)
                if os.path.exists(os.path.join(cand, "models_info.json")):
                    return cand
        return None

    def __len__(self):
        return len(self.color_files)

    def get_video_name(self):
        return os.path.basename(os.path.normpath(self.scene_dir))

    def _resize(self, img):
        if self.downscale == 1.0:
            return img
        return resize_nearest(img, self.color_W, self.color_H)

    def get_K(self, i=0):
        K = np.array(self.scene_camera[self.frame_ids[i]]["cam_K"], dtype=np.float64)
        K = K.reshape(3, 3).copy()
        if self.downscale != 1.0:
            K[:2] *= self.downscale
        return K

    @property
    def color_K(self):
        return self.get_K(0)

    def get_color(self, i=0):
        """(H,W,3) uint8 RGB."""
        return np.ascontiguousarray(self._resize(_read_frame(self.color_files[i])[..., ::-1]))

    def get_depth(self, i=0):
        """Metres (float64); under 1 mm or at least zfar set to 0."""
        path = os.path.splitext(self.color_files[i].replace("/rgb/", "/depth/"))[0] + ".png"
        scale = float(self.scene_camera[self.frame_ids[i]].get("depth_scale", 1.0))
        depth = self._resize(read_png(path).astype(np.float64) * scale / 1000.0)
        depth[(depth < 0.001) | (depth >= self.zfar)] = 0.0
        return depth

    def _gt_index(self, i):
        """Index of the first instance of self.ob_id in frame i's list."""
        for j, g in enumerate(self.scene_gt.get(self.frame_ids[i], [])):
            if int(g["obj_id"]) == self.ob_id:
                return j
        return None

    def _read_mask(self, path):
        m = read_png(path) > 0
        if self.downscale != 1.0:
            m = self._resize(m.astype(np.uint8)) > 0
        return m

    def get_mask(self, i=0, visib_only=True):
        """The followed object's visible mask (mask_visib/), else its amodal
        mask (mask/), else all False."""
        j = self._gt_index(i)
        if j is None:
            return np.zeros((self.color_H, self.color_W), dtype=bool)
        sub = "mask_visib" if visib_only else "mask"
        path = f"{self.scene_dir}/{sub}/{self.frame_ids[i]:06d}_{j:06d}.png"
        if not os.path.exists(path) and visib_only:
            return self.get_mask(i, visib_only=False)
        if not os.path.exists(path):
            logging.info(f"no mask at {path}")
            return np.zeros((self.color_H, self.color_W), dtype=bool)
        return self._read_mask(path)

    def get_gt_pose(self, i=0):
        """(4,4) object-in-camera pose in metres, or None."""
        j = self._gt_index(i)
        if j is None:
            return None
        g = self.scene_gt[self.frame_ids[i]][j]
        pose = np.eye(4)
        pose[:3, :3] = np.array(g["cam_R_m2c"], dtype=np.float64).reshape(3, 3)
        pose[:3, 3] = np.array(g["cam_t_m2c"], dtype=np.float64).reshape(3) / 1000.0
        return pose

    def get_visib_fract(self, i=0):
        """The ground truth's visible fraction from scene_gt_info.json."""
        j = self._gt_index(i)
        info = self.scene_gt_info.get(self.frame_ids[i])
        if j is None or info is None:
            return None
        return float(info[j].get("visib_fract", 1.0))

    def get_occ_mask(self, i=0):
        """Pixels of other instances that hide ours: the union of their
        visible masks within our amodal mask (uint8 0/1)."""
        fid = self.frame_ids[i]
        j = self._gt_index(i)
        occ = np.zeros((self.color_H, self.color_W), dtype=bool)
        if j is None:
            return occ.astype(np.uint8)
        amodal = self.get_mask(i, visib_only=False)
        for k in range(len(self.scene_gt.get(fid, []))):
            path = f"{self.scene_dir}/mask_visib/{fid:06d}_{k:06d}.png"
            if k != j and os.path.exists(path):
                occ |= self._read_mask(path)
        return (occ & amodal).astype(np.uint8)

    def get_gt_mesh(self):
        """The followed object's model in metres (BOP models are in mm)."""
        mesh = load_mesh(f"{self.models_dir}/obj_{self.ob_id:06d}.ply")
        mesh.vertices = mesh.vertices / 1000.0
        return mesh

    def get_model_diameter(self):
        """Metres, from models_info.json."""
        info = self.models_info.get(self.ob_id)
        return None if info is None else float(info["diameter"]) / 1000.0

    def get_symmetry_tfs(self, rot_angle_discrete=5):
        """(S,4,4) symmetry transforms, translations in metres, from
        models_info.json; the identity alone without an entry."""
        info = self.models_info.get(self.ob_id)
        if info is None:
            return np.eye(4)[None]
        return np.array(symmetry_tfs_from_info(info, rot_angle_discrete=rot_angle_discrete),
                        dtype=np.float64)
