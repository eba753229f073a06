"""Reference-format H5 pose-pair dataset ingest.

Port of `sixdof_tpu/io/h5_dataset.py`, the reader of the reference's
``learning/datasets/h5_dataset.py`` (:20-219) training-data layout: one
top-level group per object key, each holding ``i_perturb``-indexed
subgroups whose image fields (``rgbA``/``rgbB``/``depthA``/``depthB``) are
PNG-encoded byte blobs, plus per-file scalars ``crop_ratio``,
``H_ori``/``W_ori``, ``trans_normalizer``/``rot_normalizer``.  An optional
``<file>_keys.pkl`` sidecar pre-lists the object keys (h5_dataset.py:36-42).

Decoded samples land in `models/pose_data.py`'s ``PoseData`` /
``BatchPoseData``.  ``transform_batch`` reproduces the reference's
normalization (rgb/255, depth -> xyz map recentred at poseA's translation,
radius-normalized with the |c| >= 2 invalid mask, h5_dataset.py:80-129) on
the batch's device, with `ops/warp.py::warp_perspective` for the kornia
warps.

h5py is imported only by the functions that open a file; without it they
raise ImportError naming h5py (the card has none).  The PNG blobs go
through `io/png.py::{encode_png, decode_png}` (imageio's channel order).
The reference's own training H5 files are unpublished; ``write_pair_h5``
emits the same layout, so synthetic pairs round-trip through this reader.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.pose_data import BatchPoseData, PoseData
from ..ops.geometry import depth2xyzmap_batch
from ..ops.warp import warp_perspective
from .png import decode_png, encode_png


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is required to read or write pose-pair H5 files, and it is "
                          "not installed") from e
    return h5py


def _decode_image(blob) -> np.ndarray:
    """Decode a PNG byte blob stored as an h5 scalar (h5_dataset.py:199-200)."""
    return decode_png(blob if isinstance(blob, bytes) else np.asarray(blob).tobytes())


class PairH5Dataset:
    """Pose-pair H5 reader (reference h5_dataset.py:20-129).

    Parameters mirror the reference: ``mode='test'`` constructs a transform-
    only instance bound to no file (predict_pose_refine.py:134), otherwise
    object keys are enumerated from the ``_keys.pkl`` sidecar or the file
    itself, truncated to ``max_num_key``.
    """

    DEPTH_SCALE = 1000.0  # depths stored as uint16 millimetres
    _INVALID_Z = 0.001  # PairH5Dataset threshold (h5_dataset.py:97)

    def __init__(self, cfg: Optional[dict] = None, h5_file: str = "",
                 mode: str = "train", max_num_key: Optional[int] = None):
        self.cfg = dict(cfg) if cfg else {}
        self.cfg.setdefault("normalize_xyz", True)
        self.h5_file = h5_file
        self.mode = mode
        self.n_perturb = None
        self.H_ori = None
        self.W_ori = None
        self.trans_normalizer = None
        self.rot_normalizer = None
        self.object_keys: List[str] = []

        if mode == "test" or not h5_file:
            return
        h5py = _h5py()
        key_file = h5_file.replace(".h5", "_keys.pkl")
        if os.path.exists(key_file):
            with open(key_file, "rb") as ff:
                self.object_keys = list(pickle.load(ff))
            if max_num_key is not None:
                self.object_keys = self.object_keys[:max_num_key]
        else:
            with h5py.File(h5_file, "r", libver="latest") as hf:
                for k in hf:
                    self.object_keys.append(k)
                    if max_num_key is not None and len(self.object_keys) >= max_num_key:
                        break

        with h5py.File(h5_file, "r", libver="latest") as hf:
            group = hf[self.object_keys[0]]
            cnt = 0
            for k_perturb in group:
                sub = group[k_perturb]
                if "i_perturb" in k_perturb:
                    cnt += 1
                if "crop_ratio" in sub:
                    self.cfg["crop_ratio"] = float(sub["crop_ratio"][()])
                if self.H_ori is None:
                    if "H_ori" in sub:
                        self.H_ori = int(sub["H_ori"][()])
                        self.W_ori = int(sub["W_ori"][()])
                    else:  # reference default (h5_dataset.py:64-66)
                        self.H_ori, self.W_ori = 540, 720
                if "trans_normalizer" in sub and self.trans_normalizer is None:
                    tn = sub["trans_normalizer"][()]
                    self.trans_normalizer = tn.tolist() if isinstance(tn, np.ndarray) else float(tn)
                if "rot_normalizer" in sub and self.rot_normalizer is None:
                    self.rot_normalizer = float(sub["rot_normalizer"][()]) / 180.0 * np.pi
            self.n_perturb = cnt

    def __len__(self):
        return 1 if self.mode == "test" else len(self.object_keys)

    # -- sample / batch loading ------------------------------------------

    def load_sample(self, key: str, i_perturb: int = 0) -> PoseData:
        """Decode one perturbation of one object key into a PoseData."""
        with _h5py().File(self.h5_file, "r", libver="latest") as hf:
            sub = hf[key][f"i_perturb{i_perturb}"]

            def arr(name):
                return np.asarray(sub[name][()], np.float32) if name in sub else None

            def scalar(name):
                return float(sub[name][()]) if name in sub else None

            return PoseData(
                rgbA=_decode_image(sub["rgbA"][()]),
                rgbB=_decode_image(sub["rgbB"][()]),
                depthA=_decode_image(sub["depthA"][()]).astype(np.float32) / self.DEPTH_SCALE,
                depthB=_decode_image(sub["depthB"][()]).astype(np.float32) / self.DEPTH_SCALE,
                poseA=arr("poseA"), poseB=arr("poseB"), K=arr("K"),
                mesh_diameter=scalar("mesh_diameter"), tf_to_crop=arr("tf_to_crop"),
                target=scalar("target"),
            )

    def load_batch(self, keys: Sequence[str], i_perturb: int = 0) -> BatchPoseData:
        """Stack samples (one per key) into a BatchPoseData of numpy arrays."""
        samples = [self.load_sample(k, i_perturb) for k in keys]

        def stack(field):
            vals = [getattr(s, field) for s in samples]
            if any(v is None for v in vals):
                return None
            return np.stack([np.asarray(v) for v in vals], axis=0)

        return BatchPoseData(
            rgbAs=stack("rgbA"), rgbBs=stack("rgbB"),
            depthAs=stack("depthA"), depthBs=stack("depthB"),
            poseA=stack("poseA"), poseB=stack("poseB"),
            Ks=stack("K"), tf_to_crops=stack("tf_to_crop"),
            mesh_diameters=stack("mesh_diameter"),
            labels=stack("target"),
        )

    # -- normalization transforms ----------------------------------------

    def _depth_to_xyz_crop(self, depths, batch: BatchPoseData, H_ori, W_ori, dev):
        """Depth crops -> xyz-map crops via an un-warp to the original frame
        (the kornia round trip of h5_dataset.py:92-95): each depth crop is
        nearest-unwarped to (H_ori, W_ori), lifted with its K, then
        re-warped to the crop."""
        H, W = depths.shape[-2], depths.shape[-1]
        tf = _f32(batch.tf_to_crops, dev)
        crop_to_ori = torch.linalg.inv(tf)
        d_ori = torch.stack([warp_perspective(d, t[None], (H_ori, W_ori), mode="nearest")[0]
                             for d, t in zip(depths, crop_to_ori)])
        xyz = depth2xyzmap_batch(d_ori, _f32(batch.Ks, dev))
        return torch.stack([warp_perspective(x, t[None], (H, W), mode="nearest")[0]
                            for x, t in zip(xyz, tf)])  # (B,H,W,3)

    def _recentre(self, xyz, batch: BatchPoseData, invalid_z: float, dev):
        bs = xyz.shape[0]
        poseA = _f32(batch.poseA, dev)
        invalid = xyz[..., 2:3] < invalid_z
        xyz = xyz - poseA[:, :3, 3].reshape(bs, 1, 1, 3)
        if self.cfg.get("normalize_xyz", True):
            radius = _f32(batch.mesh_diameters, dev).reshape(bs, 1, 1, 1) / 2.0
            xyz = xyz / radius
            # per-channel zeroing, matching the reference's expanded mask
            # (h5_dataset.py:101-103): |c|>=2 zeroes that channel only
            invalid = invalid | (xyz.abs() >= 2)
            xyz = torch.where(invalid, torch.zeros((), device=dev), xyz)
        return xyz

    def transform_batch(self, batch: BatchPoseData, H_ori: int, W_ori: int,
                        bound: int = 1) -> BatchPoseData:
        """rgb/255 + depth->xyz recentring (h5_dataset.py:119-127), on the
        device of the batch's tensors (the CPU for numpy fields).  Returns
        @batch, its fields replaced by float32 tensors."""
        dev = _batch_device(batch)
        # a device tensor: CUDA divides by a Python scalar as a multiply by
        # its reciprocal, an ulp off the true quotient of some levels
        level = torch.tensor(255.0, device=dev)
        batch.rgbAs = _f32(batch.rgbAs, dev) / level
        batch.rgbBs = _f32(batch.rgbBs, dev) / level
        if batch.xyz_mapAs is None:
            batch.xyz_mapAs = self._depth_to_xyz_crop(_f32(batch.depthAs, dev), batch, H_ori,
                                                      W_ori, dev)
        if batch.xyz_mapBs is None:
            batch.xyz_mapBs = self._depth_to_xyz_crop(_f32(batch.depthBs, dev), batch, H_ori,
                                                      W_ori, dev)
        batch.xyz_mapAs = self._recentre(_f32(batch.xyz_mapAs, dev), batch, self._INVALID_Z, dev)
        batch.xyz_mapBs = self._recentre(_f32(batch.xyz_mapBs, dev), batch, self._INVALID_Z, dev)
        return batch


def _f32(x, dev):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32, device=dev)


def _batch_device(batch: BatchPoseData):
    """The device of the batch's first tensor field; the CPU for numpy."""
    for v in batch.__dict__.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


class TripletH5Dataset(PairH5Dataset):
    """Scorer-side variant: looser invalid-z (0.1) applied unconditionally
    before recentring (h5_dataset.py:152-170)."""

    _INVALID_Z = 0.1


class ScoreMultiPairH5Dataset(TripletH5Dataset):
    """Multi-pair scorer dataset: train_num_pair tracks n_perturb
    (h5_dataset.py:185-189)."""

    def __init__(self, cfg=None, h5_file="", mode="train", max_num_key=None):
        super().__init__(cfg=cfg, h5_file=h5_file, mode=mode, max_num_key=max_num_key)
        if mode in ("train", "val") and self.n_perturb:
            self.cfg["train_num_pair"] = self.n_perturb


class PoseRefinePairH5Dataset(PairH5Dataset):
    """Refiner dataset: derives n_view from the concatenated depthA strip and
    loads the trans/rot normalizers (h5_dataset.py:192-214)."""

    def __init__(self, cfg=None, h5_file="", mode="train", max_num_key=None):
        super().__init__(cfg=cfg, h5_file=h5_file, mode=mode, max_num_key=max_num_key)
        if mode != "test" and self.object_keys:
            with _h5py().File(self.h5_file, "r", libver="latest") as hf:
                group = hf[self.object_keys[0]]
                for key_perturb in group:
                    sub = group[key_perturb]
                    depthA = _decode_image(sub["depthA"][()])
                    depthB = _decode_image(sub["depthB"][()])
                    n_view = max(1, depthA.shape[1] // max(1, depthB.shape[1]))
                    self.cfg["n_view"] = min(self.cfg.get("n_view", n_view), n_view)
                    break


def write_pair_h5(h5_file: str, samples: dict, crop_ratio: float = 1.2,
                  H_ori: int = 540, W_ori: int = 720,
                  trans_normalizer=(0.02, 0.02, 0.05),
                  rot_normalizer_deg: float = 20.0,
                  write_keys_pkl: bool = False) -> None:
    """Emit the reference H5 layout from in-memory samples.

    ``samples`` maps object-key -> list of PoseData (one per perturbation).
    Depths are stored as uint16 mm PNGs, rgb as uint8 PNGs, matching what the
    reference's loader decodes (h5_dataset.py:199-200).
    """
    with _h5py().File(h5_file, "w", libver="latest") as hf:
        for key, plist in samples.items():
            g = hf.create_group(str(key))
            for i, s in enumerate(plist):
                sub = g.create_group(f"i_perturb{i}")
                sub["rgbA"] = np.void(encode_png(np.asarray(s.rgbA, np.uint8)))
                sub["rgbB"] = np.void(encode_png(np.asarray(s.rgbB, np.uint8)))
                dA = np.round(np.asarray(s.depthA, np.float32) * PairH5Dataset.DEPTH_SCALE)
                dB = np.round(np.asarray(s.depthB, np.float32) * PairH5Dataset.DEPTH_SCALE)
                sub["depthA"] = np.void(encode_png(dA.astype(np.uint16)))
                sub["depthB"] = np.void(encode_png(dB.astype(np.uint16)))
                sub["crop_ratio"] = float(crop_ratio)
                sub["H_ori"], sub["W_ori"] = int(H_ori), int(W_ori)
                sub["trans_normalizer"] = np.asarray(trans_normalizer, np.float32)
                sub["rot_normalizer"] = float(rot_normalizer_deg)
                for field in ("poseA", "poseB", "K", "tf_to_crop"):
                    v = getattr(s, field)
                    if v is not None:
                        sub[field] = np.asarray(v, np.float32)
                if s.mesh_diameter is not None:
                    sub["mesh_diameter"] = float(s.mesh_diameter)
                if s.target is not None:
                    sub["target"] = float(s.target)
    if write_keys_pkl:
        with open(h5_file.replace(".h5", "_keys.pkl"), "wb") as ff:
            pickle.dump(list(samples.keys()), ff)
