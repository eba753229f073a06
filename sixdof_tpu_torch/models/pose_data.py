"""Pose-pair batch containers (reference learning/datasets/pose_dataset.py).

Port of `sixdof_tpu/models/pose_data.py`.  `PoseData` is one sample and
`BatchPoseData` a batch, with the reference's field names.  The fields
hold numpy arrays as the H5 reader decodes them, or tensors once
`device()` has moved them:
- `device(device=None)` turns every array into a tensor on the resolved
  device (the card unless the caller passes e.g. "cpu"); `cuda` is an
  alias, as in the reference;
- `pin_memory()` pins the CPU tensors, the reference's meaning (the JAX
  package's is a no-op); pinning needs a card;
- `select_by_indices(ids)` gathers the same rows of every field (the
  scorer tournament's selection, reference :129-134).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class PoseData:
    """Single sample (reference pose_dataset.py:20-63)."""

    rgbA: Optional[np.ndarray] = None
    rgbB: Optional[np.ndarray] = None
    depthA: Optional[np.ndarray] = None
    depthB: Optional[np.ndarray] = None
    maskA: Optional[np.ndarray] = None
    maskB: Optional[np.ndarray] = None
    normalA: Optional[np.ndarray] = None
    normalB: Optional[np.ndarray] = None
    xyz_mapA: Optional[np.ndarray] = None
    xyz_mapB: Optional[np.ndarray] = None
    poseA: Optional[np.ndarray] = None
    poseB: Optional[np.ndarray] = None
    K: Optional[np.ndarray] = None
    target: Optional[float] = None
    mesh_diameter: Optional[float] = None
    tf_to_crop: Optional[np.ndarray] = None
    crop_mask: Optional[np.ndarray] = None
    model_pts: Optional[np.ndarray] = None
    label: Optional[np.ndarray] = None
    model_scale: Optional[np.ndarray] = None


class BatchPoseData:
    """Batched pose-pair data (reference pose_dataset.py:66-135)."""

    def __init__(self, rgbAs=None, rgbBs=None, depthAs=None, depthBs=None, normalAs=None,
                 normalBs=None, maskAs=None, maskBs=None, poseA=None, poseB=None,
                 xyz_mapAs=None, xyz_mapBs=None, tf_to_crops=None, Ks=None,
                 crop_masks=None, model_pts=None, mesh_diameters=None, labels=None):
        self.rgbAs = rgbAs
        self.rgbBs = rgbBs
        self.depthAs = depthAs
        self.depthBs = depthBs
        self.normalAs = normalAs
        self.normalBs = normalBs
        self.poseA = poseA
        self.poseB = poseB
        self.maskAs = maskAs
        self.maskBs = maskBs
        self.xyz_mapAs = xyz_mapAs
        self.xyz_mapBs = xyz_mapBs
        self.tf_to_crops = tf_to_crops
        self.crop_masks = crop_masks
        self.Ks = Ks
        self.model_pts = model_pts
        self.mesh_diameters = mesh_diameters
        self.labels = labels

    def device(self, device=None):
        """Every array as a tensor on @device (None: the card, which raises
        without one; e.g. "cpu" on request), float64 narrowed to float32
        as JAX's `jnp.asarray` does.  Returns self."""
        dev = resolve_device(device)
        for k, v in self.__dict__.items():
            if v is not None:
                t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                if t.dtype == torch.float64:
                    t = t.float()
                self.__dict__[k] = t.to(dev)
        return self

    cuda = device  # reference-compatible alias

    def pin_memory(self):
        """Pin every CPU tensor field (faster, asynchronous copies to the
        card).  Returns self."""
        if not torch.cuda.is_available():
            raise RuntimeError("pin_memory needs a CUDA card: pinned host memory is page-locked "
                               "for copies to it")
        for k, v in self.__dict__.items():
            if isinstance(v, torch.Tensor) and v.device.type == "cpu":
                self.__dict__[k] = v.pin_memory()
        return self

    def select_by_indices(self, ids):
        """A new batch holding rows @ids of every field."""
        out = BatchPoseData()
        for k, v in self.__dict__.items():
            if v is not None:
                if isinstance(v, torch.Tensor):
                    out.__dict__[k] = v[torch.as_tensor(np.asarray(ids), device=v.device)]
                else:
                    out.__dict__[k] = v[np.asarray(ids)]
        return out
