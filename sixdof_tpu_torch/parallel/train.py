"""Training: render-and-compare refiner and scorer fitting on synthetic pairs.

Port of `sixdof_tpu/parallel/train.py`.  Each step generates its batch on
the device: random ground-truth poses, bounded perturbations, both crops of
every pair rendered by `ops/rasterize.py::render_batch` (through raster
kernel K1 for CUDA tensors), a synthetic background, sensor noise, random
occluders and the optional sensor model; then a loss, a backward pass and
an Adam update.

The JAX batch makers draw from a key.  Here each is split in two:
- a draw function (`refiner_draws`, `scorer_draws`) that takes a
  `torch.Generator` on the device and returns a dict of tensors, every
  entry the value one `jax.random` call of the JAX body returns, with a
  static shape given the `TrainConfig`;
- a deterministic body (`make_refiner_batch`, `make_scorer_batch`) that
  takes those draws.
So the same draws give the JAX package's batch.  The batch makers run
under `torch.no_grad()` (the JAX loss closes over the batch, and no raster
kernel has a gradient); the networks train in float32 without autocast.

A trainer given a `device_mesh` (parallel/sharding.py, one process a rank)
trains over the mesh's axes, as the JAX trainers do:
- `data`: every rank makes the same draws from the same generator, takes
  the slice of its data index (the refiner's rows, the scorer's whole
  scenes) and renders only that slice through K1; the loss is the mean over
  the slice, and the gradients are averaged across the data ranks before
  Adam;
- `model` (n_model > 1): the whole model is built and initialised (or
  loaded) first and then split (`parallel/tensor_parallel.py`, JAX's
  `param_shardings`), so a split model is the unsplit one cut, bit for bit;
  the model ranks of a data index render the same slice, each split
  weight's gradient is averaged over its data group and every replicated
  one over the whole mesh, and Adam steps each rank's own shards and
  replicated parameters.
"""
from __future__ import annotations

import json
import logging
import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.checkpoint import MANIFEST
from ..models.networks import init_flax_style
from ..models.predict import _depth_alignment_score, occlusion_mask
from ..ops.geometry import compute_crop_window_tf_batch, egocentric_delta_pose_to_pose
from ..ops.lie import so3_exp_map
from ..ops.rasterize import MeshArrays, render_batch
from .augment import _normal, _pool, _uniform, maybe_degrade_pair, pair_draws, resize_linear
from .sharding import all_gather
from .tensor_parallel import full_state_dict, model_mesh, reduce_gradients, shard_model


class TrainConfig(NamedTuple):
    """The reference TrainingConfig fields the trainer consumes
    (training_config.py:18-101); see the JAX TrainConfig for each one."""

    batch_size: int = 64
    lr: float = 1e-4
    input_hw: tuple = (160, 160)
    trans_normalizer: float = 0.02
    rot_normalizer: float = 0.3490658503988659
    n_hypotheses: int = 8  # per scene, scorer
    z_range: tuple = (0.4, 0.8)
    # probability that a B crop gets random foreground clutter
    p_occlusion: float = 0.5
    # probability that a B crop gets the sensor model (parallel/augment.py)
    p_sensor: float = 0.0
    sensor_strength: float = 1.0
    # the predictors' visibility substitution at train time: False | True
    # (0.6 gate ceiling) | a float ceiling; must match inference
    occ_sub: object = False
    # scorer only: weight of the listwise distillation term against the
    # analytic depth/colour teacher (models/predict.py::_depth_alignment_score)
    w_distill: float = 0.0


# the occluder's depth offsets in front of the object: a near OCCLUDER, then
# a DISTRACTOR at roughly the object's depth (_apply_occluder)
OCCLUDER_Z_OFF = ((0.05, 0.25), (-0.15, 0.05))


# ------------------------------------------------------------------ draws --


def _pose_draws(gen, n, z_range):
    return dict(w=_normal(gen, (n, 3)), z=_uniform(gen, (n,), *z_range),
                xy=_uniform(gen, (n, 2), -0.03, 0.03))


def _background_draws(gen, n):
    return dict(z=_uniform(gen, (n,), 0.03, 0.25), base=_uniform(gen, (n, 1, 1, 3), 0.05, 0.9),
                coarse=_uniform(gen, (n, 8, 8, 3), -0.25, 0.25))


def _occluder_draws(gen, n, z_off):
    return dict(z=_uniform(gen, (n,), *z_off), c=_uniform(gen, (n, 2, 1, 1), 0.1, 0.9),
                r=_uniform(gen, (n, 2, 1, 1), 0.08, 0.3),
                ang=_uniform(gen, (n, 1, 1), 0.0, math.pi), gate=_uniform(gen, (n, 1, 1)),
                base=_uniform(gen, (n, 1, 1, 3), 0.05, 0.9),
                fine=_uniform(gen, (n, 16, 16, 3), -0.3, 0.3))


def _scene_draws(gen, n, cfg):
    """The draws every B crop takes: background, depth noise, clutter and
    the sensor model (the last two only where the config turns them on)."""
    H, W = cfg.input_hw
    d = dict(background=_background_draws(gen, n), noise=_normal(gen, (n, H, W, 1)))
    if cfg.p_occlusion > 0:
        d["occluders"] = [_occluder_draws(gen, n, z) for z in OCCLUDER_Z_OFF]
    if cfg.p_sensor > 0:
        d["sensor"] = pair_draws(gen, (n, H, W, 3))
    return d


def refiner_draws(gen: torch.Generator, cfg: TrainConfig):
    """Every random value `make_refiner_batch` takes, drawn on @gen's device."""
    n = cfg.batch_size
    amp_t, amp_r = cfg.trans_normalizer * 0.9, cfg.rot_normalizer * 1.2
    return dict(poses=_pose_draws(gen, n, cfg.z_range),
                perturb=dict(dt=_uniform(gen, (n, 3), -amp_t, amp_t),
                             dw=_uniform(gen, (n, 3), -amp_r, amp_r)),
                **_scene_draws(gen, n, cfg))


def scorer_draws(gen: torch.Generator, cfg: TrainConfig, n_scenes: int = 4):
    """Every random value `make_scorer_batch` takes, drawn on @gen's device."""
    n = n_scenes * cfg.n_hypotheses
    return dict(poses=_pose_draws(gen, n_scenes, cfg.z_range),
                dt=_uniform(gen, (n, 3), -1.0, 1.0), dw=_uniform(gen, (n, 3), -1.0, 1.0),
                ang=_uniform(gen, (n,), 0.0, 2 * math.pi), **_scene_draws(gen, n, cfg))


def slice_draws(draws, rows):
    """@draws with every tensor cut to @rows along its first axis."""
    if isinstance(draws, dict):
        return {k: slice_draws(v, rows) for k, v in draws.items()}
    if isinstance(draws, list):
        return [slice_draws(v, rows) for v in draws]
    return draws[rows]


# ------------------------------------------------------------------- body --


def _random_poses(d):
    """Object-in-camera poses: rotations exp(2 w), z and xy as drawn."""
    R = so3_exp_map(d["w"] * 2.0)
    n = R.shape[0]
    poses = torch.eye(4, dtype=torch.float32, device=R.device).repeat(n, 1, 1)
    poses[:, :3, :3] = R
    poses[:, :3, 3] = torch.cat([d["xy"], d["z"][:, None]], dim=-1)
    return poses


def _perturb(d, poses):
    """Egocentric perturbation by the drawn (dt, dw); returns (poses, dt, dw)."""
    return egocentric_delta_pose_to_pose(poses, d["dt"], so3_exp_map(d["dw"])), d["dt"], d["dw"]


def _crop_rays(tf_to_crops, K, H, W):
    """Per crop pixel, the full-image ray's (x/z, y/z) as two (B,H,W) maps."""
    xs = torch.arange(W, dtype=torch.float32, device=K.device)
    ys = torch.arange(H, dtype=torch.float32, device=K.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H,W,3)
    inv = torch.linalg.inv(tf_to_crops)
    full = torch.einsum("bij,hwj->bhwi", inv, grid)
    u = full[..., 0] / full[..., 2]
    v = full[..., 1] / full[..., 2]
    return u, v


def _crop_background(d, tf_to_crops, K, z_obj, out_hw):
    """A plane behind the object (0.03-0.25 m) with a low-frequency colour
    texture, for the B crop.  Returns (rgb_bg, xyz_bg), each (B,H,W,3)."""
    H, W = out_hw
    zbg = z_obj + d["z"]
    u, v = _crop_rays(tf_to_crops, K, H, W)
    dirx = (u - K[0, 2]) / K[0, 0]
    diry = (v - K[1, 2]) / K[1, 1]
    z = zbg[:, None, None]
    xyz_bg = torch.stack([dirx * z, diry * z, z.expand(dirx.shape)], dim=-1)
    rgb_bg = torch.clamp(d["base"] + resize_linear(d["coarse"], out_hw), 0.0, 1.0)
    return rgb_bg, xyz_bg


def _occluder_mask(d, out_hw, p_occ):
    """The rotated ellipse of each sample whose gate draw is below @p_occ,
    (B,H,W) bool."""
    H, W = out_hw
    c, r, ang = d["c"], d["r"], d["ang"]
    cx, cy = c[:, 0] * W, c[:, 1] * H
    rx, ry = r[:, 0] * W, r[:, 1] * H
    xs = torch.arange(W, dtype=torch.float32, device=c.device)[None, None, :]
    ys = torch.arange(H, dtype=torch.float32, device=c.device)[None, :, None]
    dx = xs - cx
    dy = ys - cy
    xr = dx * torch.cos(ang) + dy * torch.sin(ang)
    yr = -dx * torch.sin(ang) + dy * torch.cos(ang)
    return (((xr / rx) ** 2 + (yr / ry) ** 2) < 1.0) & (d["gate"] < p_occ)


def _crop_occluder(d, tf_to_crops, K, z_obj, out_hw, p_occ=0.5):
    """A random textured ellipse at the drawn offset in front of the object
    over ~p_occ of the samples.  Returns (occ (B,H,W,1) bool, rgb_occ,
    xyz_occ)."""
    H, W = out_hw
    zocc = torch.clamp(z_obj - d["z"], min=0.08)
    occ = _occluder_mask(d, out_hw, p_occ)
    u, v = _crop_rays(tf_to_crops, K, H, W)
    z = zocc[:, None, None]
    xyz_occ = torch.stack([(u - K[0, 2]) / K[0, 0] * z, (v - K[1, 2]) / K[1, 1] * z,
                           z.expand(u.shape)], dim=-1)
    rgb_occ = torch.clamp(d["base"] + resize_linear(d["fine"], out_hw), 0.0, 1.0)
    return occ[..., None], rgb_occ, xyz_occ


def _erode_edges(alpha, xyz, fill, r=2):
    """erode_depth's boundary invalidation: pixels within @r of the
    silhouette of @alpha (B,H,W,1) take @fill."""
    a = alpha[..., 0]
    amax = _pool(a, "max", 2 * r + 1)
    amin = _pool(a, "min", 2 * r + 1)
    edge = (amax > 0.5) & (amin < 0.5)
    return torch.where(edge[..., None], fill, xyz)


def _apply_occluder(draws, tf_to_crops, K, z_obj, out_hw, rgbB, xyzB, p_occ=0.5):
    """Z-composite the two clutter ellipses over B and erode the depth ring
    at each one's boundary."""
    for d in draws:
        occ, rgb_occ, xyz_occ = _crop_occluder(d, tf_to_crops, K, z_obj, out_hw, p_occ)
        # invalid (xyz = 0) pixels lose the z-test, so clutter paints over them
        zB = torch.where(torch.abs(xyzB[..., 2:3]) > 1e-6, xyzB[..., 2:3], math.inf)
        win = occ & (xyz_occ[..., 2:3] < zB)
        rgbB = torch.where(win, rgb_occ, rgbB)
        xyzB = torch.where(win, xyz_occ, xyzB)
        xyzB = _erode_edges(win.float(), xyzB, torch.zeros_like(xyzB))
    return rgbB, xyzB


def compose_pair(draws, rendA, rendB, poses_A, poses_B, tf_to_crops, K, cfg):
    """The network's (A, B) crops from the two renders: B is the render at
    the true pose over a synthetic background, with depth noise, the eroded
    silhouette ring, clutter and the sensor model; A is the render at the
    hypothesis.  xyz is relative to the hypothesis centre.
    Returns (A, B, xyzB) with xyzB the camera-frame B depth."""
    z_obj = poses_B[:, 2, 3]
    center = poses_A[:, :3, 3][:, None, None, :]
    rgb_bg, xyz_bg = _crop_background(draws["background"], tf_to_crops, K, z_obj, cfg.input_hw)
    aB = rendB["alpha"][..., None]
    noise = draws["noise"] * 0.0015
    xyzB = rendB["xyz_map"] + noise * torch.tensor([0.0, 0.0, 1.0], device=noise.device)
    rgbB = torch.where(aB > 0, rendB["color"], rgb_bg)
    xyzB = torch.where(aB > 0, xyzB, xyz_bg)
    xyzB = _erode_edges(aB, xyzB, torch.zeros_like(xyzB))
    if cfg.p_occlusion > 0:
        rgbB, xyzB = _apply_occluder(draws["occluders"], tf_to_crops, K, z_obj, cfg.input_hw,
                                     rgbB, xyzB, cfg.p_occlusion)
    if cfg.p_sensor > 0:
        rgbB, xyzB = maybe_degrade_pair(draws["sensor"], rgbB, xyzB, cfg.p_sensor,
                                        cfg.sensor_strength)
    A = torch.cat([rendA["color"], rendA["xyz_map"] - center], dim=-1)
    B = torch.cat([rgbB, xyzB - center], dim=-1)
    return A, B, xyzB


def _render_pair(mesh, hyp, true, K, mesh_diameter, cfg, plain_raster):
    H, W = cfg.input_hw
    tf_to_crops = compute_crop_window_tf_batch(hyp, K, crop_ratio=1.2, out_size=(W, H),
                                               mesh_diameter=mesh_diameter)
    rendA = render_batch(mesh, hyp, K, tf_to_crops, out_hw=cfg.input_hw, use_light=True,
                         plain_raster=plain_raster)
    rendB = render_batch(mesh, true, K, tf_to_crops, out_hw=cfg.input_hw, use_light=True,
                         plain_raster=plain_raster)
    return tf_to_crops, rendA, rendB


@torch.no_grad()
def make_refiner_batch(draws, mesh: MeshArrays, K, mesh_diameter, cfg: TrainConfig,
                       plain_raster=False):
    """Synthetic (A, B, target_dt, target_dw) batch for the refiner: B
    renders the true pose, A the perturbed one, both in A's crop window;
    the targets are the egocentric deltas from the perturbed pose to the
    true one.  @plain_raster: render through K1's plain version (the
    comparison run of chip_smoke.py); CUDA tensors otherwise launch K1."""
    gt = _random_poses(draws["poses"])
    # rotation perturbations beyond the normaliser (targets clip to +-1)
    pert, dt, dw = _perturb(draws["perturb"], gt)
    tf_to_crops, rendA, rendB = _render_pair(mesh, pert, gt, K, mesh_diameter, cfg,
                                             plain_raster)
    A, B, xyzB = compose_pair(draws, rendA, rendB, pert, gt, tf_to_crops, K, cfg)
    if cfg.occ_sub:
        # the predictors' rule (models/predict.py::_make_AB): the net must
        # see at train time what inference feeds it
        B = torch.where(occlusion_mask(rendA["xyz_map"][..., 2], xyzB[..., 2], cfg.occ_sub,
                                       0.001), A, B)
    # the predictor decodes R_corr = exp(-tanh(rot) * norm), so the
    # pre-transpose axis-angle target is +dw
    return A, B, gt[:, :3, 3] - pert[:, :3, 3], dw


def refiner_loss(model, A, B, target_dt, target_dw, cfg: TrainConfig):
    """L2 in the network's normalised pre-scale output space."""
    out = model(A, B)
    t_target = torch.clamp(target_dt / cfg.trans_normalizer, -0.999, 0.999)
    r_target = torch.clamp(target_dw / cfg.rot_normalizer, -0.999, 0.999)
    trans_loss = torch.mean(torch.sum((torch.tanh(out["trans"]) - t_target) ** 2, dim=-1))
    rot_loss = torch.mean(torch.sum((torch.tanh(out["rot"]) - r_target) ** 2, dim=-1))
    return trans_loss + rot_loss


def _linspace01(n, device):
    """jnp.linspace(0, 1, n) in float32: i / (n - 1), then exactly 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    head = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    return torch.cat([head, torch.ones(1, device=device)])


def scorer_hypotheses(draws, mesh_diameter, L):
    """The scorer batch's poses: per scene a true pose repeated L times and
    a ladder of hypotheses around it (rung 0 near-perfect, the top half
    with free rotations, the two rungs past the middle exact pi flips about
    an in-image axis).  Returns (gt, hyp), each (n_scenes * L, 4, 4)."""
    gt = torch.repeat_interleave(_random_poses(draws["poses"]), L, dim=0)
    n_scenes = gt.shape[0] // L
    scale = _linspace01(L, gt.device).repeat(n_scenes)
    dt = draws["dt"] * (scale[:, None] * mesh_diameter * 0.3)
    rot_amp = torch.where(scale > 0.5, math.pi, 0.6 * scale)
    dw = draws["dw"] * rot_amp[:, None]
    # 0.5 + 2 / max(L - 1, 1) in float32, as the JAX expression evaluates it
    top = float(np.float32(0.5) + np.float32(2.0) / np.float32(max(L - 1, 1)))
    is_flip = (scale > 0.5) & (scale <= top)
    ang = draws["ang"]
    flip_axis = torch.stack([torch.cos(ang), torch.sin(ang), torch.zeros_like(ang)], dim=-1)
    dw = torch.where(is_flip[:, None], flip_axis * math.pi + 0.05 * dw, dw)
    return gt, egocentric_delta_pose_to_pose(gt, dt, so3_exp_map(dw))


def scorer_targets(A, B, rendA, xyzB, hyp, gt, pos, mesh_diameter, L):
    """The scorer's (n_scenes, L) targets: -ADD / (0.1 diameter), the mean
    vertex displacement of each hypothesis from its true pose; and the
    analytic teacher's scores on the same degraded observations the net
    sees (models/predict.py::_depth_alignment_score)."""
    vh = torch.einsum("lij,vj->lvi", hyp[:, :3, :3], pos) + hyp[:, None, :3, 3]
    vg = torch.einsum("lij,vj->lvi", gt[:, :3, :3], pos) + gt[:, None, :3, 3]
    add = torch.linalg.norm(vh - vg, dim=-1).mean(dim=-1)
    target = (-add / (0.1 * mesh_diameter)).reshape(-1, L)
    center = hyp[:, :3, 3][:, None, None, :]
    rend_t = {"alpha": rendA["alpha"], "xyzA_m": rendA["xyz_map"] - center,
              "xyzB_m": xyzB - center, "obs_validB": xyzB[..., 2] > 0.1}
    teacher = _depth_alignment_score(A, B, rend_t, hyp, mesh_diameter).reshape(-1, L)
    return target, teacher


@torch.no_grad()
def make_scorer_batch(draws, mesh: MeshArrays, K, mesh_diameter, cfg: TrainConfig,
                      plain_raster=False):
    """n_scenes x L hypotheses around true poses, in one render call each
    for A and B.  Returns A, B (n_scenes*L, H, W, 6), the ADD-derived
    target (n_scenes, L) and the analytic teacher's scores (n_scenes, L)."""
    L = cfg.n_hypotheses
    gt, hyp = scorer_hypotheses(draws, mesh_diameter, L)
    tf_to_crops, rendA, rendB = _render_pair(mesh, hyp, gt, K, mesh_diameter, cfg, plain_raster)
    A, B, xyzB = compose_pair(draws, rendA, rendB, hyp, gt, tf_to_crops, K, cfg)
    target, teacher = scorer_targets(A, B, rendA, xyzB, hyp, gt, mesh.pos, mesh_diameter, L)
    return A, B, target, teacher


def scorer_loss(model, A, B, target, teacher=None, w_distill=0.0):
    """Listwise ranking cross-entropy + 0.3 x regression on the ADD proxy,
    + @w_distill x listwise cross-entropy against softmax(10 x teacher)."""
    ns, L = target.shape
    logits = model(A, B, L=L)["score_logit"].reshape(ns, L)
    log_p = F.log_softmax(logits, dim=-1)
    ce = -torch.mean(torch.sum(F.softmax(target, dim=-1) * log_p, dim=-1))
    reg = torch.mean((logits - target) ** 2)
    loss = ce + 0.3 * reg
    if teacher is not None and w_distill > 0:
        soft = F.softmax(teacher.detach() * 10.0, dim=-1)
        loss = loss + w_distill * -torch.mean(torch.sum(soft * log_p, dim=-1))
    return loss


def _self_biased_cross_attention_init(model):
    """W_k := W_q in the scorer's cross-hypothesis attention, for training
    from scratch: attention over the L hypotheses then starts self-focused
    instead of uniform, so each hypothesis's identity reaches the score
    head from step 0.  torch's in_proj_weight is (3D, D), the transpose of
    flax's kernel: rows D:2D take rows 0:D."""
    att = getattr(model, "att_cross", None)
    if att is not None:
        with torch.no_grad():
            D = att.in_proj_weight.shape[1]
            att.in_proj_weight[D:2 * D] = att.in_proj_weight[:D]
    return model


# --------------------------------------------------------------- trainers --


class _Trainer:
    """One model and its Adam (optax.adam's defaults: betas 0.9/0.999, eps
    1e-8 outside the square root), stepping on one object's mesh.  Trainers
    made by `sharing` step the same model and optimiser on other meshes (the
    round-robin over objects)."""

    name = ""

    def __init__(self, model, mesh_arrays: MeshArrays, K, mesh_diameter,
                 cfg: TrainConfig = TrainConfig(), device_mesh=None, params=None, tx=None,
                 seed=0, _shared=None):
        """JAX's parameters in its order: @params a state dict to start from
        (else a flax-style initialisation from @seed); @tx a function from
        the model's parameters to its optimiser (optax's transform; default
        Adam at cfg.lr)."""
        self.model = model
        self.mesh_arrays = mesh_arrays
        self.device = mesh_arrays.pos.device
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=self.device)
        self.mesh_diameter = float(mesh_diameter)
        self.cfg = cfg
        self.device_mesh = device_mesh
        if device_mesh is not None and self._units() % device_mesh.size:
            raise ValueError(f"the {self.name} batch's {self._units()} {self._unit_name} do "
                             f"not divide the data axis ({device_mesh.size})")
        if _shared is not None:
            self.optimizer = _shared
            return
        if params is not None:
            model.load_state_dict(params)
        else:
            self._init(model, torch.Generator().manual_seed(int(seed)))
        model.to(self.device).train()
        if device_mesh is not None and device_mesh.shape["model"] > 1:
            shard_model(model, device_mesh)
        self.optimizer = (tx or (lambda ps: torch.optim.Adam(ps, lr=cfg.lr)))(model.parameters())

    def _init(self, model, gen):
        init_flax_style(model, gen)

    def sharing(self, mesh_arrays: MeshArrays, K, mesh_diameter):
        """A trainer on another object that steps this model and optimiser."""
        return type(self)(self.model, mesh_arrays, K, mesh_diameter, self.cfg,
                          device_mesh=self.device_mesh, _shared=self.optimizer)

    def _local(self, draws):
        """This rank's slice of a step's draws (all of them without a mesh)."""
        if self.device_mesh is None:
            return draws
        return self._slice(draws, self.device_mesh.rows(self._units()))

    def _slice(self, draws, rows):
        return slice_draws(draws, rows)

    def step(self, gen: torch.Generator):
        """One step on a fresh batch from @gen; returns the loss as a 0-d
        device tensor (no host synchronisation without a mesh)."""
        return self.update(self.batch(gen))

    def train(self, n_steps, generator=None, log_every=10):
        """@n_steps steps drawing from @generator (default seeded 0, where
        JAX's default key is PRNGKey(0)); returns the losses as floats."""
        gen = generator if generator is not None \
            else torch.Generator(device=self.device).manual_seed(0)
        losses = []
        for i in range(n_steps):
            losses.append(float(self.step(gen)))
            if log_every and i % log_every == 0:
                logging.info(f"{self.name} step {i}: loss {losses[-1]:.5f}")
        return losses

    def gradients(self, batch):
        """Forward and backward on @batch, the gradients averaged across the
        mesh's ranks; returns the loss, its mean across the data ranks."""
        loss = self.loss(*batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if self.device_mesh is not None:
            reduce_gradients(self.model, self.device_mesh)
            loss = all_gather(loss.reshape(1), self.device_mesh).mean()
        return loss

    def update(self, batch):
        """`gradients` and the Adam update on @batch; returns the loss."""
        loss = self.gradients(batch)
        self.optimizer.step()
        return loss


class RefinerTrainer(_Trainer):
    """Trains RefineNet on synthetic perturbation pairs of one object."""

    name = "refiner"
    _unit_name = "pairs"

    def _units(self):
        return self.cfg.batch_size

    def batch(self, gen):
        """This rank's part of a batch drawn from @gen."""
        return make_refiner_batch(self._local(refiner_draws(gen, self.cfg)), self.mesh_arrays,
                                  self.K, self.mesh_diameter, self.cfg)

    def loss(self, A, B, target_dt, target_dw):
        return refiner_loss(self.model, A, B, target_dt, target_dw, self.cfg)


class ScorerTrainer(_Trainer):
    """Trains ScoreNetMultiPair on hypothesis ladders (4 scenes a step)."""

    name = "scorer"
    _unit_name = "scenes"
    n_scenes = 4

    def _units(self):
        # the listwise loss works within each scene: shard whole scenes
        return self.n_scenes

    def _slice(self, draws, rows):
        """Scenes @rows: the poses' rows, and the L hypotheses of each."""
        L = self.cfg.n_hypotheses
        hyp = slice(rows.start * L, rows.stop * L)
        return dict(slice_draws({k: v for k, v in draws.items() if k != "poses"}, hyp),
                    poses=slice_draws(draws["poses"], rows))

    def _init(self, model, gen):
        _self_biased_cross_attention_init(init_flax_style(model, gen))

    def batch(self, gen):
        """This rank's scenes of a batch drawn from @gen."""
        return make_scorer_batch(self._local(scorer_draws(gen, self.cfg, self.n_scenes)),
                                 self.mesh_arrays, self.K, self.mesh_diameter, self.cfg)

    def loss(self, A, B, target, teacher):
        return scorer_loss(self.model, A, B, target, teacher, self.cfg.w_distill)


def overfit_fixed_batch(model, batch, steps, lr, cfg: TrainConfig, clip=None):
    """@steps Adam(@lr) steps of the refiner loss on one fixed @batch, the
    gradients clipped to global norm @clip first where given (the JAX
    package's overfit test chains optax.clip_by_global_norm(1.0) before
    adam(3e-4)); returns the losses as floats, read once at the end."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    losses = []
    for _ in range(steps):
        loss = refiner_loss(model, *batch, cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if clip:
            torch.nn.utils.clip_grad_norm_(model.parameters(), clip)
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).tolist()


# ------------------------------------------------------------ checkpoints --


def load_init_params(ckpt, net):
    """The state dict to fine-tune @net from, from anything
    `models/checkpoint.py::resolve` takes; None where @ckpt names nothing
    (train from scratch)."""
    from ..models import checkpoint

    path = checkpoint.resolve(ckpt, net)
    if path is None:
        if ckpt:
            logging.warning(f"{ckpt!r} names no {net} checkpoint: training from scratch")
        return None
    if checkpoint.stored_dtype(path, net) == "bfloat16":
        # The bundled export stores bf16 roundings of the trained weights,
        # which load_params refuses for float32 compute on purpose.  They
        # are taken here explicitly: fine-tuning starts from the widened
        # bf16 values.
        logging.info(f"fine-tuning {net} from {path}: widened bf16 weights, which differ "
                     "from the JAX trainer's fp32 orbax start by bf16 rounding")
        return checkpoint.load_params(path, net, compute_dtype=torch.bfloat16)
    logging.info(f"fine-tuning {net} from {path}")
    return checkpoint.load_params(path, net, compute_dtype=torch.float32)


def save_params(out_dir, net, model, cfg=None):
    """Write @model's weights as `<out_dir>/<net>.npz` (every array float32)
    and its entry in `<out_dir>/MANIFEST.json`, the format
    `models/checkpoint.py` loads; @cfg: the predictor cfg the weights were
    trained with (e.g. {"occ_sub": 0.85}).  Entries of other networks in an
    existing manifest stay.  Crash-safe: each file is written to a
    temporary sibling and then renamed over the old one.  A model split
    over a model axis is gathered whole first (every rank of its mesh
    calls this), rank 0 of the mesh writes, and every rank returns once the
    file is there."""
    mesh = model_mesh(model)
    sd = {k: v.detach().float().cpu().numpy() for k, v in full_state_dict(model).items()}
    path = os.path.join(out_dir, f"{net}.npz")
    if mesh is None or mesh.rank == 0:
        _write_params(out_dir, net, path, sd, cfg)
    if mesh is not None:
        dist.barrier(group=mesh.world_group)
    return path


def _write_params(out_dir, net, path, sd, cfg):
    """save_params' files: @sd ({name: float32 array}) at @path, and @net's
    manifest entry."""
    os.makedirs(out_dir, exist_ok=True)
    tmp = path + ".tmp-save.npz"
    np.savez(tmp, **sd)
    mpath = os.path.join(out_dir, MANIFEST)
    manifest = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    entry = {"compute_dtype": "float32", "arrays": {k: "fp32" for k in sd}}
    if cfg:
        entry["cfg"] = dict(cfg)
    manifest[net] = entry
    mtmp = mpath + ".tmp-save"
    with open(mtmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    os.replace(mtmp, mpath)
