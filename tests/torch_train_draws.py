"""Rebuild the random draws of the JAX trainer's batch makers and sensor
model from their key, by repeating each JAX body's key splits exactly, as
the port's draw dicts hold them (parallel/train.py, parallel/augment.py).
Shared by the port's trainer tests; the values are numpy arrays until
`to_torch`."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

U = jax.random.uniform


def _np(x):
    return np.asarray(x)


def rgb_draws(key, shape):
    N = shape[0]
    kg, kgam, kwb, kbl, ksh, krd = jax.random.split(key, 6)
    return dict(gain=U(kg, (N, 1, 1, 1), minval=-0.35, maxval=0.35),
                gamma=U(kgam, (N, 1, 1, 1), minval=-0.15, maxval=0.20),
                wb=U(kwb, (N, 1, 1, 3), minval=-0.08, maxval=0.08),
                blend=U(kbl, (N, 1, 1, 1)),
                shot=jax.random.normal(ksh, tuple(shape)),
                read=jax.random.normal(krd, tuple(shape)))


def xyz_draws(key, shape):
    N, H, W = shape[:3]
    kax, ku, khole, kth = jax.random.split(key, 4)
    return dict(axial=jax.random.normal(kax, (N, H, W)), drop=U(ku, (N, H, W)),
                field=U(khole, (N, 8, 8)), thresh=U(kth, (N, 1, 1), minval=0.0, maxval=2.0))


def pair_draws(key, shape):
    ksel, kr, kx = jax.random.split(key, 3)
    # jax.random.bernoulli(k, p, shape) is uniform(k, shape) < p
    return dict(select=U(ksel, (shape[0], 1, 1, 1)), rgb=rgb_draws(kr, shape),
                xyz=xyz_draws(kx, shape))


def _pose_draws(key, n, z_range):
    k1, k2, k3 = jax.random.split(key, 3)
    return dict(w=jax.random.normal(k1, (n, 3)),
                z=U(k2, (n,), minval=z_range[0], maxval=z_range[1]),
                xy=U(k3, (n, 2), minval=-0.03, maxval=0.03))


def _background_draws(key, n):
    k1, k2, k3 = jax.random.split(key, 3)
    return dict(z=U(k1, (n,), minval=0.03, maxval=0.25),
                base=U(k2, (n, 1, 1, 3), minval=0.05, maxval=0.9),
                coarse=U(k3, (n, 8, 8, 3), minval=-0.25, maxval=0.25))


def _occluder_draws(key, n, z_off):
    kz, kc, kr, ka, kg, kt = jax.random.split(key, 6)
    kb, kf = jax.random.split(kt)
    return dict(z=U(kz, (n,), minval=z_off[0], maxval=z_off[1]),
                c=U(kc, (n, 2, 1, 1), minval=0.1, maxval=0.9),
                r=U(kr, (n, 2, 1, 1), minval=0.08, maxval=0.3),
                ang=U(ka, (n, 1, 1), minval=0.0, maxval=jnp.pi),
                gate=U(kg, (n, 1, 1)),
                base=U(kb, (n, 1, 1, 3), minval=0.05, maxval=0.9),
                fine=U(kf, (n, 16, 16, 3), minval=-0.3, maxval=0.3))


def _scene_draws(kbg, knz, n, cfg):
    H, W = cfg.input_hw
    d = dict(background=_background_draws(kbg, n), noise=jax.random.normal(knz, (n, H, W, 1)))
    if cfg.p_occlusion > 0:
        q1, q2 = jax.random.split(jax.random.fold_in(knz, 1))
        d["occluders"] = [_occluder_draws(q1, n, (0.05, 0.25)),
                          _occluder_draws(q2, n, (-0.15, 0.05))]
    if cfg.p_sensor > 0:
        d["sensor"] = pair_draws(jax.random.fold_in(knz, 2), (n, H, W, 3))
    return d


def refiner_draws(key, cfg):
    """What `sixdof_tpu/parallel/train.py::make_refiner_batch(key, ...)` draws."""
    n = cfg.batch_size
    k1, k2, k3, k4 = jax.random.split(key, 4)
    ka, kb = jax.random.split(k2)
    amp_t, amp_r = cfg.trans_normalizer * 0.9, cfg.rot_normalizer * 1.2
    return dict(poses=_pose_draws(k1, n, cfg.z_range),
                perturb=dict(dt=U(ka, (n, 3), minval=-amp_t, maxval=amp_t),
                             dw=U(kb, (n, 3), minval=-amp_r, maxval=amp_r)),
                **_scene_draws(k3, k4, n, cfg))


def scorer_draws(key, cfg, n_scenes=4):
    """What `make_scorer_batch(key, ..., n_scenes)` draws."""
    n = n_scenes * cfg.n_hypotheses
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    kbg, knz = jax.random.split(k5)
    return dict(poses=_pose_draws(k1, n_scenes, cfg.z_range),
                dt=U(k2, (n, 3), minval=-1, maxval=1), dw=U(k3, (n, 3), minval=-1, maxval=1),
                ang=U(k4, (n,), minval=0.0, maxval=2 * jnp.pi),
                **_scene_draws(kbg, knz, n, cfg))


def to_torch(d):
    """A draw dict (nested dicts and lists) of JAX arrays -> torch tensors."""
    if isinstance(d, dict):
        return {k: to_torch(v) for k, v in d.items()}
    if isinstance(d, list):
        return [to_torch(v) for v in d]
    return torch.from_numpy(np.array(d))
