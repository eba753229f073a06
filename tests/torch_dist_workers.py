"""Rank functions of tests/test_torch_sharding.py and
tests/test_torch_tensor_parallel.py, each run on every rank by
`sixdof_tpu_torch/parallel/sharding.py::spawn_ranks` as fn(mesh, inputs).

This module imports no JAX (a spawned rank would pay for its import): the
test hands each function numpy inputs and, for the networks, a directory of
port checkpoints, and compares what the ranks return with the JAX package.
Every function returns host values (numpy arrays, floats)."""
import torch


def _np(x):
    return x.detach().cpu().numpy()


def predict_rank(mesh, d):
    """Sharded refine of d["poses"]; sharded scores of the poses padded as
    JAX's shard_hypotheses pads them; the same scores with each shard scored
    on its own (a per-shard cross attention); and, with d["max_batch"], the
    scorer's tournament over the padded poses."""
    from sixdof_tpu_torch.io.mesh_io import load_mesh
    from sixdof_tpu_torch.models import predict as tp
    from sixdof_tpu_torch.ops.geometry import depth2xyzmap
    from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays
    from sixdof_tpu_torch.parallel.sharding import all_gather, pad_hypotheses, shard_hypotheses

    tr, ts = _predictors(d)
    m = load_mesh(d["mesh_path"])
    m.vertices = m.vertices - d["center"]
    arrays = make_mesh_arrays(m, "cpu")
    rgb01 = tp.to_rgb01(d["rgb"], "cpu")
    K = torch.tensor(d["K"])
    xyz = depth2xyzmap(torch.tensor(d["depth"]), K)
    poses = torch.tensor(d["poses"])
    kw = dict(compute_dtype=torch.float32, backface_cull=d["backface_cull"])
    refined = tp.refine_poses(tr.model, arrays, poses, rgb01, xyz, K, d["diameter"], 1.2, 0.02,
                              0.3490658503988659, 2, d["hw"], device_mesh=mesh, **kw)

    def score(p, device_mesh):
        return tp.score_poses(ts.model, arrays, p, rgb01, xyz, K, d["diameter"], 1.2, d["hw"],
                              mode="hybrid", device_mesh=device_mesh, **kw)

    padded, n = pad_hypotheses(poses, mesh)
    out = dict(refined=_np(refined), scores=_np(score(padded, mesh)),
               per_shard=_np(all_gather(score(shard_hypotheses(padded, mesh)[0], None), mesh)))
    if d["max_batch"]:
        ts.cfg["max_batch"] = d["max_batch"]
        out["tournament"] = _np(ts.predict(
            rgb=d["rgb"], depth=d["depth"], K=d["K"], ob_in_cams=_np(padded),
            mesh_tensors=arrays, mesh_diameter=d["diameter"], out_hw=d["hw"],
            backface_cull=d["backface_cull"], device_mesh=mesh)[0])
    return dict(out, collective_s=mesh.seconds["data"])


def _predictors(d, cfg=None):
    from sixdof_tpu_torch.models import predict as tp

    return (tp.PoseRefinePredictor("cpu", cfg=cfg, ckpt_dir=f"{d['ckpt']}/refiner.npz",
                                   compute_dtype=torch.float32),
            tp.ScorePredictor("cpu", cfg=cfg, ckpt_dir=f"{d['ckpt']}/scorer.npz",
                              compute_dtype=torch.float32))


def register_rank(mesh, d):
    """FoundationPose(device_mesh=mesh).register on d's frame at a reduced
    grid; the pose, the ranked poses and their scores."""
    from sixdof_tpu_torch.estimater import FoundationPose
    from sixdof_tpu_torch.io.mesh_io import load_mesh

    tr, ts = _predictors(d, cfg={"input_resize": d["hw"]})
    m = load_mesh(d["mesh_path"])
    est = FoundationPose(model_pts=m.vertices, model_normals=m.vertex_normals, mesh=m,
                         device="cpu", refiner=tr, scorer=ts, device_mesh=mesh, **d["engine"])
    step = len(est.rot_grid) // d["n_hypotheses"]
    est.rot_grid = est.rot_grid[::step][:d["n_hypotheses"]]
    pose = est.register(K=d["K"], rgb=d["rgb"], depth=d["depth"], ob_mask=d["mask"],
                        iteration=d["iteration"])
    return dict(pose=pose, poses=est.poses, scores=est.scores)


def capture_rank(mesh, d):
    """improve_and_raytrace with the restarts and the rays sharded."""
    from sixdof_tpu_torch.ops.icp import improve_and_raytrace

    t = {k: torch.as_tensor(v) for k, v in d.items()}
    out = improve_and_raytrace(t["src"], t["ones"], t["tgt"], t["tgt_n"], t["ones"],
                               t["init_tfs"], t["max_dists"], torch.eye(4), 0.02, t["tri"],
                               t["tri_mask"], t["ray_dirs"], t["ray_mask"], torch.eye(4),
                               max_iter=8, device_mesh=mesh)
    return [_np(x) for x in out]


def _box_arrays(d):
    from sixdof_tpu_torch.io.mesh_io import TriMesh
    from sixdof_tpu_torch.ops.rasterize import make_mesh_arrays

    return make_mesh_arrays(TriMesh(d["v"], d["f"]), "cpu")


def _trainers(mesh, d):
    """(net, trainer) of the refiner and the scorer on d's box, from the
    checkpoints in d["ckpt"] (the bundled weights)."""
    from sixdof_tpu_torch.models.networks import RefineNet, ScoreNetMultiPair
    from sixdof_tpu_torch.parallel import train as tr

    arrays = _box_arrays(d)
    cfg = tr.TrainConfig(**d["cfg"])
    for net, trainer_cls, model in (("refiner", tr.RefinerTrainer, RefineNet),
                                    ("scorer", tr.ScorerTrainer, ScoreNetMultiPair)):
        yield net, trainer_cls(model(c_in=6), arrays, d["K"], d["diameter"], cfg,
                               params=tr.load_init_params(d["ckpt"], net), device_mesh=mesh)


def trainer_rank(mesh, d):
    """One refiner step and one scorer step from the bundled weights, each
    rank rendering its slice of the same draws: the loss, every 997th entry
    of the averaged gradients, the largest entry and the trunk's largest."""
    return {net: trainer_step(trainer, torch.Generator().manual_seed(d["seed"]))
            for net, trainer in _trainers(mesh, d)}


def trainer_step(trainer, gen):
    """One step of @trainer from @gen, split to read the averaged gradients
    (split weights gathered whole) before Adam."""
    from sixdof_tpu_torch.parallel.tensor_parallel import full_tensors

    loss = trainer.gradients(trainer.batch(gen))
    grads = full_tensors(trainer.model, grads=True)
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    trainer.optimizer.step()
    return dict(loss=float(loss), grads=_np(flat[::997]), grad_max=float(flat.abs().max()),
                trunk_max=_trunk_max(grads))


def _trunk_max(tensors):
    """The largest entry of the convolution trunk's tensors."""
    return max(float(t.abs().max()) for k, t in tensors.items()
               if k.startswith(("encodeA", "encoderA")))


def _digests(tensors):
    import hashlib

    return {k: hashlib.sha1(_np(t).tobytes()).hexdigest() for k, t in tensors.items()}


def _local_rows(net, batch, mesh, L):
    """This data index's part of a whole fixed batch: the refiner's rows,
    the scorer's scenes (L hypotheses each)."""
    if net == "refiner":
        rows = mesh.rows(batch[0].shape[0])
        return [x[rows] for x in batch]
    scenes = mesh.rows(batch[2].shape[0])
    pairs = slice(scenes.start * L, scenes.stop * L)
    return [batch[0][pairs], batch[1][pairs], batch[2][scenes], batch[3][scenes]]


def tensor_parallel_rank(mesh, d):
    """The refiner and the scorer from the bundled weights on a (data,
    model) mesh: the loss and the whole averaged gradients of d's fixed
    crops (rank 0's gradients only), then one trainer step from d's draws
    (as trainer_rank) and digests of this rank's parameters after Adam;
    with d["save"], the refiner written there by save_params and the
    digests of the whole parameters it gathered."""
    from sixdof_tpu_torch.parallel.tensor_parallel import (full_state_dict, full_tensors,
                                                           split_parameters)
    from sixdof_tpu_torch.parallel.train import save_params

    out = {}
    for net, trainer in _trainers(mesh, d):
        fixed = [torch.as_tensor(x) for x in d["fixed"][net]]
        loss = trainer.gradients(_local_rows(net, fixed, mesh, d["cfg"]["n_hypotheses"]))
        grads = full_tensors(trainer.model, grads=True)
        res = dict(fixed_loss=float(loss), fixed_trunk_max=_trunk_max(grads),
                   split=sorted(split_parameters(trainer.model)))
        if mesh.rank == 0:
            res["fixed_grads"] = {k: _np(g) for k, g in grads.items()}
        res["step"] = trainer_step(trainer, torch.Generator().manual_seed(d["seed"]))
        res["digests"] = _digests(dict(trainer.model.named_parameters()))
        if d.get("save") and net == "refiner":
            res["saved"] = save_params(d["save"], net, trainer.model)
            res["saved_digests"] = _digests(full_state_dict(trainer.model))
        out[net] = res
    return dict(out, data_rank=mesh.data_rank, model_rank=mesh.model_rank,
                seconds=dict(mesh.seconds))


def mesh_capture_rank(mesh, d):
    """The mesh's layout (each axis's ranks, gathered over it) and the
    make_mesh errors on this world, then capture_rank on the mesh."""
    from sixdof_tpu_torch.parallel.sharding import all_gather, make_mesh

    me = torch.tensor([float(mesh.rank)])
    errors = []
    for n_data, n_model in ((3, 2), (None, 3), (1, 2)):
        try:
            make_mesh(n_data=n_data, n_model=n_model)
        except ValueError as e:
            errors.append(str(e))
    return dict(data_rank=mesh.data_rank, model_rank=mesh.model_rank, shape=dict(mesh.shape),
                data_axis=_np(all_gather(me, mesh)),
                model_axis=_np(all_gather(me, mesh, axis="model")), errors=errors,
                capture=capture_rank(mesh, d))


def field_rank(mesh, d):
    """One data-parallel object-field step (tests/test_parallel.py's field
    and batch, JAX's draws): the loss, the gradients and the field after
    Adam."""
    from sixdof_tpu_torch.models import object_field as of

    params = of.field_params_from_numpy(d["params"], "cpu")
    cfg, spec = of.ObjectFieldConfig(**d["cfg"]), of.HashGridSpec(**d["spec"])
    loss_fn = of.make_loss_fn(cfg, spec, sc=1.0)
    opt = torch.optim.Adam(params.parameters(), lr=cfg.lrate)
    draws = {k: torch.tensor(v) for k, v in d["draws"].items()}
    loss, _ = of.loss_and_grad(params, loss_fn, torch.as_tensor(d["batch"]), draws, mesh)
    grads = {k: _np(p.grad) for k, p in params.named_parameters()}
    opt.step()
    return dict(loss=float(loss), grads=grads,
                params={k: _np(p) for k, p in params.named_parameters()})


def gather_rank(mesh, n):
    """all_gather of a rank-valued vector of n entries; n < 0 makes rank 1
    raise."""
    from sixdof_tpu_torch.parallel.sharding import all_gather

    if n < 0 and mesh.rank == 1:
        raise ValueError("this rank fails")
    return _np(all_gather(torch.full((abs(n),), float(mesh.rank)), mesh))
