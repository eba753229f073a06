"""The multi-device path over torch.distributed: a data x model mesh.

Port of `sixdof_tpu/parallel/sharding.py`.  JAX runs one controller over a
mesh of devices and XLA inserts the collectives.  Here every device is
driven by a process of its own (a rank); each rank runs the same program
on its slice of the work, and the collectives are explicit.

The `data` axis splits the work:
- the hypothesis axis of register: each rank refines and scores its slice
  of the hypotheses (`models/predict.py`), which are gathered;
- the ICP restarts and the defect rays of a capture (`ops/icp.py`);
- training and object-field batches: each rank takes the loss of its slice,
  and the gradients are averaged before the optimizer step.
The pad rules are JAX's: hypotheses repeat the first pose, restarts repeat
the last restart, rays are padded with masked-off rays, and an object-field
ray batch must divide the data axis.  Each `shard_*` helper returns this
rank's slice of the padded work and the true count.

The `model` axis (tensor parallelism, JAX's `param_shardings`) splits the
trainers' large layers by output feature (`parallel/tensor_parallel.py`).
Rank r sits at data index r // n_model and model index r % n_model, as
JAX reshapes its devices to (n_data, n_model).  `size`, `rows`, `group`,
`all_gather` and `average_gradients` mean the data axis, so every caller
that knows only the data axis runs on a 2-D mesh as JAX does: the model
ranks of a data index do that index's work, replicated.

Ranks: `spawn_ranks` starts them with torch.multiprocessing (spawn); they
meet through a FileStore in a temporary directory (no TCP port), and the
rendezvous and the wait for results each time out.  The caller chooses
the backend.  NCCL refuses two ranks on one device, so ranks that share a
card use gloo, and every tensor stays on the card: gloo has no CUDA
all_gather, so `all_gather` copies that one tensor through host memory for
gloo; its all_reduce takes CUDA tensors.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


class DeviceMesh:
    """A (data, model) mesh of `shape["data"] * shape["model"]` ranks over a
    process group, this process being rank `rank` of it: data index
    `data_rank` = rank // n_model, model index `model_rank` = rank %
    n_model.  `group` holds the ranks of this model index (the data axis),
    `model_group` those of this data index, `world_group` all of them (None:
    the default group).  `seconds` counts the host time spent in each
    axis's collectives (those over the whole mesh as data-axis time).  A
    1-rank axis needs no group (its collectives are the identity)."""

    def __init__(self, n_data=1, rank=0, group=None, backend=None, n_model=1,
                 model_group=None, world_group=None):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.rank = int(rank)
        self.data_rank, self.model_rank = divmod(self.rank, self.shape["model"])
        self.group = group
        self.model_group = model_group
        self.world_group = world_group
        self.backend = backend
        self.seconds = {"data": 0.0, "model": 0.0}

    @property
    def size(self):
        return self.shape["data"]

    def axis(self, name):
        """(size, process group) of axis @name: "data", "model", or "world"
        (every rank of the mesh)."""
        if name == "world":
            return self.shape["data"] * self.shape["model"], self.world_group
        return self.shape[name], self.group if name == "data" else self.model_group

    def rows(self, n):
        """This data index's slice of @n rows (@n divides the data axis)."""
        per = n // self.size
        return slice(self.data_rank * per, (self.data_rank + 1) * per)


def _subgroups(lines, ranks, group):
    """One process group per line of mesh positions (indices into @ranks,
    the global ranks of @group), and the one of this process: @group itself
    where one line spans it, None where the lines hold one rank.  Every rank
    creates every subgroup, in the same order (torch.distributed requires it
    even of the ranks outside a subgroup)."""
    if len(lines) == 1:
        return group
    if len(lines[0]) == 1:
        return None
    mine = None
    me = dist.get_rank()
    for line in lines:
        members = [ranks[i] for i in line]
        sub = dist.new_group(members)
        if me in members:
            mine = sub
    return mine


def make_mesh(n_data=None, n_model=1, group=None):
    """The (data, model) mesh over an initialised process group (@group,
    default the world), whose size must be n_data * n_model (@n_data None:
    size // n_model).  Rank r sits at (r // n_model, r % n_model)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or spawn_ranks)")
    world = dist.get_world_size(group)
    if n_model < 1 or world % n_model or (n_data is not None and n_data * n_model != world):
        raise ValueError(f"the process group's {world} ranks do not form a (data={n_data}, "
                         f"model={n_model}) mesh")
    n_data = world // n_model
    ranks = dist.get_process_group_ranks(group) if group is not None else list(range(world))
    grid = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    data_group = _subgroups([list(col) for col in zip(*grid)], ranks, group)
    model_group = _subgroups(grid, ranks, group)
    return DeviceMesh(n_data, dist.get_rank(group), data_group, dist.get_backend(group),
                      n_model=n_model, model_group=model_group, world_group=group)


def _pad(x, mesh, fill):
    """@x (n, ...) padded to a multiple of the data axis with rows of @fill
    (a (1, ...) tensor); returns (padded, n)."""
    n = x.shape[0]
    pad = (-n) % mesh.size
    if pad:
        x = torch.cat([x, fill.expand(pad, *x.shape[1:])])
    return x, n


def pad_hypotheses(poses, mesh):
    """Pad the (N,4,4) hypotheses to a multiple of the data axis by repeating
    the first pose (duplicates refine alike; callers slice back to N).
    Returns (padded, N)."""
    return _pad(poses, mesh, poses[:1])


def shard_hypotheses(poses, mesh):
    """This rank's slice of the padded hypotheses, and N."""
    padded, n = pad_hypotheses(poses, mesh)
    return padded[mesh.rows(padded.shape[0])], n


def shard_restarts(init_tfs, max_dists, mesh):
    """This rank's slice of the ICP restarts (padded by repeating the last
    restart, which converges alike) and of their thresholds, and the true
    restart count."""
    tfs, n = _pad(init_tfs, mesh, init_tfs[-1:])
    dists, _ = _pad(max_dists, mesh, max_dists[-1:])
    rows = mesh.rows(tfs.shape[0])
    return tfs[rows], dists[rows], n


def shard_rays(dirs, mask, mesh):
    """This rank's slice of the defect rays (padded with masked-off rays,
    which hit nothing) and of their mask, and the true ray count."""
    dirs, n = _pad(dirs, mesh, torch.zeros_like(dirs[:1]))
    mask, _ = _pad(mask, mesh, torch.zeros_like(mask[:1]))
    rows = mesh.rows(dirs.shape[0])
    return dirs[rows], mask[rows], n


def shard_field_rays(batch, mesh):
    """This rank's slice of an object-field ray minibatch (R,11), and R.  R
    must divide the data axis: the loss is a mean over rays, so padded rows
    would bias it instead of being harmless duplicates."""
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"ray batch of {n} does not divide the data axis ({mesh.size}); "
                         "pick n_rand as a multiple")
    return batch[mesh.rows(n)], n


def _timed(mesh, axis, fn, device):
    """Run the collective @fn over @axis, its host seconds (the device
    synchronised around it) added to `mesh.seconds` (a collective over the
    whole mesh counts as data-axis time)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    mesh.seconds["model" if axis == "model" else "data"] += time.perf_counter() - t0
    return out


def all_gather(local, mesh, dim=0, axis="data"):
    """The equal-shaped slices of the ranks of @axis concatenated along
    @dim in their order; every rank gets the whole tensor, on @local's
    device."""
    size, group = mesh.axis(axis)
    if size == 1:
        return local

    def gather():
        # gloo has no CUDA all_gather: this one tensor goes through host memory
        via_host = local.is_cuda and mesh.backend == "gloo"
        x = (local.cpu() if via_host else local).contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim).to(local.device)

    return _timed(mesh, axis, gather, local.device)


def all_reduce(x, mesh, axis):
    """The sum of @x over the ranks of @axis (a new tensor; @x itself
    where the axis holds one rank)."""
    size, group = mesh.axis(axis)
    if size == 1:
        return x

    def reduce():
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    return _timed(mesh, axis, reduce, x.device)


def average_gradients(params, mesh, axis="data"):
    """Replace each parameter's gradient by its mean over the ranks of
    @axis (a missing gradient counts as zero): one all_reduce of the
    gradients flattened together."""
    params = [p for p in params if p.requires_grad]
    size, _ = mesh.axis(axis)
    if size == 1 or not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh, axis) / size
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


def _rank_main(rank, world_size, fn, args, backend, store, timeout, threads, n_model,
               results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    try:  # the result (or the failure) goes out before this rank leaves the group
        results.put((rank, True, fn(make_mesh(n_model=n_model), *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _failures(results, failed, pending, wait=5.0):
    """The message of @failed ({rank: traceback}) and of every other rank
    that reports a failure within @wait seconds, until @pending ranks have
    reported (a rank that fails makes the others fail in their next
    collective: the first report need not be the cause)."""
    deadline = time.monotonic() + wait
    while len(failed) < pending and time.monotonic() < deadline:
        try:
            rank, ok, value = results.get(timeout=max(0.01, deadline - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            failed[rank] = value
    return "\n".join(f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items()))


def spawn_ranks(fn, world_size, args=(), backend="gloo", timeout=120.0, threads=None,
                n_model=1):
    """Run `fn(mesh, *args)` on @world_size new processes (torch.multiprocessing,
    spawn), one rank each, over @backend, @mesh being their (world_size /
    @n_model, @n_model) mesh; they meet through a FileStore in a temporary
    directory.  @fn must be importable by name (a module-level
    function) and return host values (numbers, numpy arrays).  The
    rendezvous and the wait for all results each time out after @timeout
    seconds; a failed rank raises with its traceback.  @threads: torch's
    CPU threads in each rank.  Returns the results in rank order."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, fn, tuple(args), backend,
                                   os.path.join(tmp, "store"), timeout, threads, n_model,
                                   results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    # a rank that died before it could report (a crash at
                    # start-up) leaves no result: stop waiting for it
                    gone = [r for r, p in enumerate(procs) if r not in out
                            and p.exitcode is not None and results.empty()]
                    if gone:
                        raise RuntimeError(f"rank {gone[0]} exited with code "
                                           f"{procs[gone[0]].exitcode} before its result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world_size - len(out)} of {world_size} ranks gave "
                                           f"no result within {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(_failures(results, {rank: value}, world_size - len(out)))
                out[rank] = value
        finally:
            for p in procs:  # after a failure the other ranks may wait in a collective
                p.join(timeout=30 if len(out) == world_size else 0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [out[r] for r in range(world_size)]
