#!/usr/bin/env python3
"""Export the bundled orbax checkpoints as numpy files the PyTorch port reads.

    JAX_PLATFORMS=cpu python tools/export_torch_weights.py [--src weights] [--out weights_torch]

Loads `<src>/refiner` and `<src>/scorer` through the JAX predictors (orbax,
on the CPU), converts each parameter tree to the state dict of the port's
networks (`sixdof_tpu_torch/models/weights.py::params_from_jax`) and writes
`<out>/refiner.npz`, `<out>/scorer.npz` (`np.savez_compressed`) and
`<out>/MANIFEST.json`.

The predictors run the networks with `compute_dtype=bfloat16`: flax casts
every Dense and Conv parameter to bf16 (round to nearest even) before use,
while the LayerNorms and the output heads compute in fp32.  An array that
is only ever used after that cast loses nothing when stored as its bf16
rounding, so such arrays are stored as their bf16 bit patterns (`uint16`,
numpy has no bf16) and the rest as fp32.  Which arrays those are is decided
here by measurement, not from a list: an array is a bf16 candidate when
rounding it alone leaves every intermediate output of the JAX network
(`capture_intermediates`) bit-equal on a seeded input; all candidates are
then rounded together and the network's intermediates are checked again,
bit for bit, at the predictor's input size.  Any difference raises.

`sixdof_tpu_torch/models/checkpoint.py::load_params` reads the result.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NETS = ("refiner", "scorer")


def bf16_round(a):
    """float32 array -> (its RNE bf16 rounding as float32, the bf16 bits as uint16)."""
    import ml_dtypes

    b = np.asarray(a, dtype=np.float32).astype(ml_dtypes.bfloat16)
    return b.astype(np.float32), b.view(np.uint16)


def sha256_tree(src):
    """{relative path: sha256} of every file under @src."""
    out = {}
    for root, _, files in os.walk(src):
        for name in sorted(files):
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, src)] = hashlib.sha256(f.read()).hexdigest()
    return dict(sorted(out.items()))


def _predictor(net, ckpt_dir):
    import jax.numpy as jnp

    from sixdof_tpu.models.predict import PoseRefinePredictor, ScorePredictor

    cls = PoseRefinePredictor if net == "refiner" else ScorePredictor
    return cls(ckpt_dir=ckpt_dir, compute_dtype=jnp.bfloat16)


def _intermediates_fn(pred, net, hw, seed):
    """params -> every intermediate output of the network (a flat list of
    numpy arrays) on a seeded input of crop size @hw."""
    import jax

    rng = np.random.RandomState(seed)
    n = 4 if net == "scorer" else 2
    c = pred.cfg["c_in"]
    A = rng.uniform(-1, 1, (n, hw, hw, c)).astype(np.float32)
    B = rng.uniform(-1, 1, (n, hw, hw, c)).astype(np.float32)
    extra = (2,) if net == "scorer" else ()  # L: two pairs of two candidates

    @jax.jit
    def run(params):
        out, state = pred.model.apply({"params": params}, A, B, *extra,
                                      capture_intermediates=True, mutable=["intermediates"])
        return out, state["intermediates"]

    def fn(params):
        return [np.asarray(x) for x in jax.tree.leaves(run(params))]

    return fn


def _same_bits(xs, ys):
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and np.array_equal(x.view(np.uint8), y.view(np.uint8)) for x, y in zip(xs, ys))


def bf16_safe_tree(pred, net, params):
    """The flax tree with every bf16-safe leaf replaced by its rounding
    (as float32), and the number of leaves rounded."""
    import jax

    probe = _intermediates_fn(pred, net, 64, seed=0)
    base = probe(params)
    leaves, treedef = jax.tree.flatten(params)
    rounded = [bf16_round(x)[0] for x in leaves]
    keep = []
    for i, (x, r) in enumerate(zip(leaves, rounded)):
        if np.array_equal(x, r):
            keep.append(r)  # already bf16-exact
            continue
        trial = list(leaves)
        trial[i] = r
        keep.append(r if _same_bits(probe(jax.tree.unflatten(treedef, trial)), base) else x)
    tree = jax.tree.unflatten(treedef, keep)
    # all of them at once, at the predictor's own crop size
    full = _intermediates_fn(pred, net, pred.cfg["input_resize"][0], seed=1)
    if not _same_bits(full(tree), full(params)):
        raise RuntimeError(f"{net}: rounding the bf16-safe arrays together changes the outputs")
    n_rounded = sum(not np.array_equal(a, b) for a, b in zip(leaves, keep))
    return tree, n_rounded


def export(src, out):
    import jax

    from sixdof_tpu_torch.models.weights import params_from_jax

    os.makedirs(out, exist_ok=True)
    manifest = {"compute_dtype": "bfloat16", "tool": "tools/export_torch_weights.py"}
    for net in NETS:
        ckpt_dir = os.path.join(src, net)
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(f"no checkpoint at {ckpt_dir}")
        pred = _predictor(net, ckpt_dir)
        params = jax.tree.map(np.asarray, pred.params)
        tree, n_rounded = bf16_safe_tree(pred, net, params)
        sd = params_from_jax(tree)
        arrays, kinds = {}, {}
        for key, t in sd.items():
            a = t.numpy()
            r, bits = bf16_round(a)
            if np.array_equal(r, a):
                arrays[key], kinds[key] = bits, "bf16"
            else:
                arrays[key], kinds[key] = a, "fp32"
        path = os.path.join(out, f"{net}.npz")
        np.savez_compressed(path, **arrays)
        # the JAX predictor reads an OCC_SUB marker beside the checkpoint into
        # its cfg; the port's predictor takes the same override from here
        cfg = ({"occ_sub": pred.cfg["occ_sub"]}
               if os.path.exists(os.path.join(ckpt_dir, "OCC_SUB")) else {})
        manifest[net] = {
            "source": os.path.relpath(ckpt_dir, REPO) if ckpt_dir.startswith(REPO) else ckpt_dir,
            "sha256": sha256_tree(ckpt_dir),
            "cfg": cfg,
            "parameters": int(sum(a.size for a in arrays.values())),
            "arrays": kinds,
        }
        n_bf16 = sum(k == "bf16" for k in kinds.values())
        print(f"{net}: {len(kinds)} arrays, {n_bf16} bf16 ({n_rounded} rounded), "
              f"{len(kinds) - n_bf16} fp32 -> {path} ({os.path.getsize(path)} bytes)")
    with open(os.path.join(out, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", default=os.path.join(REPO, "weights"),
                   help="directory holding the orbax checkpoints refiner/ and scorer/")
    p.add_argument("--out", default=os.path.join(REPO, "weights_torch"))
    args = p.parse_args(argv)
    export(os.path.abspath(args.src), os.path.abspath(args.out))


if __name__ == "__main__":
    main()
