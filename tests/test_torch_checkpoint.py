"""The numpy export of the bundled weights (`weights_torch/`, written by
tools/export_torch_weights.py) and the port's checkpoint loader
(`sixdof_tpu_torch/models/checkpoint.py`), against the orbax checkpoints
read through the JAX predictors.

Every array is stored either as the round-to-nearest-even bf16 of the orbax
array (as uint16 bits) or as the orbax array itself, and that storage loses
nothing at compute_dtype=bf16: the networks' outputs are bit-equal in both
packages with the exported values and with the orbax ones (tolerance 0)."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sixdof_tpu.models.predict import PoseRefinePredictor as JRef
from sixdof_tpu.models.predict import ScorePredictor as JSc
from sixdof_tpu.models.torch_convert import convert_refine_net, convert_score_net
from sixdof_tpu_torch.device import network_autocast
from sixdof_tpu_torch.models import checkpoint
from sixdof_tpu_torch.models.predict import PoseRefinePredictor as TRef
from sixdof_tpu_torch.models.predict import ScorePredictor as TSc
from sixdof_tpu_torch.models.weights import params_from_jax

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT = os.path.join(REPO, "weights_torch")
NETS = ("refiner", "scorer")
HW = 32  # crop size of the network checks (the nets are fully convolutional)


@pytest.fixture(scope="module")
def jax_nets():
    """The JAX predictors on the orbax checkpoints, at bf16 compute."""
    out = {}
    for net, cls in (("refiner", JRef), ("scorer", JSc)):
        pred = cls(ckpt_dir=os.path.join(REPO, "weights", net), compute_dtype=jnp.bfloat16)
        out[net] = (pred, jax.tree.map(np.asarray, pred.params))
    return out


def _inputs(net, seed=0):
    rng = np.random.RandomState(seed)
    n = 4 if net == "scorer" else 2
    A = rng.uniform(-0.5, 0.5, (n, HW, HW, 6)).astype(np.float32)
    B = rng.uniform(-0.5, 0.5, (n, HW, HW, 6)).astype(np.float32)
    return A, B, ((2,) if net == "scorer" else ())


def _raw_export(net):
    with np.load(os.path.join(EXPORT, f"{net}.npz")) as z:
        return {k: z[k] for k in z.files}


def _manifest():
    with open(os.path.join(EXPORT, "MANIFEST.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("net", NETS)
def test_export_arrays_are_the_orbax_arrays_or_their_bf16(jax_nets, net):
    _, params = jax_nets[net]
    ref = {k: v.numpy() for k, v in params_from_jax(params).items()}
    raw, man = _raw_export(net), _manifest()
    kinds = man[net]["arrays"]
    assert man["compute_dtype"] == "bfloat16"
    assert set(raw) == set(ref) == set(kinds)
    n_bf16 = 0
    for key, a in raw.items():
        if kinds[key] == "bf16":
            n_bf16 += 1
            want = np.asarray(jnp.asarray(ref[key]).astype(jnp.bfloat16)).view(np.uint16)
            assert a.dtype == np.uint16 and np.array_equal(a, want), key
        else:
            assert a.dtype == np.float32 and np.array_equal(a.view(np.uint32),
                                                            ref[key].view(np.uint32)), key
    # the LayerNorms and output heads compute in fp32 and keep their values
    assert n_bf16 > 0 and all(kinds[k] == "fp32" for k in kinds
                              if ("norm" in k or k.startswith(("trans_head.1", "rot_head.1",
                                                               "linear.")))
                              and not np.array_equal(
                                  ref[k], ref[k].astype(ml_dtypes.bfloat16).astype(np.float32)))
    # the manifest names the checkpoint it came from, file by file
    src = os.path.join(REPO, man[net]["source"])
    from tools.export_torch_weights import sha256_tree  # noqa: E402  (repo root on sys.path)

    assert man[net]["sha256"] == sha256_tree(src) and man[net]["cfg"] == {}


@pytest.mark.parametrize("net", NETS)
def test_jax_outputs_bit_equal_with_exported_values(jax_nets, net):
    """The export's values (bf16 widened to fp32) put back into the JAX
    predictor give the orbax params' outputs bit for bit at compute_dtype
    bf16: the storage loses nothing."""
    pred, params = jax_nets[net]
    sd = {k: v.numpy() for k, v in checkpoint.load_params(EXPORT, net).items()}
    exported = (convert_refine_net if net == "refiner" else convert_score_net)(sd)
    A, B, extra = _inputs(net)
    apply = jax.jit(lambda p: pred.model.apply({"params": p}, A, B, *extra))
    got = jax.tree.leaves(apply(jax.tree.map(jnp.asarray, exported)))
    want = jax.tree.leaves(apply(jax.tree.map(jnp.asarray, params)))
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g).view(np.uint32), np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("net", NETS)
def test_port_outputs_bit_equal_export_vs_converted(jax_nets, net):
    """Refine deltas and scores of an export-loaded predictor equal those of
    one built from params_from_jax(orbax params), bit for bit, under bf16
    autocast."""
    _, params = jax_nets[net]
    cls = TRef if net == "refiner" else TSc
    cfg = {"input_resize": (HW, HW)}
    a = cls("cpu", cfg=cfg, params=params)
    b = cls("cpu", cfg=cfg, ckpt_dir=os.path.join(EXPORT, f"{net}.npz"))
    assert b.ckpt_path == os.path.join(EXPORT, f"{net}.npz")
    A, B, extra = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                   for x in _inputs(net, seed=1))
    outs = []
    for pred in (a, b):
        with torch.no_grad(), network_autocast(pred.device, torch.bfloat16):
            outs.append(pred.model(A, B, *extra))
    assert outs[0].keys() == outs[1].keys()
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_pth_round_trip(tmp_path):
    """A reference-style `.pth` (the port's module names, under a "model"
    key or bare) loads into the port's predictor."""
    seeded = TRef("cpu", seed=3)
    sd = seeded.model.state_dict()
    for name, obj in (("bare.pth", sd), ("wrapped.pth", {"model": sd, "epoch": 7})):
        torch.save(obj, tmp_path / name)
        loaded = checkpoint.load_params(str(tmp_path / name), "refiner")
        assert loaded.keys() == sd.keys() and all(torch.equal(loaded[k], sd[k]) for k in sd)
        pred = TRef("cpu", ckpt_dir=str(tmp_path / name), compute_dtype=torch.float32)
        assert all(torch.equal(v, sd[k]) for k, v in pred.model.state_dict().items())


def test_float32_predictor_from_bf16_export_raises():
    for cls in (TRef, TSc):
        with pytest.raises(ValueError, match="bf16"):
            cls("cpu", ckpt_dir=EXPORT, compute_dtype=torch.float32)


def test_orbax_directory_raises():
    for cls, net in ((TRef, "refiner"), (TSc, "scorer")):
        with pytest.raises(ValueError, match="export_torch_weights"):
            cls("cpu", ckpt_dir=os.path.join(REPO, "weights", net))


def test_missing_checkpoint_initialises_from_seed(caplog, tmp_path):
    import logging

    caplog.set_level(logging.INFO)
    a = TSc("cpu", ckpt_dir=str(tmp_path / "nothing"), seed=5)
    b = TSc("cpu", seed=5)
    assert a.ckpt_path is None and "from its seed" in caplog.text
    assert all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items())


def test_manifest_cfg_overrides_reach_the_refiner(tmp_path):
    """The JAX predictor's OCC_SUB marker travels in the manifest's cfg; a
    caller's own cfg still wins."""
    shutil.copy(os.path.join(EXPORT, "refiner.npz"), tmp_path / "refiner.npz")
    man = _manifest()
    man["refiner"]["cfg"] = {"occ_sub": 0.85}
    (tmp_path / "MANIFEST.json").write_text(json.dumps(man))
    assert TRef("cpu", ckpt_dir=str(tmp_path)).cfg["occ_sub"] == 0.85
    assert TRef("cpu", ckpt_dir=str(tmp_path), cfg={"occ_sub": False}).cfg["occ_sub"] is False
    assert TRef("cpu", ckpt_dir=EXPORT).cfg["occ_sub"] is False


def test_export_tool_regenerates_the_committed_arrays(tmp_path):
    """tools/export_torch_weights.py on weights/ writes the committed arrays
    bit for bit, and the same manifest (the zip timestamps may differ)."""
    from tools.export_torch_weights import export  # noqa: E402  (repo root on sys.path)

    export(os.path.join(REPO, "weights"), str(tmp_path))
    for net in NETS:
        old, new = _raw_export(net), np.load(tmp_path / f"{net}.npz")
        assert sorted(new.files) == sorted(old)
        for key in new.files:
            a, b = old[key], new[key]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes(), key
    assert json.loads((tmp_path / "MANIFEST.json").read_text()) == _manifest()
