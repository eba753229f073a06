"""The port's public surface against the JAX package's, read with `ast` so
that nothing is imported.  Every public function and method of
`sixdof_tpu/` has a counterpart of the same name in the port's module of
the same path, and the counterpart's positional parameters begin with
JAX's, in JAX's order: a call written against the JAX API means the same
in the port.  Parameters the port adds come after JAX's.  The exceptions
are the allow-lists below, each with its reason."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "sixdof_tpu")
PORT_ROOT = os.path.join(REPO, "sixdof_tpu_torch")

# Whole JAX modules with no port counterpart.
MODULES = {
    "ops/pallas/raster_kernel.py": "the TPU kernel K1; its port is csrc/raster_zbuffer.cu behind "
                                   "kernels/raster.py",
    "ops/pallas/raytrace_kernel.py": "the TPU kernel K2; its port is csrc/ray_mesh.cu behind "
                                     "kernels/raytrace.py",
    "native.py": "the JAX package's C++ helpers; the port keeps numpy and scipy paths held to "
                 "them (ROADMAP.md section 1)",
    "utils/aot_cache.py": "XLA's serialized executables; the port's counterpart is the "
                          "hash-named kernel libraries (kernels/build.py)",
    "models/torch_convert.py": "converts reference PyTorch checkpoints into flax trees; it stays "
                               "untouched under the port contract",
}

# Functions and methods with no port counterpart, or whose positional
# parameters differ from JAX's on purpose.
NAMES = {
    # PyTorch idiom: eager calls, modules built in __init__
    "models/predict.py::refine_poses_jit": "a jitted entry point; the port calls refine_poses",
    "models/predict.py::score_poses_jit": "a jitted entry point; the port calls score_poses",
    "models/predict.py::track_pose_jit": "a jitted entry point; the port calls track_pose",
    "models/predict.py::register_pipeline_jit": "a jitted entry point; the port calls "
                                                "register_pipeline",
    "models/networks.py::ConvTrunk.setup": "flax's setup; a torch module builds in __init__",
    "models/networks.py::RefineNet.setup": "flax's setup; a torch module builds in __init__",
    "models/networks.py::ScoreNetMultiPair.setup": "flax's setup; a torch module builds in "
                                                   "__init__",
    # numpy draws in place of JAX keys
    "parallel/augment.py::degrade_rgb_batch": "JAX's key is the port's draws (numpy/torch draws)",
    "parallel/augment.py::degrade_xyz_batch": "JAX's key is the port's draws",
    "parallel/augment.py::maybe_degrade_pair": "JAX's key is the port's draws",
    "models/object_field.py::init_field": "JAX's key is the port's draws",
    "models/object_field.py::init_hash_grid": "JAX's key is the port's generator",
    "models/object_field.py::sample_z_vals": "JAX's key is the port's draws",
    "parallel/train.py::make_refiner_batch": "JAX's key is the port's draws",
    "parallel/train.py::make_scorer_batch": "JAX's key is the port's draws, whose first axis "
                                            "carries n_scenes",
    "parallel/train.py::RefinerTrainer.train": "JAX's key is the port's torch.Generator",
    "parallel/train.py::ScorerTrainer.train": "JAX's key is the port's torch.Generator",
    # functional flax against stateful torch modules
    "parallel/train.py::refiner_loss": "flax passes the params apart; the torch module holds them",
    "parallel/train.py::scorer_loss": "flax passes the params apart; the torch module holds them",
    "parallel/train.py::save_params": "orbax checkpoints against the port's npz export",
    # GSPMD-only placement
    "parallel/sharding.py::data_sharding": "a NamedSharding helper: GSPMD only",
    "parallel/sharding.py::replicated": "a NamedSharding helper: GSPMD only",
    "parallel/sharding.py::param_shardings": "a NamedSharding helper: GSPMD only "
                                             "(parallel/tensor_parallel.py splits the layers)",
    "parallel/sharding.py::shard_batch": "a NamedSharding helper: GSPMD only",
    "parallel/sharding.py::make_mesh": "JAX's device list is the port's process group",
    # the device: the port's callers pass it where JAX has another parameter
    "models/predict.py::PoseRefinePredictor.__init__": "the device comes first, as every port "
                                                       "caller passes it; JAX's first, a cfg "
                                                       "dict, is refused by torch.device",
    "models/predict.py::ScorePredictor.__init__": "the device comes first, as every port caller "
                                                  "passes it; JAX's first, a cfg dict, is "
                                                  "refused by torch.device",
    "ops/rasterize.py::make_mesh_arrays": "the device comes second, as every port caller passes "
                                          "it; JAX's second, an int, is no CUDA device there",
    "parallel/procgen.py::procedural_objects": "the device comes third, as every port caller "
                                               "passes it",
    # JAX-only machinery (ROADMAP.md section 1)
    "utils/__init__.py::force_cpu": "JAX's platform switch; the port takes device='cpu'",
    "utils/__init__.py::enable_compile_cache": "XLA's compile cache; eager PyTorch compiles "
                                               "nothing",
    "utils/profiling.py::annotate": "the JAX profiler; the port's tools use torch.profiler",
    "utils/profiling.py::device_trace": "the JAX profiler; the port's tools use torch.profiler",
    "utils/vis.py::cv_draw_text": "OpenCV's Hershey font, which the card does not have",
}


def _positional(fn, method=False):
    """The parameters a caller fills by position (a method's self or cls
    left out, a static method's kept)."""
    params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    static = any(isinstance(d, ast.Name) and d.id == "staticmethod" for d in fn.decorator_list)
    return params[1:] if method and not static else params


def _class_methods(cls, classes):
    """A class's methods (aliases `name = method` in its body too), with
    those of its bases defined in the same module."""
    out = {}
    for base in cls.bases:
        if isinstance(base, ast.Name) and base.id in classes:
            out.update(_class_methods(classes[base.id], classes))
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _positional(node, method=True)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Name) \
                and node.value.id in out:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = out[node.value.id]
    return out


def _surface(path):
    """{name or Class.method: positional parameters} of a module."""
    tree = ast.parse(open(path).read())
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _positional(node)
        elif isinstance(node, ast.ClassDef):
            for name, params in _class_methods(node, classes).items():
                out[f"{node.name}.{name}"] = params
    return out


def _public(qualname):
    *owner, name = qualname.split(".")
    return not any(p.startswith("_") for p in owner) and \
        (not name.startswith("_") or name == "__init__")


def _jax_entries():
    out = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), JAX_ROOT).replace(os.sep, "/")
            if rel in MODULES:
                continue
            for qualname, params in _surface(os.path.join(dirpath, f)).items():
                own = qualname.split(".")[-1] if "." in qualname else None
                if _public(qualname) and own != "__call__":  # flax's forward
                    out.append((rel, qualname, params))
    return sorted(out)


ENTRIES = _jax_entries()


def test_the_allow_lists_name_what_exists():
    """Every allow-listed name is a public JAX function or module, so the
    lists cannot go stale, and each carries a reason."""
    names = {f"{rel}::{q}" for rel, q, _ in ENTRIES}
    assert set(NAMES) <= names
    for rel in MODULES:
        assert os.path.exists(os.path.join(JAX_ROOT, rel))
    assert all(r.strip() for r in list(NAMES.values()) + list(MODULES.values()))
    assert len(ENTRIES) > 300


@pytest.mark.parametrize("rel,qualname,params", ENTRIES,
                         ids=[f"{r}::{q}" for r, q, _ in ENTRIES])
def test_port_counterpart_takes_jax_positional_parameters(rel, qualname, params):
    if f"{rel}::{qualname}" in NAMES:
        return
    port_path = os.path.join(PORT_ROOT, rel)
    assert os.path.exists(port_path), f"no port module for {rel}"
    port = _surface(port_path)
    assert qualname in port, f"{rel}::{qualname} has no counterpart in the port"
    got = port[qualname]
    assert got[:len(params)] == params, \
        f"{rel}::{qualname}: JAX takes {params}, the port {got}"



# The JAX tools the port's evaluation tools stand in for: each public
# function's positional parameters begin with the JAX tool's, in its order,
# and the port's `device` comes last.  eval_register.py runs at import: its
# script's inputs (scene argument, WEIGHTS_DIR, OCC_SUB) are the port's
# main's parameters, and its one function is a closure over the script's
# frame, which the port's refine takes as its first parameter.
TOOL_FUNCTIONS = {"eval_candidate": ["main", "rank0_probe"],
                  "make_parity_artifact": ["main", "rank0_probe"]}
EVAL_REGISTER_MAIN = ["scene", "weights_dir", "occ_sub", "device"]


@pytest.mark.parametrize("tool", list(TOOL_FUNCTIONS))
def test_evaluation_tools_take_jax_tools_parameters(tool):
    jax_tool = _surface(os.path.join(REPO, "tools", f"{tool}.py"))
    port = _surface(os.path.join(REPO, "tools", f"{tool}_torch.py"))
    assert sorted(n for n in jax_tool if not n.startswith("_")) == TOOL_FUNCTIONS[tool]
    for name in TOOL_FUNCTIONS[tool]:
        got, want = port[name], jax_tool[name]
        assert got[:len(want)] == want and got[-1] == "device", (tool, name, got, want)
        assert "device" not in got[:-1]


def test_eval_register_takes_the_jax_scripts_inputs():
    jax_tool = _surface(os.path.join(REPO, "tools", "eval_register.py"))
    port = _surface(os.path.join(REPO, "tools", "eval_register_torch.py"))
    assert list(jax_tool) == ["refine"] and jax_tool["refine"] == ["poses", "iters"]
    assert port["refine"][1:3] == ["poses", "iterations"]
    assert port["main"] == EVAL_REGISTER_MAIN
    assert {"basin", "refined_grid", "ranking"} <= set(port)
