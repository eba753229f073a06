"""The port's scene, parity, sweep, FLOP and evaluation tools stand alone:
imported with every module their functions import (read from their
source), and the scene generator run at a tiny size with the sensor model,
in a fresh process, none of tests/test_torch_import.py's FORBIDDEN modules
(jax, the JAX package, cv2, ...) is loaded."""
import ast
import os
import subprocess
import sys

from test_torch_import import FORBIDDEN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ["sensor_model_torch", "make_demo_scene_torch", "parity_check_torch",
         "sweep_register_schedule_torch", "flops_report_torch", "eval_register_torch",
         "eval_candidate_torch", "make_parity_artifact_torch"]


def _imported_modules(path):
    """Every module a source file imports, at any depth (functions too)."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return sorted(names)


def test_tools_import_graph_has_no_jax_or_host_libraries(tmp_path):
    modules = sorted({m for t in TOOLS
                      for m in _imported_modules(os.path.join(REPO, "tools", f"{t}.py"))})
    assert not [m for m in modules if m.split(".")[0] in FORBIDDEN]
    code = f"""
import importlib, sys
sys.path.insert(0, "tools")
for name in {TOOLS + modules!r}:
    importlib.import_module(name)
import make_demo_scene_torch
make_demo_scene_torch.main({str(tmp_path / "scene")!r}, 2, H=24, W=32, variant="clutter",
                           sensor=True, device="cpu")
print("BAD", [n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r}])
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert sorted(os.listdir(tmp_path / "scene" / "rgb")) == ["rgb_0000.png", "rgb_0001.png"]
