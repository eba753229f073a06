"""tools/flops_report_torch.py on the CPU at a small size: FlopCounterMode's
count of one refiner and one scorer forward equals the analytic sum of
their convolutions', linears' and attention's 2 x multiply-adds (counted
here from the layers' shapes with forward hooks); the report's cascade
equals the sum of its four stages (the same calls at the same shapes); and
the report's fields."""
import json
import os
import sys

import pytest
import torch
from torch import nn

from sixdof_tpu_torch.models import networks as tn
from sixdof_tpu_torch.models.predict import PoseRefinePredictor, ScorePredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import flops_report_torch as fr  # noqa: E402

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def analytic_flops(model, call):
    """2 x the multiply-adds of every convolution, linear layer and
    attention product that @call runs through @model's layers."""
    total = [0]

    def conv(m, inp, out):
        n, c_out, h, w = out.shape
        kh, kw = m.kernel_size
        total[0] += 2 * n * c_out * h * w * (m.in_channels // m.groups) * kh * kw

    def linear(m, inp, out):
        total[0] += 2 * inp[0].numel() // m.in_features * m.in_features * m.out_features

    def attention(m, inp, out):
        b, n, d = inp[0].shape
        total[0] += 2 * b * n * d * 3 * d  # the packed QKV projection
        total[0] += 2 * 2 * b * n * n * d  # q k^T and attn v over the heads

    hooks = []
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, tn.MultiheadAttention):
            hooks.append(m.register_forward_hook(attention))
    try:
        with torch.no_grad():
            call()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


@pytest.mark.parametrize("hw", [(32, 32), (48, 64)])
def test_counter_equals_analytic_refiner_and_scorer(hw):
    gen = torch.Generator().manual_seed(0)
    A = torch.rand((4, *hw, 6), generator=gen)
    B = torch.rand((4, *hw, 6), generator=gen)
    ref, sc = tn.RefineNet().eval(), tn.ScoreNetMultiPair().eval()
    for model, call in ((ref, lambda: ref(A, B)), (sc, lambda: sc(A, B, 2))):
        with torch.no_grad():
            counted, by_op = fr.count(call)
        assert counted == analytic_flops(model, call) > 0
        assert sum(by_op.values()) == counted


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    cfg = {"input_resize": (32, 32)}
    out = str(tmp_path_factory.mktemp("flops") / "flops.json")
    rep = fr.main(device="cpu", out=out, n_hypotheses=8, prune_to=4,
                  refiner=PoseRefinePredictor("cpu", cfg=cfg, seed=0),
                  scorer=ScorePredictor("cpu", cfg=cfg, seed=1))
    return rep, out


def test_cascade_is_the_sum_of_its_stages(report):
    rep, _ = report
    stages = rep["register_stages"]
    assert list(stages) == list(fr.STAGES)
    assert rep["register_stage_sum_flops"] == sum(s["flops"] for s in stages.values())
    assert rep["register_cascade"]["flops"] == rep["register_stage_sum_flops"] > 0
    # register adds the depth polish's products to the cascade's
    assert rep["register"]["flops"] >= rep["register_cascade"]["flops"]
    assert rep["track"]["flops"] > 0


def test_report_fields(report):
    rep, out = report
    with open(out) as f:
        assert json.loads(f.read()) == json.loads(json.dumps(rep))
    assert rep["n_hypotheses"] == 8 and rep["prune_to"] == 4 and rep["device"] == "cpu"
    assert "K1" in rep["not_counted"] and "elementwise" in rep["not_counted"]
    # FLOPS.json's figures stand only beside its own shapes
    assert rep["register"]["xla_flops"] is None and rep["register"]["ratio_to_xla"] is None
    for row in rep["register_stages"].values():
        assert set(row) == {"flops", "xla_flops", "ratio_to_xla", "by_op"}
