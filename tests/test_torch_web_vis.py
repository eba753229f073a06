"""The port's viewer (`sixdof_tpu_torch/app/web_vis.py`) against the JAX
package's: the page byte for byte, the payload of `update_dash_data`, the
routes, and the run loop in viewer mode (`app/run.py::main` with
`no_server` false) against the JAX app's loop: the same payloads after
every update, with everything below the loop scripted alike (as
tests/test_torch_app_run.py::test_run_loop_bookkeeping_matches_jax does;
the payload's arrays are bit-equal, tolerance 0), and a POST /capture that
triggers a capture."""
import json
import logging
import queue
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sixdof_tpu.app import icp_pipeline as jip
from sixdof_tpu.app import run as jrun
from sixdof_tpu.app import web_vis as jweb
from sixdof_tpu.io import mesh_io as jmio
from sixdof_tpu_torch.app import icp_pipeline as tip
from sixdof_tpu_torch.app import run as trun
from sixdof_tpu_torch.app import web_vis as tweb
from sixdof_tpu_torch.io import mesh_io as tmio
from test_torch_app_run import SCENE, _rigid, _stub_loop

# The suite runs in several worker processes at once (pytest-xdist): one torch
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _get(address, path, method="GET"):
    req = urllib.request.Request(f"http://{address[0]}:{address[1]}{path}", method=method,
                                 data=b"" if method == "POST" else None)
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _strip_seq(payload):
    return {k: v for k, v in payload.items() if k != "seq"}


def test_page_is_the_jax_page():
    assert tweb._PAGE == jweb._PAGE
    assert "Capture New Data" in tweb._PAGE


def test_payload_matches_jax():
    rng = np.random.RandomState(0)
    pcds_t = [tmio.PointCloud(rng.rand(30, 3), colors=rng.rand(30, 3)),
              tmio.PointCloud(rng.rand(25_000, 3))]  # decimated to 20,000
    pcds_j = [jmio.PointCloud(p.points.copy(), colors=None if p.colors is None
                              else p.colors.copy()) for p in pcds_t]
    verts, faces = rng.rand(50, 3), rng.randint(0, 50, (9000, 3))  # decimated to 8000
    tweb.update_dash_data(pcds_t, tmio.TriMesh(verts, faces))
    jweb.update_dash_data(pcds_j, jmio.TriMesh(verts, faces))
    with tweb._payload_lock, jweb._payload_lock:
        got, want = dict(tweb._latest_payload), dict(jweb._latest_payload)
    assert json.dumps(_strip_seq(got)) == json.dumps(_strip_seq(want))
    assert len(got["pcds"][1]["points"]) == 20_000 and len(got["faces"]) == 8000
    seq = got["seq"]
    tweb.update_dash_data(pcds_t, None)  # visualize() without a mesh
    assert tweb._latest_payload["seq"] == seq + 1 and tweb._latest_payload["faces"] == []


@pytest.fixture
def server(tmp_path, monkeypatch):
    monkeypatch.setattr(tweb, "ASSETS_DIR", str(tmp_path / "assets"))
    data_q, capture_q = queue.Queue(), queue.Queue()
    srv = tweb.make_server(data_q, capture_q, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[:2], data_q, capture_q, tmp_path / "assets"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_routes(server):
    address, data_q, capture_q, assets = server
    status, ctype, body = _get(address, "/")
    assert status == 200 and ctype == "text/html" and body == tweb._PAGE.encode()
    tweb.update_dash_data([tmio.PointCloud(np.eye(3))], tmio.TriMesh(np.eye(3), [[0, 1, 2]]))
    assert data_q.get(timeout=5) is True  # the wake signal
    status, ctype, body = _get(address, "/data?t=1")
    data = json.loads(body)
    assert ctype == "application/json" and data["pcds"][0]["points"] == np.eye(3).tolist()
    assert data["faces"] == [[0, 1, 2]] and data["seq"] == tweb._latest_payload["seq"]
    assert capture_q.empty()
    assert _get(address, "/capture", "POST")[2] == b"ok"
    assert capture_q.get_nowait() is True  # on the queue before the reply
    (assets / "overlay.png").write_bytes(b"\x89PNG fake")
    assert _get(address, "/assets/overlay.png?t=5")[1:] == ("image/png", b"\x89PNG fake")
    for method, path in (("GET", "/assets/none.png"), ("GET", "/nothing"), ("POST", "/data")):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(address, path, method)
        assert e.value.code == 404


@pytest.mark.parametrize("debug", [0, 1])  # 0: async captures, 1: every frame synced
def test_viewer_mode_loop_matches_jax(tmp_path, monkeypatch, debug):
    """Both loops over synth_box's 6 frames with a capture on every later
    frame; the JAX app headless (its viewer's payload recorded at every
    update), the port serving its viewer on a free port (GET /data at every
    update): the same payloads."""
    n_frames = 6
    rng = np.random.RandomState(0)
    scripted = ([_rigid(rng, 0.3) for _ in range(n_frames)], _rigid(rng, 300.0),
                [_rigid(rng, 300.0) for _ in range(n_frames - 1)],
                [rng.uniform(-50, 50, (30 + 7 * k, 3)) for k in range(n_frames)])
    argv = ["--test_scene_dir", SCENE, "--shorter_side", "120", "--max_frames", str(n_frames),
            "--capture_every", "1", "--track_pipeline", "3", "--debug", str(debug)]

    j_payloads = []
    _stub_loop(monkeypatch, jrun, jmio, jip.RegistrationResult, scripted, [])
    monkeypatch.setattr(jrun, "ScorePredictor", lambda **_: None)
    monkeypatch.setattr(jrun, "PoseRefinePredictor", lambda **_: None)
    monkeypatch.setattr(jrun, "ASSETS_DIR", str(tmp_path / "jax_assets"))
    monkeypatch.setattr(jrun, "save_overlay", lambda *_, **__: None)

    def j_update(pcds, mesh):
        jweb.update_dash_data(pcds, mesh)
        j_payloads.append(json.loads(json.dumps(jweb._latest_payload)))

    monkeypatch.setattr(jrun, "update_dash_data", j_update)
    if debug >= 1:
        monkeypatch.setattr(jrun, "draw_posed_3d_box", lambda *_, img, **__: img)
        monkeypatch.setattr(jrun, "draw_xyz_axis", lambda img, **_: img)
    jrun.main(jrun.build_parser().parse_args(
        argv + ["--no_server", "--demo", "--precompile", "0", "--debug_dir",
                str(tmp_path / "jax")]))

    t_payloads = []
    _stub_loop(monkeypatch, trun, tmio, tip.RegistrationResult, scripted, [])
    monkeypatch.setattr(tweb, "ASSETS_DIR", str(tmp_path / "assets"))

    class State(trun.LoopState):
        def update(self, pcds, mesh):
            super().update(pcds, mesh)
            t_payloads.append(json.loads(_get(self.viewer_address, "/data")[2]))

    state = State()
    trun.main(trun.build_parser().parse_args(
        argv + ["--debug_dir", str(tmp_path / "port"), "--device", "cpu"]),
        refiner=object(), scorer=object(), state=state, viewer_address=("127.0.0.1", 0))
    assert state.viewer_address is None  # the viewer stopped with the loop
    assert len(t_payloads) == len(j_payloads) == n_frames
    seqs = [p["seq"] for p in t_payloads]
    assert seqs == list(range(seqs[0], seqs[0] + n_frames))
    for t, j in zip(t_payloads, j_payloads):
        assert len(t["pcds"]) == len(j["pcds"]) and len(t["faces"]) == len(j["faces"]) == 1280
        assert [len(p["points"]) for p in t["pcds"]] == [len(p["points"]) for p in j["pcds"]]
        assert _strip_seq(t) == _strip_seq(j)
    assert (tmp_path / "assets" / "overlay.png").exists()


def test_capture_button_triggers_a_capture(tmp_path, monkeypatch, caplog):
    """No automatic captures: a POST /capture after frame 0 makes frame 1
    a capture frame; the loop serves GET / meanwhile (the loop once logged
    "the viewer is not ported: running headless" and served nothing)."""
    rng = np.random.RandomState(1)
    n_frames = 4
    scripted = ([_rigid(rng, 0.3) for _ in range(n_frames)], _rigid(rng, 300.0),
                [_rigid(rng, 300.0) for _ in range(n_frames - 1)],
                [rng.uniform(-50, 50, (30, 3)) for _ in range(n_frames)])
    calls = []
    _stub_loop(monkeypatch, trun, tmio, tip.RegistrationResult, scripted, calls)
    monkeypatch.setattr(tweb, "ASSETS_DIR", str(tmp_path / "assets"))
    pages = []

    class State(trun.LoopState):
        def update(self, pcds, mesh):
            super().update(pcds, mesh)
            if not pages:
                pages.append(_get(self.viewer_address, "/")[2])
                _get(self.viewer_address, "/capture", "POST")

    state = State()
    with caplog.at_level(logging.INFO):
        trun.main(trun.build_parser().parse_args([
            "--test_scene_dir", SCENE, "--shorter_side", "120", "--max_frames", str(n_frames),
            "--debug", "1", "--debug_dir", str(tmp_path / "port"), "--device", "cpu"]),
            refiner=object(), scorer=object(), state=state, viewer_address=("127.0.0.1", 0))
    assert "headless" not in caplog.text and "defect viewer on http://127.0.0.1:" in caplog.text
    assert b"Capture New Data" in pages[0]
    assert [f for f, _ in state.captures] == [0, 1]
    assert [c[0] for c in calls] == ["refine", "ray_tracing", "capture"]
