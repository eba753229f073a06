"""Live 3-D defect viewer: a standard-library HTTP server with an inline JS page.

Port of `sixdof_tpu/app/web_vis.py` (the same page, byte for byte, and the
same API: `update_dash_data(pcds, mesh)` and `run_dash_app(data_q,
capture_q)`):

- `GET /`            : the single-page viewer (canvas renderer with orbit
                       controls, the mesh wireframe and the defect clouds, a
                       Capture New Data button and a Show Defects toggle);
- `GET /data`        : the latest scene payload as JSON (the page polls it
                       every second);
- `POST /capture`    : puts True on the capture queue, which the run loop
                       pops before its next capture check;
- `GET /assets/...`  : the heatmap overlay image (ASSETS_DIR).

`make_server` binds the server and returns it, so that a caller can read
the bound address (port 0 picks a free one) and shut it down;
`run_dash_app` serves until the process ends, as the JAX viewer does.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_data_queue = None
_capture_queue = None
_latest_payload = {"pcds": [], "vertices": [], "faces": []}
_payload_lock = threading.Lock()

ASSETS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

_PAGE = """<!DOCTYPE html>
<html><head><title>Defect Visualization</title>
<style>
 body { margin:0; font-family:sans-serif; display:flex; flex-direction:column; height:100vh; }
 h1 { text-align:center; margin:8px; font-size:22px; }
 #main { display:flex; flex:1; overflow:hidden; }
 #viewport { width:75%; height:100%; background:#111; }
 #side { width:25%; padding:10px; overflow-y:auto; }
 #overlay { width:100%; object-fit:contain; border-radius:5px; display:block; }
 button { width:100%; background:#007BFF; color:white; padding:12px; border:none;
          border-radius:5px; margin-bottom:10px; cursor:pointer; font-size:14px; }
 label { display:block; margin:5px; }
</style></head>
<body>
<h1>Defect Visualization</h1>
<div id="main">
 <canvas id="viewport"></canvas>
 <div id="side">
  <h4 style="text-align:center">Heatmap Color Information</h4>
  <img id="overlay" src="/assets/overlay.png"/>
  <button id="capture">Capture New Data</button>
  <label><input type="checkbox" id="showDefects" checked/> Show Defects</label>
 </div>
</div>
<script>
const canvas = document.getElementById('viewport');
const ctx = canvas.getContext('2d');
let scene = {pcds: [], vertices: [], faces: []};
let rotX = -0.6, rotY = 0.4, zoom = 1.0, panX = 0, panY = 0;
let dragging = false, lastX = 0, lastY = 0;

canvas.addEventListener('mousedown', e => { dragging = true; lastX = e.clientX; lastY = e.clientY; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  rotY += (e.clientX - lastX) * 0.01;
  rotX += (e.clientY - lastY) * 0.01;
  lastX = e.clientX; lastY = e.clientY; draw();
});
canvas.addEventListener('wheel', e => { zoom *= Math.exp(-e.deltaY * 0.001); draw(); e.preventDefault(); });

function center_scale() {
  let pts = scene.vertices;
  if (!pts.length) {
    for (const p of scene.pcds) { if (p.points.length) { pts = p.points; break; } }
  }
  if (!pts.length) return {c: [0,0,0], s: 1};
  let mn = [1e30,1e30,1e30], mx = [-1e30,-1e30,-1e30];
  for (const p of pts) for (let k=0;k<3;k++) { mn[k]=Math.min(mn[k],p[k]); mx[k]=Math.max(mx[k],p[k]); }
  const c = [(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
  const s = Math.max(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2], 1e-9);
  return {c: c, s: s};
}

function project(p, cs, w, h) {
  let x = p[0]-cs.c[0], y = p[1]-cs.c[1], z = p[2]-cs.c[2];
  const cy = Math.cos(rotY), sy = Math.sin(rotY);
  const cx = Math.cos(rotX), sx = Math.sin(rotX);
  let x1 = cy*x + sy*z, z1 = -sy*x + cy*z;
  let y1 = cx*y - sx*z1, z2 = sx*y + cx*z1;
  const scale = zoom * Math.min(w,h) * 0.7 / cs.s;
  return [w/2 + x1*scale + panX, h/2 + y1*scale + panY, z2];
}

function draw() {
  const w = canvas.clientWidth, h = canvas.clientHeight;
  canvas.width = w; canvas.height = h;
  ctx.fillStyle = '#111'; ctx.fillRect(0,0,w,h);
  const cs = center_scale();
  if (scene.vertices.length) {
    const proj = scene.vertices.map(p => project(p, cs, w, h));
    ctx.strokeStyle = 'rgba(170,170,170,0.35)';
    ctx.beginPath();
    const step = Math.max(1, Math.floor(scene.faces.length / 4000));
    for (let i = 0; i < scene.faces.length; i += step) {
      const f = scene.faces[i];
      ctx.moveTo(proj[f[0]][0], proj[f[0]][1]);
      ctx.lineTo(proj[f[1]][0], proj[f[1]][1]);
      ctx.lineTo(proj[f[2]][0], proj[f[2]][1]);
      ctx.closePath();
    }
    ctx.stroke();
  }
  if (document.getElementById('showDefects').checked) {
    for (const pcd of scene.pcds) {
      for (let i = 0; i < pcd.points.length; i++) {
        const pr = project(pcd.points[i], cs, w, h);
        const c = pcd.colors.length ? pcd.colors[i] : [1,0,0];
        ctx.fillStyle = `rgb(${Math.round(c[0]*255)},${Math.round(c[1]*255)},${Math.round(c[2]*255)})`;
        ctx.fillRect(pr[0]-2, pr[1]-2, 4, 4);
      }
    }
  }
}

async function poll() {
  try {
    const r = await fetch('/data');
    if (r.ok) {
      const d = await r.json();
      if (d.seq !== scene.seq) { scene = d; draw();
        document.getElementById('overlay').src = '/assets/overlay.png?t=' + Date.now();
      }
    }
  } catch (e) {}
}
setInterval(poll, 1000);
document.getElementById('capture').onclick = () => fetch('/capture', {method:'POST'});
document.getElementById('showDefects').onchange = draw;
window.addEventListener('resize', draw);
poll();
</script></body></html>
"""


def _decimate(arr, max_n):
    arr = np.asarray(arr)
    if len(arr) <= max_n:
        return arr
    idx = np.linspace(0, len(arr) - 1, max_n).astype(int)
    return arr[idx]


def update_dash_data(intersection_pcds, target_mesh, max_mesh_faces=8000, max_points=20000):
    """Publish the latest scene to the viewer: every defect cloud (at most
    @max_points points each) and the posed mesh (at most @max_mesh_faces
    faces; none when @target_mesh is None), with a sequence number one
    above the last."""
    global _latest_payload
    pcd_data = []
    for pcd in intersection_pcds:
        pts = _decimate(pcd.points, max_points)
        cols = _decimate(pcd.colors, max_points) if pcd.colors is not None else np.zeros((0, 3))
        pcd_data.append({"points": pts.tolist(), "colors": cols.tolist()})
    verts, faces = np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    if target_mesh is not None:
        verts = np.asarray(target_mesh.vertices)
        faces = _decimate(np.asarray(target_mesh.faces), max_mesh_faces)
    payload = {
        "pcds": pcd_data,
        "vertices": verts.tolist(),
        "faces": faces.tolist(),
    }
    with _payload_lock:
        payload["seq"] = _latest_payload.get("seq", 0) + 1
        _latest_payload = payload
    if _data_queue is not None:
        _data_queue.put(True)  # a wake signal, as in the queue design


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code, body, ctype="text/html"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Cache-Control", "no-store")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = self.path.split("?")[0]
        if path == "/":
            self._send(200, _PAGE.encode())
        elif path == "/data":
            with _payload_lock:
                body = json.dumps(_latest_payload).encode()
            self._send(200, body, "application/json")
        elif path.startswith("/assets/"):
            fpath = os.path.join(ASSETS_DIR, os.path.basename(path))
            if os.path.exists(fpath):
                with open(fpath, "rb") as f:
                    self._send(200, f.read(), "image/png")
            else:
                self._send(404, b"not found", "text/plain")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        if self.path == "/capture":
            if _capture_queue is not None:
                _capture_queue.put(True)
            self._send(200, b"ok", "text/plain")
        else:
            self._send(404, b"not found", "text/plain")


def make_server(data_q, capture_q, host="0.0.0.0", port=8050):
    """Bind the viewer on (@host, @port) and return the server (not yet
    serving).  @capture_q receives True for each POST /capture; @data_q,
    when not None, True for each update_dash_data."""
    global _data_queue, _capture_queue
    _data_queue = data_q
    _capture_queue = capture_q
    os.makedirs(ASSETS_DIR, exist_ok=True)
    server = ThreadingHTTPServer((host, port), _Handler)
    logging.info(f"defect viewer on http://{server.server_address[0]}:"
                 f"{server.server_address[1]}")
    return server


def run_dash_app(data_q, capture_q, host="0.0.0.0", port=8050):
    """Serve the viewer (blocking; run it in a thread)."""
    make_server(data_q, capture_q, host, port).serve_forever()
