"""Live web viewer, the counterpart of the reference's Pangolin GL viewer
(Viewer::Run). Port of tpuslam/viz/server.py.

A GL window is no use on a headless GPU server; instead a small in-process
HTTP server publishes the current map snapshot as JSON and serves a
self-contained HTML page that renders it in a canvas: an orbiting 3D view
of map points, keyframes, the trajectory polyline and the current camera
frustum, with the reference's GUI toggles (follow camera, show points,
show keyframes, show trajectory). Open http://<host>:<port>/ in a browser.

No third-party dependencies: http.server and a lock-guarded snapshot blob.
An update brings the served fields of the map to the host in one
device->host transfer, then builds the blob in numpy.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>tpuslam live viewer</title><style>
body { margin:0; background:#111; color:#ccc; font:12px monospace; }
#hud { position:fixed; top:8px; left:8px; z-index:2; background:#000a; padding:8px; border-radius:4px; }
#hud label { margin-right:10px; user-select:none; }
canvas { display:block; }
</style></head><body>
<div id="hud">
  <span id="status">connecting...</span><br/>
  <label><input type="checkbox" id="pts" checked>points</label>
  <label><input type="checkbox" id="kfs" checked>keyframes</label>
  <label><input type="checkbox" id="traj" checked>trajectory</label>
  <label><input type="checkbox" id="follow">follow</label>
</div>
<canvas id="c"></canvas>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
let S = {points:[], kfs:[], traj:[], cam:null, status:''};
let yaw = 0.6, pitch = 0.4, dist = 8, cx = 0, cy = 0, cz = 0;
let drag = null;
function resize(){ c.width = innerWidth; c.height = innerHeight; }
addEventListener('resize', resize); resize();
c.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.01; pitch += (e.clientY - drag[1]) * 0.01;
  pitch = Math.max(-1.55, Math.min(1.55, pitch));
  drag = [e.clientX, e.clientY];
});
c.addEventListener('wheel', e => { dist *= Math.exp(e.deltaY * 0.001); e.preventDefault(); });
function proj(p){
  let x = p[0] - cx, y = p[1] - cy, z = p[2] - cz;
  let cyw = Math.cos(yaw), syw = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  let x1 = cyw*x + syw*z, z1 = -syw*x + cyw*z;
  let y1 = cp*y - sp*z1, z2 = sp*y + cp*z1 + dist;
  if (z2 < 0.05) return null;
  const f = 0.9 * Math.min(c.width, c.height);
  return [c.width/2 + f*x1/z2, c.height/2 + f*y1/z2, z2];
}
function line(a, b, color){
  const pa = proj(a), pb = proj(b);
  if (!pa || !pb) return;
  ctx.strokeStyle = color; ctx.beginPath();
  ctx.moveTo(pa[0], pa[1]); ctx.lineTo(pb[0], pb[1]); ctx.stroke();
}
function draw(){
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, c.width, c.height);
  if (document.getElementById('follow').checked && S.cam){
    cx = S.cam.p[0]; cy = S.cam.p[1]; cz = S.cam.p[2];
  }
  if (document.getElementById('pts').checked){
    ctx.fillStyle = '#e66';
    for (const p of S.points){ const q = proj(p); if (q) ctx.fillRect(q[0], q[1], 1.6, 1.6); }
  }
  if (document.getElementById('kfs').checked){
    ctx.fillStyle = '#49f';
    for (const p of S.kfs){ const q = proj(p); if (q) ctx.fillRect(q[0]-2, q[1]-2, 4, 4); }
  }
  if (document.getElementById('traj').checked && S.traj.length > 1){
    for (let i = 1; i < S.traj.length; i++) line(S.traj[i-1], S.traj[i], '#4d4');
  }
  if (S.cam){
    for (const cn of S.cam.frustum) line(S.cam.p, cn, '#ff0');
    for (let i = 0; i < 4; i++) line(S.cam.frustum[i], S.cam.frustum[(i+1)%4], '#ff0');
  }
  document.getElementById('status').textContent = S.status;
  requestAnimationFrame(draw);
}
async function poll(){
  try {
    const r = await fetch('/state'); S = await r.json();
  } catch (e) {}
  setTimeout(poll, 500);
}
poll(); draw();
</script></body></html>"""


class LiveViewer:
    """Publish live map state over HTTP; see module docstring.

    Usage:
        viewer = LiveViewer(port=8642)
        system.attach_viewer(viewer)   # or viewer.update(...) manually
    """

    def __init__(self, port: int = 8642, max_points: int = 20000,
                 host: str = "127.0.0.1"):
        """host defaults to loopback: the served state (map points, keyframe
        poses, trajectory) is unauthenticated — pass host="0.0.0.0" only to
        expose it deliberately."""
        self.port = port
        self.max_points = max_points
        self._lock = threading.Lock()
        self._blob = json.dumps(
            {"points": [], "kfs": [], "traj": [], "cam": None, "status": "waiting"}
        ).encode()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path == "/state":
                    with viewer._lock:
                        blob = viewer._blob
                    ctype = "application/json"
                elif self.path == "/":
                    blob = _PAGE.encode()
                    ctype = "text/html"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def log_message(self, *a):  # silence per-request stderr noise
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def update(self, map_state, trajectory=None, cam_R=None, cam_t=None, status=""):
        """Snapshot map, trajectory and camera into the served JSON blob.

        map_state: the port's MapState on any device (its point positions
        and validity and the keyframe poses cross to the host in one
        transfer); trajectory: iterable of world positions (3,); cam_R /
        cam_t: the current T_cw.
        """
        m = map_state
        P, K = m.pt_valid.shape[0], m.kf_valid.shape[0]
        packed = torch.cat([m.pt_xyz.reshape(-1), m.pt_valid.to(torch.float32), m.kf_valid.to(torch.float32),
                            m.kf_R.reshape(-1), m.kf_t.reshape(-1)]).cpu().numpy()
        pts, ok, kf_ok, kf_R, kf_t = np.split(packed, np.cumsum([3 * P, P, K, 9 * K]))
        pts = pts.reshape(P, 3)[ok > 0.5]
        if len(pts) > self.max_points:
            pts = pts[:: len(pts) // self.max_points + 1]
        kf_ok = kf_ok > 0.5
        kf_R = kf_R.reshape(K, 3, 3)[kf_ok]
        kf_t = kf_t.reshape(K, 3)[kf_ok]
        kf_pos = -np.einsum("kij,kj->ki", kf_R.transpose(0, 2, 1), kf_t)

        cam = None
        if cam_R is not None:
            Rwc = np.asarray(cam_R).T
            p = -Rwc @ np.asarray(cam_t)
            z = 0.6
            corners = [
                p + Rwc @ np.array([sx * 0.4, sy * 0.3, z])
                for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))
            ]
            cam = {
                "p": [round(float(v), 4) for v in p],
                "frustum": [[round(float(v), 4) for v in cn] for cn in corners],
            }

        blob = json.dumps(
            {
                "points": np.round(pts, 4).tolist(),
                "kfs": np.round(kf_pos, 4).tolist(),
                "traj": [
                    [round(float(v), 4) for v in p] for p in (trajectory or [])
                ],
                "cam": cam,
                "status": status,
            }
        ).encode()
        with self._lock:
            self._blob = blob

    def close(self):
        self._server.shutdown()
        self._server.server_close()
