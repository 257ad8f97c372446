"""Interactive 4D viewer server (websocket streaming, stdlib only): the
port's copy of geo4d_tpu/viz/server.py, over the port's load_results_dir.

Parity target: the reference's vendored viser fork — a websocket scene
server (viser/src/viser/_viser.py + infra/_infra.py:212) driven by
visualizer.py (:15-281): load a results dir, stream per-frame point
clouds + camera frusta to a browser client, playback controls, live
updates. That fork is 28k LoC (Python server + React/three client +
WASM sorter); this module provides the same interactive capability for
geo4d_tpu results dirs in a single dependency-free file:

  * HTTP server serving an embedded WebGL player page
  * RFC6455 websocket endpoint streaming binary frame messages
    (uint32 header | int16 quantized positions | uint8 colors | f32 pose)
  * live mode: a watcher thread picks up frames as a running
    reconstruction writes them and pushes updates to every client

Usage:  python -m geo4d_tpu_torch.viz.server --data results/<seq>/<seq> [--port 8123]
"""

from __future__ import annotations

import argparse
import base64
import glob
import hashlib
import json
import os
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


# ---------------------------------------------------------------------------
# websocket framing (RFC 6455)
# ---------------------------------------------------------------------------


def ws_accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def ws_encode(payload: bytes, opcode: int = 0x2) -> bytes:
    """Server->client frame (FIN set, unmasked)."""
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < 1 << 16:
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    return header + payload


def ws_decode(sock: socket.socket) -> Optional[Tuple[int, bytes]]:
    """Read one client frame. Returns (opcode, payload) or None on close."""
    def read_exact(k):
        buf = b""
        while len(buf) < k:
            chunk = sock.recv(k - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    head = read_exact(2)
    if head is None:
        return None
    opcode = head[0] & 0x0F
    masked = head[1] & 0x80
    n = head[1] & 0x7F
    if n == 126:
        ext = read_exact(2)
        if ext is None:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = read_exact(8)
        if ext is None:
            return None
        n = struct.unpack(">Q", ext)[0]
    mask = read_exact(4) if masked else b"\x00" * 4
    if mask is None:
        return None
    data = read_exact(n) if n else b""
    if data is None:
        return None
    if masked:
        data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
    return opcode, data


# ---------------------------------------------------------------------------
# scene store
# ---------------------------------------------------------------------------


class SceneStore:
    """Loads/watches a results dir; serves quantized per-frame payloads."""

    def __init__(self, data_dir: str, downsample: int = 2,
                 conf_thr: float = 1e-3, max_points: int = 120000):
        self.data_dir = data_dir
        self.downsample = downsample
        self.conf_thr = conf_thr
        self.max_points = max_points
        self._lock = threading.Lock()
        self._frames: Dict[int, bytes] = {}
        self._meta: Optional[dict] = None
        self.reload()

    def n_frames(self) -> int:
        return len(glob.glob(os.path.join(self.data_dir, "frame_*.npy")))

    def reload(self):
        from geo4d_tpu_torch.viz.visualizer import load_results_dir

        n = self.n_frames()
        if n == 0:
            with self._lock:
                self._meta = {"type": "meta", "n_frames": 0,
                              "center": [0, 0, 0], "scale": 1.0}
            return
        clouds, poses = load_results_dir(
            self.data_dir, downsample=self.downsample, conf_thr=self.conf_thr
        )
        nonempty = [c[0] for c in clouds if len(c[0])]
        all_pts = np.concatenate(nonempty) if nonempty else np.zeros((1, 3))
        center = all_pts.mean(0)
        scale = float(np.abs(all_pts - center).max() + 1e-6)
        frames = {}
        for i, (pts, cols) in enumerate(clouds):
            if len(pts) > self.max_points:
                idx = np.random.default_rng(0).choice(
                    len(pts), self.max_points, replace=False
                )
                pts, cols = pts[idx], cols[idx]
            q = np.clip((pts - center) / scale * 32767, -32767, 32767).astype(
                "<i2"
            )
            c8 = (cols * 255).clip(0, 255).astype(np.uint8)
            pose = np.asarray(poses[i], "<f4").reshape(-1)
            frames[i] = (
                struct.pack("<II", i, len(pts))
                + q.tobytes() + c8.tobytes() + pose.tobytes()
            )
        with self._lock:
            self._frames = frames
            self._meta = {
                "type": "meta",
                "n_frames": len(frames),
                "center": center.tolist(),
                "scale": scale,
            }

    def meta(self) -> dict:
        with self._lock:
            return dict(self._meta)

    def frame(self, i: int) -> Optional[bytes]:
        with self._lock:
            return self._frames.get(i)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class ViewerServer:
    def __init__(self, data_dir: str, port: int = 8123, host: str = "127.0.0.1",
                 live: bool = False, downsample: int = 2):
        self.store = SceneStore(data_dir, downsample=downsample)
        self.live = live
        self._clients: List[socket.socket] = []
        self._clients_lock = threading.Lock()
        store = self.store
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/" or self.path == "/index.html":
                    page = _PLAYER_PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(page)))
                    self.end_headers()
                    self.wfile.write(page)
                    return
                if self.path == "/ws":
                    key = self.headers.get("Sec-WebSocket-Key")
                    if not key:
                        self.send_error(400)
                        return
                    self.send_response(101, "Switching Protocols")
                    self.send_header("Upgrade", "websocket")
                    self.send_header("Connection", "Upgrade")
                    self.send_header("Sec-WebSocket-Accept", ws_accept_key(key))
                    self.end_headers()
                    sock = self.connection
                    server._serve_ws(sock, store)
                    self.close_connection = True
                    return
                self.send_error(404)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._threads: List[threading.Thread] = []

    # ---- websocket session ----

    def _serve_ws(self, sock: socket.socket, store: SceneStore):
        with self._clients_lock:
            self._clients.append(sock)
        try:
            sock.sendall(
                ws_encode(json.dumps(store.meta()).encode(), opcode=0x1)
            )
            while True:
                msg = ws_decode(sock)
                if msg is None:
                    break
                opcode, data = msg
                if opcode == 0x8:                       # close
                    sock.sendall(ws_encode(b"", opcode=0x8))
                    break
                if opcode == 0x9:                       # ping -> pong
                    sock.sendall(ws_encode(data, opcode=0xA))
                    continue
                if opcode != 0x1:
                    continue
                try:
                    req = json.loads(data)
                except ValueError:
                    continue
                if req.get("type") == "get":
                    payload = store.frame(int(req.get("i", 0)))
                    if payload is not None:
                        sock.sendall(ws_encode(payload, opcode=0x2))
                elif req.get("type") == "meta":
                    sock.sendall(
                        ws_encode(json.dumps(store.meta()).encode(), opcode=0x1)
                    )
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            with self._clients_lock:
                if sock in self._clients:
                    self._clients.remove(sock)

    def _broadcast(self, message: dict):
        data = ws_encode(json.dumps(message).encode(), opcode=0x1)
        with self._clients_lock:
            clients = list(self._clients)
        for c in clients:
            try:
                c.sendall(data)
            except OSError:
                pass

    def _watch(self, poll_s: float = 2.0):
        """Live mode: pick up frames a running reconstruction writes."""
        known = self.store.meta()["n_frames"]
        while not self._stop.is_set():
            time.sleep(poll_s)
            n = self.store.n_frames()
            if n != known:
                self.store.reload()
                known = self.store.meta()["n_frames"]
                self._broadcast({"type": "update", "n_frames": known})

    # ---- lifecycle ----

    def start(self):
        self._stop = threading.Event()
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        if self.live:
            w = threading.Thread(target=self._watch, daemon=True)
            w.start()
            self._threads.append(w)
        return self

    def stop(self):
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()

    def serve_forever(self):
        self.start()
        print(f"[viewer] http://127.0.0.1:{self.port}  (ctrl-c to stop)")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.stop()


_PLAYER_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>geo4d_tpu live 4D viewer</title>
<style>body{margin:0;background:#111;color:#eee;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;z-index:2}
canvas{display:block}</style></head>
<body><div id="hud">frame <span id="fi">0</span>/<span id="ft">0</span>
 &nbsp;<button id="play">pause</button>
 &nbsp;drag=rotate wheel=zoom &nbsp;<span id="st">connecting…</span></div>
<canvas id="c"></canvas>
<script>
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl');
const vs = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
varying vec3 v; void main(){ gl_Position=mvp*vec4(p,1.0);
gl_PointSize=2.0; v=col; }`;
const fs = `precision mediump float; varying vec3 v;
void main(){ gl_FragColor=vec4(v,1.0); }`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);return o;}
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);
const pbuf=gl.createBuffer(), cbuf=gl.createBuffer();
const locP=gl.getAttribLocation(prog,'p'), locC=gl.getAttribLocation(prog,'col');
const locM=gl.getUniformLocation(prog,'mvp');
let frames={}, nFrames=0, fi=0, playing=true, rx=-0.3, ry=0, dist=2.5;
document.getElementById('play').onclick=e=>{playing=!playing;
  e.target.textContent=playing?'pause':'play';};
let drag=false,lx=0,ly=0;
canvas.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return; ry+=(e.clientX-lx)*0.01;
rx+=(e.clientY-ly)*0.01; lx=e.clientX; ly=e.clientY;};
canvas.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
const ws = new WebSocket(`ws://${location.host}/ws`);
ws.binaryType='arraybuffer';
ws.onmessage=ev=>{
  if(typeof ev.data === 'string'){
    const m=JSON.parse(ev.data);
    if(m.type==='meta'||m.type==='update'){
      nFrames=m.n_frames;
      document.getElementById('ft').textContent=nFrames;
      document.getElementById('st').textContent=m.type==='update'?'live':'';
      for(let i=0;i<nFrames;i++) if(!(i in frames))
        ws.send(JSON.stringify({type:'get', i}));
    }
  } else {
    const dv=new DataView(ev.data);
    const i=dv.getUint32(0,true), n=dv.getUint32(4,true);
    const pts=new Int16Array(ev.data, 8, n*3);
    const col=new Uint8Array(ev.data, 8+n*6, n*3);
    frames[i]={pts, col, n};
  }
};
function mat(){
  const a=Math.cos(rx),b=Math.sin(rx),c=Math.cos(ry),d=Math.sin(ry);
  const ar=canvas.width/canvas.height, f=1.5, n=0.01, fa=100;
  const R=[c,d*b,-d*a,0, 0,a,b,0, d,-c*b,c*a,0, 0,0,0,1];
  const P=[f/ar,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
  const T=[1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,-dist,1];
  function mul(A,B){const M=new Array(16).fill(0);
    for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)
      M[j*4+i]+=A[k*4+i]*B[j*4+k]; return M;}
  return new Float32Array(mul(P, mul(T, R)));
}
function draw(){
  canvas.width=innerWidth; canvas.height=innerHeight;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.07,0.07,0.07,1); gl.clear(gl.COLOR_BUFFER_BIT);
  const f=frames[fi]; if(!f){return;}
  const pos=new Float32Array(f.n*3);
  for(let i=0;i<f.n*3;i++) pos[i]=f.pts[i]/32767;
  gl.bindBuffer(gl.ARRAY_BUFFER,pbuf);
  gl.bufferData(gl.ARRAY_BUFFER,pos,gl.DYNAMIC_DRAW);
  gl.enableVertexAttribArray(locP);
  gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  const col=new Float32Array(f.n*3);
  for(let i=0;i<f.n*3;i++) col[i]=f.col[i]/255;
  gl.bindBuffer(gl.ARRAY_BUFFER,cbuf);
  gl.bufferData(gl.ARRAY_BUFFER,col,gl.DYNAMIC_DRAW);
  gl.enableVertexAttribArray(locC);
  gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
  gl.uniformMatrix4fv(locM,false,mat());
  gl.drawArrays(gl.POINTS,0,f.n);
  document.getElementById('fi').textContent=fi;
}
setInterval(()=>{ if(playing&&nFrames>0){fi=(fi+1)%nFrames;} draw(); }, 83);
</script></body></html>
"""


def main(argv=None):
    p = argparse.ArgumentParser(description="geo4d_tpu interactive 4D viewer")
    p.add_argument("--data", required=True, help="results dir (one sequence)")
    p.add_argument("--port", type=int, default=8123)
    p.add_argument("--downsample", type=int, default=2)
    p.add_argument("--live", action="store_true",
                   help="watch the dir and push frames as they appear")
    args = p.parse_args(argv)
    ViewerServer(args.data, port=args.port, live=args.live,
                 downsample=args.downsample).serve_forever()


if __name__ == "__main__":
    main()
