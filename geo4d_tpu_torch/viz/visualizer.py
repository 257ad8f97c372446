"""4D playback visualizer over the results-dir contract: the port's copy of
geo4d_tpu/viz/visualizer.py (frames read with data/images.py, poses with
evals/trajectory.py; no Pillow).

    python -m geo4d_tpu_torch.viz.visualizer --data <results>/<seq>

Parity target: reference viser/visualizer.py (:15-281) + the
Record3dLoader_Customized reader (viser/src/viser/extras/
_record3d_customized.py:18-…): loads `pred_intrinsics.txt`,
`pred_traj.txt` (TUM), `frame_*.npy` depth, `conf_*.npy`, `frame_*.png`,
recenters poses on the middle frame, unprojects depth -> per-frame point
cloud, and plays the sequence with camera frusta.

The reference vendors a 28k-LoC viser fork (websocket server + React/three
client + WASM splat sorter). Our results dirs are byte-compatible with that
reader, so a stock `pip install viser` works against them unchanged. For a
zero-dependency path, this module exports a single self-contained HTML file
(embedded WebGL renderer + playback controls, point clouds quantized to
uint16) (the command above).
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os
from typing import Optional

import numpy as np

from geo4d_tpu_torch.data.images import read_png
from geo4d_tpu_torch.evals.trajectory import Trajectory


def load_results_dir(data_dir: str, stride: int = 1, conf_thr: float = 1e-3,
                     downsample: int = 2):
    """Read the results contract back into per-frame point clouds."""
    traj = np.loadtxt(os.path.join(data_dir, "pred_traj.txt"))
    K = np.loadtxt(os.path.join(data_dir, "pred_intrinsics.txt")).reshape(-1, 3, 3)
    depth_files = sorted(glob.glob(os.path.join(data_dir, "frame_*.npy")))
    poses = Trajectory.from_tum(traj).matrices()
    # recenter on the middle frame (record3d reader :70-74)
    mid = poses[len(poses) // 2].copy()
    poses = np.einsum("ij,njk->nik", np.linalg.inv(mid), poses)

    clouds = []
    for i in range(0, len(depth_files), stride):
        depth = np.load(depth_files[i])[::downsample, ::downsample]
        conf_path = os.path.join(data_dir, f"conf_{i:04d}.npy")
        conf = (
            np.load(conf_path)[::downsample, ::downsample]
            if os.path.exists(conf_path)
            else np.ones_like(depth)
        )
        h, w = depth.shape
        fx = K[i, 0, 0] / downsample
        fy = K[i, 1, 1] / downsample
        cx = K[i, 0, 2] / downsample
        cy = K[i, 1, 2] / downsample
        xx, yy = np.meshgrid(np.arange(w), np.arange(h))
        pts = np.stack(
            [(xx - cx) / fx * depth, (yy - cy) / fy * depth, depth], axis=-1
        ).reshape(-1, 3)
        pts = pts @ poses[i, :3, :3].T + poses[i, :3, 3]

        png = os.path.join(data_dir, f"frame_{i:04d}.png")
        if os.path.exists(png):
            img = read_png(png)[::downsample, ::downsample]
            colors = img.reshape(-1, 3).astype(np.float32) / 255.0
        else:
            colors = np.full_like(pts, 0.7, dtype=np.float32)

        mask = conf.reshape(-1) > conf_thr
        clouds.append((pts[mask].astype(np.float32), colors[mask]))
    return clouds, poses


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>geo4d_tpu 4D viewer</title>
<style>body{margin:0;background:#111;color:#eee;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;z-index:2}
canvas{display:block}</style></head>
<body><div id="hud">frame <span id="fi">0</span>/<span id="ft">0</span>
 &nbsp;<button id="play">pause</button>
 &nbsp;drag=rotate wheel=zoom</div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const frames = DATA.frames.map(f => ({
  pts: new Int16Array(Uint8Array.from(atob(f.p), c=>c.charCodeAt(0)).buffer),
  col: new Uint8Array(Uint8Array.from(atob(f.c), c=>c.charCodeAt(0)))
}));
const S = DATA.scale, C = DATA.center;
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
const pbuf = gl.createBuffer(), cbuf = gl.createBuffer();
const locP = gl.getAttribLocation(prog,'p'), locC = gl.getAttribLocation(prog,'col');
const locM = gl.getUniformLocation(prog,'mvp');
let fi=0, playing=true, rx=-0.3, ry=0.0, dist=2.5;
document.getElementById('ft').textContent = frames.length;
document.getElementById('play').onclick = e => {playing=!playing;
  e.target.textContent = playing?'pause':'play';};
let drag=false,lx=0,ly=0;
canvas.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return; ry+=(e.clientX-lx)*0.01;
rx+=(e.clientY-ly)*0.01; lx=e.clientX; ly=e.clientY;};
canvas.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
function mat(){
  const a=Math.cos(rx),b=Math.sin(rx),c=Math.cos(ry),d=Math.sin(ry);
  const ar=canvas.width/canvas.height, f=1.5, n=0.01, fa=100;
  // column-major mvp = P * T(-dist) * Rx * Ry
  const R=[c,d*b,-d*a,0, 0,a,b,0, d,-c*b,c*a,0, 0,0,0,1];
  const out=new Float32Array(16);
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
  const f = frames[fi];
  const pos = new Float32Array(f.pts.length);
  for(let i=0;i<f.pts.length;i++) pos[i]=f.pts[i]/32767*S;
  gl.bindBuffer(gl.ARRAY_BUFFER, pbuf);
  gl.bufferData(gl.ARRAY_BUFFER, pos, gl.DYNAMIC_DRAW);
  gl.enableVertexAttribArray(locP);
  gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  const col = new Float32Array(f.col.length);
  for(let i=0;i<f.col.length;i++) col[i]=f.col[i]/255;
  gl.bindBuffer(gl.ARRAY_BUFFER, cbuf);
  gl.bufferData(gl.ARRAY_BUFFER, col, gl.DYNAMIC_DRAW);
  gl.enableVertexAttribArray(locC);
  gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
  gl.uniformMatrix4fv(locM,false,mat());
  gl.drawArrays(gl.POINTS,0,f.pts.length/3);
  document.getElementById('fi').textContent=fi;
}
setInterval(()=>{ if(playing){fi=(fi+1)%frames.length;} draw(); }, 83);
</script></body></html>
"""


def export_html(data_dir: str, out_path: Optional[str] = None, stride: int = 1,
                downsample: int = 2, max_points: int = 60000) -> str:
    """Results dir -> one self-contained interactive HTML file."""
    clouds, _ = load_results_dir(data_dir, stride=stride, downsample=downsample)
    nonempty = [c[0] for c in clouds if len(c[0])]
    all_pts = np.concatenate(nonempty) if nonempty else np.zeros((1, 3))
    center = all_pts.mean(0)
    scale = float(np.abs(all_pts - center).max() + 1e-6)

    frames = []
    for pts, cols in clouds:
        if len(pts) > max_points:
            idx = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
            pts, cols = pts[idx], cols[idx]
        q = np.clip((pts - center) / scale * 32767, -32767, 32767).astype(np.int16)
        c8 = (cols * 255).clip(0, 255).astype(np.uint8)
        frames.append(
            {
                "p": base64.b64encode(q.tobytes()).decode(),
                "c": base64.b64encode(c8.tobytes()).decode(),
            }
        )
    payload = {"frames": frames, "scale": 1.0, "center": center.tolist()}
    html = _HTML_TEMPLATE.replace("__DATA__", json.dumps(payload))
    out_path = out_path or os.path.join(data_dir, "viewer.html")
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description="geo4d_tpu 4D viewer export")
    p.add_argument("--data", required=True, help="results dir (one sequence)")
    p.add_argument("--out", default=None)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--downsample", type=int, default=2)
    args = p.parse_args(argv)
    out = export_html(args.data, args.out, args.stride, args.downsample)
    print(f"viewer -> {out}")


if __name__ == "__main__":
    main()
