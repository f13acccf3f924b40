"""Interactive 3-D viewer in the browser for live and replayed SLAM runs
(counterpart of ``evennicer_slam_tpu/tools/viz_server.py``; the standard
library's ``ThreadingHTTPServer`` and numpy).

The reference drives an open3d window fed by a queue: a shaded mesh that
reloads as mapping progresses, the estimated and ground-truth trajectories,
a camera frustum following the current pose, mouse navigation. Headless,
the window is a browser: this module serves a self-contained WebGL viewer
(no external assets) and two data endpoints, and a poll thread watches the
run directory as ``viz.py --follow`` does:

- ``GET /``           the viewer page (embedded HTML/JS, WebGL1; the JAX
                      package's page, byte for byte)
- ``GET /state.json`` current frame idx, est/GT trajectory positions,
                      current pose, mesh version
- ``GET /mesh.bin``   latest mesh, packed binary (header, positions,
                      per-vertex normals, RGBA colors, u32 triangle indices)

The client polls ``/state.json`` (~1 Hz), fetches ``/mesh.bin`` again
whenever ``mesh_version`` changes, and redraws the trajectories and the
frustum every poll. The checkpoints of both packages carry the keys read
here, so either package's server serves either package's run.

Usage:
    python -m evennicer_slam_tpu_torch.tools.viz_server <config.yaml>
        [--output DIR] [--port 8765] [--host 127.0.0.1] [--poll_s 2]
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh
from evennicer_slam_tpu_torch.tools.viz import _load_latest


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (accumulated face cross products)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    n = np.zeros_like(v)
    if len(f):
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        for k in range(3):
            np.add.at(n, f[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 1e-12, n / np.maximum(norm, 1e-12), [0.0, 0.0, 1.0])
    return n.astype(np.float32)


def pack_mesh(mesh, version: int) -> bytes:
    """Binary mesh buffer the JS client parses with a DataView.

    Layout (little endian): magic ``u32 0x4d455348``, version u32, n_verts
    u32, n_faces u32, then positions f32[3n], normals f32[3n], colors
    u8[4n] (RGBA), indices u32[3f].
    """
    v = np.ascontiguousarray(mesh.vertices, dtype="<f4")
    f = np.ascontiguousarray(mesh.faces, dtype="<u4")
    n = vertex_normals(mesh.vertices, mesh.faces)
    if mesh.vertex_colors is not None and len(mesh.vertex_colors):
        c = np.asarray(mesh.vertex_colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
    else:
        c = np.full((len(v), 3), 180, np.uint8)
    rgba = np.concatenate(
        [c[:, :3], np.full((len(v), 1), 255, np.uint8)], axis=1
    )
    head = struct.pack("<IIII", 0x4D455348, version, len(v), len(f))
    return b"".join([
        head,
        v.tobytes(),
        np.ascontiguousarray(n, dtype="<f4").tobytes(),
        rgba.tobytes(),
        f.tobytes(),
    ])


class RunWatcher:
    """Polls a run's output dir; caches trajectory state + packed mesh."""

    def __init__(self, output: str, poll_s: float = 2.0):
        self.output = output
        self.poll_s = poll_s
        self._lock = threading.Lock()
        self._state = {
            "idx": -1, "mesh_version": 0, "n_verts": 0, "n_faces": 0,
            "est": [], "gt": [], "cur_c2w": np.eye(4).tolist(),
            "output": output,
        }
        self._mesh_bytes = pack_mesh(_EmptyMesh(), 0)
        self._seen_ckpt = None
        self._seen_mesh = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.refresh()
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.poll_s):
            try:
                self.refresh()
            except Exception as e:  # noqa: BLE001 - keep serving on bad reads
                print(f"[viz_server] refresh failed: {e}")

    def refresh(self):
        try:
            latest = _load_latest(self.output)
        except FileNotFoundError:
            latest = None
        if latest is None:
            return
        ckpt, est, gt, mesh_path, idx = latest
        # parse/pack outside the lock (full-res mesh loads take seconds;
        # /state.json and /mesh.bin must not stall behind them), then swap
        # the finished buffers in under it. refresh() runs on one thread,
        # so _seen_* reads without the lock are safe.
        state_update = None
        if ckpt != self._seen_ckpt:
            finite = lambda p: np.isfinite(p).all(axis=(1, 2))  # noqa: E731
            est = est[finite(est)]
            gt = gt[finite(gt)]
            state_update = dict(
                idx=idx,
                est=np.round(est[:, :3, 3], 4).tolist(),
                gt=np.round(gt[:, :3, 3], 4).tolist(),
                cur_c2w=(est[-1] if len(est) else np.eye(4)).tolist(),
            )
        mesh_bytes = None
        if mesh_path is not None and mesh_path != self._seen_mesh:
            mesh = Mesh.load(mesh_path)
            ver = self._state["mesh_version"] + 1  # single-writer read
            mesh_bytes = pack_mesh(mesh, ver)
        with self._lock:
            if state_update is not None:
                self._seen_ckpt = ckpt
                self._state.update(state_update)
            if mesh_bytes is not None:
                self._seen_mesh = mesh_path
                self._mesh_bytes = mesh_bytes
                self._state.update(
                    mesh_version=ver, n_verts=len(mesh.vertices),
                    n_faces=len(mesh.faces),
                    mesh_path=os.path.basename(mesh_path),
                )

    def state_json(self) -> bytes:
        with self._lock:
            return json.dumps(self._state).encode()

    def mesh_bin(self) -> bytes:
        with self._lock:
            return self._mesh_bytes


class _EmptyMesh:
    vertices = np.zeros((0, 3), np.float32)
    faces = np.zeros((0, 3), np.int64)
    vertex_colors = None


def make_handler(watcher: RunWatcher):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(PAGE.encode(), "text/html; charset=utf-8")
            elif path == "/state.json":
                self._send(watcher.state_json(), "application/json")
            elif path == "/mesh.bin":
                self._send(watcher.mesh_bin(), "application/octet-stream")
            else:
                self.send_error(404)

    return Handler


def serve(output: str, host: str = "127.0.0.1", port: int = 8765,
          poll_s: float = 2.0, blocking: bool = True):
    watcher = RunWatcher(output, poll_s).start()
    httpd = ThreadingHTTPServer((host, port), make_handler(watcher))
    print(f"[viz_server] http://{host}:{httpd.server_address[1]}/  "
          f"(watching {output})")
    if blocking:
        try:
            httpd.serve_forever()
        finally:
            watcher.stop()
    else:
        # Accept loop in a daemon thread so callers can talk to the server
        # immediately; httpd.shutdown() stops this loop (it would deadlock
        # if serve_forever were never entered).
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, watcher


PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>EvenNICER-SLAM-TPU viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;
   font:12px/1.4 system-ui,sans-serif;color:#ddd}
 #c{width:100%;height:100%;display:block}
 #hud{position:fixed;top:8px;left:8px;background:rgba(0,0,0,.55);
   padding:8px 10px;border-radius:6px;pointer-events:none;white-space:pre}
 #legend{position:fixed;bottom:8px;left:8px;background:rgba(0,0,0,.55);
   padding:6px 10px;border-radius:6px;pointer-events:none}
 .sw{display:inline-block;width:10px;height:10px;margin-right:4px;
   border-radius:2px}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">connecting…</div>
<div id="legend">
 <span class="sw" style="background:#4da3ff"></span>estimated&nbsp;
 <span class="sw" style="background:#888"></span>ground truth&nbsp;
 <span class="sw" style="background:#ff5252"></span>camera<br>
 drag orbit · right/shift-drag pan · wheel zoom
</div>
<script>
"use strict";
const cv = document.getElementById("c"), hud = document.getElementById("hud");
const gl = cv.getContext("webgl", {antialias: true});

function sh(type, src){const s=gl.createShader(type);gl.shaderSource(s,src);
 gl.compileShader(s);
 if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
   throw gl.getShaderInfoLog(s);
 return s;}
function prog(vs,fs){const p=gl.createProgram();
 gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));
 gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);
 if(!gl.getProgramParameter(p,gl.LINK_STATUS))
   throw gl.getProgramInfoLog(p);
 return p;}

const meshProg = prog(`
 attribute vec3 aPos; attribute vec3 aNrm; attribute vec4 aCol;
 uniform mat4 uMVP; uniform vec3 uEye;
 varying vec3 vN; varying vec4 vC; varying vec3 vL;
 void main(){ gl_Position = uMVP * vec4(aPos,1.0);
   vN = aNrm; vC = aCol; vL = normalize(uEye - aPos); }`, `
 precision mediump float;
 varying vec3 vN; varying vec4 vC; varying vec3 vL;
 void main(){
   float d = abs(dot(normalize(vN), normalize(vL)));
   vec3 c = vC.rgb * (0.25 + 0.75 * d);
   gl_FragColor = vec4(c, 1.0); }`);
const lineProg = prog(`
 attribute vec3 aPos; uniform mat4 uMVP;
 void main(){ gl_Position = uMVP * vec4(aPos,1.0); }`, `
 precision mediump float; uniform vec4 uColor;
 void main(){ gl_FragColor = uColor; }`);

// --- tiny mat4 helpers (column major) -----------------------------------
function perspective(fovy, aspect, near, far){
 const f = 1/Math.tan(fovy/2), nf = 1/(near-far);
 return [f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1,
         0,0,2*far*near*nf,0];}
function mul(a,b){const o=new Array(16);
 for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
   for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s;}return o;}
function lookAt(eye, ctr, up){
 const z=norm3(sub3(eye,ctr)), x=norm3(cross3(up,z)), y=cross3(z,x);
 return [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
   -dot3(x,eye),-dot3(y,eye),-dot3(z,eye),1];}
function sub3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross3(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
  a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
 return [a[0]/l,a[1]/l,a[2]/l];}

// --- orbit camera --------------------------------------------------------
const cam = {yaw: 0.6, pitch: 0.5, dist: 6, target: [0,0,0], auto: true};
function eyePos(){
 const cp=Math.cos(cam.pitch), sp=Math.sin(cam.pitch);
 const cy=Math.cos(cam.yaw), sy=Math.sin(cam.yaw);
 return [cam.target[0]+cam.dist*cp*cy,
         cam.target[1]+cam.dist*cp*sy,
         cam.target[2]+cam.dist*sp];}
let drag=null;
cv.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,
  pan:e.button===2||e.shiftKey};cam.auto=false;});
window.addEventListener("mouseup",()=>drag=null);
cv.addEventListener("contextmenu",e=>e.preventDefault());
window.addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
 drag.x=e.clientX; drag.y=e.clientY;
 if(drag.pan){
   const s=cam.dist*0.0018, eye=eyePos();
   const z=norm3(sub3(eye,cam.target)), x=norm3(cross3([0,0,1],z)),
         y=cross3(z,x);
   for(let i=0;i<3;i++)
     cam.target[i]+= -dx*s*x[i] + dy*s*y[i];
 }else{
   cam.yaw -= dx*0.007;
   cam.pitch = Math.min(1.45, Math.max(-1.45, cam.pitch + dy*0.007));
 }});
cv.addEventListener("wheel",e=>{e.preventDefault();cam.auto=false;
 cam.dist*=Math.exp(e.deltaY*0.001);
 cam.dist=Math.min(100,Math.max(0.1,cam.dist));},{passive:false});

// --- buffers -------------------------------------------------------------
const meshBuf={pos:gl.createBuffer(),nrm:gl.createBuffer(),
 col:gl.createBuffer(),idx:gl.createBuffer(),n:0};
const lineBufs={est:gl.createBuffer(),gt:gl.createBuffer(),
 fr:gl.createBuffer()};
const lineN={est:0,gt:0,fr:0};
let state={idx:-1,mesh_version:-1}, meshVer=-1;

function setLines(key, flat){
 gl.bindBuffer(gl.ARRAY_BUFFER,lineBufs[key]);
 gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(flat),gl.DYNAMIC_DRAW);
 lineN[key]=flat.length/3;}

function frustumSegs(m){ // m = 4x4 row-major c2w
 const s=0.12, loc=[[0,0,0],[-1,-.75,-1.5],[1,-.75,-1.5],[1,.75,-1.5],
   [-1,.75,-1.5]].map(p=>{
    const x=p[0]*s,y=p[1]*s,z=p[2]*s;
    return [m[0][0]*x+m[0][1]*y+m[0][2]*z+m[0][3],
            m[1][0]*x+m[1][1]*y+m[1][2]*z+m[1][3],
            m[2][0]*x+m[2][1]*y+m[2][2]*z+m[2][3]];});
 const e=[[0,1],[0,2],[0,3],[0,4],[1,2],[2,3],[3,4],[4,1]], out=[];
 for(const [a,b] of e){out.push(...loc[a],...loc[b]);}
 return out;}

async function poll(){
 try{
  const st = await (await fetch("state.json")).json();
  state = st;
  setLines("est", st.est.flat());
  setLines("gt", st.gt.flat());
  setLines("fr", frustumSegs(st.cur_c2w));
  if(st.mesh_version !== meshVer){
    const buf = await (await fetch("mesh.bin")).arrayBuffer();
    const dv = new DataView(buf);
    if(dv.getUint32(0,true)===0x4d455348){
      const nv=dv.getUint32(8,true), nf=dv.getUint32(12,true);
      let o=16;
      const pos=new Float32Array(buf,o,3*nv); o+=12*nv;
      const nrm=new Float32Array(buf,o,3*nv); o+=12*nv;
      const col=new Uint8Array(buf,o,4*nv);   o+=4*nv;
      const idx=new Uint32Array(buf,o,3*nf);
      gl.bindBuffer(gl.ARRAY_BUFFER,meshBuf.pos);
      gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
      gl.bindBuffer(gl.ARRAY_BUFFER,meshBuf.nrm);
      gl.bufferData(gl.ARRAY_BUFFER,nrm,gl.STATIC_DRAW);
      gl.bindBuffer(gl.ARRAY_BUFFER,meshBuf.col);
      gl.bufferData(gl.ARRAY_BUFFER,col,gl.STATIC_DRAW);
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,meshBuf.idx);
      // WebGL1 u32 indices need OES_element_index_uint (universal today)
      gl.getExtension("OES_element_index_uint");
      gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,idx,gl.STATIC_DRAW);
      meshBuf.n=3*nf; meshVer=st.mesh_version;
      if(cam.auto && nv>0){ // frame the scene once
        let mn=[1e9,1e9,1e9],mx=[-1e9,-1e9,-1e9];
        for(let i=0;i<nv;i+=Math.max(1,Math.floor(nv/5000))){
          for(let k=0;k<3;k++){const v=pos[3*i+k];
            mn[k]=Math.min(mn[k],v);mx[k]=Math.max(mx[k],v);}}
        cam.target=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
        cam.dist=1.6*Math.hypot(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2])||6;
      }
    }
  }
  hud.textContent = `frame ${st.idx}` +
    (st.mesh_path?`  mesh ${st.mesh_path} v${st.mesh_version}`:"") +
    `\n${st.n_verts||0} verts / ${st.n_faces||0} tris` +
    `\nest ${st.est.length} poses`;
 }catch(e){ hud.textContent = "poll error: "+e; }
 setTimeout(poll, 1000);
}

function draw(){
 const w=cv.clientWidth,h=cv.clientHeight;
 if(cv.width!==w||cv.height!==h){cv.width=w;cv.height=h;}
 gl.viewport(0,0,w,h);
 gl.clearColor(0.07,0.07,0.08,1);
 gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const eye=eyePos();
 const mvp=mul(perspective(0.9,w/h,0.02,500),
               lookAt(eye,cam.target,[0,0,1]));
 if(meshBuf.n>0){
  gl.useProgram(meshProg);
  gl.uniformMatrix4fv(gl.getUniformLocation(meshProg,"uMVP"),false,mvp);
  gl.uniform3fv(gl.getUniformLocation(meshProg,"uEye"),eye);
  const bind=(buf,name,size,type,norm)=>{
    const loc=gl.getAttribLocation(meshProg,name);
    gl.bindBuffer(gl.ARRAY_BUFFER,buf);
    gl.enableVertexAttribArray(loc);
    gl.vertexAttribPointer(loc,size,type,norm,0,0);};
  bind(meshBuf.pos,"aPos",3,gl.FLOAT,false);
  bind(meshBuf.nrm,"aNrm",3,gl.FLOAT,false);
  bind(meshBuf.col,"aCol",4,gl.UNSIGNED_BYTE,true);
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,meshBuf.idx);
  gl.drawElements(gl.TRIANGLES,meshBuf.n,gl.UNSIGNED_INT,0);
 }
 gl.useProgram(lineProg);
 gl.uniformMatrix4fv(gl.getUniformLocation(lineProg,"uMVP"),false,mvp);
 const aPos=gl.getAttribLocation(lineProg,"aPos");
 gl.enableVertexAttribArray(aPos);
 const drawLines=(key,mode,rgba)=>{
  if(lineN[key]<2)return;
  gl.bindBuffer(gl.ARRAY_BUFFER,lineBufs[key]);
  gl.vertexAttribPointer(aPos,3,gl.FLOAT,false,0,0);
  gl.uniform4fv(gl.getUniformLocation(lineProg,"uColor"),rgba);
  gl.drawArrays(mode,0,lineN[key]);};
 gl.lineWidth(2);
 drawLines("gt",gl.LINE_STRIP,[0.55,0.55,0.55,1]);
 drawLines("est",gl.LINE_STRIP,[0.30,0.64,1.0,1]);
 drawLines("fr",gl.LINES,[1.0,0.32,0.32,1]);
 requestAnimationFrame(draw);
}
poll(); draw();
</script></body></html>
"""


def main(argv=None):
    from evennicer_slam_tpu_torch.config import default_config_path, load_config

    p = argparse.ArgumentParser(
        description="Interactive browser viewer for a SLAM run (live or replay)"
    )
    p.add_argument("config", type=str)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--poll_s", type=float, default=2.0)
    p.add_argument("--nice", dest="nice", action="store_true", default=True)
    p.add_argument("--imap", dest="nice", action="store_false")
    args = p.parse_args(argv)
    cfg = load_config(args.config, default_config_path(args.nice))
    output = args.output or cfg["data"]["output"]
    serve(output, args.host, args.port, args.poll_s)


if __name__ == "__main__":
    main()
