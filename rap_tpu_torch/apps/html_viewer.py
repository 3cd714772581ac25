"""Self-contained interactive HTML/WebGL point-cloud viewer export (a copy
of rap_tpu/apps/html_viewer.py; the port imports nothing of rap_tpu).

The headless counterpart of the reference's two Open3D GUI viewers: one
dependency-free .html file with the point data embedded (base64 float32 /
uint8) and a small hand-written WebGL renderer, opened in any browser with
no network and no installs.

Interactions:
  drag = orbit, wheel = zoom, shift/right-drag = pan
  n / p or the dropdown = next / previous sample
  c = cycle color mode (parts -> PCA features -> height)
  g = toggle estimated poses (input <-> registered), when poses are bundled
  +/- = point size, r = reset camera, b = background toggle

Produced by `python -m rap_tpu_torch.apps.viewer results|samples ... --html out.html`.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from pathlib import Path

import numpy as np

from ..utils.render import part_ids_to_colors, pca_colors


@dataclasses.dataclass
class HtmlSample:
    """One viewable sample: concatenated points + per-mode colors.

    ``positions`` (N,3) float32; ``positions_alt`` optional second state of
    the same points (e.g. estimated poses applied) toggled with 'g';
    ``colors`` dict mode-name -> (N,3) uint8.
    """

    name: str
    positions: np.ndarray
    colors: dict[str, np.ndarray]
    positions_alt: np.ndarray | None = None
    alt_label: str = "registered"


def _subsample(n_total: int, cap: int, seed: int = 0) -> np.ndarray:
    if n_total <= cap:
        return np.arange(n_total)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_total, cap, replace=False))


def build_sample(
    name: str,
    parts: list[np.ndarray],
    features: list[np.ndarray] | None = None,
    parts_alt: list[np.ndarray] | None = None,
    alt_label: str = "registered",
    max_points: int = 80_000,
    pca_basis: np.ndarray | None = None,
) -> tuple[HtmlSample, np.ndarray | None]:
    """Assemble an HtmlSample from part clouds (+ optional per-part features
    for PCA coloring and an alternative posed state). Subsamples to
    ``max_points``. Returns (sample, pca_basis) so the basis can be frozen
    across samples (the reference freezes it from the first batch)."""
    pts = np.concatenate(parts).astype(np.float32)
    ids = np.concatenate([np.full(len(p), i) for i, p in enumerate(parts)])
    keep = _subsample(len(pts), max_points)
    pts = pts[keep]
    ids = ids[keep]
    colors = {"parts": (part_ids_to_colors(ids)[:, :3] * 255).astype(np.uint8)}
    if features is not None and all(f is not None for f in features):
        allf = np.concatenate(features)[keep]
        cols, pca_basis = pca_colors(allf, pca_basis)
        colors["features (PCA)"] = (np.asarray(cols)[:, :3] * 255).astype(np.uint8)
    z = pts[:, 2]
    zr = np.clip((z - z.min()) / max(float(z.max() - z.min()), 1e-9), 0, 1)
    hm = np.stack([zr, 1.0 - np.abs(zr - 0.5) * 2.0, 1.0 - zr], axis=1)
    colors["height"] = (hm * 255).astype(np.uint8)
    alt = None
    if parts_alt is not None:
        alt = np.concatenate(parts_alt).astype(np.float32)[keep]
    return HtmlSample(name, pts, colors, alt, alt_label), pca_basis


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode("ascii")


def export_html(samples: list[HtmlSample], out_path, title="rap_tpu viewer") -> Path:
    """Write the single-file viewer. Point data is embedded base64; the
    decoded Float32/Uint8 arrays upload straight into WebGL buffers."""
    payload = []
    for s in samples:
        entry = {
            "name": s.name,
            "n": int(len(s.positions)),
            "pos": _b64(s.positions.astype(np.float32)),
            "colors": {k: _b64(v) for k, v in s.colors.items()},
        }
        if s.positions_alt is not None:
            entry["posAlt"] = _b64(s.positions_alt.astype(np.float32))
            entry["altLabel"] = s.alt_label
        payload.append(entry)
    html = _TEMPLATE.replace("__TITLE__", title).replace(
        "__DATA__", json.dumps(payload)
    )
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(html)
    return out_path


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#101014;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:rgba(20,20,28,.85);padding:8px 10px;
      border-radius:6px;line-height:1.7;z-index:2}
 #hud select,#hud button{background:#22232b;color:#ddd;border:1px solid #444;
      border-radius:4px;padding:2px 6px;margin-right:4px}
 #help{position:fixed;bottom:8px;left:8px;color:#888;z-index:2}
 canvas{display:block}
</style></head><body>
<div id="hud">
 <select id="sample"></select>
 <button id="color"></button>
 <button id="pose" style="display:none"></button>
 <span id="info"></span>
</div>
<div id="help">drag orbit &middot; wheel zoom &middot; shift-drag pan &middot;
 n/p sample &middot; c color &middot; g poses &middot; +/- size &middot;
 r reset &middot; b background</div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
function decode(b64, T){const s=atob(b64);const u=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new T(u.buffer);}
const canvas=document.getElementById('c');
const gl=canvas.getContext('webgl',{antialias:true});
const vs=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;uniform float ps;
 varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.0);
 gl_PointSize=max(ps/max(gl_Position.w,0.01),1.0);vc=col;}`;
const fs=`precision mediump float;varying vec3 vc;void main(){
 vec2 d=gl_PointCoord-vec2(0.5);if(dot(d,d)>0.25)discard;
 gl_FragColor=vec4(vc,1.0);}`;
function sh(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
 gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
 throw gl.getShaderInfoLog(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(prog);gl.useProgram(prog);
const locP=gl.getAttribLocation(prog,'p'),locC=gl.getAttribLocation(prog,'col');
const locMVP=gl.getUniformLocation(prog,'mvp'),locPS=gl.getUniformLocation(prog,'ps');
gl.enableVertexAttribArray(locP);gl.enableVertexAttribArray(locC);
gl.enable(gl.DEPTH_TEST);

let cur=0,colorModes=[],colorIdx=0,usingAlt=false,pointSize=42,dark=true;
let theta=0.8,phi=0.9,radius=1,target=[0,0,0],radius0=1,center0=[0,0,0];
const bufs={pos:gl.createBuffer(),posAlt:null,cols:{}};
let N=0,posArr=null,posAltArr=null;

function loadSample(i){
 cur=i;const d=DATA[i];N=d.n;
 posArr=decode(d.pos,Float32Array);
 gl.bindBuffer(gl.ARRAY_BUFFER,bufs.pos);
 gl.bufferData(gl.ARRAY_BUFFER,posArr,gl.STATIC_DRAW);
 posAltArr=null;bufs.posAlt=null;
 if(d.posAlt){posAltArr=decode(d.posAlt,Float32Array);
  bufs.posAlt=gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER,bufs.posAlt);
  gl.bufferData(gl.ARRAY_BUFFER,posAltArr,gl.STATIC_DRAW);}
 bufs.cols={};colorModes=Object.keys(d.colors);
 if(colorIdx>=colorModes.length)colorIdx=0;
 for(const k of colorModes){const b=gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.bufferData(gl.ARRAY_BUFFER,decode(d.colors[k],Uint8Array),gl.STATIC_DRAW);
  bufs.cols[k]=b;}
 // fit camera to the bounding box of whichever state is shown
 usingAlt=!!d.posAlt;   // default to the registered view when available
 fitCamera();updateHud();
}
function activePos(){return usingAlt&&posAltArr?posAltArr:posArr;}
function fitCamera(){
 const a=activePos();let mn=[1/0,1/0,1/0],mx=[-1/0,-1/0,-1/0];
 for(let i=0;i<N;i++)for(let j=0;j<3;j++){const v=a[3*i+j];
  if(v<mn[j])mn[j]=v;if(v>mx[j])mx[j]=v;}
 center0=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
 const dx=mx[0]-mn[0],dy=mx[1]-mn[1],dz=mx[2]-mn[2];
 radius0=Math.max(Math.sqrt(dx*dx+dy*dy+dz*dz),1e-6)*1.2;
 target=center0.slice();radius=radius0;theta=0.8;phi=0.9;
}
function mat(){
 const w=canvas.width,h=canvas.height,asp=w/h,f=1/Math.tan(0.4);
 const near=radius0*0.001,far=radius0*50;
 const eye=[target[0]+radius*Math.cos(phi)*Math.cos(theta),
            target[1]+radius*Math.cos(phi)*Math.sin(theta),
            target[2]+radius*Math.sin(phi)];
 // look-at
 let zx=eye[0]-target[0],zy=eye[1]-target[1],zz=eye[2]-target[2];
 let zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
 const up=[0,0,1];
 let xx=up[1]*zz-up[2]*zy,xy=up[2]*zx-up[0]*zz,xz=up[0]*zy-up[1]*zx;
 let xl=Math.hypot(xx,xy,xz)||1;xx/=xl;xy/=xl;xz/=xl;
 const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 const tx=-(xx*eye[0]+xy*eye[1]+xz*eye[2]);
 const ty=-(yx*eye[0]+yy*eye[1]+yz*eye[2]);
 const tz=-(zx*eye[0]+zy*eye[1]+zz*eye[2]);
 const nf=1/(near-far);
 // column-major mvp = P * V
 const P=[f/asp,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1, 0,0,2*far*near*nf,0];
 const V=[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0, tx,ty,tz,1];
 const M=new Float32Array(16);
 for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
  for(let k=0;k<4;k++)s+=P[k*4+r]*V[c*4+k];M[c*4+r]=s;}
 return M;
}
function draw(){
 const dpr=window.devicePixelRatio||1;
 canvas.width=innerWidth*dpr;canvas.height=innerHeight*dpr;
 canvas.style.width=innerWidth+'px';canvas.style.height=innerHeight+'px';
 gl.viewport(0,0,canvas.width,canvas.height);
 if(dark)gl.clearColor(0.063,0.063,0.078,1);else gl.clearColor(0.97,0.97,0.98,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 if(!N)return;
 gl.bindBuffer(gl.ARRAY_BUFFER,usingAlt&&bufs.posAlt?bufs.posAlt:bufs.pos);
 gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bufs.cols[colorModes[colorIdx]]);
 gl.vertexAttribPointer(locC,3,gl.UNSIGNED_BYTE,true,0,0);
 gl.uniformMatrix4fv(locMVP,false,mat());
 gl.uniform1f(locPS,pointSize*(window.devicePixelRatio||1)*radius0/radius);
 gl.drawArrays(gl.POINTS,0,N);
}
function updateHud(){
 const d=DATA[cur];
 document.getElementById('sample').value=cur;
 document.getElementById('color').textContent='color: '+colorModes[colorIdx];
 const pb=document.getElementById('pose');
 if(d.posAlt){pb.style.display='';
  pb.textContent=usingAlt?(d.altLabel||'registered'):'input';}
 else pb.style.display='none';
 document.getElementById('info').textContent=d.name+' ('+N.toLocaleString()+' pts)';
 draw();
}
const sel=document.getElementById('sample');
DATA.forEach((d,i)=>{const o=document.createElement('option');
 o.value=i;o.textContent=d.name;sel.appendChild(o);});
sel.onchange=()=>loadSample(+sel.value);
document.getElementById('color').onclick=()=>{
 colorIdx=(colorIdx+1)%colorModes.length;updateHud();};
document.getElementById('pose').onclick=()=>{usingAlt=!usingAlt;fitCamera();updateHud();};
let drag=null;
canvas.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,
 pan:e.shiftKey||e.button===2};});
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.pan){const s=radius*0.0015;
  const cx=Math.cos(theta),sx=Math.sin(theta);
  target[0]+=s*(dx*sx);target[1]-=s*(dx*cx);target[2]+=s*dy;}
 else{theta-=dx*0.008;phi=Math.min(1.55,Math.max(-1.55,phi+dy*0.008));}
 draw();});
canvas.addEventListener('contextmenu',e=>e.preventDefault());
canvas.addEventListener('wheel',e=>{e.preventDefault();
 radius*=Math.exp(e.deltaY*0.001);draw();},{passive:false});
addEventListener('keydown',e=>{
 if(e.key==='n')loadSample((cur+1)%DATA.length);
 else if(e.key==='p')loadSample((cur+DATA.length-1)%DATA.length);
 else if(e.key==='c'){colorIdx=(colorIdx+1)%colorModes.length;updateHud();}
 else if(e.key==='g'&&DATA[cur].posAlt){usingAlt=!usingAlt;updateHud();}
 else if(e.key==='+'||e.key==='='){pointSize*=1.25;draw();}
 else if(e.key==='-'){pointSize/=1.25;draw();}
 else if(e.key==='r'){fitCamera();draw();}
 else if(e.key==='b'){dark=!dark;draw();}});
addEventListener('resize',draw);
if(DATA.length)loadSample(0);
</script></body></html>
"""
