"""Interactive latent→shape explorer (counterpart of
``msd_tpu/explorer.py``; the functions take no ``params``, since a torch
module holds its own weights).

Experiential parity with the reference's
``interactive_visualization_latent_to_shape.ipynb`` (slider per latent
dimension → decode → marching cubes → live 3-D view) in two forms that fit
a headless host:

- :func:`export_interactive_html` — a **self-contained HTML file** (no
  network, no dependencies) with one slider per explored latent dimension
  over *precomputed* marching-cubes frames, rendered by an embedded
  canvas rasterizer (drag to rotate, wheel to zoom). Frames are
  single-axis sweeps around a base latent: moving a slider shows
  ``base + delta·step`` along that dimension (other sliders snap back,
  matching the one-dim-at-a-time way the notebook is actually used).
- :func:`run_matplotlib_explorer` — a **live** matplotlib-widgets session
  (requires a display): sliders re-decode through the real decoder on
  every change, exactly the notebook's loop.

Mesh payloads are binary-packed (base64 u16 vertices / u32 faces) so a
typical 8-dim × 9-step export stays a few MB.

Every frame is the port's ``create_mesh`` of its latent, bit for bit:
``sweep_frames`` builds one ``PointEvaluator`` per sweep and hands it to
each call, so K1's weight preparation on the card is done once, not once
per frame. At N=97 and above (after ``create_mesh``'s snap to 4k+1) the
frames stream on the card; at N=65 and below they take the dense route
(``mesh._pick_block``). Only ``run_matplotlib_explorer`` needs matplotlib.
"""

from __future__ import annotations

import base64
import json
import logging
import os

import numpy as np
import torch

from msd_tpu_torch import mesh as mesh_mod


def _decode_mesh(decoder, latent, N, evaluator):
    """(verts, faces) for one latent, or None when no surface crosses."""
    res = mesh_mod.create_mesh(
        decoder, torch.as_tensor(np.asarray(latent, np.float32), device=evaluator.device),
        N=N, return_mesh=True, evaluator=evaluator,
    )
    if res is None or res is False:
        return None
    return res


def sweep_frames(decoder, base_latent, dims, steps, delta, N):
    """Precompute single-axis sweep meshes.

    Returns (base_mesh, {dim: [mesh or None per step]}, step_values) where
    ``step_values`` are the per-slider latent offsets (length ``steps``,
    symmetric around 0, centre exactly 0 = base shape).
    """
    base_latent = np.asarray(base_latent, np.float32).reshape(-1)
    step_values = np.linspace(-delta, delta, steps)
    evaluator = mesh_mod.mesh_evaluator(decoder, N)
    base_mesh = _decode_mesh(decoder, base_latent, N, evaluator)
    frames = {}
    for d in dims:
        row = []
        for s in step_values:
            if abs(s) < 1e-12 and base_mesh is not None:
                row.append(base_mesh)
                continue
            z = base_latent.copy()
            z[d] += s
            row.append(_decode_mesh(decoder, z, N, evaluator))
        frames[int(d)] = row
        logging.info("sweep dim %d: %d/%d frames have surface",
                     d, sum(m is not None for m in row), steps)
    return base_mesh, frames, step_values


def _pack_mesh(mesh):
    """Quantize a (verts, faces) mesh to base64 u16 verts + u32 faces."""
    if mesh is None:
        return None
    v, f = mesh
    v = np.asarray(v, np.float64)
    f = np.asarray(f, np.uint32)
    lo = v.min(axis=0)
    span = np.maximum(v.max(axis=0) - lo, 1e-9)
    q = np.round((v - lo) / span * 65535.0).astype("<u2")
    return {
        "lo": [float(x) for x in lo],
        "span": [float(x) for x in span],
        "nv": int(len(v)),
        "nf": int(len(f)),
        "v": base64.b64encode(q.tobytes()).decode("ascii"),
        "f": base64.b64encode(f.astype("<u4").tobytes()).decode("ascii"),
    }


def export_interactive_html(
    decoder, base_latent, out_path, dims=None, steps=9,
    delta=0.05, N=64, title="msd_tpu latent explorer",
):
    """Write a self-contained interactive HTML latent explorer.

    ``dims`` defaults to the first min(8, latent_size) dimensions; pass an
    explicit list to explore designated disentangled dims (e.g. [0, 1] for
    diagnosis/age in the Stage-2 configs).
    """
    base_latent = np.asarray(base_latent, np.float32).reshape(-1)
    if dims is None:
        dims = list(range(min(8, base_latent.shape[0])))
    dims = [int(d) for d in dims]
    base_mesh, frames, step_values = sweep_frames(
        decoder, base_latent, dims, steps, delta, N
    )
    if base_mesh is None and all(m is None for row in frames.values() for m in row):
        raise RuntimeError("no sweep frame produced a surface; is the decoder trained?")
    payload = {
        "title": title,
        "dims": dims,
        "steps": [float(s) for s in step_values],
        "delta": float(delta),
        "base": _pack_mesh(base_mesh),
        "frames": {str(d): [_pack_mesh(m) for m in row] for d, row in frames.items()},
    }
    html = _HTML_TEMPLATE.replace("__TITLE__", title).replace(
        "__PAYLOAD__", json.dumps(payload, separators=(",", ":"))
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as fh:
        fh.write(html)
    logging.info("wrote %s (%.1f MB, %d dims x %d steps)",
                 out_path, os.path.getsize(out_path) / 1e6, len(dims), steps)
    return out_path


def run_matplotlib_explorer(
    decoder, base_latent, dims=None, delta=0.05, N=48,
):
    """Live slider→decode→marching-cubes explorer (notebook parity; needs
    an interactive matplotlib backend/display)."""
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider

    base_latent = np.asarray(base_latent, np.float32).reshape(-1)
    if dims is None:
        dims = list(range(min(8, base_latent.shape[0])))
    z = base_latent.copy()
    evaluator = mesh_mod.mesh_evaluator(decoder, N)

    fig = plt.figure(figsize=(7, 8))
    ax = fig.add_axes([0.02, 0.25, 0.96, 0.72], projection="3d")

    def draw():
        ax.clear()
        mesh = _decode_mesh(decoder, z, N, evaluator)
        if mesh is None:
            ax.set_title("no surface at this latent")
        else:
            v, f = mesh
            ax.plot_trisurf(v[:, 0], v[:, 1], f, v[:, 2], color="#c9b458", lw=0.05)
            ax.set_title("latent explorer")
        ax.set_box_aspect((1, 1, 1))
        lim = 1.0
        ax.set_xlim(-lim, lim), ax.set_ylim(-lim, lim), ax.set_zlim(-lim, lim)
        fig.canvas.draw_idle()

    sliders = []
    h = 0.20 / max(len(dims), 1)
    for i, d in enumerate(dims):
        sax = fig.add_axes([0.15, 0.02 + i * h, 0.7, h * 0.7])
        s = Slider(sax, f"z[{d}]", float(z[d] - delta), float(z[d] + delta), valinit=float(z[d]))

        def on_change(val, d=d):
            z[d] = val
            draw()

        s.on_changed(on_change)
        sliders.append(s)
    draw()
    plt.show()
    return fig


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#14161a;color:#e6e6e6;display:flex;flex-direction:column;align-items:center}
 h1{font-size:16px;font-weight:600;margin:12px 0 4px}
 #hint{font-size:12px;color:#9aa0a6;margin-bottom:8px}
 canvas{background:#1d2026;border-radius:8px;cursor:grab}
 #panel{width:700px;max-width:95vw;margin:10px 0 30px}
 .row{display:flex;align-items:center;gap:10px;margin:6px 0}
 .row label{width:52px;font-size:13px;color:#c9b458}
 .row input[type=range]{flex:1}
 .row .val{width:74px;font-size:12px;color:#9aa0a6;text-align:right}
 .missing{color:#e06c75;font-size:12px;margin-left:8px}
</style></head><body>
<h1>__TITLE__</h1>
<div id="hint">drag to rotate &middot; wheel to zoom &middot; one slider active at a time (single-axis sweeps around the base latent)</div>
<canvas id="c" width="700" height="520"></canvas>
<div id="panel"></div>
<script>
const DATA = __PAYLOAD__;
function unpack(m){
 if(!m) return null;
 const vb = Uint8Array.from(atob(m.v), ch=>ch.charCodeAt(0));
 const fb = Uint8Array.from(atob(m.f), ch=>ch.charCodeAt(0));
 const q = new Uint16Array(vb.buffer), faces = new Uint32Array(fb.buffer);
 const v = new Float32Array(m.nv*3);
 for(let i=0;i<m.nv;i++) for(let k=0;k<3;k++)
   v[i*3+k] = m.lo[k] + (q[i*3+k]/65535.0)*m.span[k];
 return {v:v, f:faces, nv:m.nv, nf:m.nf};
}
const base = unpack(DATA.base);
const frames = {};
for(const d of DATA.dims) frames[d] = DATA.frames[String(d)].map(unpack);
let current = base, yaw = 0.7, pitch = -0.5, zoom = 1.0;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
function render(){
 ctx.fillStyle = '#1d2026'; ctx.fillRect(0,0,cv.width,cv.height);
 if(!current){ctx.fillStyle='#e06c75';ctx.font='14px sans-serif';
   ctx.fillText('no surface at this latent', 280, 260); return;}
 const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
 const n=current.nv, v=current.v, f=current.f, nf=current.nf;
 const px=new Float32Array(n), py=new Float32Array(n), pz=new Float32Array(n);
 // center+scale once per mesh
 let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
 for(let i=0;i<n;i++) for(let k=0;k<3;k++){const x=v[i*3+k]; if(x<lo[k])lo[k]=x; if(x>hi[k])hi[k]=x;}
 const cx0=(lo[0]+hi[0])/2, cy0=(lo[1]+hi[1])/2, cz0=(lo[2]+hi[2])/2;
 const ext=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])||1;
 const s = 380*zoom/ext;
 for(let i=0;i<n;i++){
  const x=v[i*3]-cx0, y=v[i*3+1]-cy0, z=v[i*3+2]-cz0;
  const x1=cy*x+sy*z, z1=-sy*x+cy*z;
  const y2=cp*y-sp*z1, z2=sp*y+cp*z1;
  px[i]=350+s*x1; py[i]=260-s*y2; pz[i]=z2;
 }
 const order=new Array(nf); const depth=new Float32Array(nf);
 for(let t=0;t<nf;t++){const a=f[t*3],b=f[t*3+1],c=f[t*3+2];
   depth[t]=(pz[a]+pz[b]+pz[c])/3; order[t]=t;}
 order.sort((a,b)=>depth[a]-depth[b]);
 for(const t of order){
  const a=f[t*3],b=f[t*3+1],c=f[t*3+2];
  const ux=px[b]-px[a], uy=py[b]-py[a], wx=px[c]-px[a], wy=py[c]-py[a];
  const area=ux*wy-uy*wx; if(area<=0) continue;            // backface cull
  const nz=area/ (Math.hypot(ux,uy)*Math.hypot(wx,wy)+1e-9);
  const l=Math.min(1,0.35+0.65*nz);
  ctx.fillStyle=`rgb(${Math.round(201*l)},${Math.round(180*l)},${Math.round(88*l)})`;
  ctx.beginPath();ctx.moveTo(px[a],py[a]);ctx.lineTo(px[b],py[b]);ctx.lineTo(px[c],py[c]);ctx.closePath();ctx.fill();
 }
}
let dragging=false,lx=0,ly=0;
cv.addEventListener('mousedown',e=>{dragging=true;lx=e.clientX;ly=e.clientY;});
window.addEventListener('mouseup',()=>dragging=false);
window.addEventListener('mousemove',e=>{if(!dragging)return;
 yaw+=(e.clientX-lx)*0.008; pitch+=(e.clientY-ly)*0.008; lx=e.clientX;ly=e.clientY; render();});
cv.addEventListener('wheel',e=>{e.preventDefault();zoom*=Math.exp(-e.deltaY*0.001);render();});
const panel=document.getElementById('panel');
const mid=Math.floor(DATA.steps.length/2);
const sliders={};
for(const d of DATA.dims){
 const row=document.createElement('div');row.className='row';
 const lab=document.createElement('label');lab.textContent='z['+d+']';
 const inp=document.createElement('input');inp.type='range';
 inp.min=0;inp.max=DATA.steps.length-1;inp.step=1;inp.value=mid;
 const val=document.createElement('span');val.className='val';val.textContent='+0.0000';
 inp.addEventListener('input',()=>{
  for(const d2 of DATA.dims){if(d2!==d){sliders[d2].value=mid;
    sliders[d2].nextSibling.textContent='+0.0000';}}
  const i=parseInt(inp.value);
  val.textContent=(DATA.steps[i]>=0?'+':'')+DATA.steps[i].toFixed(4);
  current=frames[d][i]||null; render();
 });
 sliders[d]=inp;
 row.appendChild(lab);row.appendChild(inp);row.appendChild(val);panel.appendChild(row);
}
render();
</script></body></html>
"""
