"""Interactive 3D scene viewer as one self-contained HTML file.

Counterpart of sdflabel_tpu/utils/viz3d.py, the headless analogue of the
reference's two Open3D windows (utils/visualizer.py:51-88 plot_3d, the
model/scene correspondences with heat-coloured lines, and :91-120
plot_3d_final, the LIDAR with estimated and GT cuboids): the scene is
embedded as JSON and drawn by a dependency-free canvas renderer with
orbit, pan and zoom. Open the file in any browser; it needs no server and
no network.

Controls: drag = orbit, wheel = zoom, shift-drag = pan, R = reset,
number keys toggle layers.
"""

from __future__ import annotations

import json
import os

import numpy as np

_MAX_POINTS = 60000


def _pts(a, max_n=_MAX_POINTS):
    a = np.asarray(a, np.float64).reshape(-1, 3)
    if len(a) > max_n:
        step = len(a) / max_n
        a = a[(np.arange(max_n) * step).astype(int)]
    return np.round(a, 3).tolist()


def cuboid_edges(dimensions, location, rotation_y):
    """KITTI cuboid -> 12 wireframe edges (24 xyz vertices).

    Same convention as utils.viz.plot_bev / the reference's
    make_cuboid_lineset (visualizer.py:98-109 via refinement.py:280-357):
    dimensions = (h, w, l), location = bottom-center in camera frame,
    yaw about +Y.
    """
    h, w, ln = [float(v) for v in dimensions]
    x, y, z = [float(v) for v in location]
    c, s = np.cos(float(rotation_y)), np.sin(float(rotation_y))
    # 8 corners in object frame (y up = -h..0 since location is bottom)
    xs = np.array([+1, +1, -1, -1, +1, +1, -1, -1]) * (w / 2)
    ys = np.array([0, 0, 0, 0, -1, -1, -1, -1]) * h
    zs = np.array([+1, -1, -1, +1, +1, -1, -1, +1]) * (ln / 2)
    rx = c * xs + s * zs
    rz = -s * xs + c * zs
    corners = np.stack([rx + x, ys + y, rz + z], 1)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
             (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
    return [[corners[a].tolist(), corners[b].tolist()] for a, b in edges]


def export_scene_html(
    path: str,
    lidar=None,
    model_points=None,
    scene_points=None,
    correspondences=None,
    est_boxes=(),
    gt_boxes=(),
    title: str = "sdflabel_tpu 3D scene",
):
    """Write a single-file interactive 3D viewer.

    lidar: (N,3) camera-frame background cloud (gray).
    model_points: (M,3) rendered/model surface points (blue).
    scene_points: (K,3) frustum/scene points the 3D loss matches against
      (orange).
    correspondences: optional (model_idx -> scene pairing) dict with keys
      'a' (P,3), 'b' (P,3), 'heat' (P,) — drawn as heat-colored lines,
      the analogue of visualizer.py:51-88.
    est_boxes / gt_boxes: iterables of label dicts with 'dimensions',
      'location', 'rotation_y' — red / green wireframes
      (visualizer.py:91-120).
    """
    layers = []
    if lidar is not None and len(np.atleast_2d(lidar)):
        layers.append({"kind": "points", "name": "lidar",
                       "color": "#9a9a9a", "size": 1.2,
                       "pts": _pts(lidar)})
    if scene_points is not None and len(np.atleast_2d(scene_points)):
        layers.append({"kind": "points", "name": "scene",
                       "color": "#e8953a", "size": 2.0,
                       "pts": _pts(scene_points)})
    if model_points is not None and len(np.atleast_2d(model_points)):
        layers.append({"kind": "points", "name": "model",
                       "color": "#3a7fe8", "size": 2.2,
                       "pts": _pts(model_points)})
    if correspondences is not None and len(correspondences.get("a", [])):
        a = np.asarray(correspondences["a"], np.float64).reshape(-1, 3)
        b = np.asarray(correspondences["b"], np.float64).reshape(-1, 3)
        heat = np.asarray(correspondences.get(
            "heat", np.zeros(len(a))), np.float64).reshape(-1)
        n = min(len(a), len(b), len(heat), 4000)
        hmax = float(heat[:n].max()) if n and heat[:n].max() > 0 else 1.0
        layers.append({
            "kind": "lines", "name": "correspondences",
            "segs": np.round(np.stack([a[:n], b[:n]], 1), 3).tolist(),
            "heat": np.round(heat[:n] / hmax, 3).tolist(),
        })
    for name, boxes, color in (("est", est_boxes, "#e03a3a"),
                               ("gt", gt_boxes, "#2fae4f")):
        segs = []
        for box in boxes:
            segs.extend(cuboid_edges(box["dimensions"], box["location"],
                                     box["rotation_y"]))
        if segs:
            layers.append({"kind": "lines", "name": f"{name} cuboids",
                           "color": color, "segs": segs, "width": 2.0})

    scene = {"title": title, "layers": layers}
    html = _TEMPLATE.replace("__SCENE_JSON__", json.dumps(scene))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, path)  # atomic: live-reload viewers never see a torn file
    return path


_TEMPLATE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
 html,body{margin:0;height:100%;background:#16181d;color:#cfd3da;
  font:12px system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;user-select:none;line-height:1.6}
 #hud b{color:#fff}.sw{display:inline-block;width:9px;height:9px;
  border-radius:2px;margin-right:4px;vertical-align:-1px}
 .off{opacity:.35}#help{position:fixed;bottom:8px;left:10px;opacity:.55}
 canvas{display:block}
</style></head><body>
<canvas id="c"></canvas><div id="hud"></div>
<div id="help">drag orbit &middot; shift-drag pan &middot; wheel zoom
 &middot; R reset &middot; 1-9 toggle layers</div>
<script>
const SCENE = __SCENE_JSON__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W,H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
addEventListener('resize',()=>{resize();draw();}); resize();

// scene centroid + radius for the initial camera
let ctr=[0,0,0], n=0, rad=1;
for(const L of SCENE.layers){
  const P = L.kind==='points'?L.pts:(L.segs?L.segs.flat():[]);
  for(const p of P){ctr[0]+=p[0];ctr[1]+=p[1];ctr[2]+=p[2];n++;}
}
if(n){ctr=ctr.map(v=>v/n);}
for(const L of SCENE.layers){
  const P = L.kind==='points'?L.pts:(L.segs?L.segs.flat():[]);
  for(const p of P){const d=Math.hypot(p[0]-ctr[0],p[1]-ctr[1],p[2]-ctr[2]);
    if(d>rad)rad=d;}
}
const HOME={yaw:-0.6,pitch:-0.35,dist:rad*2.2,tx:0,ty:0};
let cam={...HOME};
const vis = SCENE.layers.map(()=>true);

function project(p){
  // camera frame: KITTI-style x right, y down, z forward; orbit about ctr
  let x=p[0]-ctr[0], y=p[1]-ctr[1], z=p[2]-ctr[2];
  const cy=Math.cos(cam.yaw), sy=Math.sin(cam.yaw);
  let x1=cy*x+sy*z, z1=-sy*x+cy*z;
  const cp=Math.cos(cam.pitch), sp=Math.sin(cam.pitch);
  let y2=cp*y+sp*z1, z2=-sp*y+cp*z1;
  z2+=cam.dist;
  if(z2<0.05)return null;
  const f=0.9*Math.min(W,H);
  return [W/2+f*x1/z2+cam.tx, H/2+f*y2/z2+cam.ty, z2];
}
function heatColor(t){ // blue->red, like the reference's heat lines
  const r=Math.round(255*Math.min(1,2*t)),
        b=Math.round(255*Math.min(1,2*(1-t)));
  return `rgb(${r},${Math.round(64*(1-Math.abs(2*t-1)))+30},${b})`;
}
function draw(){
  ctx.fillStyle='#16181d';ctx.fillRect(0,0,W,H);
  SCENE.layers.forEach((L,i)=>{
    if(!vis[i])return;
    if(L.kind==='points'){
      ctx.fillStyle=L.color; const s=L.size||1.5;
      for(const p of L.pts){const q=project(p);
        if(q)ctx.fillRect(q[0]-s/2,q[1]-s/2,s,s);}
    }else{
      ctx.lineWidth=L.width||1.0;
      L.segs.forEach((seg,k)=>{
        const a=project(seg[0]), b=project(seg[1]);
        if(!a||!b)return;
        ctx.strokeStyle = L.heat?heatColor(L.heat[k]):L.color;
        ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);
        ctx.stroke();
      });
    }
  });
  hud();
}
function hud(){
  const el=document.getElementById('hud');
  el.innerHTML='<b>'+SCENE.title+'</b><br>'+SCENE.layers.map((L,i)=>{
    const c=L.color||'#888';
    const cnt=L.kind==='points'?L.pts.length+' pts':L.segs.length+' lines';
    return `<span class="${vis[i]?'':'off'}"><span class="sw" `+
      `style="background:${c}"></span>${i+1} ${L.name} (${cnt})</span>`;
  }).join('<br>');
}
let drag=null;
cv.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,
  shift:e.shiftKey};});
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{
  if(!drag)return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
  if(drag.shift){cam.tx+=dx;cam.ty+=dy;}
  else{cam.yaw+=dx*0.008;
       cam.pitch=Math.max(-1.55,Math.min(1.55,cam.pitch+dy*0.008));}
  drag={x:e.clientX,y:e.clientY,shift:drag.shift};draw();
});
cv.addEventListener('wheel',e=>{e.preventDefault();
  cam.dist*=Math.exp(e.deltaY*0.001);draw();},{passive:false});
addEventListener('keydown',e=>{
  if(e.key==='r'||e.key==='R'){cam={...HOME};draw();}
  const k=parseInt(e.key);
  if(k>=1&&k<=SCENE.layers.length){vis[k-1]=!vis[k-1];draw();}
});
draw();
</script></body></html>
"""

_TEMPLATE = _TEMPLATE.replace("__TITLE__", "sdflabel_tpu 3D scene")
