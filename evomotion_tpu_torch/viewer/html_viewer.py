"""Self-contained HTML viewer: recorded-trajectory playback + live policy view.

Port copy of ``evomotion_tpu/viewer/html_viewer.py`` (no JAX): the port keeps
its own copy so that it imports no module of the JAX package; keep the two
in step (tests/test_torch_viewer.py holds their output equal).

Reference counterparts:
- Renderer/drawables (evo_motion_view/src/renderer.cpp:21-119,
  drawables/specular.cpp, drawables/ground.cpp): a GLFW window with Phong
  specular members over a two-color TileGround checkerboard. Here: an
  embedded JavaScript software renderer (canvas 2D, painter-sorted flat-shaded
  hull triangles with a diffuse+specular shade, checkerboard ground) inside a
  single HTML file — no GL context, no external assets (zero-egress friendly).
- FollowCamera (src/camera.cpp:28-58): replicated exactly — smoothing
  `smooth += (center - smooth) * factor * dt` with factor 2, distance 5,
  up_angle pi/2, side_angle 0, up (0,1,0).
- Per-item random colors (drawables/factory.cpp random-color ctor).

Two modes:
- `write_playback_html(npz, out)`: embeds a recorded trajectory
  (viewer/recorder.py .npz) and plays it at 60 FPS with scrubbing.
- live: the same HTML polls /state from viewer/live.py's HTTP server, which
  steps agent+env per frame (InferOpenGlWindow semantics,
  src/gui/widget/opengl_window.cpp:227-241).
"""

from __future__ import annotations

import json

import numpy as np


def _body_meshes(model) -> list[dict]:
    """Triangulated hull meshes per body (local frame)."""
    from scipy.spatial import ConvexHull

    meshes = []
    rng = np.random.default_rng(0)
    for i in range(model.n_bodies):
        pts = model.hull[i][model.hull_mask[i] > 0]
        if len(pts) < 4:
            pts = np.concatenate([pts, pts + 1e-3], 0)
        hull = ConvexHull(pts.astype(np.float64), qhull_options="QJ")
        # orient triangles outward using qhull's plane equations
        tris = []
        for simplex, eq in zip(hull.simplices, hull.equations):
            a, b, c = pts[simplex]
            n = np.cross(b - a, c - a)
            if np.dot(n, eq[:3]) < 0:
                simplex = simplex[::-1]
            tris.append([int(x) for x in simplex])
        # random color per item (factory.cpp random-color constructors)
        col = rng.uniform(0.2, 0.9, 3)
        is_static = model.inv_mass[i] == 0.0
        meshes.append(
            {
                "name": model.body_names[i],
                "verts": np.round(pts, 5).tolist(),
                "tris": tris,
                "color": [round(float(c), 3) for c in col],
                "static": bool(is_static),
            }
        )
    return meshes


_JS = r"""
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const W = cv.width, H = cv.height;
const FOCAL = 1.2*H;
// FollowCamera parity (camera.cpp:28-58)
const cam = {smooth: [0,0,0], factor: 2.0, distance: 5.0,
             upAngle: Math.PI/2, sideAngle: 0.0, init: false};
function camStep(center, dt) {
  if (!cam.init) { cam.smooth = center.slice(); cam.init = true; }
  for (let i=0;i<3;i++) cam.smooth[i] += (center[i]-cam.smooth[i])*cam.factor*dt;
  const pos = [cam.smooth[0]+Math.cos(cam.sideAngle)*cam.distance,
               cam.smooth[1]+Math.sin(cam.upAngle),
               cam.smooth[2]+Math.sin(cam.sideAngle)*cam.distance];
  return {pos: pos, look: cam.smooth, up: [0,1,0]};
}
// TileGround parity (drawables/ground.cpp): two-color checkerboard
function drawGround(tris){
  const S=1, N=14, cy=cam.smooth;
  const x0=Math.floor(cy[0])-N, z0=Math.floor(cy[2])-N;
  for(let i=0;i<2*N;i++) for(let j=0;j<2*N;j++){
    const x=x0+i, z=z0+j;
    const col = ((x+z)&1) ? [200,200,205] : [150,150,158];
    const quad=[[x,GROUND_Y,z],[x+S,GROUND_Y,z],[x+S,GROUND_Y,z+S],[x,GROUND_Y,z+S]];
    const p=quad.map(project);
    if(p.some(q=>q===null)) continue;
    tris.push({z:(p[0][2]+p[2][2])/2+1e3, pts:[p[0],p[1],p[2],p[3]],
               col:`rgb(${col[0]},${col[1]},${col[2]})`});
  }
}
function drawFrame(pos, quat){
  const rootI = ROOT_BODY;
  const c = camStep(pos[rootI], 1/60);
  lookAt(c.pos, c.look, c.up);
  ctx.fillStyle = '#10141c'; ctx.fillRect(0,0,W,H);
  const tris = [];
  drawGround(tris);
  for(let b=0;b<MESHES.length;b++){
    const m = MESHES[b];
    if (m.static) continue;  // ground drawn as checkerboard
    const wv = m.verts.map(v=>add3(qrot(quat[b], v), pos[b]));
    emitMesh(tris, wv, m.tris, m.color, false);
  }
  paint(tris);
  ctx.fillStyle='#9ab'; ctx.font='13px monospace';
  ctx.fillText(STATUS(), 12, 20);
}
"""

_PLAYBACK_JS = r"""
let fi = 0, playing = true;
function STATUS(){ return `frame ${fi+1}/${FRAMES_POS.length}  (space: pause, arrows: scrub)`; }
function tick(){
  drawFrame(FRAMES_POS[fi], FRAMES_QUAT[fi]);
  if (playing) fi = (fi+1) % FRAMES_POS.length;
  requestAnimationFrame(tick);
}
document.addEventListener('keydown', e=>{
  if(e.code==='Space') playing=!playing;
  if(e.code==='ArrowRight') fi=Math.min(fi+1,FRAMES_POS.length-1);
  if(e.code==='ArrowLeft') fi=Math.max(fi-1,0);
});
tick();
"""

_LIVE_JS = r"""
let last = null, info = '';
function STATUS(){ return info; }
async function poll(){
  try {
    const r = await fetch('/state');
    const s = await r.json();
    last = s;
    info = `live  step ${s.step}  reward/step ${s.reward.toFixed(3)}  episode ${s.episode}`;
    drawFrame(s.pos, s.quat);
  } catch (e) { info = 'disconnected'; }
  setTimeout(poll, 1000/60);
}
poll();
"""


def _html(meshes, root_body, ground_y, body_js):
    from .js_core import JS_CORE

    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>evomotion viewer</title>
<style>body{{margin:0;background:#10141c}}canvas{{display:block;margin:0 auto}}</style>
</head><body>
<canvas id="cv" width="1024" height="720"></canvas>
<script>
const MESHES = {json.dumps(meshes)};
const ROOT_BODY = {root_body};
const GROUND_Y = {ground_y};
{JS_CORE}
{_JS}
{body_js}
</script></body></html>"""


def write_playback_html(npz_path: str, out_path: str, model, root_body: int,
                        ground_y: float = -1.5) -> None:
    """Render a recorded .npz trajectory into a self-playing HTML file."""
    data = np.load(npz_path, allow_pickle=True)
    meshes = _body_meshes(model)
    frames = (
        f"const FRAMES_POS = {json.dumps(np.round(data['pos'], 4).tolist())};\n"
        f"const FRAMES_QUAT = {json.dumps(np.round(data['quat'], 5).tolist())};\n"
    )
    with open(out_path, "w") as f:
        f.write(_html(meshes, root_body, ground_y, frames + _PLAYBACK_JS))


def live_html(model, root_body: int, ground_y: float = -1.5) -> str:
    """The live-view page served by viewer/live.py."""
    return _html(_body_meshes(model), root_body, ground_y, _LIVE_JS)
