"""Shared JS renderer core — the framework's "program/shader layer".

Port copy of ``evomotion_tpu/viewer/js_core.py`` (no JAX): the port keeps
its own copy so that it imports no module of the JAX package; keep the two
in step (tests/test_torch_viewer.py holds their output equal).

Reference counterpart: evo_motion_view's Program/Shader abstraction
(program.cpp, shader.cpp + 8 GLSL files, V4 in SURVEY §2.3): one place that
defines the vector math, the projection, and the specular shading every
drawable uses, consumed by multiple windows. Here the renderer is a
software rasterizer embedded in HTML pages (viewer/html_viewer.py playback
+ live views, builder/web_editor.py editor), and this module is the single
shared "program": pages embed JS_CORE and register their own camera +
frame sources on top, exactly like the reference's windows share one
compiled program object with per-drawable uniforms.

The render-to-texture path (V5 FrameBuffer) maps to the offline renderer
viewer/render3d.py, which rasterizes the same scene description into image
buffers (PNG/GIF) instead of a canvas.
"""

JS_CORE = r"""
// --- vec3 / quat math (the "shader library") ---
function sub(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function add3(a,b){return [a[0]+b[0],a[1]+b[1],a[2]+b[2]];}
function mul3(a,s){return [a[0]*s,a[1]*s,a[2]*s];}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function dot(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm(a){const l=Math.hypot(a[0],a[1],a[2])||1e-9;return [a[0]/l,a[1]/l,a[2]/l];}
function qrot(q,v){ // xyzw
  const u=[q[0],q[1],q[2]], w=q[3];
  const t=cross(u,v).map(x=>2*x);
  return [v[0]+w*t[0]+cross(u,t)[0], v[1]+w*t[1]+cross(u,t)[1], v[2]+w*t[2]+cross(u,t)[2]];
}
function qmul(a,b){
  return [a[3]*b[0]+a[0]*b[3]+a[1]*b[2]-a[2]*b[1],
          a[3]*b[1]-a[0]*b[2]+a[1]*b[3]+a[2]*b[0],
          a[3]*b[2]+a[0]*b[1]-a[1]*b[0]+a[2]*b[3],
          a[3]*b[3]-a[0]*b[0]-a[1]*b[1]-a[2]*b[2]];
}
function axisAngleQuat(axis, ang){
  const s = Math.sin(ang/2);
  return [axis[0]*s, axis[1]*s, axis[2]*s, Math.cos(ang/2)];
}
// --- view + projection (vertex "shader") ---
let view = null;
function lookAt(pos, look, up){
  const f = norm(sub(look, pos));
  const s = norm(cross(f, up));
  const u = cross(s, f);
  view = {p: pos, s: s, u: u, f: f};
}
function project(v){
  const d = sub(v, view.p);
  const x = dot(d, view.s), y = dot(d, view.u), z = dot(d, view.f);
  if (z < 0.05) return null;
  return [W/2 + FOCAL*x/z, H/2 - FOCAL*y/z, z];
}
// --- specular shading (fragment "shader"; drawables/specular.cpp role) ---
const LIGHT = norm([0.4, 1.0, 0.6]);
function shade(base, n, vdir){
  const diff = Math.max(dot(n, LIGHT), 0.0);
  const h = norm(sub(LIGHT, vdir));
  const spec = Math.pow(Math.max(dot(n,h),0), 16)*0.5;
  return base.map(c=>Math.min(255, Math.round(255*(0.25*c + 0.75*c*diff) + 255*spec)));
}
// --- painter's rasterizer (the draw call) ---
function paint(tris){
  tris.sort((p,q)=>q.z-p.z);
  for(const t of tris){
    ctx.beginPath();
    ctx.moveTo(t.pts[0][0], t.pts[0][1]);
    for(let i=1;i<t.pts.length;i++) ctx.lineTo(t.pts[i][0], t.pts[i][1]);
    ctx.closePath(); ctx.fillStyle = t.col; ctx.fill();
  }
}
// shade+emit one convex mesh given world-space verts (a "drawable")
function emitMesh(tris, wv, meshTris, baseColor, focus){
  const pv = wv.map(project);
  for(const t of meshTris){
    const [a,b,c] = t;
    if(!pv[a]||!pv[b]||!pv[c]) continue;
    const n = norm(cross(sub(wv[b],wv[a]), sub(wv[c],wv[a])));
    const ctr = mul3(add3(add3(wv[a],wv[b]),wv[c]), 1/3);
    const vdir = norm(sub(ctr, view.p));
    if (dot(n, vdir) > 0) continue;  // backface
    let col = shade(baseColor, n, vdir);
    if (focus) col = [Math.min(255,col[0]+70), col[1], Math.max(0,col[2]-30)];
    tris.push({z:(pv[a][2]+pv[b][2]+pv[c][2])/3, pts:[pv[a],pv[b],pv[c]],
               col:`rgb(${col[0]},${col[1]},${col[2]})`});
  }
}
"""
