"""Web robot-builder editor: an HTML shell over RobotBuilderEnvironment.

Port copy of ``evomotion_tpu/builder/web_editor.py`` (no JAX): the editor
API, page and server are the JAX package's; the infer tab builds the port's
env and agent on ``device`` (default ``cuda``: the env's per-env physics
step runs the fat-row sweep) and steps them with the port's
``viewer.live.LiveSession``. Keep the two in step
(tests/test_torch_web_editor.py holds their replies equal).

Reference counterpart: the ImGui application + builder windows
(src/gui/application.cpp:14-331, src/gui/widget/opengl_window.cpp:155-224,
src/gui/widget/** ~1.5k LoC): member list, new/duplicate/settings windows,
construct-tools translate gizmo, mouse ray picking with focus highlight
(gui/context.{h,cpp} ItemFocusContext), robot save/load via the file menu.
TPU-native reframing: the editor is one self-contained HTML page (same
zero-dependency software renderer family as viewer/html_viewer.py) served
next to a JSON API over the EXISTING RobotBuilderEnvironment — every edit
(add/clone/remove/update/rename, constraints, muscles, save/load) calls the
same methods the programmatic API exposes, and picking uses the
environment's own ray_cast_member / ray_cast_constraint
(robot_builder/environment.cpp:449-518).

Interaction map (reference -> here):
- BuilderOpenGlWindow mouse ray picking  -> canvas click -> POST /api
  {"op": "ray_cast_member"} with the camera ray; hit member gets the focus
  highlight color
- construct-tools translate gizmo        -> drag with "g" held: moves the
  selected member in the camera plane (children follow via the server's
  BFS propagation in update_member)
- member settings window                 -> side-panel numeric fields ->
  update_member
- File > save/load robot                 -> /api save_robot / load_robot
  (bit-exact JSON codec, round-trip tested)
"""

from __future__ import annotations

import json
import os
import threading
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

import numpy as np


def _confine_path(path: str, workspace: str) -> str:
    """Resolve `path` inside `workspace` and refuse escapes.

    The editor HTTP API takes filesystem paths from the page; without
    confinement any web page the user visits could blind-POST to the local
    server (CSRF/DNS rebinding) and read/write arbitrary files. Relative
    paths are taken relative to the workspace; absolute paths must resolve
    inside it."""
    root = os.path.realpath(workspace)
    resolved = os.path.realpath(
        path if os.path.isabs(path) else os.path.join(root, path)
    )
    if resolved != root and not resolved.startswith(root + os.sep):
        raise ValueError(
            f"path {path!r} escapes the editor workspace {root!r}"
        )
    return resolved


def _shape_meshes() -> dict:
    """Unit hull triangle meshes per shape kind (client applies
    scale/rotation/translation)."""
    from scipy.spatial import ConvexHull

    from ..physics.shapes import CUBE, CYLINDER, FEET, SPHERE, get_shape

    out = {}
    for kind in (CUBE, SPHERE, CYLINDER, FEET):
        pts = np.asarray(get_shape(kind).hull_verts, np.float64)
        hull = ConvexHull(pts, qhull_options="QJ")
        tris = []
        for simplex, eq in zip(hull.simplices, hull.equations):
            a, b, c = pts[simplex]
            if np.dot(np.cross(b - a, c - a), eq[:3]) < 0:
                simplex = simplex[::-1]
            tris.append([int(x) for x in simplex])
        out[kind] = {"verts": np.round(pts, 5).tolist(), "tris": tris}
    return out


def editor_state(b) -> dict:
    """Full robot description for the page (mirrors what the ImGui windows
    display: member list + transforms, constraints, muscles, root)."""

    def v(x):
        return np.round(np.asarray(x, float), 6).tolist()

    from ..physics.model import _quat_to_mat3

    def world_point(member_name, local):
        m = b._member(member_name)
        return (
            _quat_to_mat3(np.asarray(m.rotation, float))
            @ np.asarray(local, float)
            + np.asarray(m.translation, float)
        )

    cons = []
    for c in b.constraints:
        kind = b.get_constraint_type(c.name)
        info = {
            "name": c.name, "type": kind,
            "parent": c.parent_name, "child": c.child_name,
        }
        # world-space joint marker (the reference renders each constraint as
        # a NoBodyItem empty item at its frame, constraint.cpp get_empty_item)
        if kind == "hinge":
            info["pivot"] = v(world_point(c.parent_name, c.pivot_in_parent))
            rp = _quat_to_mat3(np.asarray(b._member(c.parent_name).rotation, float))
            info["axis"] = v(rp @ np.asarray(c.axis_in_parent, float))
        else:
            info["pivot"] = v(world_point(c.parent_name, c.frame_in_parent_pos))
        cons.append(info)
    return {
        "robot_name": b.get_robot_name(),
        "root": b.get_root_name(),
        "members": [
            {
                "name": m.name, "shape": m.shape, "pos": v(m.translation),
                "rot": v(m.rotation), "scale": v(m.scale),
                "mass": round(float(m.mass), 6),
                "friction": round(float(m.friction), 6),
                "ignore_collision": bool(m.ignore_collision),
            }
            for m in b.members
        ],
        "constraints": cons,
        "muscles": [
            {
                "name": m.name, "a": m.item_a, "b": m.item_b,
                "pa": v(world_point(m.item_a, m.pos_in_a)),
                "pb": v(world_point(m.item_b, m.pos_in_b)),
            }
            for m in b.muscles
        ],
    }


def apply_op(b, req: dict, workspace: str | None = None, device=None) -> dict:
    """Dispatch one editor operation onto the builder environment.

    `workspace` (set by the HTTP server; None for programmatic use) confines
    save_robot/load_robot paths to one directory; `device` is where the
    infer tab's env and agent run (default ``cuda``)."""
    op = req.get("op")
    a = req.get("args", {})
    if op == "ray_cast_member":
        hit = b.ray_cast_member(a["from"], a["to"])
        return {"ok": True, "hit": hit}
    if op == "ray_cast_constraint":
        hit = b.ray_cast_constraint(a["from"], a["to"])
        return {"ok": True, "hit": hit}
    if op == "add_member":
        ok = b.add_member(
            a["name"], a.get("shape", "cube"), a.get("pos", (0, 0, 0)),
            a.get("rot", (0, 0, 0, 1)), a.get("scale", (0.1, 0.1, 0.1)),
            a.get("mass", 1.0), a.get("friction", 0.5),
        )
        return {"ok": bool(ok)}
    if op == "update_member":
        ok = b.update_member(
            a["name"], new_pos=a.get("pos"), new_rot=a.get("rot"),
            new_scale=a.get("scale"), new_friction=a.get("friction"),
            new_mass=a.get("mass"),
            new_ignore_collision=a.get("ignore_collision"),
        )
        return {"ok": bool(ok)}
    if op == "clone":
        ok = b.clone_body_part(
            a["name"], a.get("prefix", "copy"), a.get("pos", (0, 0, 0)),
            a.get("rot", (0, 0, 0, 1)),
        )
        return {"ok": bool(ok)}
    if op == "rename_member":
        return {"ok": bool(b.rename_member(a["name"], a["new_name"]))}
    if op == "remove_member":
        return {"ok": bool(b.remove_member(a["name"]))}
    if op == "set_root":
        return {"ok": bool(b.set_root(a["name"]))}
    if op == "attach_hinge":
        ok = b.attach_hinge_constraint(
            a["name"], a["parent"], a["child"], a["pivot"], a["axis"],
            a.get("limit_min", 1.0), a.get("limit_max", -1.0),
        )
        return {"ok": bool(ok)}
    if op == "attach_fixed":
        ok = b.attach_fixed_constraint(
            a["name"], a["parent"], a["child"], a["pos"], a.get("rot", (0, 0, 0, 1))
        )
        return {"ok": bool(ok)}
    if op == "remove_constraint":
        return {"ok": bool(b.remove_constraint(a["name"]))}
    if op == "add_muscle":
        ok = b.add_muscle(
            a["name"], a["a"], a["b"], a.get("insert_a", (0, 0, 0)),
            a.get("insert_b", (0, 0, 0)),
        )
        return {"ok": bool(ok)}
    if op == "remove_muscle":
        return {"ok": bool(b.remove_muscle(a["name"]))}
    if op == "infer_start":
        return _infer_start(b, a, workspace, device)
    if op == "infer_state":
        sess = _INFER.get("session")
        if sess is None:
            return {"ok": False, "error": "no infer session"}
        out = sess.advance()
        out.update(ok=True, names=_INFER["names"], bodies=_INFER["bodies"])
        return out
    if op == "infer_stop":
        _INFER["session"] = None
        return {"ok": True}
    if op == "save_robot":
        path = _confine_path(a["path"], workspace) if workspace else a["path"]
        b.save_robot(path)
        return {"ok": True, "path": path}
    if op == "load_robot":
        path = _confine_path(a["path"], workspace) if workspace else a["path"]
        b.load_robot(path)
        return {"ok": True}
    return {"ok": False, "error": f"unknown op {op}"}


def _is_local_host_value(value: str | None) -> bool:
    """True iff a Host/Origin header names this local server.

    Rejecting foreign Host values defends against DNS rebinding; rejecting
    foreign Origins defends against CSRF from web pages the user visits
    while `cli gui` is running."""
    if not value:
        return False
    host = value.split("://", 1)[-1]  # Origin carries a scheme, Host doesn't
    if host.startswith("["):
        hostname = host.split("]", 1)[0] + "]"
    elif ":" in host:
        hostname = host.rsplit(":", 1)[0]
    else:
        hostname = host
    return hostname in ("localhost", "127.0.0.1", "[::1]")


# live infer session state (one per process, like the reference's one
# InferOpenGlWindow tab per "Start inference" click)
_INFER: dict = {"session": None, "names": [], "bodies": []}


def _infer_start(b, a: dict, workspace: str | None, device=None) -> dict:
    """Load an agent checkpoint and step the current robot live.

    The web analog of InferSettingsWindow -> InferOpenGlWindow
    (src/gui/widget/infer/infer_settings.cpp:54-70, opengl_window.cpp:227-241):
    robot JSON + agent checkpoint dir -> a robot_walk env stepped by the
    loaded agent once per client poll. Like the reference — which hardcodes
    CrossQAgent(256, 1024, 128, 1, 3e-4, 0.99, 1, 2) — the agent family and
    architecture default to that CrossQ config, overridable via args. The
    env and agent run on ``device`` (default ``cuda``)."""
    import os as _os
    import tempfile

    from ..agents.factory import get_agent_factory
    from ..device import resolve
    from ..envs.registry import get_environment_factory
    from ..viewer.live import LiveSession

    agent_dir = a["agent_dir"]
    if workspace:
        agent_dir = _confine_path(agent_dir, workspace)
    robot_path = a.get("robot_path")
    if robot_path:
        if workspace:
            robot_path = _confine_path(robot_path, workspace)
    else:
        # infer on the robot currently in the editor
        fd, robot_path = tempfile.mkstemp(suffix=".json", prefix="infer_robot_")
        _os.close(fd)
        b.save_robot(robot_path)

    dev = resolve(device)
    env_name = a.get("env", "robot_walk")
    env_params = dict(a.get("env_params", {}))
    env_params.setdefault("skeleton_json_path", robot_path)
    env = get_environment_factory(env_name, env_params).make(
        int(a.get("seed", 1234)), mt_parity=False, device=dev
    )
    agent_name = a.get("agent", "cross_q")
    agent_params = {
        "seed": "12345", "actor_hidden_size": "256",
        "critic_hidden_size": "1024", "batch_size": "128", "epoch": "1",
        "learning_rate": "3e-4", "gamma": "0.99", "replay_buffer_size": "1",
        "train_every": "2", "tau": "0.005",
        **{k: str(v) for k, v in a.get("agent_params", {}).items()},
    }
    agent = get_agent_factory(agent_name, agent_params).create_agent(
        env.observation_size, env.action_size, device=dev
    )
    agent.load(agent_dir)
    agent.set_eval(True)
    _INFER["session"] = LiveSession(env, agent, int(a.get("seed", 1234)))
    # member-name -> body-index map so the client can pose the meshes
    names, bodies = [], []
    for name in (m.name for m in b.members):
        if name in env.model.body_names:
            names.append(name)
            bodies.append(env.model.body_names.index(name))
    _INFER["names"], _INFER["bodies"] = names, bodies
    return {"ok": True, "obs_dim": env.observation_size,
            "action_dim": env.action_size, "names": names, "bodies": bodies}


def serve_editor(builder, port: int = 8801, max_requests: int | None = None,
                 workspace: str | None = None, device=None):
    """Serve the editor at http://localhost:<port>/ (blocking).

    max_requests bounds the single-threaded test path (same pattern as
    viewer/live.py serve_live after the round-2 deadlock fix). Save/load
    paths from the page are confined to `workspace` (default: the current
    directory); the shared builder is mutated under one lock so concurrent
    request threads serialize. The infer tab runs on ``device``."""
    page = editor_html()
    served = {"n": 0}
    ws = os.path.realpath(workspace or os.getcwd())
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reject_foreign(self) -> bool:
            """403 unless Host (and Origin, if present) are localhost."""
            if not _is_local_host_value(self.headers.get("Host")):
                self._send(b'{"ok": false, "error": "foreign Host"}',
                           "application/json", 403)
                return True
            origin = self.headers.get("Origin")
            if origin is not None and not _is_local_host_value(origin):
                self._send(b'{"ok": false, "error": "foreign Origin"}',
                           "application/json", 403)
                return True
            return False

        def do_GET(self):
            served["n"] += 1
            if self._reject_foreign():
                return
            if self.path == "/robot":
                with lock:
                    state = editor_state(builder)
                state["meshes"] = _shape_meshes()
                self._send(json.dumps(state).encode(), "application/json")
            else:
                self._send(page.encode(), "text/html")

        def do_POST(self):
            served["n"] += 1
            if self._reject_foreign():
                return
            n = int(self.headers.get("Content-Length", "0"))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                with lock:
                    out = apply_op(builder, req, workspace=ws, device=device)
            except Exception as e:  # surface builder errors to the page
                out = {"ok": False, "error": f"{e}", "trace": traceback.format_exc()}
            self._send(json.dumps(out).encode(), "application/json")

        def log_message(self, *a):
            pass

    if max_requests is None:
        server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        print(f"robot builder: http://localhost:{port}/ (ctrl-c to stop)")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    else:
        class BoundedServer(HTTPServer):
            timed_out = False

            def handle_timeout(self):
                self.timed_out = True

        server = BoundedServer(("127.0.0.1", port), Handler)
        server.timeout = 30.0
        while served["n"] < max_requests:
            server.timed_out = False
            server.handle_request()
            if server.timed_out:
                break  # no request arrived in time: client went away
    server.server_close()
    return served["n"]


_EDITOR_JS = r"""
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const W = cv.width, H = cv.height, FOCAL = 1.1*H;
let ROBOT = null, MESHES = null, selected = null;
let cam = {yaw: 0.7, pitch: 0.45, dist: 4.0, target: [0, 0.3, 0]};
function camPos(){
  const cp = Math.cos(cam.pitch), sp = Math.sin(cam.pitch);
  const cy = Math.cos(cam.yaw), sy = Math.sin(cam.yaw);
  return add3(cam.target, mul3([cp*cy, sp, cp*sy], cam.dist));
}
function mkView(){ lookAt(camPos(), cam.target, [0,1,0]); }
function pixelRay(px, py){
  // inverse of project(): world-space ray through the pixel
  const dir = norm(add3(add3(mul3(view.s,(px-W/2)/FOCAL), mul3(view.u,-(py-H/2)/FOCAL)), view.f));
  return {from: view.p, to: add3(view.p, mul3(dir, 100.0))};
}
function memberColor(name){
  let h = 0;
  for (const ch of name) h = (h*31 + ch.charCodeAt(0)) % 9973;
  return [0.35+0.5*((h%7)/7), 0.35+0.5*(((h/7|0)%7)/7), 0.35+0.5*(((h/49|0)%7)/7)];
}
function drawGrid(tris){
  const N=8;
  for(let i=-N;i<N;i++) for(let j=-N;j<N;j++){
    const col = ((i+j)&1) ? [46,50,62] : [36,40,50];
    const quad=[[i,0,j],[i+1,0,j],[i+1,0,j+1],[i,0,j+1]].map(project);
    if(quad.some(q=>q===null)) continue;
    tris.push({z:(quad[0][2]+quad[2][2])/2+1e3, pts:quad,
               col:`rgb(${col[0]},${col[1]},${col[2]})`});
  }
}
// CubeGrid backdrop (reference drawables/cube_grid.cpp): sparse 3D lattice
// of markers above the ground plane as a spatial depth cue
function drawCubeGrid(){
  ctx.fillStyle = 'rgba(110,125,160,0.25)';
  for(let x=-4;x<=4;x+=2) for(let y=1;y<=3;y+=1) for(let z=-4;z<=4;z+=2){
    const p = project([x,y,z]);
    if(!p) continue;
    const s = Math.max(1, 4/p[2]*3);
    ctx.fillRect(p[0]-s/2, p[1]-s/2, s, s);
  }
}
// --- gizmos (reference NoShapeItem kinds, item.cpp:100-160):
// BASIS_AXIS translate arrows + ROTATION_TORUS rings on the selection ---
const AXCOL = ['#e05555','#55c060','#5878e0'];  // x, y, z
function axisDirs(m){
  return [qrot(m.rot,[1,0,0]), qrot(m.rot,[0,1,0]), qrot(m.rot,[0,0,1])];
}
let gizmoHits = [];  // screen-space handles: {kind:'axis'|'ring', axis, x, y}
function drawGizmos(){
  gizmoHits = [];
  if (!selected) return;
  const m = ROBOT.members.find(x=>x.name===selected);
  if (!m) return;
  const L = 1.6*Math.max(m.scale[0], m.scale[1], m.scale[2]);
  const dirs = axisDirs(m);
  const c0 = project(m.pos);
  if (!c0) return;
  for (let a=0;a<3;a++){
    // BASIS_AXIS arrow
    const tip = project(add3(m.pos, mul3(dirs[a], L)));
    if (tip){
      ctx.strokeStyle = AXCOL[a]; ctx.lineWidth = 2.5;
      ctx.beginPath(); ctx.moveTo(c0[0],c0[1]); ctx.lineTo(tip[0],tip[1]); ctx.stroke();
      ctx.fillStyle = AXCOL[a];
      ctx.beginPath(); ctx.arc(tip[0],tip[1],5,0,7); ctx.fill();
      gizmoHits.push({kind:'axis', axis:a, x:tip[0], y:tip[1]});
    }
    // ROTATION_TORUS ring: circle around axis a through the two other dirs
    const u = dirs[(a+1)%3], v = dirs[(a+2)%3], R = L*0.8;
    ctx.strokeStyle = AXCOL[a]; ctx.lineWidth = 1.2;
    ctx.beginPath();
    let started=false, handle=null;
    for(let t=0;t<=24;t++){
      const th = t/24*2*Math.PI;
      const p = project(add3(m.pos, add3(mul3(u,R*Math.cos(th)), mul3(v,R*Math.sin(th)))));
      if(!p){started=false;continue;}
      if(!started){ctx.moveTo(p[0],p[1]);started=true;} else ctx.lineTo(p[0],p[1]);
      if(t===6) handle=p;
    }
    ctx.stroke();
    if (handle){
      ctx.fillStyle = AXCOL[a];
      ctx.fillRect(handle[0]-4, handle[1]-4, 8, 8);
      gizmoHits.push({kind:'ring', axis:a, x:handle[0], y:handle[1]});
    }
  }
}
function hitGizmo(px, py){
  for (const g of gizmoHits)
    if (Math.hypot(px-g.x, py-g.y) < 10) return g;
  return null;
}
// joint markers (reference NoBodyItem empties at constraint frames) and
// muscle attachment lines
let markerHits = [];
function drawJointMarkers(){
  markerHits = [];
  if (!ROBOT) return;
  for (const mu of ROBOT.muscles){
    const a = project(mu.pa), b = project(mu.pb);
    if (!a || !b) continue;
    ctx.strokeStyle = 'rgba(230,160,90,0.8)'; ctx.lineWidth = 1.5;
    ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke();
  }
  for (const c of ROBOT.constraints){
    if (!c.pivot) continue;
    const p = project(c.pivot);
    if (!p) continue;
    ctx.strokeStyle = c.type === 'hinge' ? '#7fd0ff' : '#d0a0ff';
    ctx.lineWidth = 1.5;
    ctx.beginPath();
    ctx.moveTo(p[0], p[1]-5); ctx.lineTo(p[0]+5, p[1]);
    ctx.lineTo(p[0], p[1]+5); ctx.lineTo(p[0]-5, p[1]);
    ctx.closePath(); ctx.stroke();
    if (c.axis){
      const tip = project(add3(c.pivot, mul3(norm(c.axis), 0.25)));
      if (tip){ ctx.beginPath(); ctx.moveTo(p[0],p[1]);
                ctx.lineTo(tip[0],tip[1]); ctx.stroke(); }
    }
    markerHits.push({name: c.name, type: c.type,
                     parent: c.parent, child: c.child, x: p[0], y: p[1]});
  }
}
function hitMarker(px, py){
  for (const m of markerHits)
    if (Math.hypot(px-m.x, py-m.y) < 8) return m;
  return null;
}
function draw(){
  mkView();
  ctx.fillStyle = '#10141c'; ctx.fillRect(0,0,W,H);
  if (!ROBOT) return;
  const tris = [];
  drawGrid(tris);
  for (const m of ROBOT.members){
    const mesh = MESHES[m.shape];
    const wv = mesh.verts.map(v=>{
      const sv = [v[0]*m.scale[0], v[1]*m.scale[1], v[2]*m.scale[2]];
      return add3(qrot(m.rot, sv), m.pos);
    });
    emitMesh(tris, wv, mesh.tris, memberColor(m.name), m.name === selected);
  }
  paint(tris);
  drawCubeGrid();
  drawJointMarkers();
  drawGizmos();
  ctx.fillStyle='#9ab'; ctx.font='13px monospace';
  ctx.fillText(`${ROBOT.robot_name}  members:${ROBOT.members.length} `+
    `constraints:${ROBOT.constraints.length} muscles:${ROBOT.muscles.length}` +
    (selected ? `  [${selected}] (drag+g moves it)` : '  (click a member to select)'), 12, 20);
}
async function api(op, args){
  const r = await fetch('/api', {method:'POST', body: JSON.stringify({op: op, args: args||{}})});
  const out = await r.json();
  if (!out.ok && out.error) setMsg('error: ' + out.error);
  return out;
}
async function refresh(){
  const r = await fetch('/robot');
  const s = await r.json();
  MESHES = s.meshes; ROBOT = s;
  renderPanel(); draw();
}
function setMsg(t){ document.getElementById('msg').textContent = t; }
function renderPanel(){
  const ul = document.getElementById('members');
  ul.innerHTML = '';
  for (const m of ROBOT.members){
    const li = document.createElement('li');
    li.textContent = (m.name === ROBOT.root ? '* ' : '') + m.name;
    li.style.cursor = 'pointer';
    if (m.name === selected) li.style.color = '#fc6';
    li.onclick = ()=>{ select(m.name); };
    ul.appendChild(li);
  }
  const f = document.getElementById('fields');
  if (!selected) { f.style.display = 'none'; return; }
  const m = ROBOT.members.find(x=>x.name===selected);
  if (!m) { selected = null; f.style.display = 'none'; return; }
  f.style.display = 'block';
  for (const [id, val] of [['f_pos', m.pos], ['f_scale', m.scale],
                           ['f_mass', [m.mass]], ['f_fric', [m.friction]]])
    document.getElementById(id).value = val.map(x=>+x.toFixed(4)).join(', ');
}
function select(name){ selected = name; renderPanel(); draw(); }
async function applyFields(){
  const g = id=>document.getElementById(id).value.split(',').map(Number);
  await api('update_member', {name: selected, pos: g('f_pos'), scale: g('f_scale'),
                              mass: g('f_mass')[0], friction: g('f_fric')[0]});
  await refresh();
}
// --- mouse: orbit / pick / grab-move ---
let drag = null, gKey = false;
document.addEventListener('keydown', e=>{ if(e.key==='g') gKey = true; });
document.addEventListener('keyup', e=>{ if(e.key==='g') gKey = false; });
cv.addEventListener('mousedown', e=>{
  const g = selected ? hitGizmo(e.offsetX, e.offsetY) : null;
  drag = {x: e.offsetX, y: e.offsetY, moved: false, gizmo: g,
          grab: !g && gKey && selected ? true : false};
});
cv.addEventListener('mousemove', async e=>{
  if (!drag) return;
  const dx = e.offsetX - drag.x, dy = e.offsetY - drag.y;
  if (Math.abs(dx)+Math.abs(dy) > 2) drag.moved = true;
  if (drag.gizmo && selected){
    const m = ROBOT.members.find(x=>x.name===selected);
    const d3 = axisDirs(m)[drag.gizmo.axis];
    if (drag.gizmo.kind === 'axis'){
      // translate along the arrow's world axis (construct-tools translate)
      const p0 = project(m.pos), p1 = project(add3(m.pos, d3));
      if (p0 && p1){
        const sx = p1[0]-p0[0], sy = p1[1]-p0[1];
        const t = (dx*sx + dy*sy) / Math.max(sx*sx + sy*sy, 1e-6);
        m.pos = add3(m.pos, mul3(d3, t));
        drag.pendingPos = m.pos;
      }
    } else {
      // rotate about the ring's axis (construct-tools rotate)
      const ang = (dx - dy) * 0.01;
      m.rot = qmul(axisAngleQuat(d3, ang), m.rot);
      drag.pendingRot = m.rot;
    }
    drag.x = e.offsetX; drag.y = e.offsetY;
    draw();
  } else if (drag.grab && selected){
    const m = ROBOT.members.find(x=>x.name===selected);
    const z = dot(sub(m.pos, view.p), view.f);
    const dw = add3(mul3(view.s, dx*z/FOCAL), mul3(view.u, -dy*z/FOCAL));
    m.pos = add3(m.pos, dw);  // optimistic; server applies on mouseup
    drag.x = e.offsetX; drag.y = e.offsetY; drag.pendingPos = m.pos;
    draw();
  } else {
    cam.yaw += dx*0.008; cam.pitch = Math.min(1.4, Math.max(-1.4, cam.pitch + dy*0.008));
    drag.x = e.offsetX; drag.y = e.offsetY;
    draw();
  }
});
cv.addEventListener('mouseup', async e=>{
  const d = drag; drag = null;
  if (!d) return;
  if (d.pendingPos || d.pendingRot){
    const args = {name: selected};
    if (d.pendingPos) args.pos = d.pendingPos;
    if (d.pendingRot) args.rot = d.pendingRot;
    await api('update_member', args);
    await refresh();  // children followed via server-side BFS
  } else if (!d.moved){
    const mk = hitMarker(e.offsetX, e.offsetY);
    if (mk){  // constraint focus (BuilderOpenGlWindow constraint popups)
      setMsg(`${mk.type} "${mk.name}": ${mk.parent} -> ${mk.child}`);
      return;
    }
    mkView();
    const ray = pixelRay(e.offsetX, e.offsetY);
    const out = await api('ray_cast_member', {from: ray.from, to: ray.to});
    select(out.hit);
  }
});
cv.addEventListener('wheel', e=>{
  cam.dist = Math.min(30, Math.max(0.5, cam.dist * (e.deltaY > 0 ? 1.1 : 0.9)));
  e.preventDefault(); draw();
});
// --- toolbar ---
async function addMember(){
  const name = prompt('member name'); if (!name) return;
  await api('add_member', {name: name, pos: [0, 0.5, 0], scale: [0.1,0.1,0.1]});
  await refresh(); select(name);
}
async function cloneSel(){
  if (!selected) return setMsg('select a member first');
  const m = ROBOT.members.find(x=>x.name===selected);
  await api('clone', {name: selected, prefix: 'copy',
                      pos: add3(m.pos, [0.5,0,0]), rot: m.rot});
  await refresh();
}
async function removeSel(){
  if (!selected) return setMsg('select a member first');
  await api('remove_member', {name: selected}); selected = null;
  await refresh();
}
async function setRootSel(){
  if (!selected) return setMsg('select a member first');
  await api('set_root', {name: selected}); await refresh();
}
async function saveRobot(){
  const p = document.getElementById('path').value;
  const out = await api('save_robot', {path: p});
  if (out.ok) setMsg('saved to ' + out.path);
}
async function loadRobot(){
  const p = document.getElementById('path').value;
  const out = await api('load_robot', {path: p});
  if (out.ok) { setMsg('loaded ' + p); selected = null; await refresh(); }
}
// --- infer tab (reference InferSettingsWindow -> InferOpenGlWindow:
// load robot + agent checkpoint, watch it act; one env step per poll) ---
let inferTimer = null, inferMap = null, basePoses = null;
async function inferStart(){
  if (inferTimer) return setMsg('infer already running');
  const dir = document.getElementById('agent_dir').value;
  const out = await api('infer_start', {agent_dir: dir});
  if (!out.ok) return;
  inferMap = {names: out.names, bodies: out.bodies};
  basePoses = ROBOT.members.map(m=>({name: m.name, pos: m.pos.slice(), rot: m.rot.slice()}));
  inferTimer = setInterval(inferPoll, 33);
  setMsg('infer running');
}
let inferBusy = false;
async function inferPoll(){
  if (inferBusy) return;  // env steps once per *served* poll; don't pile up
  inferBusy = true;
  try {
    const out = await api('infer_state', {});
    if (!out.ok){ await inferStop(); return; }
    for (let i = 0; i < inferMap.names.length; i++){
      const m = ROBOT.members.find(x=>x.name===inferMap.names[i]);
      if (!m) continue;
      const b = inferMap.bodies[i];
      m.pos = out.pos[b]; m.rot = out.quat[b];
    }
    draw();
    setMsg(`infer step ${out.step} ep ${out.episode} r ${out.reward.toFixed(3)}`);
  } finally { inferBusy = false; }
}
async function inferStop(){
  if (inferTimer){ clearInterval(inferTimer); inferTimer = null; }
  await api('infer_stop', {});
  if (basePoses){
    for (const p of basePoses){
      const m = ROBOT.members.find(x=>x.name===p.name);
      if (m){ m.pos = p.pos; m.rot = p.rot; }
    }
    basePoses = null;
  }
  draw(); setMsg('infer stopped');
}
refresh();
"""


def editor_html() -> str:
    from ..viewer.js_core import JS_CORE

    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>evomotion robot builder</title>
<style>
body{{margin:0;background:#10141c;color:#cdd3df;font:13px monospace;display:flex}}
#panel{{width:260px;padding:10px;overflow-y:auto;height:100vh;box-sizing:border-box}}
#members{{list-style:none;padding-left:6px;max-height:30vh;overflow-y:auto}}
button{{margin:2px;background:#273049;color:#cdd3df;border:1px solid #3a4663;
        padding:3px 8px;cursor:pointer}}
input{{width:95%;background:#1a2030;color:#cdd3df;border:1px solid #3a4663;margin:2px 0}}
#msg{{color:#fc6;min-height:16px}}
</style></head><body>
<div id="panel">
  <h3>robot builder</h3>
  <div>
    <button onclick="addMember()">add</button>
    <button onclick="cloneSel()">clone</button>
    <button onclick="removeSel()">remove</button>
    <button onclick="setRootSel()">set root</button>
  </div>
  <ul id="members"></ul>
  <div id="fields" style="display:none">
    <div>pos <input id="f_pos"></div>
    <div>scale <input id="f_scale"></div>
    <div>mass <input id="f_mass"></div>
    <div>friction <input id="f_fric"></div>
    <button onclick="applyFields()">apply</button>
  </div>
  <hr>
  <div>robot json path<input id="path" value="robot.json"></div>
  <button onclick="saveRobot()">save</button>
  <button onclick="loadRobot()">load</button>
  <hr>
  <div>infer: agent checkpoint dir<input id="agent_dir" value="save_final"></div>
  <button onclick="inferStart()">start infer</button>
  <button onclick="inferStop()">stop</button>
  <div id="msg"></div>
</div>
<canvas id="cv" width="1024" height="760"></canvas>
<script>
{JS_CORE}
{_EDITOR_JS}
</script></body></html>"""
