"""The port's web robot-builder editor against the JAX package's.

The editor's operations (``apply_op``) go through both packages on equal
builders: every reply and the editor state after it are equal as JSON
text, and the page, the shape meshes, the path confinement and the
foreign-host check agree. The port's server serves the page and the API on
127.0.0.1, and its infer tab steps a port CrossQ checkpoint on the CPU
(the port's env and agent, the port's LiveSession).
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from evomotion_tpu.builder import web_editor as jw
from evomotion_tpu.builder.builder_env import RobotBuilderEnvironment as JB
from evomotion_tpu_torch.builder import web_editor as tw
from evomotion_tpu_torch.builder.builder_env import RobotBuilderEnvironment as TB
from test_torch_viewer import free_port, wait_listening

SPIDER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "evomotion_tpu_torch", "resources", "skeleton", "spider.json")


def _ops(path, leg_pos):
    return [
        {"op": "update_member", "args": {"name": "body_legA", "pos": leg_pos}},
        {"op": "add_member", "args": {"name": "torso2", "pos": [0, 1, 0],
                                      "scale": [0.3, 0.2, 0.4]}},
        {"op": "clone", "args": {"name": "torso2", "prefix": "c", "pos": [1, 1, 0]}},
        {"op": "ray_cast_member", "args": {"from": [0, 1, -5], "to": [0, 1, 5]}},
        {"op": "ray_cast_constraint", "args": {"from": [0, 3, 0], "to": [0, -3, 0]}},
        {"op": "rename_member", "args": {"name": "c_torso2", "new_name": "torso3"}},
        {"op": "attach_fixed", "args": {"name": "weld", "parent": "torso2",
                                        "child": "torso3", "pos": [0.5, 1, 0]}},
        {"op": "add_muscle", "args": {"name": "m_new", "a": "torso2", "b": "torso3"}},
        {"op": "remove_muscle", "args": {"name": "m_new"}},
        {"op": "remove_constraint", "args": {"name": "weld"}},
        {"op": "remove_member", "args": {"name": "torso3"}},
        {"op": "no_such_op"},
        {"op": "infer_state"},
        {"op": "save_robot", "args": {"path": path}},
        {"op": "load_robot", "args": {"path": path}},
    ]


def test_apply_op_replies_match_jax(tmp_path):
    jb, tb = JB(), TB()
    jb.load_robot(SPIDER)
    tb.load_robot(SPIDER)
    state = tw.editor_state(tb)
    assert json.dumps(state) == json.dumps(jw.editor_state(jb))
    assert len(state["members"]) == 17 and len(state["muscles"]) == 12
    leg = next(m for m in state["members"] if m["name"] == "body_legA")
    ops = _ops("edited.json", [p + d for p, d in zip(leg["pos"], (0.3, 0.1, -0.2))])
    ws_j, ws_t = tmp_path / "jax", tmp_path / "torch"
    ws_j.mkdir()
    ws_t.mkdir()
    for op in ops:
        rj = jw.apply_op(jb, op, workspace=str(ws_j))
        rt = tw.apply_op(tb, op, workspace=str(ws_t), device="cpu")
        if op["op"] == "save_robot":
            assert rj.pop("path") == str(ws_j / "edited.json")
            assert rt.pop("path") == str(ws_t / "edited.json")
        assert json.dumps(rt, sort_keys=True) == json.dumps(rj, sort_keys=True), op
        assert json.dumps(tw.editor_state(tb)) == json.dumps(jw.editor_state(jb)), op
    assert (ws_t / "edited.json").read_text() == (ws_j / "edited.json").read_text()
    # paths from the page stay inside the workspace
    for mod in (jw, tw):
        with pytest.raises(ValueError, match="escapes the editor workspace"):
            mod.apply_op(TB(), {"op": "save_robot", "args": {"path": "../x.json"}},
                         workspace=str(ws_t))


def test_page_meshes_and_host_check_match_jax():
    assert tw.editor_html() == jw.editor_html()
    assert json.dumps(tw._shape_meshes()) == json.dumps(jw._shape_meshes())
    for value in (None, "", "localhost", "localhost:8801", "127.0.0.1:9", "[::1]:80",
                  "http://localhost:8801", "http://evil.example", "evil.example:8801",
                  "127.0.0.1.evil.example", "https://[::1]"):
        assert tw._is_local_host_value(value) == jw._is_local_host_value(value), value
    ws = os.getcwd()
    assert tw._confine_path("a/b.json", ws) == jw._confine_path("a/b.json", ws)


def test_editor_serves_page_and_api():
    b = TB()
    b.load_robot(SPIDER)
    port = free_port()
    t = threading.Thread(target=tw.serve_editor, args=(b, port, 4), daemon=True)
    t.start()
    wait_listening(port)
    base = f"http://127.0.0.1:{port}"
    page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
    assert "robot builder" in page
    robot = json.loads(urllib.request.urlopen(base + "/robot", timeout=10).read())
    assert len(robot["members"]) == 17 and "meshes" in robot
    req = urllib.request.Request(base + "/api", method="POST", data=json.dumps(
        {"op": "update_member", "args": {"name": robot["members"][0]["name"],
                                         "pos": [0.5, 0.5, 0.5]}}).encode())
    assert json.loads(urllib.request.urlopen(req, timeout=10).read())["ok"]
    req = urllib.request.Request(base + "/", headers={"Host": "evil.example"})
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=10)
    assert err.value.code == 403
    t.join(timeout=30)
    assert not t.is_alive()


def test_editor_infer_tab(tmp_path):
    """infer_start with a fresh port CrossQ checkpoint on a tiny robot built
    in the editor, 3 polls of infer_state, infer_stop (tests/test_web_editor.py)."""
    from evomotion_tpu_torch.agents.cross_q import CrossQAgent
    from evomotion_tpu_torch.envs.robot import RobotWalkFactory

    b = TB("bot")
    q = [0.0, 0.0, 0.0, 1.0]
    assert b.add_member("torso", "cube", (0, 0.6, 0), q, (0.4, 0.2, 0.3), 2.0, 0.5)
    assert b.add_member("leg", "cube", (0.5, 0.3, 0), q, (0.08, 0.3, 0.08), 0.5, 0.5)
    assert b.set_root("torso")
    assert b.attach_hinge_constraint("hip", "torso", "leg", (0.45, 0.6, 0.0), (0, 0, 1),
                                     -0.5, 0.5)
    assert b.add_muscle("m0", "torso", "leg", (0.2, 0.0, 0.0), (0.0, 0.2, 0.0))
    robot_json = tmp_path / "tiny.json"
    b.save_robot(str(robot_json))
    env = RobotWalkFactory({"skeleton_json_path": str(robot_json), "reset_frames": "2"}).make(
        1, mt_parity=False, device="cpu")
    agent = CrossQAgent(12345, env.observation_size, env.action_size, 16, 16, 8, 1, 3e-4,
                        0.99, 1, 2, device="cpu")
    ckpt = tmp_path / "save_final"
    ckpt.mkdir()
    agent.save(str(ckpt))
    out = tw.apply_op(b, {"op": "infer_start", "args": {
        "agent_dir": str(ckpt), "env_params": {"reset_frames": "2"},
        "agent_params": {"actor_hidden_size": "16", "critic_hidden_size": "16",
                         "batch_size": "8"},
    }}, workspace=str(tmp_path), device="cpu")
    assert out["ok"], out
    assert out["names"] and len(out["names"]) == len(out["bodies"]) == 2
    poses = []
    for _ in range(3):
        st = tw.apply_op(b, {"op": "infer_state"}, device="cpu")
        assert st["ok"] and not np.isnan(np.asarray(st["pos"])).any()
        poses.append(np.asarray(st["pos"]))
    assert np.abs(poses[0] - poses[-1]).max() > 0
    assert tw.apply_op(b, {"op": "infer_stop"})["ok"]
    assert not tw.apply_op(b, {"op": "infer_state"})["ok"]
