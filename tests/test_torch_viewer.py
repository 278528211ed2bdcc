"""The port's viewer against the JAX package's (CPU).

The renderer core (``JS_CORE``), the live page and the playback HTML are
equal to JAX's as text for an equal model and the same recording; the
recorder's ``.npz`` has the keys, shapes and dtypes of a JAX recording of
the same model (cartpole stepped in both packages; the spider from shared
states); the live server serves 3 frames of the port's cartpole on
127.0.0.1; render3d and ``render_frames`` (matplotlib) write the same
images as JAX's.
"""

import json
import socket
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import torch

from evomotion_tpu.envs.cartpole import CartPole as JCartPole
from evomotion_tpu.envs.cartpole import CartPoleParams as JParams
from evomotion_tpu.viewer import html_viewer as jh
from evomotion_tpu.viewer import js_core as jjs
from evomotion_tpu.viewer import recorder as jrec
from evomotion_tpu_torch.agents.debug_agents import RandomAgent
from evomotion_tpu_torch.envs.cartpole import CartPole, CartPoleParams
from evomotion_tpu_torch.viewer import html_viewer as th
from evomotion_tpu_torch.viewer import js_core as tjs
from evomotion_tpu_torch.viewer import recorder as trec


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_listening(port, deadline=15.0):
    t0 = time.time()
    while time.time() - t0 < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"server on port {port} never came up")


def get_retry(url, deadline=60.0):
    """GET ``url``, retrying while the server is not up yet (a bare probe
    connection would end the live server's bounded loop)."""
    t0 = time.time()
    while True:
        try:
            return urllib.request.urlopen(url, timeout=60).read()
        except OSError:
            if time.time() - t0 > deadline:
                raise
            time.sleep(0.2)


def _recordings(tmp_path, n=5):
    """The same 5 zero-action cartpole steps recorded in both packages."""
    jenv = JCartPole(JParams(reset_frame_nb=2))
    jr = jrec.TrajectoryRecorder(jenv)
    state, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    step = jax.jit(jenv.step)
    for _ in range(n):
        state, _ = step(state, jnp.zeros((1,)))
        jr.add(state)
    tenv = CartPole(CartPoleParams(reset_frame_nb=2), mt_seed=0, device="cpu")
    tr = trec.TrajectoryRecorder(tenv)
    st, _ = tenv.reset(1)
    for _ in range(n):
        st, _ = tenv.step(st, torch.zeros((1, 1)))
        tr.add(st)
    paths = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jr.save(paths[0])
    tr.save(paths[1])
    return jenv, tenv, paths


def test_js_core_and_live_page_match_jax():
    assert tjs.JS_CORE == jjs.JS_CORE
    jenv, tenv = JCartPole(JParams()), CartPole(CartPoleParams(), device="cpu")
    assert th.live_html(tenv.model, tenv.pendulum, -1.5) == jh.live_html(
        jenv.model, jenv.pendulum, -1.5)


def test_recorder_and_playback_html_match_jax(tmp_path):
    jenv, tenv, (jp, tp) = _recordings(tmp_path)
    with np.load(jp) as a, np.load(tp) as b:
        assert sorted(a.files) == sorted(b.files) == [
            "body_names", "hull", "hull_mask", "pos", "quat"]
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
        assert b["pos"].shape == (5, tenv.model.n_bodies, 3)
        for k in ("body_names", "hull", "hull_mask"):
            np.testing.assert_array_equal(a[k], b[k])
    # the same recording and an equal model give the same page, byte for byte
    for npz in (jp, tp):
        th.write_playback_html(npz, str(tmp_path / "t.html"), tenv.model, tenv.pendulum)
        jh.write_playback_html(npz, str(tmp_path / "j.html"), jenv.model, jenv.pendulum)
        assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    html = (tmp_path / "t.html").read_text()
    frames = html.split("const FRAMES_POS = ")[1].split(";\n")[0]
    assert len(json.loads(frames)) == 5


def test_spider_recording_matches_jax_format(tmp_path):
    """The spider's recording: world 0 of the port's states, saved as the
    JAX recorder saves the same poses."""
    from evomotion_tpu.envs.robot import RobotWalk as JWalk
    from evomotion_tpu_torch.envs.robot import RobotWalk, RobotWalkParams

    tenv = RobotWalk(RobotWalkParams(reset_frames=1), mt_seed=3, device="cpu",
                     per_env_step=True)
    st, _ = tenv.reset(1)
    tr = trec.TrajectoryRecorder(tenv)
    jr = jrec.TrajectoryRecorder(JWalk())
    for _ in range(2):
        st, _ = tenv.step(st, torch.zeros((1, 12)))
        tr.add(st)
        jr.add(type("S", (), {"physics": type("P", (), {
            "pos": jnp.asarray(st.physics.pos[0].numpy()),
            "quat": jnp.asarray(st.physics.quat[0].numpy())})})())
    jr.save(str(tmp_path / "j.npz"))
    tr.save(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
            np.testing.assert_array_equal(a[k], b[k])
        assert b["pos"].shape == (2, 42, 3)


def test_live_viewer_serves_frames():
    from evomotion_tpu_torch.viewer.live import serve_live

    env = CartPole(CartPoleParams(reset_frame_nb=2), device="cpu")
    agent = RandomAgent(action_space=1, seed=0)
    port = free_port()
    results = {}

    def client():
        results["page"] = get_retry(f"http://127.0.0.1:{port}/").decode()
        results["frames"] = [
            json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/state",
                                              timeout=60).read())
            for _ in range(3)
        ]

    t = threading.Thread(target=client, daemon=True)
    t.start()
    session = serve_live(env, agent, port=port, max_frames=3)
    t.join(timeout=60)
    assert "cam.factor" in results["page"] and "drawGround" in results["page"]
    frames = results["frames"]
    assert len(frames) == 3
    # each poll advanced the env one step (settle frames are not skipped)
    assert [f["step"] for f in frames] == [1, 2, 3] or frames[-1]["episode"] >= 1
    assert np.asarray(frames[0]["pos"]).shape == (env.model.n_bodies, 3)
    assert session.step_idx == frames[-1]["step"]


def test_offline_renders_match_jax(tmp_path):
    from evomotion_tpu.viewer import render3d as j3d
    from evomotion_tpu_torch.viewer import render3d as t3d

    _, _, (_, tp) = _recordings(tmp_path)
    for mod, name in ((t3d, "t3d.png"), (j3d, "j3d.png")):
        mod.render_trajectory(tp, str(tmp_path / name), every=1, max_frames=2)
    assert (tmp_path / "t3d.png").read_bytes() == (tmp_path / "j3d.png").read_bytes()
    trec.render_frames(tp, str(tmp_path / "t.png"), every=1, max_frames=3)
    jrec.render_frames(tp, str(tmp_path / "j.png"), every=1, max_frames=3)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
