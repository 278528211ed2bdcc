"""Live policy viewer: HTTP server stepping agent+env per rendered frame.

Reference counterpart: the windowed 60 FPS infer loop (src/infer.cpp:82-105)
and InferOpenGlWindow (src/gui/widget/opengl_window.cpp:227-241): step =
env->do_step(agent->act(...)) once per rendered frame, auto-reset on done.
Here the browser polls /state at ~60 FPS; each poll advances the env one
step (so wall-clock speed follows the client's frame rate, like the
reference's vsync'd loop) and returns body poses as JSON for the embedded
software renderer (viewer/html_viewer.py).

Port of ``evomotion_tpu/viewer/live.py`` on the port's envs and agents: the
step is the env's own, on its device (one world, the per-env physics step
for the sequential envs), and resets draw from a ``torch.Generator`` seeded
with ``env_seed`` where the env has no mt19937 table. The loop is JAX's: no
skipping of settle frames, an auto-reset on ``done``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

import numpy as np
import torch


class LiveSession:
    """Steps agent+env; one step per /state poll (thread-safe)."""

    def __init__(self, env, agent, env_seed: int = 1234):
        self.env = env
        self.agent = agent
        self._lock = threading.Lock()
        self._gen = torch.Generator(device=env.device).manual_seed(env_seed)
        self.state, self.res = env.reset(1, self._gen)
        self.step_idx = 0
        self.episode = 0

    def advance(self) -> dict:
        with self._lock:
            action = self.agent.act(self.res.obs, float(self.res.reward[0]))
            self.state, self.res = self.env.step(self.state, action, self._gen)
            self.step_idx += 1
            if bool(self.res.done[0]):
                # auto-reset (opengl_window.cpp:237-240)
                self.agent.done(self.res.obs, float(self.res.reward[0]))
                self.episode += 1
                self.step_idx = 0
            phys = self.state.physics
            return {
                "pos": np.round(phys.pos[0].cpu().numpy(), 4).tolist(),
                "quat": np.round(phys.quat[0].cpu().numpy(), 5).tolist(),
                "reward": float(self.res.reward[0]),
                "step": self.step_idx,
                "episode": self.episode,
            }


def serve_live(env, agent, port: int = 8800, env_seed: int = 1234,
               root_body: int | None = None, max_frames: int | None = None):
    """Serve the live viewer at http://localhost:<port>/ (blocking).

    max_frames: stop after N polls (for tests)."""
    from .html_viewer import live_html

    if root_body is None:
        root_body = getattr(getattr(env, "meta", None), "root_body", 0)
    ground_y = float(env.model.init_pos[:, 1].min()) if env.model.n_bodies else -1.5
    page = live_html(env.model, root_body, ground_y)
    session = LiveSession(env, agent, env_seed)
    served = {"n": 0, "total": 0}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            served["total"] += 1
            if self.path == "/state":
                body = json.dumps(session.advance()).encode()
                ctype = "application/json"
                served["n"] += 1
            else:
                body = page.encode()
                ctype = "text/html"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    if max_frames is None:
        server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        print(f"live viewer: http://localhost:{port}/ (ctrl-c to stop)")
        server.serve_forever()
    else:
        # Single-threaded server for the bounded (test) path: handle_request()
        # returns only after the handler ran, so the served counter is exact.
        # The timeout bounds the wait for the next request, so a client that
        # stops polling early can never hang the loop.
        server = HTTPServer(("127.0.0.1", port), Handler)
        server.timeout = 30.0
        while served["n"] < max_frames:
            before = served["total"]
            server.handle_request()
            if served["total"] == before:
                break  # timed out with no request: client went away
    server.server_close()
    return session
