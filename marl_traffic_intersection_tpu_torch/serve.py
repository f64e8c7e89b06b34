"""Policy inference server: batch observations in, actions out.

The port's counterpart of the repo's serve.py, with the same HTTP surface
(stdlib HTTP, no extra dependencies):

  python -m marl_traffic_intersection_tpu_torch.serve --checkpoint artifacts/policy_mlp_cfg1 \\
      --port 8787
  curl -X POST localhost:8787/act -d '{"obs": [[...127 floats...]]}'
    -> {"actions": [[throttle, steer], ...]}
  GET /healthz -> {"ok": true, "served": N}

``--checkpoint`` is a directory saved by the port's train (train_sac for
``--model sac``) or a shipped policy (``artifacts/policy_mlp_cfg1`` or its
bare name), read by ``utils/checkpoint.py::load_policy``. The forward runs on
the card unless ``--device cpu`` asks for the CPU, always on ``max_batch``
rows: a request is zero-padded to that size, and one larger than it is cut
into chunks of it. So an answer does not depend on the size of the request it
came in with, even where the card's matrix library would pick another kernel
for another row count. The recurrent (gru) family is served stateless on the
server and stateful on the client: the client sends its hidden state ``h``
(N, 128) with each request (zeros when absent) and gets the new one back.
"""
from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .models import MODEL_FAMILIES
from .utils.checkpoint import load_policy

Act = Callable[[np.ndarray, Optional[np.ndarray]], Tuple[np.ndarray, Optional[np.ndarray]]]


def make_policy(checkpoint: str, model_kind: str = "mlp", max_batch: int = 256,
                device=None) -> Act:
    """``act(obs (N, 127), h=None) -> (actions (N, 2), h_new or None)``, numpy
    in and out; ``act.h_dim`` is the GRU's width (0 for the feedforward
    families) and ``act.forward`` the padded forward on the device."""
    dev = resolve_device(device)
    model, mean_fn = load_policy(checkpoint, model_kind, dev)
    h_dim = model.gru_features if model_kind == "gru" else 0

    @torch.no_grad()
    def forward(obs: torch.Tensor, h: Optional[torch.Tensor]):
        """(max_batch, 127) [, (max_batch, h_dim)] on the device -> tanh(mean) [, h_new]."""
        if h_dim:
            mean, h_new = mean_fn(obs, h)
            return torch.tanh(mean), h_new
        return torch.tanh(mean_fn(obs)), None

    def act(obs: np.ndarray, h: Optional[np.ndarray] = None):
        n = obs.shape[0]
        if n > max_batch:
            parts = [act(obs[i:i + max_batch], None if h is None else h[i:i + max_batch])
                     for i in range(0, n, max_batch)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]) if h_dim else None)
        padded = np.zeros((max_batch, 127), np.float32)
        padded[:n] = obs
        hp = None
        if h_dim:
            hp = np.zeros((max_batch, h_dim), np.float32)
            if h is not None:
                hp[:n] = h
            hp = torch.from_numpy(hp).to(dev)
        actions, h_new = forward(torch.from_numpy(padded).to(dev), hp)
        return actions.cpu().numpy()[:n], None if h_new is None else h_new.cpu().numpy()[:n]

    forward(torch.zeros((max_batch, 127), device=dev),       # warm up the fixed shape
            torch.zeros((max_batch, h_dim), device=dev) if h_dim else None)
    act.h_dim = h_dim
    act.forward = forward
    return act


def make_server(act: Act, port: int, host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """An HTTP server answering ``POST /act`` with ``act`` and ``GET
    /healthz``; the caller runs ``serve_forever`` and ``shutdown``."""
    lock = threading.Lock()
    served = [0]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                with lock:
                    n = served[0]
                self._reply(200, {"ok": True, "served": n})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/act":
                return self._reply(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                obs = np.asarray(req["obs"], np.float32)
                if obs.ndim == 1:
                    obs = obs[None]
                if obs.ndim != 2 or obs.shape[1] != 127:
                    return self._reply(400, {"error": f"obs must be (N, 127), "
                                                      f"got {list(obs.shape)}"})
                h = req.get("h")
                if h is not None:
                    h = np.asarray(h, np.float32)
                    expect = (obs.shape[0], act.h_dim)
                    if act.h_dim == 0:
                        return self._reply(400, {"error": "h given but the served model is not "
                                                          "recurrent"})
                    if h.shape != expect:
                        return self._reply(400, {"error": f"h must be {list(expect)}, "
                                                          f"got {list(h.shape)}"})
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                return self._reply(400, {"error": f"bad request: {e}"})
            actions, h_new = act(obs, h)
            with lock:
                served[0] += obs.shape[0]
            payload = {"actions": actions.tolist()}
            if h_new is not None:  # recurrent family: the client carries its state
                payload["h"] = h_new.tolist()
            self._reply(200, payload)

    return ThreadingHTTPServer((host, port), Handler)


def serve(checkpoint: str, port: int, model_kind: str = "mlp", max_batch: int = 256,
          device=None) -> None:
    httpd = make_server(make_policy(checkpoint, model_kind, max_batch, device), port)
    print(f"serving policy on :{port} (max_batch={max_batch})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--model", choices=sorted(MODEL_FAMILIES), default="mlp")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' to ask for it")
    args = ap.parse_args(argv)
    serve(args.checkpoint, args.port, args.model, args.max_batch, args.device)


if __name__ == "__main__":
    main()
