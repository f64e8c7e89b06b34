"""The port's policy server over a real socket, on the CPU: the counterparts
of tests/test_serve.py, and every answer equal to a direct padded forward."""
import contextlib
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from marl_traffic_intersection_tpu_torch import serve as S

from . import _torch_port  # noqa: F401  (one torch thread per test worker)

MAX_BATCH = 32


@contextlib.contextmanager
def _serving(act):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = S.make_server(act, port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield port
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def mlp():
    act = S.make_policy("artifacts/policy_mlp_cfg1", max_batch=MAX_BATCH, device="cpu")
    with _serving(act) as port:
        yield act, port


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/act", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _post_error(port, payload):
    """The status and error message of a request the server refuses."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, payload)
    with e.value:
        return e.value.code, json.loads(e.value.read())["error"]


def _direct(act, obs, h=None):
    """The actions (and hidden state) of a direct forward over the request
    padded to max_batch rows, chunk by chunk."""
    acts, hs = [], []
    for i in range(0, len(obs), MAX_BATCH):
        part = obs[i:i + MAX_BATCH]
        po = torch.zeros(MAX_BATCH, 127)
        po[:len(part)] = torch.from_numpy(part)
        ph = None
        if act.h_dim:
            ph = torch.zeros(MAX_BATCH, act.h_dim)
            if h is not None:
                ph[:len(part)] = torch.from_numpy(h[i:i + MAX_BATCH])
        a, h_new = act.forward(po, ph)
        acts.append(a[:len(part)].numpy())
        if h_new is not None:
            hs.append(h_new[:len(part)].numpy())
    return np.concatenate(acts), (np.concatenate(hs) if hs else None)


def _obs(n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 127)).astype(np.float32)


def test_act_endpoint(mlp):
    act, port = mlp
    obs = _obs(3)
    a = np.asarray(_post(port, {"obs": obs.tolist()})["actions"], np.float32)
    assert a.shape == (3, 2) and (np.abs(a) <= 1.0).all()
    np.testing.assert_array_equal(a, _direct(act, obs)[0])


def test_act_oversized_batch_chunks(mlp):
    act, port = mlp
    obs = _obs(70, seed=1)                             # > max_batch = 32
    a = np.asarray(_post(port, {"obs": obs.tolist()})["actions"], np.float32)
    assert a.shape == (70, 2)
    np.testing.assert_array_equal(a, _direct(act, obs)[0])
    # an answer does not depend on the request it came in with
    np.testing.assert_array_equal(a[40:43], np.asarray(
        _post(port, {"obs": obs[40:43].tolist()})["actions"], np.float32))


def test_act_bad_shape_400(mlp):
    code, msg = _post_error(mlp[1], {"obs": [[1.0, 2.0]]})
    assert code == 400 and "127" in msg
    code, msg = _post_error(mlp[1], {"obs": _obs(2).tolist(), "h": [[0.0] * 128] * 2})
    assert code == 400 and "not recurrent" in msg


def test_recurrent_serving_roundtrip():
    """gru family: the client-held hidden state round-trips through /act."""
    act = S.make_policy("policy_gru_multi", "gru", max_batch=8, device="cpu")
    assert act.h_dim == 128
    obs = _obs(2, seed=2)
    with _serving(act) as port:
        out1 = _post(port, {"obs": obs.tolist()})                 # no h -> zeros
        h1 = np.asarray(out1["h"], np.float32)
        assert np.asarray(out1["actions"]).shape == (2, 2) and h1.shape == (2, 128)
        out2 = _post(port, {"obs": obs.tolist(), "h": h1.tolist()})
        h2 = np.asarray(out2["h"], np.float32)
        assert not np.allclose(h1, h2)                            # memory evolves
        assert np.all(np.abs(np.asarray(out2["actions"])) <= 1.0)
        code, msg = _post_error(port, {"obs": obs.tolist(), "h": [[0.0, 0.0]]})
        assert code == 400 and "h must be" in msg          # malformed h
    a1, d1 = _direct(act, obs)
    a2, d2 = _direct(act, obs, h1)
    np.testing.assert_array_equal(np.asarray(out1["actions"], np.float32), a1)
    np.testing.assert_array_equal(h1, d1)
    np.testing.assert_array_equal(np.asarray(out2["actions"], np.float32), a2)
    np.testing.assert_array_equal(h2, d2)


def test_healthz(mlp):
    with urllib.request.urlopen(f"http://127.0.0.1:{mlp[1]}/healthz", timeout=10) as r:
        body = json.loads(r.read())
    assert body["ok"] is True and body["served"] >= 0


def test_serve_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.make_policy("policy_mlp_cfg1")
