"""The port's artifact, serving daemon and CLI, on the CPU.

Generation here runs the rollout kernels' plain versions (CPU tensors);
``chip_smoke.py`` drives the same daemon on the card through the kernels.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from vae_connexe_torch import cli
from vae_connexe_torch.models import CRVAE, ErrorVAE, masked_heads
from vae_connexe_torch.server import GeneratorServer
from vae_connexe_torch.serving import export_generator, load_generator
from vae_connexe_torch.train import generate_from_draws
from torch_threads import one_torch_thread  # noqa: F401

P, H, HE, BATCH, T = 4, 8, 6, 6, 5


@pytest.fixture(scope="module")
def small():
    g = torch.Generator().manual_seed(0)
    model = CRVAE(p=P, hidden=H, rollout_len=T)
    err = ErrorVAE(d=P, hidden=HE, rollout_len=T)
    params, eparams = model.init(g, "cpu"), err.init(g, "cpu")
    parents = (torch.rand((P, P), generator=g) > 0.3).float()
    blob = export_generator(model, err, params, eparams, batch=BATCH,
                            parents=parents)
    return model, err, params, eparams, parents, blob


@pytest.fixture(scope="module")
def server(small):
    srv = GeneratorServer(small[-1], device="cpu")     # port=0: auto-pick
    srv.start()
    yield srv
    srv.shutdown()


def _post(srv, body):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=30)


def _get(srv, path):
    with urllib.request.urlopen(f"http://{srv.host}:{srv.port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


def test_artifact_matches_in_process_generation(small):
    """fn(seed) is generate_from_draws on the seed's two draws, error-VAE
    h0 first; the parents mask is baked into the saved heads."""
    model, err, params, eparams, parents, blob = small
    fn, meta = load_generator(blob, "cpu")
    g = torch.Generator().manual_seed(11)
    h0_err = torch.randn((BATCH, HE), generator=g)
    h0 = torch.randn((BATCH, H), generator=g)
    want = generate_from_draws(model, err, masked_heads(params.heads, parents),
                               params.readout, eparams.dec, eparams.out,
                               h0_err, h0)
    np.testing.assert_array_equal(fn(11), want.numpy())
    assert meta["kind"] == "crvae_compensated_generator"
    assert (meta["batch"], meta["rollout_len"], meta["p"], meta["hidden"]) == \
        (BATCH, T, P, H)
    # Exported from CPU weights: the artifact runs where they lay.
    assert meta["platforms"] == ["cpu"] and "torch_version" in meta


def test_artifact_deterministic_and_seed_sensitive(small, tmp_path):
    path = tmp_path / "gen.vcxt"
    path.write_bytes(small[-1])
    fn, _ = load_generator(path, "cpu")
    a, b, c = fn(3), fn(3), fn(4)
    assert a.shape == (BATCH, T, P) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)


def test_artifact_rejects_bad_input(small):
    blob = small[-1]
    with pytest.raises(ValueError, match="bad magic"):
        load_generator(b"XXXXXXXX" + blob[8:], "cpu")
    hlen = int.from_bytes(blob[8:12], "little")
    header, body = json.loads(blob[12:12 + hlen]), blob[12 + hlen:]
    # A win header on a compensated generator's program, and an unknown kind.
    for kind, err in (("win_conditioned_generator", "takes inputs of shapes"),
                      ("other", "unknown artifact kind")):
        h = json.dumps({**header, "kind": kind}).encode()
        with pytest.raises(ValueError, match=err):
            load_generator(blob[:8] + len(h).to_bytes(4, "little") + h + body,
                           "cpu")
    model, e, params, eparams = small[:4]
    with pytest.raises(ValueError, match="cuda"):
        export_generator(model, e, params, eparams, batch=2, platforms=["tpu"])
    with pytest.raises(ValueError, match="kernel"):
        export_generator(model, e, params, eparams, batch=2, kernel="mosaic")


def test_server_healthz_generate_and_meta(server, small):
    status, body = _get(server, "/healthz")
    assert status == 200 and body == {"ok": True}
    with _post(server, {"seed": 5}) as r:
        assert r.headers["Content-Type"] == "application/x-npy"
        samples = np.load(io.BytesIO(r.read()))
    fn, _ = load_generator(small[-1], "cpu")
    np.testing.assert_array_equal(samples, fn(5))
    with _post(server, {"seed": 5, "format": "json", "n_samples": 2}) as r:
        body = json.loads(r.read())
    np.testing.assert_array_equal(np.asarray(body["samples"], np.float32),
                                  fn(5)[:2])
    _, meta = _get(server, "/meta")
    assert meta["requests"] >= 2 and meta["generate_ms"]["p50"] is not None


def test_server_coalesces_seedless_requests(server):
    """Two "seed": null requests queued while the dispatch lock is held are
    served by one generator call."""
    art = server._artifacts[server._default]
    calls0, coal0 = art.device_calls, art.coalesced_requests
    outs, errs = [None, None], []

    def client(i):
        try:
            with _post(server, {"seed": None, "n_samples": 3}) as r:
                outs[i] = np.load(io.BytesIO(r.read()))
        except Exception as e:              # surfaced in the main thread
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    server._lock.acquire()
    try:
        for t in threads:
            t.start()
        for _ in range(500):
            if len(art.coal_queue) == 2:
                break
            threading.Event().wait(0.01)
    finally:
        server._lock.release()
    for t in threads:
        t.join(timeout=30)
    assert not errs, errs
    assert all(o.shape == (3, T, P) for o in outs)
    assert art.device_calls - calls0 == 1
    assert art.coalesced_requests - coal0 == 2


def test_cli_generate(small, tmp_path, capsys):
    path = tmp_path / "gen.vcxt"
    path.write_bytes(small[-1])
    out = tmp_path / "s.npy"
    cli.main(["generate", str(path), "--seed", "2", "--out", str(out),
              "--device", "cpu"])
    result = json.loads(capsys.readouterr().out)
    assert result["shape"] == [BATCH, T, P]
    fn, _ = load_generator(path, "cpu")
    np.testing.assert_array_equal(np.load(out), fn(2))


def test_server_bad_requests_and_dispatch_errors(server):
    """Malformed requests get a JSON 400; a generator that fails gets a
    JSON 500 on both the explicit-seed and the coalesced path, and /meta
    counts it."""
    import urllib.error

    for body in ({"format": "xml"}, {"n_samples": 0},
                 {"format": "json", "wire_dtype": "float16"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, body)
        assert e.value.code == 400 and "error" in json.loads(e.value.read())
    art = server._artifacts[server._default]
    orig, errors0 = art.fn, art.errors

    def broken(seed):
        raise RuntimeError("device lost")

    art.fn = broken
    try:
        for body in ({"seed": 1}, {"seed": None, "n_samples": 2}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server, body)
            assert e.value.code == 500
            assert "device lost" in json.loads(e.value.read())["error"]
    finally:
        art.fn = orig
    assert art.errors - errors0 == 2 and len(art.coal_queue) == 0


def test_server_routes_and_loops_sub_seeds(small):
    """Several artifacts by name, /artifacts, an unknown route's 404, and
    n_samples above the batch served from deterministic sub-seeds."""
    import urllib.error

    srv = GeneratorServer({"a": small[-1], "b": small[-1]}, device="cpu")
    srv.start()
    try:
        _, arts = _get(srv, "/artifacts")
        assert arts["default"] == "a" and set(arts["artifacts"]) == {"a", "b"}
        req = urllib.request.Request(
            f"http://{srv.host}:{srv.port}/generate/b",
            data=json.dumps({"seed": 4, "n_samples": BATCH + 2}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            big = np.load(io.BytesIO(r.read()))
        assert big.shape == (BATCH + 2, T, P)
        with _post(srv, {"seed": 4, "n_samples": BATCH + 2}) as r:
            np.testing.assert_array_equal(np.load(io.BytesIO(r.read())), big)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv, "/meta/c")
        assert e.value.code == 404
    finally:
        srv.shutdown()
