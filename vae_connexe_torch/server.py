"""Serving daemon for generator artifacts (port of ``vae_connexe_tpu/server.py``).

The same daemon as the reference's, reading artifacts through the port's
own ``serving.load_generator``, so every generation runs on the card
through the CUDA rollout kernels.  Stdlib-only (``http.server``).

One daemon serves ONE OR MORE artifacts:

- ``GET /healthz``          → ``{"ok": true}`` once every artifact is warm.
- ``GET /artifacts``        → the route names and core geometry.
- ``GET /meta[/<name>]``    → artifact header (model geometry, batch,
  rollout_len, serve_dtype, platforms) + serving stats: request count,
  queue depth (requests currently waiting on or holding the dispatch
  lock), and generate-latency percentiles (p50/p95/p99/mean over a
  sliding window of the last 1024 dispatches).
- ``POST /generate[/<name>]`` with JSON body ``{"seed": <int>|null,
  "n_samples": <int>, "format": "npy"|"json",
  "wire_dtype": "float32"|"float16"}`` → compensated-rollout samples; a
  context-conditioned (win-family) artifact also needs ``"context"``, a
  nested list of shape (batch, tau, p), and its requests are never
  coalesced.
  ``n_samples`` defaults to the artifact's baked batch; smaller values
  slice the generated batch, larger ones loop it over sub-seeds derived
  deterministically from ``seed`` (``np.random.SeedSequence`` — the same
  (seed, n_samples) always returns the same samples).  ``"npy"``
  (default) streams an ``application/x-npy`` body (``np.load``-able);
  ``"json"`` returns the nested list.  ``wire_dtype: "float16"`` casts
  the npy body to float16 — half the response bytes; the artifact still
  computes in its own dtype (generated series are O(10), far inside f16
  range; opt in when wire bandwidth, not sample precision, is the
  bottleneck).

**Request coalescing**: ``"seed": null`` means "any fresh samples" — the
server assigns the seed.  Such requests with ``n_samples <= batch`` are
coalescible: concurrent ones are served FIFO from ONE device dispatch
each time the baked batch has room (disjoint slices of one generated
batch), so k small requests cost ~ceil(sum(n_i)/batch) dispatches
instead of k.  Explicit-seed requests are never coalesced — their
(seed, n_samples) → samples contract stays bitwise.

Unexpected dispatch failures (CUDA runtime errors) return
a JSON ``500`` body and are counted in ``/meta`` ``errors`` — the daemon
never drops a connection without a response.

Dispatch is serialized with one FIFO ticket lock shared across artifacts
(``_FairLock`` — strict arrival order, no barging): one card, one queue —
the artifact's batch dimension is the throughput lever; coalescing + fair
serialization bound per-request latency at queue_depth × service time.
``queue_depth`` in ``/meta`` is the backpressure signal.
"""

from __future__ import annotations

import collections
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from vae_connexe_torch.serving import load_generator

_LAT_WINDOW = 1024


class _FairLock:
    """FIFO ticket lock for the dispatch queue.

    A bare ``threading.Lock`` wakes whichever waiter the OS schedules
    (barging): under sustained concurrent load a request can lose the
    race to later arrivals indefinitely.  The ticket discipline serves
    requests strictly in arrival order, so per-request latency is
    bounded by queue_depth × service time — the predictable
    backpressure ``/meta`` advertises.

    ``acquire(until=...)`` is the coalescing fast path: a waiter whose
    request is filled by ANOTHER thread's shared dispatch cancels its
    ticket and returns immediately instead of idling behind every
    earlier-ticketed dispatch (e.g. a long explicit-seed multi-call
    request).  Cancelled tickets are skipped when ``_serving`` reaches
    them, so the queue never stalls on a departed waiter.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._next_ticket = 0
        self._serving = 0
        self._cancelled = set()

    def acquire(self, until=None) -> bool:
        """Take a ticket and wait for it.  If ``until()`` becomes true
        first, cancel the ticket and return False (lock NOT held)."""
        with self._cond:
            ticket = self._next_ticket
            self._next_ticket += 1
            while ticket != self._serving:
                if until is not None and until():
                    self._cancelled.add(ticket)
                    return False
                self._cond.wait()
        return True

    def release(self):
        with self._cond:
            self._serving += 1
            while self._serving in self._cancelled:
                self._cancelled.discard(self._serving)
                self._serving += 1
            self._cond.notify_all()

    def wake(self):
        """Re-notify waiters so ``until`` predicates are re-evaluated
        (called after a shared dispatch marks waiters done)."""
        with self._cond:
            self._cond.notify_all()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _Waiter:
    """One coalescible request queued for a shared dispatch."""

    __slots__ = ("n", "result", "error", "done", "seed", "offset")

    def __init__(self, n: int):
        self.n = n
        self.result = None
        self.error = None
        self.done = False
        self.seed = None     # the shared dispatch's server-assigned seed
        self.offset = 0      # this request's slice offset in that batch


class _Artifact:
    """One loaded generator + its per-route serving stats."""

    def __init__(self, source, name: str, device=None):
        self.name = name
        self.fn, self.meta = load_generator(source, device)
        self.needs_context = self.meta["kind"] == "win_conditioned_generator"
        self.requests = 0
        self.device_calls = 0              # actual generator dispatches
        self.coalesced_requests = 0        # requests served from a shared one
        self.errors = 0                    # unexpected dispatch failures (500s)
        self.latencies = collections.deque(maxlen=_LAT_WINDOW)
        self.coal_queue = collections.deque()   # FIFO of _Waiter
        self.coal_mutex = threading.Lock()

    def warm(self) -> float:
        """First call pays the kernels' build or load."""
        t0 = time.perf_counter()
        if self.needs_context:
            self.fn(0, np.zeros((self.meta["batch"], self.meta["tau"],
                                 self.meta["p"]), np.float32))
        else:
            self.fn(0)
        return time.perf_counter() - t0

    def stats(self) -> dict:
        lat = np.asarray(self.latencies, np.float64)
        pct = (lambda q: round(1e3 * float(np.percentile(lat, q)), 3)) \
            if lat.size else (lambda q: None)
        return {
            "requests": self.requests,
            "device_calls": self.device_calls,
            "coalesced_requests": self.coalesced_requests,
            "errors": self.errors,
            "generate_ms": {"p50": pct(50), "p95": pct(95), "p99": pct(99),
                            "mean": (round(1e3 * float(lat.mean()), 3)
                                     if lat.size else None),
                            "window": int(lat.size)},
        }


def _sub_seeds(seed: int, k: int) -> list[int]:
    """k deterministic int32 sub-seeds for multi-batch requests — the same
    (seed, n_samples) always yields the same sample tensor."""
    if k == 1:
        return [int(seed)]
    return [int(s) for s in
            np.random.SeedSequence(int(seed)).generate_state(k) >> 1]


class GeneratorServer:
    """Serve one or more exported generator artifacts over HTTP.

    ``artifacts``: a single source (path / bytes) or a list of paths /
    ``{name: source}`` dict.  With several artifacts, the first is the
    default route (``/generate``) and each is also addressable as
    ``/generate/<name>`` (names default to the file stem).

    ``device``: where the artifacts run (default ``cuda``).

    ``port=0`` picks a free port (read it back from ``.port`` — the test
    harness pattern).  ``start()`` spawns the accept loop in a daemon
    thread; ``serve_forever()`` blocks (the CLI path).
    """

    def __init__(self, artifacts, host: str = "127.0.0.1", port: int = 0,
                 device=None):
        import pathlib

        if isinstance(artifacts, dict):
            items = list(artifacts.items())
        elif isinstance(artifacts, (list, tuple)):
            items = [(pathlib.Path(a).stem if isinstance(a, (str, pathlib.Path))
                      else f"artifact{i}", a)
                     for i, a in enumerate(artifacts)]
        else:
            items = [(pathlib.Path(artifacts).stem
                      if isinstance(artifacts, (str, pathlib.Path))
                      else "artifact0", artifacts)]
        if len({n for n, _ in items}) != len(items):
            raise ValueError(f"duplicate artifact names in "
                             f"{[n for n, _ in items]}; pass a dict to name "
                             f"them explicitly")
        self._artifacts = {name: _Artifact(src, name, device)
                           for name, src in items}
        self._default = next(iter(self._artifacts))
        self.meta = self._artifacts[self._default].meta   # back-compat
        self._lock = _FairLock()
        self._pending = 0                  # requests waiting on/holding _lock
        self._pending_lock = threading.Lock()
        # Server-assigned seeds for "seed": null requests.  A plain counter:
        # coalesced requests have no reproducibility contract (the response
        # is a slice of a shared batch); it only needs to differ per
        # dispatch.  int31 to match _sub_seeds' range.
        self._auto_seed_lock = threading.Lock()
        self._auto_seed_next = 0x5EED
        self._warmup_s = 0.0
        for art in self._artifacts.values():
            self._warmup_s += art.warm()

        server = self

        class Handler(BaseHTTPRequestHandler):
            # quiet by default; the CLI enables logging
            log_enabled = False

            def log_message(self, fmt, *args):  # noqa: N802
                if self.log_enabled:
                    BaseHTTPRequestHandler.log_message(self, fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj):
                self._send(code, json.dumps(obj).encode(), "application/json")

            def _route(self, prefix: str):
                """Resolve /<prefix>[/<name>] to an artifact (or None+error)."""
                if self.path == prefix:
                    return server._artifacts[server._default]
                if self.path.startswith(prefix + "/"):
                    name = self.path[len(prefix) + 1:]
                    art = server._artifacts.get(name)
                    if art is None:
                        self._send_json(404, {
                            "error": f"no artifact {name!r}; serving "
                                     f"{sorted(server._artifacts)}"})
                        return None
                    return art
                self._send_json(404, {"error": f"no route {self.path}"})
                return None

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._send_json(200, {"ok": True})
                elif self.path == "/artifacts":
                    self._send_json(200, {
                        "default": server._default,
                        "artifacts": {
                            n: {k: a.meta.get(k) for k in
                                ("kind", "batch", "rollout_len", "p",
                                 "serve_dtype", "kernel")}
                            for n, a in server._artifacts.items()}})
                elif self.path == "/meta" or self.path.startswith("/meta/"):
                    art = self._route("/meta")
                    if art is None:
                        return
                    self._send_json(200, {
                        **art.meta, "artifact": art.name,
                        "warmup_s": round(server._warmup_s, 4),
                        "queue_depth": server._pending,
                        **art.stats()})
                else:
                    self._send_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                art = self._route("/generate")
                if art is None:
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    req = json.loads(self.rfile.read(length) or b"{}")
                    raw_seed = req.get("seed", 0)
                    seed = None if raw_seed is None else int(raw_seed)
                    fmt = req.get("format", "npy")
                    if fmt not in ("npy", "json"):
                        raise ValueError(f"format must be 'npy' or 'json', "
                                         f"got {fmt!r}")
                    wire = req.get("wire_dtype", "float32")
                    if wire not in ("float32", "float16"):
                        raise ValueError(f"wire_dtype must be 'float32' or "
                                         f"'float16', got {wire!r}")
                    if wire == "float16" and fmt == "json":
                        raise ValueError(
                            "wire_dtype 'float16' applies to the npy wire "
                            "format only; with format='json' drop wire_dtype "
                            "or use format='npy'")
                    batch = art.meta["batch"]
                    n = int(req.get("n_samples", batch))
                    if n < 1:
                        raise ValueError(f"n_samples must be >= 1, got {n}")
                    extra = ()
                    if art.needs_context:
                        if "context" not in req:
                            raise ValueError(
                                "this artifact is context-conditioned; the "
                                "request body needs 'context': nested list "
                                f"of shape (batch={batch}, "
                                f"tau={art.meta['tau']}, "
                                f"p={art.meta['p']})")
                        extra = (np.asarray(req["context"], np.float32),)
                except (ValueError, json.JSONDecodeError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                coalescible = (seed is None and n <= batch
                               and not art.needs_context)
                offset = 0
                try:
                    if coalescible:
                        samples, seed, offset = \
                            server._coalesced_generate(art, n)
                    else:
                        if seed is None:   # auto seed: n > batch or context
                            seed = server._next_auto_seed()
                        n_calls = -(-n // batch)
                        with server._pending_lock:
                            server._pending += 1
                        try:
                            with server._lock:
                                t0 = time.perf_counter()
                                parts = [art.fn(s, *extra)
                                         for s in _sub_seeds(seed, n_calls)]
                                dt = time.perf_counter() - t0
                                art.requests += 1
                                art.device_calls += n_calls
                                art.latencies.append(dt)
                        finally:
                            with server._pending_lock:
                                server._pending -= 1
                        samples = (parts[0][:n] if n_calls == 1
                                   else np.concatenate(parts, axis=0)[:n])
                except ValueError as e:     # e.g. context shape mismatch
                    self._send_json(400, {"error": str(e)})
                    return
                except Exception as e:      # e.g. a CUDA runtime error:
                    # a JSON 500 beats a dropped connection — clients get an
                    # error body, /meta counts it.
                    art.errors += 1
                    self._send_json(500, {
                        "error": f"{type(e).__name__}: {e}"})
                    return
                if fmt == "json":
                    self._send_json(200, {"seed": seed,
                                          "offset": offset,
                                          "shape": list(samples.shape),
                                          "samples": np.asarray(samples).tolist()})
                else:
                    buf = io.BytesIO()
                    np.save(buf, np.asarray(samples, np.float16)
                            if wire == "float16" else np.asarray(samples))
                    self._send(200, buf.getvalue(), "application/x-npy")

        self._handler_cls = Handler
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = None

    def _next_auto_seed(self) -> int:
        with self._auto_seed_lock:
            s = self._auto_seed_next
            self._auto_seed_next = (s + 1) & 0x7FFFFFFF
        return s

    def _coalesced_generate(self, art: _Artifact, n: int):
        """Serve one "seed": null request of n <= batch samples, sharing the
        device dispatch with every other coalescible request queued for the
        same artifact.  Returns ``(samples, dispatch_seed, slice_offset)``.

        The waiter joins the artifact's FIFO queue, then contends for the
        dispatch lock.  Whichever waiter holds the lock drains the longest
        queue prefix that fits in the baked batch, runs ONE generator call,
        and hands out disjoint slices; a waiter filled by another thread's
        dispatch cancels its lock ticket and returns immediately rather
        than idling behind earlier-ticketed dispatches.  FIFO on both the
        queue and the lock keeps arrival order.
        """
        w = _Waiter(n)
        with art.coal_mutex:
            art.coal_queue.append(w)
        batch = art.meta["batch"]
        with self._pending_lock:
            self._pending += 1
        try:
            if self._lock.acquire(until=lambda: w.done):
                try:
                    while not w.done:
                        with art.coal_mutex:
                            take, total = [], 0
                            while (art.coal_queue
                                   and total + art.coal_queue[0].n <= batch):
                                total += art.coal_queue[0].n
                                take.append(art.coal_queue.popleft())
                        seed = self._next_auto_seed()
                        t0 = time.perf_counter()
                        try:
                            out = art.fn(seed)
                        except Exception as e:
                            # Fail every waiter popped for this dispatch —
                            # leaving them pop'd-but-pending would hang their
                            # threads forever.
                            for wt in take:
                                wt.error, wt.done = e, True
                            raise
                        dt = time.perf_counter() - t0
                        off = 0
                        for wt in take:
                            wt.result = out[off:off + wt.n]
                            wt.seed, wt.offset = seed, off
                            off += wt.n
                            wt.done = True
                        art.requests += len(take)
                        art.coalesced_requests += len(take)
                        art.device_calls += 1
                        art.latencies.append(dt)
                        self._lock.wake()   # served waiters cancel + return
                finally:
                    self._lock.release()
        except Exception:
            # Our own waiter may still sit in the queue (the popped prefix
            # filled the batch before reaching it): remove it, or a later
            # dispatch wastes batch capacity on a departed thread and the
            # request stats double-count.
            if not w.done:
                with art.coal_mutex:
                    try:
                        art.coal_queue.remove(w)
                    except ValueError:   # raced: another dispatch took it
                        pass
            raise
        finally:
            with self._pending_lock:
                self._pending -= 1
        if w.error is not None:
            raise w.error
        return w.result, w.seed, w.offset

    def start(self) -> None:
        """Accept requests on a daemon thread (returns immediately)."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self, log: bool = True) -> None:
        """Block serving requests (the ``cli serve`` path)."""
        self._handler_cls.log_enabled = log
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
