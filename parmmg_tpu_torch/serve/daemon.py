"""Pool daemon: the persistent serving process (port of
``serve/daemon.py``).

A daemon owns one ``ServeDriver`` (and with it the kernels built once,
the card's allocator cache and the pool's buckets) for its lifetime, and
fronts ``submit/poll/fetch`` with a thin stdlib HTTP/JSON RPC layer so
that clients come and go while the slots stay warm.

Transport (stdlib only, localhost-class): JSON bodies; mesh arrays ride
base64 npz (bit-exact both ways, the JAX daemon's wire format).
Endpoints:

    POST /submit    {tenant?, npz_b64?, path?, sol?} -> {tid}
                    (HTTP 429 {error, deferred:true} under admission
                    backpressure: retry later)
    GET  /poll?tid= -> request state machine position
    GET  /fetch?tid=-> {npz_b64}: merged mesh fields + met (409 until the
                    request is done)
    GET  /healthz   -> liveness + loop counters
    GET  /metrics   -> Prometheus text exposition (obs registry)
    GET  /report    -> the full ServeDriver report
    GET  /trace?last=N -> the trace ring's summary and its newest N
                    records (256 by default; the JSONL sink of the
                    front end's --trace keeps them all)
    POST /pause /resume /step /shutdown  (ops and deterministic tests;
                    /step runs exactly one serving-loop iteration)

Threads: one HTTP server (a handler thread a request) and one serving
loop; a re-entrant lock serializes driver access, so RPC handlers see
consistent state between steps.  All device work runs under that lock,
on the default CUDA stream of whichever thread holds it (the kernels
launch on ``torch.cuda.current_stream``, and no thread here makes a
stream of its own).

Failure semantics: the RPC dispatch is the ``serve.daemon_rpc``
faultpoint — a fault while handling a tenant's request kills that
request: the tenant is quarantined (``ServeDriver.quarantine``) while its
cohort-mates keep their bytes and the daemon keeps serving.

Hang semantics: with ``step_deadline_s`` > 0 (the JAX package's
PARMMG_DEADLINE_SERVE_S; 0, off, by default) each serving-loop step runs
under ``run_with_deadline`` on a worker thread of its own, the first with
``step_grace_s`` more.  On expiry the daemon flips ``/healthz`` to
not-ok with ``wedged: true`` and waits the stuck step out (it still owns
the card and the lock) instead of piling new steps behind it.

Run it as ``python -m parmmg_tpu_torch.serve.daemon`` (``--help``).
"""
from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler

import numpy as np

from ..resilience.watchdog import GRACE_S
from .driver import ServeDriver

__all__ = ["PoolDaemon", "decode_npz", "encode_npz", "mesh_arrays"]


# ---------------------------------------------------------------------------
# bit-exact array transport (base64 npz)
# ---------------------------------------------------------------------------
def mesh_arrays(mesh, met=None) -> dict:
    """Merged (mesh, met) -> {field: np.ndarray} payload, tags as uint32
    as the JAX package stores them.  Accepts a core Mesh or a plain dict
    of arrays (the stub pools of the host-only tests)."""
    if isinstance(mesh, dict):
        out = {k: np.asarray(v) for k, v in mesh.items()}
    else:
        from ..core.mesh import mesh_to_numpy
        out = mesh_to_numpy(mesh)
    if met is not None:
        out["met"] = met.cpu().numpy() if hasattr(met, "cpu") \
            else np.asarray(met)
    return out


def encode_npz(arrays: dict) -> str:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_npz(b64: str) -> dict:
    raw = base64.b64decode(b64.encode("ascii"))
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------
class PoolDaemon:
    """Persistent pool service: HTTP front end + serving-loop thread
    around one :class:`ServeDriver`.

    ``port=0`` binds an ephemeral port, readable from :attr:`port` after
    :meth:`start` (8077 by default, the JAX package's PARMMG_SERVE_PORT
    default).  ``start_paused`` starts with the loop idle.
    ``step_deadline_s`` / ``step_grace_s``: the step watchdog (module
    docstring).  ``driver_kwargs`` build the driver when none is given
    (``device`` defaults to ``"cuda"``)."""

    def __init__(self, driver: ServeDriver | None = None,
                 host: str = "127.0.0.1", port: int = 8077,
                 idle_sleep_s: float = 0.02, start_paused: bool = False,
                 step_deadline_s: float = 0.0,
                 step_grace_s: float = GRACE_S, **driver_kwargs):
        self.driver = driver if driver is not None \
            else ServeDriver(**driver_kwargs)
        self.host = host
        self.port = int(port)
        self.idle_sleep_s = float(idle_sleep_s)
        self.paused = bool(start_paused)
        self.step_deadline_s = float(step_deadline_s)
        self.step_grace_s = float(step_grace_s)
        self._wedged = False
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._httpd = None
        self._threads: list[threading.Thread] = []

    # ---- lifecycle --------------------------------------------------------
    def start(self) -> "PoolDaemon":
        from http.server import ThreadingHTTPServer

        from ..obs import trace as otrace
        if self._httpd is not None:
            raise RuntimeError("daemon already started")
        otrace.new_run(getattr(self.driver.pool, "device", None))
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._httpd.pool_daemon = self
        self.port = int(self._httpd.server_address[1])
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever,
                             name="parmmg-serve-http", daemon=True),
            threading.Thread(target=self._loop,
                             name="parmmg-serve-loop", daemon=True),
        ]
        for t in self._threads:
            t.start()
        otrace.event("serve.daemon_start", port=self.port)
        otrace.log(1, f"serve daemon: listening on "
                      f"http://{self.host}:{self.port}", err=True)
        return self

    def _loop(self) -> None:
        from ..obs import trace as otrace
        from ..obs.metrics import REGISTRY
        from ..resilience.watchdog import WatchdogTimeout, run_with_deadline

        def step():
            # the lock is taken inside the guarded fn, so a wedged step
            # is observable: its thread owns the RLock for the step's
            # whole duration, and /healthz stays lock-free
            with self._lock:
                return self.driver.service_once()

        while not self._stop.is_set():
            if self.paused:
                self._stop.wait(self.idle_sleep_s)
                continue
            try:
                st = run_with_deadline(step, self.step_deadline_s,
                                       "serve.slot_step",
                                       grace_s=self.step_grace_s)
            except WatchdogTimeout as e:
                # the abandoned step thread still holds the RLock (and
                # the card): more steps would pile up behind it.  Mark
                # the daemon wedged (healthz not-ok, so a supervisor can
                # restart it) and wait the thread out; if it ever
                # finishes, serving resumes.
                REGISTRY.counter("serve.step_timeouts").inc()
                otrace.event("serve.step_timeout",
                             seconds=float(e.seconds))
                otrace.log(0, f"serve daemon: serving step exceeded "
                              f"{e.seconds:g}s deadline — wedged "
                              "(healthz not-ok) until it returns",
                           err=True)
                # only this thread writes the flag; /healthz reads it
                # without the lock by design
                self._wedged = True
                th = getattr(e, "thread", None)
                while th is not None and th.is_alive() \
                        and not self._stop.is_set():
                    self._stop.wait(max(self.idle_sleep_s, 0.1))
                self._wedged = False
                continue
            except Exception as e:
                # the loop is the service: an escaped iteration error
                # must not kill serving while /healthz stays green —
                # account it, back off, keep looping
                REGISTRY.counter("serve.loop_errors").inc()
                otrace.event("serve.loop_error", detail=repr(e)[:300])
                otrace.log(0, f"serve daemon: serving-loop iteration "
                              f"failed ({e!r}); continuing", err=True)
                self._stop.wait(max(self.idle_sleep_s, 0.1))
                continue
            if st != "active":
                # idle, or stalled on capacity: a daemon waits (new
                # submissions, autoscale and timeouts resolve it)
                self._stop.wait(self.idle_sleep_s)

    def shutdown(self) -> None:
        from ..obs import trace as otrace
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10)
        otrace.event("serve.daemon_stop", port=self.port)
        otrace.log(1, "serve daemon: stopped", err=True)

    def alive(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    def __enter__(self) -> "PoolDaemon":
        return self if self._httpd is not None else self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ---- RPC dispatch -----------------------------------------------------
    def handle_rpc(self, method: str, op: str, qs: dict, payload: dict):
        """One RPC -> (status, body, content_type).  The dispatch runs
        behind the ``serve.daemon_rpc`` faultpoint: a fault here kills
        this request — its tenant is quarantined, the daemon and every
        other tenant keep going."""
        from ..obs import trace as otrace
        from ..obs.metrics import REGISTRY
        from ..resilience.faults import faultpoint
        tid = payload.get("tenant") or (qs.get("tid") or [None])[0]
        otrace.log(2, f"serve daemon: {method} /{op}"
                      + (f" tid={tid}" if tid else ""), err=True)
        otrace.event("serve.rpc", op=op,
                     **({"tenant": tid} if tid else {}))
        try:
            faultpoint("serve.daemon_rpc", key=tid if tid else op)
        except Exception as e:
            q = False
            if tid:
                with self._lock:
                    q = self.driver.quarantine(
                        tid, f"daemon rpc fault: {e!r:.200}")
            REGISTRY.counter("serve.rpc_faults").inc()
            otrace.event("serve.rpc_fault", op=op,
                         **({"tenant": tid} if tid else {}))
            otrace.log(1, f"serve daemon: RPC fault on /{op}"
                          + (f" — tenant {tid} quarantined" if q else ""),
                       err=True)
            return 500, {"error": repr(e), "quarantined": q}, None
        try:
            return self._dispatch(method, op, qs, payload, tid)
        except Exception as e:
            REGISTRY.counter("serve.rpc_errors").inc()
            otrace.log(1, f"serve daemon: /{op} failed ({e!r})",
                       err=True)
            return 500, {"error": repr(e)}, None

    def _dispatch(self, method: str, op: str, qs: dict, payload: dict,
                  tid):
        d = self.driver
        if op == "submit" and method == "POST":
            b64 = payload.get("npz_b64")
            with self._lock:
                if b64:
                    mesh, met = d.stage_payload(decode_npz(b64))
                    got, reason = d.try_submit(
                        mesh=mesh, met=met, tenant=payload.get("tenant"))
                else:
                    got, reason = d.try_submit(
                        path=payload.get("path"),
                        sol=payload.get("sol"),
                        tenant=payload.get("tenant"))
            if got is None:
                return 429, {"error": reason, "deferred": True}, None
            return 200, {"tid": got}, None
        if op == "poll":
            with self._lock:
                if tid is None or tid not in d.requests:
                    return 404, {"error": f"unknown request {tid!r}"}, \
                        None
                return 200, d.poll(tid), None
        if op == "fetch":
            with self._lock:
                if tid is None or tid not in d.requests:
                    return 404, {"error": f"unknown request {tid!r}"}, \
                        None
                try:
                    mesh, met = d.fetch(tid)
                except RuntimeError as e:
                    return 409, {"error": str(e)}, None
                arrays = mesh_arrays(mesh, met)
            return 200, {"tid": tid, "npz_b64": encode_npz(arrays)}, None
        if op == "healthz":
            # lock-free: a liveness probe must answer even while the loop
            # thread holds the driver lock through a long step; the
            # counters are single reads of host values (snapshot-racy,
            # probe-accurate).  ok == the loop can make progress (paused
            # counts: an operator's choice, not a death)
            loop_alive = bool(len(self._threads) > 1
                              and self._threads[1].is_alive())
            out = {"ok": bool((self.paused or loop_alive)
                              and not self._wedged),
                   "paused": self.paused,
                   "loop_alive": loop_alive,
                   "wedged": self._wedged,
                   "steps": d.pool.steps,
                   "active": len(d.pool.active_tenants()),
                   "queue": len(d.queue),
                   "requests": len(d.requests),
                   "quarantined": list(d.pool.quarantined)}
            return 200, out, None
        if op == "metrics":
            from ..obs.metrics import REGISTRY
            return (200, REGISTRY.to_prometheus(),
                    "text/plain; version=0.0.4")
        if op == "report":
            with self._lock:
                rep = d.report(list(d._occupancy_traj))
            return 200, rep, None
        if op == "trace":
            # lock-free, as /healthz: the tracer has a lock of its own
            from ..obs.trace import TRACER
            last = int((qs.get("last") or ["256"])[0])
            recs = list(TRACER.ring)
            return 200, {"summary": TRACER.summary(),
                         "records": recs[max(0, len(recs) - last):]}, None
        if op == "pause" and method == "POST":
            self.paused = True
            return 200, {"paused": True}, None
        if op == "resume" and method == "POST":
            self.paused = False
            return 200, {"paused": False}, None
        if op == "step" and method == "POST":
            with self._lock:
                st = d.service_once()
            return 200, {"state": st}, None
        if op == "shutdown" and method == "POST":
            # respond first, stop from a fresh thread (shutdown joins the
            # HTTP thread — never from inside a handler)
            threading.Thread(target=self.shutdown,
                             name="parmmg-serve-shutdown",
                             daemon=True).start()
            return 200, {"ok": True}, None
        return 404, {"error": f"unknown op {op!r} ({method})"}, None


# ---------------------------------------------------------------------------
# stdlib HTTP plumbing
# ---------------------------------------------------------------------------
class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):        # route through obs
        from ..obs import trace as otrace
        otrace.log(3, "serve daemon http: " + fmt % args, err=True)

    def _route(self, method: str) -> None:
        from urllib.parse import parse_qs, urlsplit
        u = urlsplit(self.path)
        op = u.path.strip("/") or "healthz"
        qs = parse_qs(u.query)
        payload: dict = {}
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            try:
                payload = json.loads(self.rfile.read(n).decode("utf-8"))
            except ValueError:
                payload = {}
        code, body, ctype = self.server.pool_daemon.handle_rpc(
            method, op, qs, payload)
        data = body.encode("utf-8") if isinstance(body, str) \
            else json.dumps(body, default=str).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype or "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")


# ---------------------------------------------------------------------------
# front end: python -m parmmg_tpu_torch.serve.daemon
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    """Run the daemon in the foreground until SIGINT or a /shutdown RPC
    (the counterpart of the JAX package's ``scripts/serve_daemon.py``;
    its ``PARMMG_SERVE_*`` variables are flags here)."""
    import argparse
    import os
    import time

    from ..obs import trace as otrace

    ap = argparse.ArgumentParser(
        prog="python -m parmmg_tpu_torch.serve.daemon",
        description="Serve remeshing requests over HTTP from one pool.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8077,
                    help="bind port (0 = ephemeral)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--cycles", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4,
                    help="slots a bucket")
    ap.add_argument("--chunk", type=int, default=1,
                    help="tenants a dispatch")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="queued requests before submits get 429 "
                         "(0 = unbounded)")
    ap.add_argument("--timeout-s", type=float, default=0.0,
                    help="wall seconds a request (0 = off)")
    ap.add_argument("--step-deadline-s", type=float, default=0.0,
                    help="serving-step watchdog (0 = off)")
    ap.add_argument("--out", default=None,
                    help="directory for each tenant's distributed output")
    ap.add_argument("--paused", action="store_true",
                    help="start with the serving loop paused")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append every trace record to this JSONL file")
    ap.add_argument("-v", "--verbose", action="count", default=0)
    args = ap.parse_args(argv)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.trace:
        otrace.TRACER.configure(args.trace)
    daemon = PoolDaemon(host=args.host, port=args.port,
                        start_paused=args.paused,
                        step_deadline_s=args.step_deadline_s,
                        out_dir=args.out, verbose=args.verbose,
                        timeout_s=args.timeout_s, max_queue=args.max_queue,
                        cycles=args.cycles, slots_per_bucket=args.slots,
                        chunk=args.chunk, device=args.device)
    daemon.start()
    otrace.log(0, f"serve daemon: pid {os.getpid()} on "
                  f"http://{daemon.host}:{daemon.port} "
                  f"(device {daemon.driver.pool.device})", err=True)
    try:
        while daemon.alive():
            time.sleep(0.5)
    except KeyboardInterrupt:
        otrace.log(0, "serve daemon: SIGINT, shutting down", err=True)
        daemon.shutdown()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
