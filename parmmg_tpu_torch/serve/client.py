"""HTTP client for the pool daemon (serve/daemon.py; the port's copy of
``serve/client.py``).

Deliberately light — stdlib + numpy only, no torch: a serving client must
run anywhere (a solver loop, a CI gate, a laptop) while the daemon owns
the card.  Mesh arrays ride base64 npz both ways, so a fetched result is
byte-equal to what the daemon's slot computed.

    from parmmg_tpu_torch.serve.client import ServeClient
    cl = ServeClient(port=8077)
    tid = cl.submit(vert=vert, tet=tet, met=met, tenant="job-42")
    cl.wait(tid)
    arrays = cl.fetch(tid)          # {mesh field: np.ndarray, "met": ...}

``submit`` raises :class:`BackpressureDeferred` on HTTP 429 (the
admission controller is deferring — retry later); every other non-2xx
raises :class:`ServeDaemonError` with the status and decoded body.
"""
from __future__ import annotations

import base64
import io
import json
import time

import numpy as np

__all__ = ["BackpressureDeferred", "ServeClient", "ServeDaemonError"]


class ServeDaemonError(RuntimeError):
    """Non-2xx daemon response (status + decoded body attached)."""

    def __init__(self, status: int, body):
        self.status = int(status)
        self.body = body
        super().__init__(f"daemon RPC failed ({status}): {body}")


class BackpressureDeferred(ServeDaemonError):
    """HTTP 429: admission deferred (queue full / autoscale latch) —
    the request was NOT enqueued; retry later."""


class ServeClient:
    """Thin submit/poll/fetch client over the daemon's RPC surface."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8077,
                 timeout_s: float = 60.0):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)

    # ---- transport --------------------------------------------------------
    def _rpc(self, method: str, path: str, payload: dict | None = None):
        import http.client
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            body = None if payload is None else json.dumps(payload)
            headers = {"Content-Type": "application/json"} if body \
                else {}
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            ctype = resp.getheader("Content-Type") or ""
            out = {}
            if data:
                out = json.loads(data) if "json" in ctype \
                    else data.decode("utf-8", "replace")
            if resp.status == 429:
                raise BackpressureDeferred(resp.status, out)
            if resp.status >= 400:
                raise ServeDaemonError(resp.status, out)
            return out
        finally:
            conn.close()

    @staticmethod
    def _tid_qs(tid: str) -> str:
        from urllib.parse import quote
        return quote(str(tid), safe="")

    # ---- request lifecycle ------------------------------------------------
    def submit(self, vert=None, tet=None, met=None, vref=None,
               tref=None, tenant: str | None = None,
               path: str | None = None, sol: str | None = None) -> str:
        """Submit a tenant mesh: raw arrays (vert/tet[/met][/refs],
        shipped bit-exact as npz and staged daemon-side) or a
        daemon-visible file ``path`` (+ optional ``sol``).  Returns the
        request/tenant id."""
        payload: dict = {}
        if tenant is not None:
            payload["tenant"] = str(tenant)
        if path is not None:
            payload["path"] = str(path)
            if sol is not None:
                payload["sol"] = str(sol)
        else:
            arrays = {"vert": np.asarray(vert), "tet": np.asarray(tet)}
            for k, v in (("met", met), ("vref", vref), ("tref", tref)):
                if v is not None:
                    arrays[k] = np.asarray(v)
            buf = io.BytesIO()
            np.savez_compressed(buf, **arrays)
            payload["npz_b64"] = base64.b64encode(
                buf.getvalue()).decode("ascii")
        return self._rpc("POST", "/submit", payload)["tid"]

    def poll(self, tid: str) -> dict:
        return self._rpc("GET", f"/poll?tid={self._tid_qs(tid)}")

    def wait(self, tid: str, timeout_s: float = 600.0,
             interval_s: float = 0.05) -> dict:
        """Poll until the request reaches a terminal state; returns the
        final poll payload.  Raises TimeoutError past ``timeout_s``."""
        t0 = time.monotonic()
        while True:
            got = self.poll(tid)
            if got["state"] not in ("queued", "running"):
                return got
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(
                    f"request {tid} still {got['state']} after "
                    f"{timeout_s}s")
            time.sleep(interval_s)

    def fetch(self, tid: str) -> dict:
        """Merged result of a DONE request as
        {mesh field: np.ndarray, "met": np.ndarray} — bit-identical to
        the daemon-side merge."""
        got = self._rpc("GET", f"/fetch?tid={self._tid_qs(tid)}")
        raw = base64.b64decode(got["npz_b64"].encode("ascii"))
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    # ---- ops surface ------------------------------------------------------
    def health(self) -> dict:
        return self._rpc("GET", "/healthz")

    def metrics_text(self) -> str:
        return self._rpc("GET", "/metrics")

    def report(self) -> dict:
        return self._rpc("GET", "/report")

    def trace(self, last: int = 256) -> dict:
        """The daemon's trace ring: ``{"summary", "records"}`` with the
        newest ``last`` records."""
        return self._rpc("GET", f"/trace?last={int(last)}")

    def pause(self) -> dict:
        return self._rpc("POST", "/pause")

    def resume(self) -> dict:
        return self._rpc("POST", "/resume")

    def step(self) -> dict:
        """Run exactly one serving-loop iteration (deterministic tests
        against a paused daemon)."""
        return self._rpc("POST", "/step")

    def shutdown(self) -> dict:
        return self._rpc("POST", "/shutdown")
