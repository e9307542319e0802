"""Closed-loop HTTP load on the port's server, clients in a process of
their own (counterpart of ``scripts/probe_serve_load.py``).

    python -m vsearch_tpu_torch.scripts.probe_serve_load [--duration 10]
        [--phases 1x1,8x1,32x1,8x8,32x8,32x32,4x4r,16x4r] [--device cpu]

Starts ``probe_serve_server`` (BERT-base VDR over a 200,000-passage
bag-of-token index) as a child process that owns the card, then, from
this process, drives phases of W closed-loop client threads, each sending
batch-B ``/search`` requests (k = 100; ``r``: with rerank) for
``--duration`` seconds: queries/s over the phase's active window,
request p50/p99 ms and errors. Also the ``/healthz`` round trip (the bare
HTTP stack) and, from ``/stats``, the coalescer's device calls against
the requests: the trace shape ROADMAP R2 asks for. Threads, not
processes: a client spends its life blocked on its socket. On the CPU
the rates and latencies are not reported (None): they would be the
host's.
"""
from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.request

from . import common
from .probe_serve_server import add_model_args

WORDS = ("green tea mars planet einstein relativity city river "
         "history music film president language science computer "
         "network model train retrieval document term weight score "
         "rank vector binary lexical university book island energy"
         ).split()
PHASES = "1x1,8x1,32x1,8x8,32x8,32x32,4x4r,16x4r"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _post(url, payload, timeout=300):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def worker(url: str, batch: int, rerank: bool, duration: float, wid: int,
           out: dict) -> None:
    """One closed-loop client: batch-B requests until the deadline, its
    latencies and its own active window."""
    rng = random.Random(1234 + wid)
    lats, errors = [], 0
    t_start = time.perf_counter()
    deadline = t_start + duration
    while time.perf_counter() < deadline:
        qs = [" ".join(rng.choices(WORDS, k=10)) for _ in range(batch)]
        t0 = time.perf_counter()
        try:
            _post(url + "/search", {"queries": qs, "k": 100,
                                    "rerank": rerank, "tenant": f"w{wid}"})
            lats.append((time.perf_counter() - t0) * 1e3)
        except Exception:  # noqa: BLE001 - counted, as the JAX probe does
            errors += 1
    out[wid] = {"lats_ms": lats, "errors": errors, "t_start": t_start,
                "t_end": time.perf_counter()}


def run_phase(url: str, conc: int, batch: int, rerank: bool,
              duration: float, timed: bool) -> dict:
    out: dict = {}
    threads = [threading.Thread(target=worker, args=(
        url, batch, rerank, duration, w, out)) for w in range(conc)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration + 600)
    lats = sorted(x for d in out.values() for x in d["lats_ms"])
    window = (max(d["t_end"] for d in out.values())
              - min(d["t_start"] for d in out.values()))
    n = len(lats)

    def pct(p):
        return lats[min(n - 1, int(p * n))] if n and timed else None

    return {"conc": conc, "batch": batch, "rerank": rerank, "requests": n,
            "errors": sum(d["errors"] for d in out.values()),
            "qps": n * batch / window if timed else None,
            "req_p50_ms": pct(0.50), "req_p99_ms": pct(0.99)}


def parse_phases(spec: str):
    """"8x4r" -> (8 clients, batch 4, rerank)."""
    for part in (p for p in spec.split(",") if p):
        conc, batch = part.rstrip("r").split("x")
        yield int(conc), int(batch), part.endswith("r")


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--duration", type=float, default=10.0)
        ap.add_argument("--phases", default=PHASES)
        ap.add_argument("--ready-timeout", type=float, default=1800.0)
        add_model_args(ap)

    args, dev, out = common.start(__doc__, argv, add)
    timed = dev.type == "cuda"
    cmd = [sys.executable, "-m", "vsearch_tpu_torch.scripts."
           "probe_serve_server", "--port", "0", "--device", args.device]
    for name in ("num_passages", "layers", "hidden", "heads",
                 "intermediate", "warmup_max", "seed"):
        cmd += [f"--{name.replace('_', '-')}", str(getattr(args, name))]
    srv = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + args.ready_timeout
        line = ""
        while time.time() < deadline:
            line = srv.stdout.readline()
            if line.startswith("READY") or srv.poll() is not None:
                break
        if not line.startswith("READY"):
            raise RuntimeError("the server child never became ready")
        url = f"http://127.0.0.1:{int(line.split()[1])}"
        _get(url + "/healthz")
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            _get(url + "/healthz")
        rtt = (time.perf_counter() - t0) / reps * 1e3
        calls0 = _get(url + "/stats").get("coalesced_device_calls", 0)
        phases, requests = [], 0
        for conc, batch, rerank in parse_phases(args.phases):
            ph = run_phase(url, conc, batch, rerank, args.duration, timed)
            phases.append(ph)
            requests += ph["requests"]
            # drain the coalescer's backlog before the next phase
            time.sleep(min(2.0, args.duration))
            _post(url + "/search", {"queries": ["drain sentinel"], "k": 10,
                                    "rerank": False})
            requests += 1
        stats = _get(url + "/stats")
        calls = stats.get("coalesced_device_calls")
        out.update({
            "num_passages": args.num_passages,
            "healthz_rtt_ms": rtt,
            "client": "threads in a process of their own",
            "phases": phases, "server_stats": stats,
            "device_calls_per_request": (
                None if calls is None
                else (calls - calls0) / max(requests, 1))})
    finally:
        srv.send_signal(signal.SIGTERM)
        try:
            srv.wait(timeout=60)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
