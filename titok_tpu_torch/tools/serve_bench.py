"""Load bench of the HTTP serving host: throughput, latency, batching
factor (the port of the JAX package's ``tools/serve_bench.py``).

It starts ``tools/serve.py``'s server in this process (the same
``ThreadingHTTPServer`` and service objects a deployment runs), fires
concurrent npz-over-HTTP requests from N client threads, and prints one
JSON line:

    {"op": "forward", "clients": 8, "requests": 64, "clips_per_sec": ...,
     "p50_ms": ..., "p95_ms": ..., "device_calls": ..., "clips_per_call": ...}

``clips_per_call`` is the cross-request batching factor: 1.0 with
``--window-ms 0`` (one device call a request); with a window, concurrent
clips share budget-sized packed calls (``BatchingTokenizerService``).
Latencies are host-clock times of whole requests (the program's outputs
are copied back to the host before a reply, so each ends after its device
work).

Usage::

    python -m titok_tpu_torch.tools.export_model --config configs/tiny.yaml \\
        --ckpt out_ckpt/12000 --out exported/
    python -m titok_tpu_torch.tools.serve_bench --artifacts exported/ \\
        --clients 8 --requests 64 --window-ms 20
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
import urllib.request

import numpy as np


def _clip(rng: np.random.Generator, thw, uint8: bool) -> np.ndarray:
    t, h, w = thw
    if uint8:  # THWC wire format: a quarter of the bytes of f32 CTHW
        return rng.integers(0, 256, size=(t, h, w, 3), dtype=np.uint8)
    return rng.uniform(-1.0, 1.0, size=(3, t, h, w)).astype(np.float32)


def _post(url: str, **arrays) -> dict:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req) as r:
        return dict(np.load(io.BytesIO(r.read())))


def run_bench(artifacts: str, op: str = "forward", clients: int = 8, requests: int = 64,
              thw=(8, 128, 128), tokens: int = 64, window_ms: float = 20.0,
              uint8: bool = True, warmup: int = 1) -> dict:
    """Serve ``artifacts`` on a free local port and fire ``requests``
    requests of ``op`` from ``clients`` threads, each with its own seeded
    clip; returns the JSON line's fields."""
    from titok_tpu_torch.tools.serve import make_server

    server = make_server(artifacts, port=0, window_ms=window_ms)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{port}/{op}"
    try:
        rng = np.random.default_rng(0)
        body = {"video": _clip(rng, thw, uint8), "tokens": tokens}
        if op == "decode":
            out = _post(f"http://127.0.0.1:{port}/encode", **body)
            body = {"indices": out["indices"], "grid": out["grid"]}
        for _ in range(warmup):  # first-call costs out of the timing
            _post(url, **body)
        calls0 = server.service.device_calls

        latencies: list[float] = []
        errors: list[str] = []
        lock = threading.Lock()
        # requests spread over the clients, the remainder to the first few:
        # the total fired always equals the flag
        shares = [requests // clients + (1 if i < requests % clients else 0)
                  for i in range(clients)]
        start = threading.Barrier(clients + 1)

        def client(seed: int, count: int):
            mine = dict(body)
            if op != "decode":
                mine["video"] = _clip(np.random.default_rng(seed), thw, uint8)
            start.wait()
            for _ in range(count):
                t0 = time.perf_counter()
                try:
                    _post(url, **mine)
                except Exception as e:  # noqa: BLE001 — recorded, not raised
                    with lock:
                        errors.append(str(e))
                    continue
                dt = time.perf_counter() - t0
                with lock:
                    latencies.append(dt)

        threads = [threading.Thread(target=client, args=(i, shares[i])) for i in range(clients)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        calls = server.service.device_calls - calls0
    finally:
        server.shutdown()
        server.server_close()
        server.service.close()

    n = len(latencies)
    lat = sorted(latencies) or [float("nan")]
    return {
        "op": op,
        "quant": server.service.meta.get("quant"),
        "device": server.service.meta["device"],
        "clients": clients,
        "requests": sum(shares),
        "ok": n,
        "errors": errors[:3],
        "window_ms": window_ms,
        "clip_thw": list(thw),
        "tokens": tokens,
        "wall_s": round(wall, 3),
        "clips_per_sec": round(n / wall, 2) if wall > 0 else 0.0,
        "p50_ms": round(1e3 * lat[n // 2], 1),
        "p95_ms": round(1e3 * lat[min(n - 1, int(n * 0.95))], 1),
        "device_calls": calls,
        "clips_per_call": round(n / calls, 2) if calls else 0.0,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifacts", required=True)
    ap.add_argument("--op", choices=("forward", "encode", "decode"), default="forward")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--clip", default="8x128x128", help="TxHxW of each request's clip")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--window-ms", type=float, default=20.0)
    ap.add_argument("--f32-wire", action="store_true",
                    help="send float32 CTHW instead of uint8 THWC")
    args = ap.parse_args(argv)
    thw = tuple(int(x) for x in args.clip.split("x"))
    res = run_bench(args.artifacts, op=args.op, clients=args.clients, requests=args.requests,
                    thw=thw, tokens=args.tokens, window_ms=args.window_ms,
                    uint8=not args.f32_wire)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
