"""HTTP serving host for exported tokenizer programs: the port of the JAX
package's ``tools/serve.py``.

``tools/export_model.py`` traces the model into ``torch.export`` programs
with the weights baked in; this host serves them with no model code, no
config and no checkpoint: torch and the custom ops to run the programs
(``load_exported``), and the packer (``data/packing.py``) to build the
fixed-shape batch the programs were exported for (``meta.json`` carries
its shape).

Protocol: npz bodies over HTTP. Videos are float32 CTHW in [-1, 1] (the
reference's wire format) or uint8 THWC (a quarter of the bytes; the
packer normalizes them):

    POST /encode   npz{video, tokens}          -> npz{indices, grid}
    POST /decode   npz{indices, grid}          -> npz{video}
    POST /forward  npz{video, tokens}          -> npz{video, indices}
    GET  /healthz                              -> meta.json

A malformed request gets 400, a failure of the device or the program 500.

Usage::

    python -m titok_tpu_torch.tools.serve --artifacts exported/ --port 8600 \\
        [--batch-window-ms 20]

    # client
    import io, urllib.request, numpy as np
    buf = io.BytesIO(); np.savez(buf, video=vid, tokens=16)
    r = urllib.request.urlopen("http://localhost:8600/encode", buf.getvalue())
    out = np.load(io.BytesIO(r.read()))
    out["indices"], out["grid"]

By default each request runs its own device call (serialized by a lock).
With ``--batch-window-ms > 0``, concurrent requests arriving within the
window are packed into one budget-sized device call: the packing the
trainer uses for variable-shape clips is also the serving batcher.

Grad mode is a thread's own: the request and dispatch threads do not
inherit the main thread's ``no_grad``, so every program call here runs
under its own ``torch.no_grad()``.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import queue
import threading
import time

import numpy as np
import torch

from titok_tpu_torch.data.packing import (
    GridOnly,
    pack_samples,
    sample_offsets,
    to_device,
    unpack_indices,
    unpack_videos,
    video_dims,
)


class TokenizerService:
    """The exported programs with pack and unpack around them."""

    def __init__(self, artifacts_dir: str):
        from titok_tpu_torch.tools.export_model import load_exported

        self.forward, self.decode, self.meta = load_exported(artifacts_dir)
        self.device = torch.device(self.meta["device"])
        self._lock = threading.Lock()
        self.device_calls = 0  # forwards + decodes dispatched

    def _cost(self, video, tokens: int) -> int:
        """Budget slots this clip needs; raises ``ValueError`` on a clip the
        programs cannot serve. Takes float CTHW in [-1, 1] or uint8 THWC."""
        ps = list(self.meta["patch_size"])
        dims = video_dims(video)
        if any(d % p for d, p in zip(dims, ps)):
            raise ValueError(f"grid {dims} not divisible by patch {ps}")
        cost = math.prod(d // p for d, p in zip(dims, ps)) + int(tokens)
        if cost > self.meta["seq_len"]:
            raise ValueError(f"clip needs {cost} slots > exported budget {self.meta['seq_len']}")
        return cost

    def _pack_group(self, videos, tokens):
        m = self.meta
        return pack_samples(
            [v if (isinstance(v, GridOnly) or v.dtype == np.uint8) else np.asarray(v, np.float32)
             for v in videos],
            [int(t) for t in tokens],
            seq_len=m["seq_len"], max_samples=m["max_samples"],
            patch_size=list(m["patch_size"]), head_dim=m["head_dim"])

    def _run(self, program, *args):
        """One device call of ``program``, under the lock and ``no_grad``."""
        with self._lock, torch.no_grad():
            self.device_calls += 1
            return program(*args)

    # -- grouped execution (one device call for N clips) -------------------
    def forward_group(self, videos, tokens):
        """``[(recon, indices)]`` for up to a budget's worth of clips."""
        for v, t in zip(videos, tokens):
            self._cost(v, t)
        batch = self._pack_group(videos, tokens)
        recon, idx = self._run(self.forward, to_device(batch, self.device))
        vids = unpack_videos(recon.to(torch.float32).cpu().numpy(), batch,
                             list(self.meta["patch_size"]))
        idxs = unpack_indices(idx.cpu().numpy(), batch)
        return list(zip(vids[: len(videos)], idxs[: len(videos)]))

    def decode_group(self, indices_list, grids):
        """``[video]`` for up to a budget's worth of (indices, grid) pairs."""
        dummies = [GridOnly(grid, self.meta["in_channels"]) for grid in grids]
        for d, ix in zip(dummies, indices_list):
            self._cost(d, len(ix))
        batch = self._pack_group(dummies, [len(ix) for ix in indices_list])
        offs = sample_offsets(batch.token_counts, batch.grid_sizes)
        flat = np.zeros((batch.seq_len,), np.int32)
        for j, ix in enumerate(indices_list):
            flat[offs[j]: offs[j] + len(ix)] = np.asarray(ix, np.int32)
        recon = self._run(self.decode, torch.from_numpy(flat).to(self.device),
                          to_device(batch, self.device))
        return unpack_videos(recon.to(torch.float32).cpu().numpy(), batch,
                             list(self.meta["patch_size"]))[: len(grids)]

    # -- single-clip API ----------------------------------------------------
    def encode_clip(self, video, tokens: int) -> np.ndarray:
        return self.forward_group([video], [tokens])[0][1]

    def forward_clip(self, video, tokens: int):
        return self.forward_group([video], [tokens])[0]

    def decode_clip(self, indices, grid) -> np.ndarray:
        return self.decode_group([indices], [grid])[0]

    def close(self) -> None:
        """Release what the service runs beside the programs (nothing here)."""


# the queue item that stops a BatchingTokenizerService's dispatch thread
_STOP = ("stop", None, 0, None, None)


class BatchingTokenizerService(TokenizerService):
    """Cross-request batching: requests arriving within ``window_ms`` of
    each other are packed into one budget-sized device call. Throughput
    scales with clips a budget; a request waits at most the window plus the
    shared call."""

    def __init__(self, artifacts_dir: str, window_ms: float = 0.0):
        super().__init__(artifacts_dir)
        self.window_s = float(window_ms) / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._holdover = None  # the item that did not fit the last group
        threading.Thread(target=self._dispatch_loop, daemon=True).start()

    # public API: validate in the request thread, then enqueue and wait
    def _submit(self, op: str, payload, cost: int):
        done = threading.Event()
        slot: dict = {}
        self._queue.put((op, payload, cost, done, slot))
        done.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def encode_clip(self, video, tokens):
        return self._submit("fwd", (video, tokens), self._cost(video, tokens))[1]

    def forward_clip(self, video, tokens):
        return self._submit("fwd", (video, tokens), self._cost(video, tokens))

    def decode_clip(self, indices, grid):
        cost = self._cost(GridOnly(grid, self.meta["in_channels"]), len(indices))
        return self._submit("dec", (indices, grid), cost)

    def _gather_group(self):
        """Block for one item, then collect items of the same op that arrive
        within the window while the group fits the budget; None once the
        service is closed."""
        first = self._holdover or self._queue.get()
        self._holdover = None
        if first is _STOP:
            return None
        op, group, used = first[0], [first], first[2]
        deadline = time.monotonic() + self.window_s
        while len(group) < self.meta["max_samples"]:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item[0] != op or used + item[2] > self.meta["seq_len"]:
                self._holdover = item  # starts the next group
                break
            group.append(item)
            used += item[2]
        return op, group

    def close(self) -> None:
        """Stop the dispatch thread once the requests queued before are served."""
        self._queue.put(_STOP)

    def _dispatch_loop(self):
        while (gathered := self._gather_group()) is not None:
            op, group = gathered
            try:
                run = self.forward_group if op == "fwd" else self.decode_group
                outs = run([g[1][0] for g in group], [g[1][1] for g in group])
                for (_, _, _, done, slot), out in zip(group, outs):
                    slot["out"] = out
                    done.set()
            except Exception as e:  # noqa: BLE001 — handed to each waiting request
                for _, _, _, done, slot in group:
                    slot["err"] = e
                    done.set()


def _npz(body: bytes) -> dict:
    return dict(np.load(io.BytesIO(body)))


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def make_server(artifacts_dir: str, port: int = 0, window_ms: float = 0.0):
    """Build (but do not start) the HTTP server on 127.0.0.1, with
    ``.service`` attached. ``port=0`` picks a free port
    (``server.server_address[1]``). ``window_ms > 0`` batches concurrent
    requests into shared device calls (one request thread each under
    ``ThreadingHTTPServer``; they block on the shared dispatch)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if window_ms > 0:
        service = BatchingTokenizerService(artifacts_dir, window_ms)
    else:
        service = TokenizerService(artifacts_dir)

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, body: bytes, ctype: str = "application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, json.dumps(service.meta).encode(), "application/json")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = _npz(self.rfile.read(n))
                if self.path == "/encode":
                    idx = service.encode_clip(req["video"], int(req["tokens"]))
                    grid = np.asarray(video_dims(req["video"]), np.int32)
                    out = _npz_bytes(indices=idx, grid=grid)
                elif self.path == "/decode":
                    out = _npz_bytes(video=service.decode_clip(req["indices"], req["grid"]))
                elif self.path == "/forward":
                    vid, idx = service.forward_clip(req["video"], int(req["tokens"]))
                    out = _npz_bytes(video=vid, indices=idx)
                else:
                    self._reply(404, b"not found", "text/plain")
                    return
                self._reply(200, out)
            except (ValueError, KeyError) as e:  # malformed request
                self._reply(400, str(e).encode(), "text/plain")
            except Exception as e:  # noqa: BLE001 — device or program failure: retryable
                self._reply(500, str(e).encode(), "text/plain")

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.service = service
    return server


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifacts", required=True,
                    help="directory written by titok_tpu_torch.tools.export_model")
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="batch concurrent requests arriving within this window into one "
                         "packed device call (0 = off)")
    args = ap.parse_args(argv)
    server = make_server(args.artifacts, args.port, args.batch_window_ms)
    meta = server.service.meta
    print(f"serving {args.artifacts} (budget {meta['seq_len']}, quant {meta.get('quant')}, "
          f"{meta['device']}) on http://127.0.0.1:{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
