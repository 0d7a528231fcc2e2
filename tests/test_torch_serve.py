"""The port's HTTP serving host (``titok_tpu_torch/tools/serve.py``) and its
load bench (``tools/serve_bench.py``) over exported programs, on the CPU:
the cases of ``tests/test_serve.py``.

The tiny model of ``tests/test_serve.py`` (``tiny_config``, f32, seq 256,
``min_grid`` (4,16,16)) built by the JAX package and carried over with
``weights.from_flax_params``; its attention through the kernels' ops. One
export serves every server here. Held: ``/healthz``; ``/encode``,
``/decode`` and ``/forward`` equal to the live port model (indices exact,
videos within 1e-4, as ``tests/test_serve.py``), and the served indices
equal to JAX's ``TiTokModel.encode`` on the same weights; the uint8 wire;
batched serving equal to single serving in fewer device calls; the bench
tool; 400 on a client error."""

import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import tiny_config  # noqa: E402
from titok_tpu.models.titok import TiTokModel as JTiTokModel  # noqa: E402
from titok_tpu.models.titok import make_titok as j_make_titok  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.models.titok import TiTokModel, make_titok  # noqa: E402
from titok_tpu_torch.tools.export_model import export_model  # noqa: E402
from titok_tpu_torch.tools.serve import make_server  # noqa: E402
from titok_tpu_torch.tools.serve_bench import run_bench  # noqa: E402
from titok_tpu_torch.weights import from_flax_params  # noqa: E402


def _start(art: str, window_ms: float = 0.0):
    server = make_server(art, port=0, window_ms=window_ms)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server) -> None:
    server.shutdown()
    server.server_close()
    server.service.close()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``(JAX model, port model, artifact dir, base url)`` of a server over
    one export, at window 0."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as one_torch_thread, which a module fixture runs before
    try:
        jcfg = tiny_config()
        jm = JTiTokModel(j_make_titok(jcfg), seq_len=256, min_grid=(4, 16, 16))
        cfg = Config(jcfg.to_dict())
        cfg.set_dotted("training.main.attn_impl", "auto")
        port = TiTokModel(make_titok(cfg), params=from_flax_params(jax.tree.map(np.asarray,
                                                                                jm.params)),
                          seq_len=256, min_grid=(4, 16, 16), device="cpu")
        art = str(tmp_path_factory.mktemp("artifacts"))
        export_model(port.module, port._dummy_batch(), art)
        server, base = _start(art)
    finally:
        torch.set_num_threads(n)
    yield jm, port, art, base
    _stop(server)


def _post(url: str, **arrays) -> dict:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with urllib.request.urlopen(url, buf.getvalue(), timeout=300) as r:
        return dict(np.load(io.BytesIO(r.read())))


def test_healthz(served):
    *_, base = served
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        meta = json.loads(r.read())
    assert meta["seq_len"] == 256 and "max_samples" in meta and meta["device"] == "cpu"


def test_encode_decode_matches_model(served):
    jm, port, _, base = served
    rng = np.random.default_rng(0)
    vid = rng.random((3, 4, 16, 16), np.float32) * 2 - 1

    out = _post(base + "/encode", video=vid, tokens=5)
    ref_idx = port.encode([vid], [5])[0]
    np.testing.assert_array_equal(out["indices"], ref_idx)
    np.testing.assert_array_equal(out["indices"], jm.encode([vid], [5])[0])
    np.testing.assert_array_equal(out["grid"], vid.shape[1:])

    dec = _post(base + "/decode", indices=out["indices"], grid=out["grid"])
    ref_vid = port.decode_indices([ref_idx], [vid.shape[1:]])[0]
    assert dec["video"].shape == ref_vid.shape
    np.testing.assert_allclose(dec["video"], ref_vid, rtol=1e-4, atol=1e-4)

    fwd = _post(base + "/forward", video=vid, tokens=5)
    np.testing.assert_array_equal(fwd["indices"], ref_idx)
    assert fwd["video"].shape == ref_vid.shape

    # uint8 THWC wire: the same indices as the model on that clip
    u8 = np.clip(np.rint((vid + 1) * 127.5), 0, 255).astype(np.uint8).transpose(1, 2, 3, 0)
    out8 = _post(base + "/encode", video=u8, tokens=5)
    np.testing.assert_array_equal(out8["indices"], port.encode([u8], [5])[0])
    np.testing.assert_array_equal(out8["indices"], jm.encode([u8], [5])[0])
    np.testing.assert_array_equal(out8["grid"], vid.shape[1:])


def test_batched_serving_matches_single(served):
    """window_ms > 0: concurrent requests pack into shared device calls,
    with the single-clip results in fewer device calls."""
    _, port, art, base = served
    server, bbase = _start(art, window_ms=400)
    try:
        rng = np.random.default_rng(2)
        vids = [rng.random((3, 4, 16, 16), np.float32) * 2 - 1 for _ in range(4)]
        _post(bbase + "/encode", video=vids[0], tokens=4)  # warm the program
        calls_before = server.service.device_calls
        with ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(lambda v: _post(bbase + "/encode", video=v, tokens=4), vids))
        calls = server.service.device_calls - calls_before
        assert calls < 4, f"no batching happened ({calls} calls for 4 requests)"
        for v, out, r in zip(vids, outs, port.encode(vids, [4] * 4)):
            np.testing.assert_array_equal(out["indices"], r)
            np.testing.assert_array_equal(out["indices"],
                                          _post(base + "/encode", video=v, tokens=4)["indices"])
    finally:
        _stop(server)


def test_serve_bench_tool(served):
    """The bench runs against a fresh in-process server, completes every
    request, and reports a batching factor."""
    _, _, art, _ = served
    res = run_bench(art, op="forward", clients=4, requests=8, thw=(4, 16, 16), tokens=4,
                    window_ms=300, uint8=True)
    assert res["ok"] == 8 and not res["errors"] and res["device"] == "cpu"
    assert res["clips_per_sec"] > 0 and res["device_calls"] >= 1
    assert res["clips_per_call"] >= 1.0
    assert res["p95_ms"] >= res["p50_ms"] > 0


def test_client_errors_are_400(served):
    *_, base = served
    rng = np.random.default_rng(1)
    for bad in (rng.random((3, 5, 17, 16), np.float32),   # grid not divisible by the patch
                rng.random((3, 64, 64, 64), np.float32)):  # over the budget
        buf = io.BytesIO()
        np.savez(buf, video=bad, tokens=4)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/encode", buf.getvalue(), timeout=60)
        assert ei.value.code == 400
    buf = io.BytesIO()
    np.savez(buf, tokens=4)  # no video
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/forward", buf.getvalue(), timeout=60)
    assert ei.value.code == 400
