"""The port's tokenizer CLI (``python -m titok_tpu_torch.tools.tokenize``)
against the JAX package's ``tools/tokenize.py`` on the CPU.

Two small mp4 clips written with the port's ``encode_video`` (one larger
than ``max_grid`` and off the patch multiple, so both CLIs cut it) go
through both CLIs' ``encode`` with the same weights: JAX's tiny model (seed
0, its Dense kernels scaled by 4 so that the tokens spread over many FSQ
codes) handed to JAX's CLI in place of its loader, and the same weights
read by the port's CLI from a checkpoint of the port's layout (``--ckpt``).
In f32 the ``.npz`` files hold the same keys and equal values (indices,
grid, fps); ``decode`` writes the same ``_recon.mp4`` names, whose decoded
frames agree within 2 of 255 (the recon within 1e-4 on [-1, 1] before the
mpeg4 encoder). ``--quant`` runs; an EMA-VQ config whose checkpoint has no
codebook raises."""

import argparse
import importlib.util
import os
from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.tree_util as jtu  # noqa: E402

from tests.reference_native import reference_native_lib  # noqa: E402, F401
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import tiny_config  # noqa: E402
from titok_tpu_torch.data.video_reader import VideoReader, encode_video  # noqa: E402
from titok_tpu_torch.tools import tokenize  # noqa: E402
from titok_tpu_torch.weights import from_flax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = 6


def _jax_tokenize():
    """The JAX package's ``tools/tokenize.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_tokenize", os.path.join(REPO, "tools", "tokenize.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's CLI with its loader returning JAX's tiny model (seed 0, Dense
    kernels x4), the tiny config as YAML, a port checkpoint of the same
    weights, and two clips."""
    tmp = tmp_path_factory.mktemp("tok")
    cfg = tiny_config()
    cfg_path = str(tmp / "tiny.yaml")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_yaml())
    jt = _jax_tokenize()
    jcfg, jm = jt._load_model(cfg_path, None, TOKENS, [])
    jm.params = jtu.tree_map_with_path(
        lambda p, x: x * 4.0 if jtu.keystr(p).endswith("['kernel']") else x, jm.params)
    ckpt = tmp / "ckpt" / "1"
    ckpt.mkdir(parents=True)
    gen = {k: torch.tensor(v) for k, v in
           from_flax_params(jax.tree.map(np.asarray, jm.params)).items()}
    torch.save({"step": 1, "gen": gen, "disc": {}}, ckpt / "state.pt")
    jt._load_model = mock.Mock(return_value=(jcfg, jm))
    rng = np.random.default_rng(0)
    clips = []
    for name, thw in (("a", (4, 16, 16)), ("b", (6, 20, 18))):
        path = str(tmp / f"{name}.mp4")
        encode_video(path, rng.integers(0, 256, (*thw, 3), dtype=np.uint8), fps=6.0)
        clips.append(path)
    return jt, cfg_path, str(ckpt), clips, tmp


def _args(cmd, inputs, cfg_path, out, **kw):
    base = {"inputs": inputs, "config": cfg_path, "ckpt": None, "out": out, "quant": None,
            "overrides": [], "tokens": TOKENS}
    return argparse.Namespace(cmd=cmd, **{**base, **kw})


def test_cli_round_trip_matches_jax(setup):
    jt, cfg_path, ckpt, clips, tmp = setup
    jout, pout = str(tmp / "jax_tok"), str(tmp / "port_tok")
    jt.encode_cmd(_args("encode", clips, cfg_path, jout))
    tokenize.main(["encode", *clips, "--config", cfg_path, "--ckpt", ckpt, "--out", pout,
                   "--tokens", str(TOKENS), "--device", "cpu"])
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(pout)) == ["a.npz", "b.npz"]
    for name in names:
        with np.load(os.path.join(jout, name)) as j, np.load(os.path.join(pout, name)) as p:
            assert sorted(j.files) == sorted(p.files) == ["fps", "grid", "indices"]
            for key in j.files:
                assert p[key].dtype == j[key].dtype, (name, key)
                np.testing.assert_array_equal(p[key], j[key], err_msg=f"{name} {key}")
            assert p["indices"].shape == (TOKENS,)
            np.testing.assert_array_equal(p["grid"], (4, 16, 16))  # cut to max_grid

    jrec, prec = str(tmp / "jax_rec"), str(tmp / "port_rec")
    toks = [os.path.join(pout, n) for n in names]
    jt.decode_cmd(_args("decode", toks, cfg_path, jrec))
    tokenize.main(["decode", *toks, "--config", cfg_path, "--ckpt", ckpt, "--out", prec,
                   "--device", "cpu"])
    assert sorted(os.listdir(jrec)) == sorted(os.listdir(prec)) == ["a_recon.mp4", "b_recon.mp4"]
    for name in sorted(os.listdir(prec)):
        with VideoReader(os.path.join(prec, name)) as p, VideoReader(os.path.join(jrec, name)) as j:
            assert len(p) == len(j) == 4 and p.fps == j.fps
            a, b = (r.get_batch(list(range(4))).astype(np.int16) for r in (p, j))
            assert int(np.abs(a - b).max()) <= 2, name


def test_functions_below_the_file_io(setup):
    """``encode_clip`` and ``decode_tokens`` (what ``chip_smoke.py`` drives
    without libav) equal JAX's model calls inside its CLI."""
    jt, cfg_path, ckpt, clips, _ = setup
    cfg, model = tokenize.load_model(cfg_path, ckpt, device="cpu")
    _, jm = jt._load_model(cfg_path, None, TOKENS, [])
    assert len(np.unique(tokenize.encode_clip(model, tokenize.read_clip(clips[0], cfg)[0],
                                              64)[0])) > 8  # the tokens spread
    vid, fps = tokenize.read_clip(clips[1], cfg)
    jvid, jfps = jt._read_clip(clips[1], cfg)
    np.testing.assert_array_equal(vid, jvid)
    assert fps == jfps
    idx, grid = tokenize.encode_clip(model, vid, TOKENS)
    np.testing.assert_array_equal(idx, jm.encode([jvid], [TOKENS])[0])
    frames = tokenize.decode_tokens(model, idx, grid)
    want = jm.decode_indices([idx], grids=[tuple(grid)])[0]
    want = ((np.clip(want, -1, 1) + 1) / 2 * 255).astype(np.uint8).transpose(1, 2, 3, 0)
    assert frames.shape == want.shape == (4, 16, 16, 3) and frames.dtype == np.uint8
    assert int(np.abs(frames.astype(np.int16) - want).max()) <= 1


def test_quant_and_missing_codebook(setup, tmp_path):
    """``--quant w8a8`` encodes; a ``quantizer: vq`` config over a
    checkpoint without a codebook raises, as JAX's CLI does."""
    _, cfg_path, ckpt, clips, _ = setup
    out = str(tmp_path / "q")
    tokenize.main(["encode", clips[0], "--config", cfg_path, "--ckpt", ckpt, "--out", out,
                   "--quant", "w8a8", "--tokens", str(TOKENS), "--device", "cpu"])
    with np.load(os.path.join(out, "a.npz")) as f:
        assert f["indices"].shape == (TOKENS,) and f["indices"].dtype == np.int32
    with pytest.raises(RuntimeError, match="no vq_state but the config selects quantizer: vq"):
        tokenize.main(["encode", clips[0], "--config", cfg_path, "--ckpt", ckpt, "--out", out,
                       "--set", "tokenizer.model.quantizer=vq", "--device", "cpu"])
