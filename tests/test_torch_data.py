"""The port's data layer against the JAX package's on the CPU: the libav
reader and encoder, the swscale crops, the fused packer, the chunk sampler,
the WebDataset and CSV readers (the same batches byte for byte, on the f32,
bf16 and uint8 wires, with 0 and 2 decode threads, in train and eval), the
errors, the converter, the decode hashes ``chip_smoke.py`` prints, and
``Trainer.fit`` on the eval-set tars on the f32 and the uint8 wire.

Inputs: ``docs/eval_set/*.tar`` (read only) and a few clips the port's
``encode_video`` writes under a temporary directory. JAX is called only
for its data functions, which are numpy and its own native library."""

import csv
import itertools
import json
import os
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from chip_smoke import EVAL_SET, EVAL_SET_SHA256, eval_set_sha256  # noqa: E402
from tests.reference_native import reference_native_lib  # noqa: E402, F401
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import tiny_config  # noqa: E402
from titok_tpu.data import chunking as jchunk  # noqa: E402
from titok_tpu.data import packing as jpack  # noqa: E402
from titok_tpu.data import video_reader as jvr  # noqa: E402
from titok_tpu.data.csv_dataset import csv_batches as j_csv_batches  # noqa: E402
from titok_tpu.data.wds_dataset import tarfile_to_samples as j_tarfile_to_samples  # noqa: E402
from titok_tpu.data.wds_dataset import wds_batches as j_wds_batches  # noqa: E402
from titok_tpu_torch.config import Config  # noqa: E402
from titok_tpu_torch.data import _native, chunking, packing, video_reader  # noqa: E402
from titok_tpu_torch.data.convert_to_wds import main as convert_main  # noqa: E402
from titok_tpu_torch.data.csv_dataset import csv_batches  # noqa: E402
from titok_tpu_torch.data.wds_dataset import (  # noqa: E402
    expand_shards,
    tarfile_to_samples,
    wds_batches,
)
from titok_tpu_torch.data.workers import WorkerPool  # noqa: E402
from titok_tpu_torch.training.trainer import Trainer, select_data_backend  # noqa: E402

PATCH = [2, 4, 4]
TARS = os.path.join(EVAL_SET, "{00000..00002}.tar")
FIELDS = ("patches", "segment_ids", "token_mask", "rope_cos", "rope_sin", "token_counts",
          "grid_sizes", "grids", "sample_valid", "fps")
WIRES = {"f32": {}, "bf16": {"training.main.precision": "bf16-mixed"},
         "u8": {"dataset.uint8_wire": True}}


def _gradient_clip(t=16, h=48, w=64):
    """A smooth clip, so that the lossy codec's round trip stays close."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([np.stack([(xx * 255 / w).astype(np.uint8), (yy * 255 / h).astype(np.uint8),
                               np.full((h, w), i * 255 // t, np.uint8)], -1) for i in range(t)])


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Clips the port's encoder writes: ``gradient.mp4``, three random
    clips ``v0-2.mp4`` of 12-23 frames at 32x40, and a CSV of the random
    ones; ``corrupt.mp4`` is the first one's bytes cut short."""
    d = tmp_path_factory.mktemp("clips")
    video_reader.encode_video(str(d / "gradient.mp4"), _gradient_clip(), fps=8.0)
    rng = np.random.default_rng(0)
    for i in range(3):
        t = int(rng.integers(12, 24))
        frames = rng.integers(0, 256, size=(t, 32, 40, 3), dtype=np.uint8)
        video_reader.encode_video(str(d / f"v{i}.mp4"), frames, fps=8.0)
    data = (d / "v0.mp4").read_bytes()
    (d / "corrupt.bin").write_bytes(data[: len(data) // 3])
    with open(d / "clips.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["path"])
        w.writeheader()
        for i in range(3):
            w.writerow({"path": str(d / f"v{i}.mp4")})
    return d


def _cfg(data, **over):
    cfg = tiny_config(**{"dataset.train_dataset": data, "dataset.eval_dataset": data,
                         "training.eval.eval_samples": 12, **over})
    return cfg, Config(cfg.to_dict())


def _csv_cfg(clips, **over):
    return _cfg(str(clips / "clips.csv"), **{"training.sampling.fps_range": [4, 8], **over})


@pytest.fixture(autouse=True)
def jax_resize_reads_padding(monkeypatch):
    """JAX's native resize reads up to a pixel past the end of its input
    where a crop window ends at the last frame's bottom-right corner (odd
    widths), and its output then depends on the bytes after the caller's
    buffer; the port scales that frame from a copy padded with its last
    pixel (``native/frame_resize.cpp``). JAX's resize is given its input in
    a buffer padded the same way, so that both read the same bytes."""
    orig = jvr.resize_frames

    def padded(frames, out_hw, crop=None):
        f = np.ascontiguousarray(frames, np.uint8).reshape(-1)
        buf = np.empty(f.size + 64, np.uint8)
        buf[: f.size] = f
        buf[f.size:] = np.resize(f[-3:], 64)
        return orig(buf[: f.size].reshape(frames.shape), out_hw, crop)

    monkeypatch.setattr(jvr, "resize_frames", padded)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = getattr(g, f), np.asarray(getattr(w, f))
            if f == "patches" and a.dtype == np.float32:
                b = b.astype(np.float32)  # the JAX bf16 wire's rows, cast
            assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f)


# -- reader, encoder, resize, packer ------------------------------------------


@pytest.mark.parametrize("source", ["path", "bytes", "eval_set"])
def test_reader_matches_jax(clips, source):
    """Metadata and random-access decode equal JAX's reader; random access
    equals the sequential decode. (An index given twice in one call decodes
    the next frame for the repeat, in both packages' decoders; the chunk
    sampler's indices never repeat.)"""
    src = {"path": str(clips / "v1.mp4"), "bytes": (clips / "v2.mp4").read_bytes(),
           "eval_set": next(tarfile_to_samples(os.path.join(EVAL_SET, "00001.tar")))["mp4"]}[source]
    with video_reader.VideoReader(src) as r:
        j = jvr.VideoReader(src)
        assert (len(r), r.height, r.width, r.get_avg_fps()) == (len(j), j.height, j.width,
                                                                j.get_avg_fps())
        seq = r.get_batch(np.arange(len(r)))
        idx = [len(r) - 1, 0, 7, 3, 10, 5]
        out = r.get_batch(idx)
        np.testing.assert_array_equal(out, j.get_batch(idx))
        np.testing.assert_array_equal(out, seq[idx])
    with pytest.raises(ValueError, match="closed"):
        r.get_batch([0])


def test_encode_video_round_trips(clips):
    """The port's encoder: the clip decodes back within the lossy codec's
    error, and JAX's reader reads the file the same."""
    clip = _gradient_clip()
    with video_reader.VideoReader(str(clips / "gradient.mp4")) as r:
        assert len(r) == 16 and (r.height, r.width) == (48, 64) and abs(r.fps - 8.0) < 0.1
        out = r.get_batch(range(16))
    assert np.abs(out.astype(np.int32) - clip).mean() < 10
    np.testing.assert_array_equal(out, jvr.VideoReader(str(clips / "gradient.mp4")).get_batch(
        range(16)))


@pytest.mark.parametrize("case", ["resize", "crop", "random_resized_crop", "center_crop",
                                  "bottom_right", "out_of_bounds"])
def test_resize_matches_jax(case):
    """swscale's crop and bicubic resize and the two crops of the chunk
    sampler equal JAX's bit for bit (the JAX package's native resize)."""
    frames = np.random.default_rng(1).integers(0, 256, size=(5, 61, 83, 3), dtype=np.uint8)
    if case == "resize":
        got, want = video_reader.resize_frames(frames, (32, 40)), jvr.resize_frames(frames,
                                                                                     (32, 40))
    elif case == "crop":
        got = video_reader.resize_frames(frames, (16, 16), crop=(5, 7, 40, 40))
        want = jvr.resize_frames(frames, (16, 16), crop=(5, 7, 40, 40))
        np.testing.assert_array_equal(got, video_reader.resize_frames(
            np.ascontiguousarray(frames[:, 5:45, 7:47]), (16, 16)))
    elif case == "random_resized_crop":
        got = chunking.random_resized_crop(frames, (24, 32), 0.3, np.random.default_rng(4))
        want = jchunk.random_resized_crop(frames, (24, 32), 0.3, np.random.default_rng(4))
    elif case == "center_crop":
        got = chunking.resize_center_crop(frames, (24, 40))
        want = jchunk.resize_center_crop(frames, (24, 40))
    elif case == "bottom_right":  # reads nothing past its input, whatever follows it
        frames = frames[:2, :44, :40]
        outs = []
        for fill in (0, 255):
            buf = np.full(frames.size + 64, fill, np.uint8)
            buf[: frames.size] = frames.reshape(-1)
            outs.append(video_reader.resize_frames(buf[: frames.size].reshape(frames.shape),
                                                   (32, 16), crop=(34, 3, 10, 37)))
        got, want = outs[0], jvr.resize_frames(frames, (32, 16), crop=(34, 3, 10, 37))
        np.testing.assert_array_equal(outs[1], got)
    else:
        with pytest.raises(ValueError, match="fr_resize_frames"):
            video_reader.resize_frames(frames, (16, 16), crop=(50, 0, 40, 40))
        return
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dims", [(8, 16, 24, 3), (7, 13, 21, 3), (4, 8, 8, 1), (5, 9, 4, 3)])
def test_packer_matches_jax_and_plain(dims):
    """The fused packer equals JAX's and its plain version (byte shuffle,
    then decode_rows) bit for bit, odd grids included (the remainder is
    cut, as ``patchify`` cuts it)."""
    frames = np.random.default_rng(sum(dims)).integers(0, 256, size=dims, dtype=np.uint8)
    got = video_reader.patchify_normalize(frames, PATCH)
    assert got.dtype == np.float32
    assert got.shape == (np.prod([d // p for d, p in zip(dims, PATCH)]), 32 * dims[-1])
    np.testing.assert_array_equal(got, jvr.patchify_normalize(frames, PATCH))
    np.testing.assert_array_equal(got, packing.patchify_normalize_reference(
        frames[: dims[0] // 2 * 2, : dims[1] // 4 * 4, : dims[2] // 4 * 4], PATCH))


@pytest.mark.parametrize("source", ["u8", "float"])
def test_uint8_wire_packing_matches_jax(source):
    """``pack_samples`` on the uint8 wire: JAX's bytes exactly (a float
    source quantized as JAX quantizes it); at patch slots the bytes decode
    to the f32 wire's rows (u8 clips: bit for bit; float clips: within half
    a pixel step)."""
    rng = np.random.default_rng(7)
    shapes = [(2, 8, 12), (4, 12, 8), (2, 16, 16)]
    if source == "u8":
        vids = [rng.integers(0, 256, size=(*s, 3), dtype=np.uint8) for s in shapes]
    else:
        vids = [rng.uniform(-1, 1, size=(3, *s)).astype(np.float32) for s in shapes]
    kw = dict(seq_len=128, max_samples=8, patch_size=PATCH)
    b8 = packing.pack_samples(vids, [3, 1, 5], dtype=torch.uint8, **kw)
    bf = packing.pack_samples(vids, [3, 1, 5], **kw)
    _assert_batches_equal([b8], [jpack.pack_samples(vids, [3, 1, 5], dtype=np.uint8, **kw)])
    assert b8.wire == torch.uint8 and b8.patches.dtype == np.uint8
    slots = (~b8.token_mask) & (b8.segment_ids > 0)
    dec = packing.decode_rows(b8.patches)[slots]
    if source == "u8":
        np.testing.assert_array_equal(dec, bf.patches[slots])
    else:
        np.testing.assert_allclose(dec, bf.patches[slots], atol=1.01 / 255, rtol=0)
    t = packing.host_tensors(b8)["patches"]
    assert t.dtype == torch.uint8 and torch.equal(t, torch.from_numpy(b8.patches))
    with pytest.raises(ValueError, match="wire"):  # f32 rows never truncate to bytes
        packing.host_tensors(packing.PackedBatch(**{**b8.__dict__, "patches": bf.patches}))


def test_wire_dtype_matches_jax():
    for name, over in WIRES.items():
        jcfg, cfg = _cfg("synthetic", **over)
        want = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float32): torch.float32}.get(
            np.dtype(jpack.wire_dtype(jcfg)), torch.bfloat16)
        assert packing.wire_dtype(cfg) == want, name


# -- chunks and batches --------------------------------------------------------


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_chunks_match_jax(mode):
    """``iter_video_chunks`` over an eval-set clip: the same chunks (bytes
    and fps) from the same seed, and the rng left in the same state."""
    data = next(tarfile_to_samples(os.path.join(EVAL_SET, "00002.tar")))["mp4"]
    kw = dict(patch_size=PATCH, min_grid=[2, 8, 8], max_grid=[8, 32, 40], fps_range=[2, 8],
              max_aspect_ratio=2, min_scale=0.25, eval=mode == "eval")
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    with video_reader.VideoReader(data) as r:
        got = list(chunking.iter_video_chunks(r, rng=rng, **kw))
    want = list(jchunk.iter_video_chunks(jvr.VideoReader(data), rng=jrng, **kw))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g["fps"] == w["fps"]
        np.testing.assert_array_equal(g["video"], w["video"])
    assert rng.random() == jrng.random()


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("backend", ["wds", "csv"])
def test_batches_match_jax(clips, backend, workers, mode):
    """``wds_batches`` (the eval-set tars) and ``csv_batches`` (the encoded
    clips) yield JAX's batches byte for byte, on the f32, bf16 and uint8
    wires: the first 3 in train, every one in eval, which ends at
    ``eval_samples`` chunks."""
    ev = mode == "eval"
    for wire, over in WIRES.items():
        over = {**over, "dataset.workers": workers}
        if backend == "wds":
            (jcfg, cfg), fns = _cfg(TARS, **over), (wds_batches, j_wds_batches)
        else:
            (jcfg, cfg), fns = _csv_cfg(clips, **over), (csv_batches, j_csv_batches)
        got = list(itertools.islice(fns[0](cfg, eval=ev, seed=3), 3 if not ev else None))
        want = list(itertools.islice(fns[1](jcfg, eval=ev, seed=3), 3 if not ev else None))
        _assert_batches_equal(got, want)
        assert all(b.wire == packing.wire_dtype(cfg) for b in got), wire
        if ev:
            assert sum(b.num_samples for b in got) == 12


def test_backend_by_extension():
    assert select_data_backend(_cfg(TARS)[1]) is wds_batches
    assert select_data_backend(_cfg("a.csv")[1]) is csv_batches
    with pytest.raises(ValueError, match="share format"):
        select_data_backend(_cfg(TARS, **{"dataset.eval_dataset": "a.csv"})[1])
    assert expand_shards("s-{00..02}.tar") == ["s-00.tar", "s-01.tar", "s-02.tar"]
    assert expand_shards("plain.tar") == ["plain.tar"]


# -- errors ----------------------------------------------------------------------


def test_remote_shard_rejected():
    with pytest.raises(ValueError, match="remote"):
        wds_batches(_cfg("hf://datasets/foo/{000..001}.tar")[1])


@pytest.mark.parametrize("fault", ["bad_flag", "missing_source"])
def test_missing_library_raises_when_batches_are_created(clips, tmp_path, monkeypatch, fault):
    """A host library that cannot be built raises from ``wds_batches`` and
    ``csv_batches`` themselves, with the compiler's message, not from a
    decode loop that would skip every clip: the build pointed at a bad flag
    or at a copy of ``native/`` without the decoder's source."""
    monkeypatch.setattr(_native, "_libs", {})
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    if fault == "bad_flag":
        monkeypatch.setattr(_native, "CXX_FLAGS", _native.CXX_FLAGS + ["-fno-such-flag"])
        match = "no-such-flag"
    else:
        shutil.copytree(_native.NATIVE_DIR, tmp_path / "native")
        os.remove(tmp_path / "native" / "video_decoder.cpp")
        monkeypatch.setattr(_native, "NATIVE_DIR", str(tmp_path / "native"))
        match = "video_decoder.cpp"
    for fn, cfg in ((wds_batches, _cfg(TARS)[1]), (csv_batches, _csv_cfg(clips)[1])):
        with pytest.raises(_native.NativeLibraryError, match=match):
            fn(cfg)
    with pytest.raises(_native.NativeLibraryError, match=match):
        video_reader.VideoReader(str(clips / "v0.mp4"))


def test_corrupt_clip_skipped_and_printed(clips, tmp_path, capsys):
    """A clip that fails to decode is skipped with a printed line, in both
    packages, and the batches around it stay JAX's."""
    path = tmp_path / "with_corrupt.csv"
    path.write_text(f"path\n{clips / 'corrupt.bin'}\n{clips / 'v1.mp4'}\n")
    jcfg, cfg = _csv_cfg(clips, **{"dataset.train_dataset": str(path),
                                   "dataset.eval_dataset": str(path)})
    got = list(csv_batches(cfg, eval=True, seed=1))
    assert "Decode fail" in capsys.readouterr().out
    want = list(j_csv_batches(jcfg, eval=True, seed=1))
    _assert_batches_equal(got, want)


def test_worker_pool_round_robin_errors_and_stop():
    pool = WorkerPool([lambda: iter([0, 2, 4]), lambda: iter([1, 3])])
    assert list(pool) == [0, 1, 2, 3, 4]

    def boom():
        yield 1
        raise RuntimeError("decode exploded")

    it = iter(WorkerPool([boom]))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode exploded"):
        next(it)
    pool = WorkerPool([lambda: itertools.count(), lambda: itertools.count(100)], depth=2)
    it = iter(pool)
    assert [next(it) for _ in range(4)] == [0, 100, 1, 101]
    it.close()  # an endless stream abandoned: its threads end
    assert not any(t.is_alive() for t in pool._threads)


# -- converter, decode hashes ----------------------------------------------------


def test_convert_to_wds_round_trips(clips, tmp_path, capsys):
    """Shards of 2: the mp4 bytes copied as they are, read back through
    ``wds_batches``; ``--reencode`` takes every container (an ``.avi``
    name too) and decodes to the same frames within the codec's error."""
    src = tmp_path / "in"
    src.mkdir()
    for i in range(3):
        shutil.copy(clips / f"v{i}.mp4", src / f"v{i}.mp4")
    assert convert_main([str(src), str(tmp_path / "out"), "--shard-size", "2"]) == 3
    assert sorted(os.listdir(tmp_path / "out")) == ["00000.tar", "00001.tar"]
    got = sorted(s["mp4"] for p in ("00000", "00001")
                 for s in tarfile_to_samples(str(tmp_path / "out" / f"{p}.tar")))
    assert got == sorted((src / f"v{i}.mp4").read_bytes() for i in range(3))
    cfg = _csv_cfg(clips, **{"dataset.train_dataset": str(tmp_path / "out/{00000..00001}.tar")})[1]
    b = next(iter(wds_batches(cfg, seed=0)))
    assert b.num_samples >= 1 and int(b.token_counts.sum() + b.grid_sizes.sum()) <= 128

    shutil.copy(clips / "gradient.mp4", src / "g.avi")
    assert convert_main([str(src), str(tmp_path / "re"), "--reencode"]) == 4
    assert "wrote 4 samples" in capsys.readouterr().out
    sample = [s for s in tarfile_to_samples(str(tmp_path / "re" / "00000.tar"))]
    assert len(sample) == 4
    with video_reader.VideoReader(str(clips / "gradient.mp4")) as r:
        src_frames = r.get_batch(range(16))
    decoded = []
    for s in sample:
        with video_reader.VideoReader(s["mp4"]) as r:
            if (r.height, r.width) == (48, 64):
                decoded.append(r.get_batch(range(len(r))))
    assert len(decoded) == 1 and decoded[0].shape == src_frames.shape
    assert np.abs(decoded[0].astype(np.int32) - src_frames).mean() < 10


def test_decode_hashes_pinned():
    """The eval set's decoded frames and 128x128 center crops: the port's
    and JAX's SHA-256 equal the pins ``chip_smoke.py`` compares a card
    machine's libav with."""
    assert eval_set_sha256(tarfile_to_samples, video_reader.VideoReader,
                           chunking.resize_center_crop) == EVAL_SET_SHA256
    assert eval_set_sha256(j_tarfile_to_samples, jvr.VideoReader,
                           jchunk.resize_center_crop) == EVAL_SET_SHA256


# -- the whole slice -------------------------------------------------------------


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """``Trainer.fit`` of 2 steps on the eval-set tars with an eval at step 2
    (tiny_config: precision 32, LPIPS and the discriminator off; frames of
    at least 12x12, so that SSIM is summed on the device, as at full size),
    on the f32 and the uint8 wire: each run's metrics.jsonl records."""
    out, threads = {}, torch.get_num_threads()
    torch.set_num_threads(1)  # as one_torch_thread, which runs after module fixtures
    for wire, over in (("f32", {}), ("u8", {"dataset.uint8_wire": True})):
        run = tmp_path_factory.mktemp(f"fit_{wire}")
        _, cfg = _cfg(TARS, **{"general.checkpoints.save_path": str(run),
                               "training.sampling.min_grid": [2, 12, 12],
                               "training.main.max_steps": 2,
                               "training.eval.eval_step_interval": 2,
                               "training.eval.eval_samples": 4, "training.eval.log_recon_num": 0,
                               "dataset.workers": 2, **over})
        Trainer(cfg, device="cpu").fit()
        with open(run / "metrics.jsonl") as f:
            out[wire] = [json.loads(line) for line in f]
        shutil.rmtree(run)  # the checkpoint: nothing left behind
    torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("wire", ["f32", "u8"])
def test_fit_on_eval_set_tars(fits, wire):
    """Finite losses and an eval with PSNR/SSIM on either wire; at
    precision 32 the uint8 wire's losses equal the f32 wire's exactly (the
    bytes decode to the f32 rows' bits, and the -1 the zero bytes decode to
    at token and pad slots is masked out of every sum)."""
    rows = fits[wire]
    train = [r for r in rows if "train/gen/total_loss" in r]
    assert [r["step"] for r in train] == [0, 1]
    for r in train:
        assert all(np.isfinite(v) for k, v in r.items() if k.startswith("train/"))
    ev = [r for r in rows if "eval/psnr" in r]
    assert [r["step"] for r in ev] == [2] and np.isfinite(ev[0]["eval/psnr"])
    assert -1 <= ev[0]["eval/ssim"] <= 1
    for a, b in zip(train, [r for r in fits["f32"] if "train/gen/total_loss" in r]):
        for k in a:
            if k.startswith(("train/gen/", "train/disc/")):
                assert a[k] == b[k], k
    assert ev[0]["eval/psnr"] == [r for r in fits["f32"] if "eval/psnr" in r][0]["eval/psnr"]
