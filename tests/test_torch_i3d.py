"""The port's I3D (``titok_tpu_torch/metrics/i3d.py``) and FVD against the
JAX package's on the CPU.

Weights: the torch mirror of pytorch-i3d (``tests/torch_i3d_mirror.py``,
random BatchNorm statistics) through ``tools/convert_i3d.py``, the file
both packages load. The forward at the JAX package's own test shape,
2x3x12x64x64, agrees within 1e-5 (the CPU shows 4e-7 on logits of about
0.8). TF-SAME padding, convs and max pools, at odd and even sizes, strides
1 and 2, within 1e-5. The FVD preprocessing within 2e-5 (JAX's own
einsum lies 8e-6 from a float64 reference on the upscale), on an upscale
and on a downscale that antialiases, which ``F.interpolate`` misses by
more than 1e-2."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from tests.torch_i3d_mirror import TorchInceptionI3d  # noqa: E402
from tests.torch_metric_fixtures import SEEDS, i3d_weights  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from titok_tpu.metrics import fvd as jfvd  # noqa: E402
from titok_tpu.metrics import i3d as ji3d  # noqa: E402
from titok_tpu_torch.metrics import fvd, i3d  # noqa: E402
from titok_tpu_torch.weights import from_flax_params, unflatten  # noqa: E402
from tools.convert_i3d import convert_state_dict  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module")
def flat():
    torch.manual_seed(0)
    m = TorchInceptionI3d(num_classes=400)
    for mod in m.modules():  # random BatchNorm statistics, so the folding counts
        if isinstance(mod, torch.nn.BatchNorm3d):
            with torch.no_grad():
                mod.running_mean.normal_(0, 0.5)
                mod.running_var.uniform_(0.5, 2.0)
                mod.weight.normal_(1.0, 0.2)
                mod.bias.normal_(0, 0.2)
    return convert_state_dict({k: v.detach().numpy() for k, v in m.eval().state_dict().items()})


@pytest.fixture(scope="module")
def npz(flat, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("i3d") / "i3d.npz")
    np.savez(path, **flat)
    return path


def test_i3d_matches_jax(flat, npz):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(2, 3, 12, 64, 64)).astype(np.float32)
    want = np.asarray(ji3d.InceptionI3d(400).apply(
        {"params": ji3d.load_i3d_params(npz)}, np.transpose(x, (0, 2, 3, 4, 1))))
    model = i3d.InceptionI3d(400).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in i3d.load_i3d_params(npz).items()})
    assert sorted(model.state_dict()) == sorted(from_flax_params(unflatten(flat)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 400)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("size", [9, 10])
@pytest.mark.parametrize("stride", [1, 2])
def test_tf_same_padding(size, stride):
    """A Unit3D's conv and a max pool at TF-SAME against flax's and lax's
    ``SAME``; at stride 2 on an even size the front pad is one less than
    the back."""
    rng = np.random.default_rng(size * 10 + stride)
    kernel, strides = (3, 7, 5), (stride, stride, stride)
    x = rng.normal(size=(1, 3, size, size + 2, size + 1)).astype(np.float32)
    w = rng.normal(size=(*kernel, 3, 4)).astype(np.float32) * 0.1
    want = np.asarray(nn.Conv(4, kernel, strides=strides, padding="SAME", use_bias=False).apply(
        {"params": {"kernel": w}}, np.transpose(x, (0, 2, 3, 4, 1))))
    unit = i3d.Unit3D(3, 4, kernel, strides, relu=False, bn=False)
    unit.load_state_dict({k: torch.from_numpy(v)
                          for k, v in from_flax_params({"conv": {"kernel": w}}).items()})
    with torch.no_grad():
        got = unit(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    pads = i3d.same_pads(x.shape[2:], kernel, strides)
    if stride == 2 and size % 2 == 0:  # H 12 under a 7 kernel: 2 in front, 3 behind
        assert pads[2:4] == [2, 3], pads
    want = np.asarray(ji3d._max_pool_same(jnp.asarray(np.transpose(x, (0, 2, 3, 4, 1))),
                                          (3, 3, 3), strides))
    got = i3d.max_pool_same(torch.from_numpy(x), (3, 3, 3), strides).numpy()
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 4, 1), want)


@pytest.mark.parametrize("hw", [(48, 40), (100, 40)], ids=["upscale", "downscale"])
def test_preprocess_matches_jax(hw):
    """Resize to 64 (H and W), last frame repeated to 10 frames. 100 -> 64
    shrinks H, where ``jax.image.resize`` widens its triangle (antialias)."""
    rng = np.random.default_rng(hw[0])
    x = rng.uniform(-1, 1, size=(2, 3, 4, *hw)).astype(np.float32)
    want = np.transpose(np.asarray(ji3d.preprocess_bcthw(x, target=64)), (0, 4, 1, 2, 3))
    got = i3d.preprocess_bcthw(torch.from_numpy(x), target=64).numpy()
    assert got.shape == want.shape == (2, 3, 10, 64, 64)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(got[:, :, 3], got[:, :, 9])
    plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=(4, 64, 64),
                                            mode="trilinear", align_corners=False).numpy()
    gap = float(np.abs(plain - want[:, :, :4]).max())
    assert (gap > 1e-2) if hw[0] > 64 else (gap < 2e-5), gap


def test_fvd_routes_and_raises(tmp_path):
    """A ``.npz`` runs the port's I3D (on the device asked for); any other
    file loads as torchscript with ``map_location``; no file raises JAX's
    ``RuntimeError`` at the first ``update``. Both packages' FVD agree on
    the same clips, on seeded He-scaled weights (the mirror's features
    hardly move with the input: FVD 1e-12), target lowered to 64: features
    within 1e-5 of logits of about 4, FVD 1e-4 relative."""
    npz = str(tmp_path / "i3d.npz")
    np.savez(npz, **i3d_weights(SEEDS["i3d"]))
    rng = np.random.default_rng(1)
    clips = [rng.uniform(-1, 1, size=(1, 3, t, 40, 48)).astype(np.float32) for t in (4, 6, 8)]
    with pytest.raises(RuntimeError, match="FVD needs local I3D weights"):
        fvd.FVDCalculator(device="cpu").update(clips[0], clips[0])

    ours, theirs = fvd.FVDCalculator(npz, device="cpu"), jfvd.FVDCalculator(npz)
    ours._get_extractor().target = theirs._get_extractor().target = 64
    assert isinstance(ours._extractor, i3d.I3DExtractor)
    for c in clips:
        noisy = np.clip(c + 0.2 * rng.normal(size=c.shape), -1, 1).astype(np.float32)
        ours.update(noisy, c)
        theirs.update(noisy, c)
    for a, b in zip(ours.real_feats + ours.fake_feats, theirs.real_feats + theirs.fake_feats):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours.compute(), theirs.compute(), rtol=1e-4)

    class Stats(torch.nn.Module):  # the torchscript I3D's call signature
        def forward(self, x, rescale: bool = False, resize: bool = False,
                    return_features: bool = True):
            return torch.cat([x.mean(dim=(2, 3, 4)), x.std(dim=(2, 3, 4))], dim=1)

    pt = str(tmp_path / "i3d.pt")
    torch.jit.script(Stats()).save(pt)
    ours, theirs = fvd.FVDCalculator(pt, device="cpu"), jfvd.FVDCalculator(pt)
    for c in clips:
        ours.update(c * 0.5, c)
        theirs.update(c * 0.5, c)
    assert isinstance(ours._extractor, fvd.I3DFeatureExtractor)
    assert ours._extractor.device == torch.device("cpu")
    np.testing.assert_allclose(ours.compute(), theirs.compute(), rtol=1e-5)
    os.remove(pt)
    os.remove(npz)
