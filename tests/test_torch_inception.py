"""The port's InceptionV3 (``titok_tpu_torch/metrics/inception_v3.py``) and
image metrics (``image_metrics.py``) against the JAX package's on the CPU.

Weights: the torch mirror of torchvision's ``inception_v3``
(``tests/torch_inception_mirror.py``, random BatchNorm statistics) through
``tools/convert_inception.py``. At 2x3x64x64 upsampled to 299, activations
and logits within 2e-5 (the CPU shows 2.4e-7 on activations of about 2.6).
The align-corners upsample within 2e-5 of JAX's (XLA computes its
``linspace`` coordinates an ulp apart, 4e-6 on the output) and of
``F.interpolate(align_corners=True)``. ``inception_score`` and
``calculate_fid`` are the same bits on the same features;
``MetricCalculator`` over each package's extractor, on seeded He-scaled
weights (the mirror's activations hardly move with the image: FID 4e-13),
agrees within 1e-4 relative (FID, MMD, IS) and exactly (PSNR, SSIM). Its
FID reads the first 64 of the 2048 activations: scipy's ``sqrtm`` of a
2048-d product takes 15 s a call on one core here, and
``tests/test_torch_metrics.py`` takes the one full-width FID (JAX's
committed features)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_inception_mirror import TorchInceptionV3  # noqa: E402
from tests.torch_metric_fixtures import SEEDS, inception_weights  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from titok_tpu.metrics import image_metrics as jim  # noqa: E402
from titok_tpu.metrics import inception_v3 as jinc  # noqa: E402
from titok_tpu_torch.metrics import image_metrics, inception_v3  # noqa: E402
from tools.convert_inception import convert_state_dict  # noqa: E402

ATOL = 2e-5


@pytest.fixture(scope="module")
def extractors(tmp_path_factory):
    torch.manual_seed(0)
    m = TorchInceptionV3()
    for mod in m.modules():  # random BatchNorm statistics, so the folding counts
        if isinstance(mod, torch.nn.BatchNorm2d):
            with torch.no_grad():
                mod.running_mean.normal_(0, 0.5)
                mod.running_var.uniform_(0.5, 2.0)
                mod.weight.normal_(1.0, 0.2)
                mod.bias.normal_(0, 0.2)
    path = str(tmp_path_factory.mktemp("inception") / "inception.npz")
    np.savez(path, **convert_state_dict({k: v.detach().numpy()
                                         for k, v in m.eval().state_dict().items()}))
    return (inception_v3.load_inception_extractor(path, device="cpu"),
            jinc.load_inception_extractor(path))


def test_inception_matches_jax(extractors):
    ours, theirs = extractors
    x = np.random.default_rng(0).uniform(-1, 1, size=(2, 3, 64, 64)).astype(np.float32)
    acts, logits = ours(x)
    want_acts, want_logits = theirs(x)
    assert acts.shape == (2, 2048) and logits.shape == (2, 1000)
    np.testing.assert_allclose(acts, want_acts, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits, want_logits, atol=ATOL, rtol=0)


@pytest.mark.parametrize("out_hw", [(64, 48), (1, 7)])
def test_resize_bilinear_align_corners(out_hw):
    x = np.random.default_rng(1).uniform(-1, 1, size=(2, 3, 17, 23)).astype(np.float32)
    got = inception_v3.resize_bilinear_align_corners(torch.from_numpy(x), *out_hw).numpy()
    want = np.asarray(jinc.resize_bilinear_align_corners(
        jnp.asarray(x.transpose(0, 2, 3, 1)), *out_hw)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if out_hw[0] > 1:
        ref = torch.nn.functional.interpolate(torch.from_numpy(x), size=out_hw, mode="bilinear",
                                              align_corners=True).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_image_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(40, 16)), rng.normal(loc=0.5, size=(30, 16))
    assert image_metrics.calculate_fid(a, b) == jim.calculate_fid(a, b)
    logits = rng.normal(scale=3.0, size=(50, 10))
    assert image_metrics.inception_score(logits) == jim.inception_score(logits)
    assert image_metrics.inception_score(np.zeros((50, 10))) == pytest.approx(1.0, abs=1e-5)

    path = str(tmp_path / "inception.npz")
    np.savez(path, **inception_weights(SEEDS["inception"]))
    extractors = (inception_v3.load_inception_extractor(path, device="cpu"),
                  jinc.load_inception_extractor(path))

    def first_64(extractor):
        def feature_fn(images):
            acts, logits = extractor(images)
            return acts[:, :64], logits
        return feature_fn

    ours, theirs = (first_64(e) for e in extractors)
    metrics = ("fid", "is", "mmd", "psnr", "ssim")
    calc, jcalc = (image_metrics.MetricCalculator(metrics, feature_fn=ours),
                   jim.MetricCalculator(metrics, feature_fn=theirs))
    target = rng.uniform(-1, 1, size=(4, 3, 64, 64)).astype(np.float32)
    recon = np.clip(target + rng.normal(0, 0.3, target.shape), -1, 1).astype(np.float32)
    for c in (calc, jcalc):
        c.update(recon[:2], target[:2])
        c.update(recon[2:], target[2:])
    got, want = calc.compute(), jcalc.compute()
    assert set(got) == set(want) == set(metrics)
    for k in ("psnr", "ssim"):
        assert got[k] == want[k], k
    assert got["fid"] > 1e-2, got
    for k in ("fid", "is", "mmd"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    with pytest.raises(RuntimeError, match="feature extractor"):
        image_metrics.MetricCalculator(("fid",)).update(recon, target)
