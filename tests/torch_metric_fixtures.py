"""The eval metrics' parity check: its seeded weights, its inputs and its
scores, shared by ``tests/torch_parity_fixtures.py`` (which writes JAX's
results, ``docs/artifacts/r4_tiny_lpips_5000_torch/jax_metrics.npz``),
the CPU tests and ``chip_smoke.py`` (which holds the port on the card to
them). Imports torch and the port, never JAX.

Weights are drawn with numpy in the flat ``.npz`` layout that
``tools/convert_{i3d,vjepa,inception}.py`` write (keys '/'-joined flax
paths, flax kernel layouts, folded BatchNorm), so one file serves the JAX
package's loaders and the port's alike. The shapes come from the port's
modules (built on the ``meta`` device); the values from
``np.random.default_rng(seed)``, one tensor after another in sorted key
order:

- conv kernels ``N(0, 2 / fan_in)`` (He), so 60 stacked I3D units neither
  vanish nor blow up; conv biases ``N(0, 0.01²)``;
- ``bn_scale`` ``1 + N(0, 0.1²)``, ``bn_offset`` ``N(0, 0.1²)``;
- Dense kernels ``N(0, 0.02²)`` (jepa's init width), biases
  ``N(0, 0.01²)``; LayerNorm ``scale`` ``1 + N(0, 0.1²)``, ``bias``
  ``N(0, 0.1²)``; ``query_tokens`` ``N(0, 0.02²)``.
"""

from __future__ import annotations

import numpy as np
import torch

# the seed of each network's weights and of the clip that makes I3D's
# resize shrink (the committed clips are 128-168 px, all upscaled to 224)
SEEDS = {"i3d": 1801, "vjepa": 1802, "inception": 1803, "clip": 1804}
SEEDED_CLIP_THW = (16, 256, 320)
# the scores compare the first SPLIT clips (and their frames) with the rest
SPLIT = 5

# torch weight layout -> flax kernel layout, by rank
_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _shapes(module: torch.nn.Module) -> dict[str, tuple]:
    """The module's parameters as flat flax keys and shapes (flax layout)."""
    out = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        shape = tuple(p.shape)
        if leaf == "weight" and p.ndim in _TO_FLAX:
            leaf, shape = "kernel", tuple(shape[i] for i in _TO_FLAX[p.ndim])
        elif leaf == "weight":  # the only 1-D weights are LayerNorm's
            leaf = "scale"
        out["/".join([*path, leaf])] = shape
    return out


def _draw(shapes: dict[str, tuple], seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    flat = {}
    for key in sorted(shapes):
        shape = shapes[key]
        *path, leaf = key.split("/")
        z = rng.standard_normal(shape, dtype=np.float32)
        if leaf in ("bn_scale", "scale"):
            flat[key] = (1.0 + 0.1 * z).astype(np.float32)
            continue
        if leaf == "kernel" and len(shape) > 2:  # conv: fan-in = all but O
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
        elif leaf in ("kernel", "query_tokens"):
            std = 0.02
        elif leaf == "bias" and not path[-1].startswith("norm"):
            std = 0.01
        else:  # bn_offset, LayerNorm bias
            std = 0.1
        flat[key] = (z * np.float32(std)).astype(np.float32)
    return flat


def i3d_weights(seed: int, num_classes: int = 400) -> dict[str, np.ndarray]:
    from titok_tpu_torch.metrics.i3d import InceptionI3d

    with torch.device("meta"):
        return _draw(_shapes(InceptionI3d(num_classes)), seed)


def vjepa_weights(seed: int, model_name: str = "vit_large") -> dict[str, np.ndarray]:
    from titok_tpu_torch.metrics.vjepa import SPECS, VJEPAFeatures

    with torch.device("meta"):
        return _draw(_shapes(VJEPAFeatures(SPECS[model_name])), seed)


def inception_weights(seed: int) -> dict[str, np.ndarray]:
    from titok_tpu_torch.metrics.inception_v3 import InceptionV3

    with torch.device("meta"):
        return _draw(_shapes(InceptionV3()), seed)


def metric_clips(uint8_clips: list[np.ndarray]) -> list[np.ndarray]:
    """The check's inputs: each committed uint8 THWC clip as ``[1, 3, T, H,
    W]`` f32 in [-1, 1] (``x / 127.5 - 1``), then the seeded clip of
    :data:`SEEDED_CLIP_THW`, uniform in [-1, 1]."""
    out = [(np.asarray(c, np.float32) / 127.5 - 1.0).transpose(3, 0, 1, 2)[None]
           for c in uint8_clips]
    rng = np.random.default_rng(SEEDS["clip"])
    out.append(rng.uniform(-1.0, 1.0, (1, 3, *SEEDED_CLIP_THW)).astype(np.float32))
    return out


def clip_frames(clip: np.ndarray) -> np.ndarray:
    """A ``[1, 3, T, H, W]`` clip's frames as NCHW images."""
    return np.ascontiguousarray(clip[0].transpose(1, 0, 2, 3))


def metric_scores(feats: dict, image_metrics) -> dict:
    """FVD and JEDi between the first :data:`SPLIT` clips and the rest, and
    FID, MMD and IS between their frames (IS over the rest's), by
    ``image_metrics``' host math (either package's ``image_metrics``
    module: its ``calculate_fid``, ``mmd_poly`` and ``inception_score``).
    ``feats``: ``i3d [clips, 400]``, ``vjepa [clips, D]``,
    ``inception_acts [frames, 2048]``, ``inception_logits [frames, 1000]``
    and ``frames`` (each clip's frame count)."""
    cut = int(np.sum(feats["frames"][:SPLIT]))
    acts, logits = feats["inception_acts"], feats["inception_logits"]
    return {
        "fvd": image_metrics.calculate_fid(feats["i3d"][:SPLIT], feats["i3d"][SPLIT:]),
        "jedi": image_metrics.mmd_poly(feats["vjepa"][:SPLIT], feats["vjepa"][SPLIT:]) * 100.0,
        "fid": image_metrics.calculate_fid(acts[:cut], acts[cut:]),
        "mmd": image_metrics.mmd_poly(acts[:cut], acts[cut:]) * 100.0,
        "is": image_metrics.inception_score(logits[cut:]),
    }
