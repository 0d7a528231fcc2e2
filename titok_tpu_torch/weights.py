"""Carry flax parameters over to the port's state dict.

The port's module tree mirrors the flax names (``encoder.model_layers.
attn_0.to_qkv`` …), so the mapping is mechanical:

- a flax ``Dense`` ``kernel [in, out]`` becomes ``Linear.weight [out, in]``;
- a flax ``Conv`` ``kernel [kh, kw, in, out]`` (HWIO) becomes
  ``Conv2d.weight [out, in, kh, kw]`` (OIHW), and a 3-D one
  ``[kt, kh, kw, in, out]`` ``Conv3d.weight [out, in, kt, kh, kw]``;
- a flax ``LayerNorm`` ``scale`` becomes ``LayerNorm.weight``;
- ``bias``, RMSNorm ``weight``, ``mask_token [1, 1]``, the folded
  BatchNorm's ``bn_scale`` and ``bn_offset`` and the pooler's
  ``query_tokens`` are copied as they are.

The same holds for the discriminator, a ``PackedEncoder`` under the same
names. The EMA-VQ state (the JAX ``VQState``: codebook, ema_counts,
ema_sums, ages) maps onto the buffers of ``TiTok.quantize`` under the same
field names. An LPIPS tree (``net/conv{i}`` HWIO kernels and biases,
``lin{k}/kernel [1, 1, C, 1]``) maps by :func:`from_flax_params` too, and
so do the eval metrics' networks (I3D, V-JEPA, InceptionV3) from the flat
``.npz`` that ``tools/convert_{i3d,vjepa,inception}.py`` write, the file
the JAX package's loaders read (:func:`load_flat_npz`).
Takes a nested dict (or a ``VQState``) whose leaves convert with
``np.asarray`` (numpy arrays, or the arrays of a JAX tree); imports no
JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from titok_tpu_torch.models.vq import STATE_NAMES


# flax kernel layout -> torch weight layout, by rank: Dense [in, out], Conv
# HWIO, Conv DHWIO
_KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def unflatten(flat: Mapping) -> dict:
    """``{"a/b/kernel": x, ...}`` (a converter's flat ``.npz``) -> the
    nested flax tree, numpy leaves."""
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return tree


def load_flat_npz(path: str) -> dict[str, np.ndarray]:
    """A converter's flat ``.npz`` (keys '/'-joined flax paths) as a torch
    state dict."""
    with np.load(path) as z:
        return from_flax_params(unflatten({k: z[k] for k in z.files}))


def from_flax_params(tree: Mapping) -> dict[str, np.ndarray]:
    """Nested flax params (numpy leaves) -> flat torch state dict (numpy
    values, f32): the TiTok and discriminator trees, and the LPIPS tree of
    a converted ``.npz`` (``net.conv{i}.weight`` OIHW and ``.bias``,
    ``lin{k}.weight [1, C, 1, 1]``)."""
    out: dict[str, np.ndarray] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            name = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(val, name + ".")
            elif key == "kernel":
                arr = np.asarray(val, np.float32)
                if arr.ndim not in _KERNEL_PERM:
                    raise ValueError(f"{name}: expected a 2-D Dense or a 4-D or 5-D Conv "
                                     f"kernel, got {arr.shape}")
                out[f"{prefix}weight"] = np.ascontiguousarray(arr.transpose(_KERNEL_PERM[arr.ndim]))
            elif key == "scale":  # flax LayerNorm
                out[f"{prefix}weight"] = np.asarray(val, np.float32)
            else:
                out[name] = np.asarray(val, np.float32)

    walk(tree, "")
    return out


def from_vq_state(vq_state, prefix: str = "quantize.") -> dict[str, np.ndarray]:
    """A JAX ``VQState`` (numpy leaves) as the port's EMA-VQ buffers, f32,
    named ``prefix + field`` (``quantize.codebook`` ... in the TiTok state
    dict; ``prefix=""`` for ``TiTokModel(vq_state=...)`` or
    ``EMAVQ.set_state``)."""
    return {prefix + name: np.asarray(getattr(vq_state, name), np.float32)
            for name in STATE_NAMES}


def from_flax_train_state(state) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """``(generator, discriminator)`` state dicts from a JAX ``TrainState``
    (its ``gen_params`` and ``disc_params``), ready for
    ``TrainStepBuilder.init_state(gen_params=..., disc_params=...)``. When
    the state has a ``VQState`` the generator's dict also holds its
    ``quantize.*`` buffers."""
    gen = from_flax_params(state.gen_params)
    vq_state = getattr(state, "vq_state", ())
    if hasattr(vq_state, "codebook"):
        gen.update(from_vq_state(vq_state))
    return gen, from_flax_params(state.disc_params)
