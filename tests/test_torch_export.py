"""The port's exported programs (``titok_tpu_torch/tools/export_model.py``,
``torch.export``) and its custom ops (``ops/custom_ops.py``) on the CPU.

The models of ``tests/test_export.py`` (``tiny_config``, FSQ and EMA-VQ
with a 64-code codebook, f32, seq 512, ``min_grid`` (2,8,8)), built by the
JAX package and carried over with ``weights.from_flax_params`` (and
``from_vq_state``). Held:

- the round trip, FSQ and VQ, float and w8a8: the loaded ``forward``
  program's indices equal the live module's and its reconstruction is
  within 1e-5; the ``decode`` program within 1e-5 of the live
  ``decode_indices_packed``; in float both against JAX's jitted forward and
  decode too (indices equal, 1e-5), the functions of ``tests/test_export.py``;
- every kernel call of a program is one custom-op node;
- ``torch.library.opcheck`` of each of the four ops;
- ``load_exported`` in a fresh process that imports no model module;
- one small export with ``attn_impl: flash_rope`` and one with ``flash_v1``.
"""

import json
import os
import subprocess
import sys

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
from titok_tpu_torch.ops import custom_ops  # noqa: E402
from titok_tpu_torch.serving.quant import quantize_model  # noqa: E402
from titok_tpu_torch.tools.export_model import PROGRAMS, export_model, load_exported  # noqa: E402
from titok_tpu_torch.weights import from_flax_params, from_vq_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
CASES = [("fsq", None), ("fsq", "w8a8"), ("vq", None), ("vq", "w8a8")]


def _jax_config(quantizer: str):
    cfg = tiny_config()
    cfg.set_dotted("tokenizer.model.quantizer", quantizer)
    if quantizer == "vq":
        cfg.set_dotted("tokenizer.model.vq", {"codebook_size": 64})
    return cfg


def _port_config(quantizer: str, attn_impl: str = "auto") -> Config:
    """The port's config of :func:`_jax_config`, its attention through the
    kernels' ops (``tiny_config`` selects dense ``reference`` attention)."""
    cfg = Config(_jax_config(quantizer).to_dict())
    cfg.set_dotted("training.main.attn_impl", attn_impl)
    return cfg


def _models(quantizer: str):
    """JAX's model of ``tests/test_export.py`` and the port's on its weights."""
    jm = JTiTokModel(j_make_titok(_jax_config(quantizer)), seq_len=512, min_grid=(2, 8, 8))
    params = from_flax_params(jax.tree.map(np.asarray, jm.params))
    vq_state = from_vq_state(jm.vq_state, "") if quantizer == "vq" else None
    port = TiTokModel(make_titok(_port_config(quantizer)), params=params, vq_state=vq_state,
                      seq_len=512, min_grid=(2, 8, 8), device="cpu")
    return jm, port


def _batch(model):
    vid = np.random.default_rng(0).uniform(-1, 1, size=(3, 4, 16, 16)).astype(np.float32)
    return model._pack([vid], [5]).device_arrays()


def _tensors(arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each case of :data:`CASES` exported once: ``{case: (jax model, port
    model, batch, artifact dir)}``."""
    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as one_torch_thread, which a module fixture runs before
    try:
        for quantizer in ("fsq", "vq"):
            jm, port = _models(quantizer)
            batch = _batch(port)
            for quant in (None, "w8a8"):
                art = str(tmp_path_factory.mktemp(f"{quantizer}_{quant}"))
                export_model(port.module, batch, art, quant=quant)
                out[(quantizer, quant)] = (jm, port, batch, art)
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("quantizer,quant", CASES)
def test_export_roundtrip(quantizer, quant, exported):
    jm, port, batch, art = exported[(quantizer, quant)]
    fwd, dec, meta = load_exported(art)
    assert meta == {"seq_len": 512, "max_samples": int(batch["token_counts"].shape[0]),
                    "head_dim": 64, "patch_size": [2, 4, 4], "in_channels": 3,
                    "quantizer": quantizer, "device": "cpu", "quant": quant}
    live = quantize_model(port, quant).module if quant else port.module
    b = _tensors(batch)
    with torch.no_grad():
        recon, idx = fwd(b)
        ref_recon, ref_aux = live(b)
        rec2 = dec(idx, b)
        ref_rec2 = live.decode_indices_packed(idx, b)
    torch.testing.assert_close(idx, ref_aux["indices"], rtol=0, atol=0)
    torch.testing.assert_close(recon, ref_recon, rtol=ATOL, atol=ATOL)
    torch.testing.assert_close(rec2, ref_rec2, rtol=ATOL, atol=ATOL)
    if quant is None:  # the float forward program is JAX's forward
        want_recon, want_aux = jm._jit_forward(jm.params, jm.vq_state, batch)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_aux["indices"]))
        np.testing.assert_allclose(recon.numpy(), np.asarray(want_recon), rtol=ATOL, atol=ATOL)
    # every kernel call is one custom-op node: 8 attention forwards (4 + 4
    # layers), and EMA-VQ's search once in the forward program
    ops = _op_nodes(fwd)
    assert ops.count(torch.ops.titok.segment_attn_fwd.default) == 8
    assert ops.count(torch.ops.titok.vq_nearest.default) == (quantizer == "vq")
    assert _op_nodes(dec).count(torch.ops.titok.segment_attn_fwd.default) == 4


def _op_nodes(program) -> list:
    """The custom-op targets a loaded program calls, one a call."""
    return [n.target for n in program.graph.nodes
            if isinstance(n.target, torch._ops.OpOverload) and n.target.namespace == "titok"]


def _op_inputs(rng):
    """Small CPU inputs of each op: two segments and pad, GQA 4/2."""
    S = 40
    seg = torch.tensor([1] * 17 + [2] * 19 + [0] * 4, dtype=torch.int32)
    q, k, v = (torch.from_numpy(rng.standard_normal((S, h, 64)).astype(np.float32))
               for h in (4, 2, 2))
    cos, sin = (torch.from_numpy(f(rng.uniform(0, 6, (S, 30))).astype(np.float32))
                for f in (np.cos, np.sin))
    z = torch.from_numpy(rng.standard_normal((S, 8)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    return {"segment_attn_fwd": (q, k, v, seg, None, 0.125),
            "segment_attn_rope_fwd": (q, k, v, seg, None, cos, sin, None, None, 0.125),
            "segment_attn_v1_fwd": (q, k, v, seg, 0.125),
            "vq_nearest": (z, cb)}


@pytest.mark.parametrize("name", sorted(custom_ops.OPS))
def test_opcheck(name):
    """Schema, fake tensors and dispatch of each op (no autograd kernel:
    the training path keeps its autograd Functions)."""
    args = _op_inputs(np.random.default_rng(3))[name]
    torch.library.opcheck(custom_ops.OPS[name], args, test_utils=(
        "test_schema", "test_faketensor", "test_aot_dispatch_dynamic"))


def test_load_exported_needs_no_model_code(exported, tmp_path):
    """A fresh process loads the EMA-VQ w8a8 artifact and runs both
    programs with ``titok_tpu_torch.models`` never imported."""
    _, port, batch, art = exported[("vq", "w8a8")]
    b = _tensors(batch)
    with torch.no_grad():
        recon, aux = quantize_model(port, "w8a8").module(b)
    torch.save(b, tmp_path / "batch.pt")
    code = f"""
import sys, torch
from titok_tpu_torch.tools.export_model import load_exported
fwd, dec, meta = load_exported({art!r})
b = torch.load({str(tmp_path / 'batch.pt')!r})
with torch.no_grad():
    recon, idx = fwd(b)
    rec2 = dec(idx, b)
torch.save((recon, idx, rec2), {str(tmp_path / 'out.pt')!r})
print(sorted(m for m in sys.modules if m.startswith("titok_tpu_torch.models")))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]", res.stdout
    got_recon, got_idx, rec2 = torch.load(tmp_path / "out.pt")
    torch.testing.assert_close(got_idx, aux["indices"], rtol=0, atol=0)
    torch.testing.assert_close(got_recon, recon, rtol=ATOL, atol=ATOL)
    assert rec2.shape == recon.shape


@pytest.mark.parametrize("attn_impl", ["flash_rope", "flash_v1"])
def test_export_other_attention(attn_impl):
    """``attn_impl: flash_rope`` and ``flash_v1`` trace through their own op
    (8 calls, none of the default forward's), and the exported forward
    equals the live module (which ``tests/test_torch_flash_rope_slice.py``
    and ``tests/test_torch_flash_v1.py`` hold to JAX); seeded weights."""
    from titok_tpu_torch.tools.export_model import _Forward

    port = TiTokModel(make_titok(_port_config("fsq", attn_impl)), seq_len=512,
                      min_grid=(2, 8, 8), device="cpu")
    b = _tensors(_batch(port))
    with torch.no_grad():
        program = torch.export.export(_Forward(port.module), (b,)).module()
        recon, idx = program(b)
        ref_recon, ref_aux = port.module(b)
    torch.testing.assert_close(idx, ref_aux["indices"], rtol=0, atol=0)
    torch.testing.assert_close(recon, ref_recon, rtol=ATOL, atol=ATOL)
    op = {"flash_rope": torch.ops.titok.segment_attn_rope_fwd,
          "flash_v1": torch.ops.titok.segment_attn_v1_fwd}[attn_impl].default
    assert _op_nodes(program) == [op] * 8


def test_meta_json_keys(exported):
    """``meta.json`` carries JAX's keys, with ``device`` in place of
    ``platforms``."""
    *_, art = exported[("fsq", None)]
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == {"seq_len", "max_samples", "head_dim", "patch_size", "in_channels",
                         "quantizer", "device", "quant"}
