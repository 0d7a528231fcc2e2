"""The port's EMA-VQ against the JAX package on the CPU: the plain
nearest-neighbour search (against ``vq_nearest_reference`` and the Pallas
kernel in interpret mode), ``EMAVQ``'s forward and EMA update from the same
carried state, revival and the data-dependent init by their properties, and
the vq TiTok forward and tokenizer API with carried params and codebook.

Small sizes throughout: patch (2,4,4), seq 128, codebook 256, dim 4."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402, F401
from tests.util import PATCH, synthetic_videos  # noqa: E402
from titok_tpu.models.titok import TiTok as JTiTok  # noqa: E402
from titok_tpu.models.titok import TiTokModel as JTiTokModel  # noqa: E402
from titok_tpu.models.vq import EMAVQ as JEMAVQ  # noqa: E402
from titok_tpu.models.vq import VQState  # noqa: E402
from titok_tpu.ops.vq_distance import vq_nearest_pallas, vq_nearest_reference  # noqa: E402
from titok_tpu_torch.config import load_config  # noqa: E402
from titok_tpu_torch.models.titok import TiTok, TiTokModel, make_titok  # noqa: E402
from titok_tpu_torch.models.vq import (  # noqa: E402
    EMAVQ,
    STATE_NAMES,
    init_vq_state,
    init_vq_state_from_latents,
)
from titok_tpu_torch.ops import vq_distance as vd  # noqa: E402
from titok_tpu_torch.weights import from_flax_params, from_vq_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D = 256, 4
# near-tie rule of the plain search against JAX (XLA's dot sums in another
# order): the other side's code is within EPS * (1 + |d*|) of the plain
# minimum d*, and so is its partial distance
EPS = 1e-6


def _codebook(kind: str, rng) -> np.ndarray:
    if kind == "normal":
        return rng.normal(size=(N, D)).astype(np.float32)
    if kind == "separated":  # a 4^4 grid with spacing 3: no near ties
        g = np.stack(np.meshgrid(*[np.arange(4)] * D, indexing="ij"), -1).reshape(-1, D)
        return (3.0 * g - 4.5).astype(np.float32)
    cb = rng.normal(size=(N, D)).astype(np.float32)  # "duplicated": pairs of equal rows
    cb[1::2] = cb[0::2]
    return cb


def _latents(kind: str, cb: np.ndarray, rng, S: int = 300) -> np.ndarray:
    if kind == "normal":
        return rng.normal(size=(S, D)).astype(np.float32)
    pick = rng.integers(0, N, S)
    return (cb[pick] + 0.3 * rng.normal(size=(S, D))).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "separated", "duplicated"])
def test_vq_nearest_matches_jax(rng, kind):
    """The port's plain search against ``vq_nearest_reference`` and the
    Pallas kernel (interpret mode): indices exact on the separated and the
    duplicated codebook (there the lower of two equal rows), the near-tie
    rule otherwise with >= 99.9 % identical."""
    cb = _codebook(kind, rng)
    z = _latents(kind, cb, rng)
    idx, dist = vd.vq_nearest(torch.from_numpy(z), torch.from_numpy(cb))
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32 and idx.shape == (300,)
    ref_idx, ref_d = vq_nearest_reference(jnp.asarray(z), jnp.asarray(cb))
    with pltpu.force_tpu_interpret_mode():
        pal_idx, pal_d = vq_nearest_pallas(jnp.asarray(z), jnp.asarray(cb))
    scale = 1.0 + dist.abs()
    for j_idx, j_d in ((ref_idx, ref_d), (pal_idx, pal_d)):
        j_idx = torch.from_numpy(np.array(j_idx))
        if kind == "normal":
            slack = (vd.distances_at(torch.from_numpy(z), torch.from_numpy(cb), j_idx) - dist)
            assert float((slack / scale).max()) <= EPS
            assert float((idx == j_idx).float().mean()) >= 0.999
        else:
            assert torch.equal(idx, j_idx)
        err = (torch.from_numpy(np.array(j_d)) - dist).abs() / scale
        assert float(err.max()) <= EPS
    if kind == "duplicated":
        assert bool((idx % 2 == 0).all())
    # the dense d(s, n) of the plain version and distances_at agree bit for bit
    assert torch.equal(vd.distances_at(torch.from_numpy(z), torch.from_numpy(cb), idx), dist)


def test_vq_nearest_gate_rejects_planted_faults(rng):
    """``gate``, the card's comparison, on the CPU: the plain version
    passes itself; the last 64-code tile skipped, or ties sent to the
    highest index, fail it."""
    z, cb = torch.from_numpy(_latents("normal", None, rng)), torch.from_numpy(_codebook("normal", rng))
    idx, dist = vd.vq_nearest_reference(z, cb)
    assert vd.gate(z, cb, idx, dist)["ok"]
    skip_i, skip_d = vd.vq_nearest_reference(z, cb[:-64])
    assert not vd.gate(z, cb, skip_i, skip_d)["ok"]
    dup = torch.from_numpy(_codebook("duplicated", rng))
    zd = torch.from_numpy(_latents("duplicated", dup.numpy(), rng))
    hi_i, hi_d = vd.vq_nearest_reference(zd, dup.flip(0))
    hi_i = (N - 1 - hi_i).to(torch.int32)
    assert vd.gate(zd, dup, *vd.vq_nearest_reference(zd, dup), exact=True)["ok"]
    g = vd.gate(zd, dup, hi_i, hi_d, exact=True)
    assert not g["ok"] and g["same"] == 0.0 and g["slack"] == 0.0  # equal distances


@pytest.mark.parametrize("N", [16384, 1000, 37])
@pytest.mark.parametrize("S", [4096, 3409, 1152, 777, 1])
def test_vq_plan(S, N):
    """The kernel's planner (a pure function): every code in exactly one
    range, in order; a cluster of at most 8 CTAs, whose CTAs cover all N
    codes of a row block, and a grid of whole clusters; ranges of at least
    one step of codes. At N 16384 every CTA has 16 warps and the grid
    fills the card one CTA an SM: a cluster twice as large would not fit,
    or the cluster is already 8. base_vq's one shape, S 4096, gets 64 row
    blocks by clusters of 2."""
    p = vd.plan_for(S, N)
    assert 1 <= p.warps <= vd.MAX_WARPS and 1 <= p.cluster <= vd.MAX_CLUSTER
    assert p.ctas % p.cluster == 0 and p.ctas == p.row_blocks * p.cluster
    assert p.row_blocks * vd.ROWS >= S > (p.row_blocks - 1) * vd.ROWS
    assert p.per_range % 4 == 0 and p.ranges == p.cluster * p.warps * vd.GROUPS
    covered = np.zeros(N, np.int64)
    prev_end = 0
    # range r (rank, warp, group order) covers [r * per_range, (r + 1) * per_range) within N
    for begin, end in ((min(N, r * p.per_range), min(N, (r + 1) * p.per_range))
                       for r in range(p.ranges)):
        assert begin == prev_end or begin == end == N  # contiguous, in code order
        covered[begin:end] += 1
        prev_end = end
    assert (covered == 1).all()
    assert p.ranges == vd.GROUPS or p.per_range >= vd.TILE
    if N == 16384:
        assert p.warps == 16
        assert p.ctas <= vd.NUM_SMS < 2 * p.ctas or p.cluster == vd.MAX_CLUSTER
    if (S, N) == (4096, 16384):
        assert p == vd.Plan(warps=16, cluster=2, per_range=256, row_blocks=64)


def _jstate(state: dict) -> VQState:
    return VQState(**{k: jnp.asarray(np.asarray(v)) for k, v in state.items()})


@pytest.mark.parametrize("S", [128, 700])
def test_emavq_forward_matches_jax(rng, S):
    """From the same state and latents (some rows weighted 0): codes,
    indices, commit, counts, sums, perplexity and the entropy loss
    (``entropy_weight`` 0.1; S = 700 is not a multiple of its 512-row
    chunk), and the gradient of a loss of all three with respect to z.
    Tolerance: 1e-6 on values computed the same way; 2e-6 relative on the
    entropy loss and the gradient, which sum [S, N] softmax terms in
    another order."""
    state = init_vq_state(torch.Generator().manual_seed(0), N, D)
    z = (rng.normal(size=(S, D)) * 0.7).astype(np.float32)
    w = (rng.uniform(size=S) > 0.25).astype(np.float32)
    vq = EMAVQ(N, D, entropy_weight=0.1)
    vq.set_state(state)
    jvq = JEMAVQ(N, D, entropy_weight=0.1, impl="reference")
    js = _jstate(state)

    zt = torch.from_numpy(z).requires_grad_()
    codes, aux = vq(zt, torch.from_numpy(w))
    jcodes, jaux = jvq(jnp.asarray(z), js, weights=jnp.asarray(w))
    np.testing.assert_array_equal(aux["indices"].numpy(), np.asarray(jaux["indices"]))
    assert len(np.unique(aux["indices"].numpy())) > 20
    np.testing.assert_allclose(codes.detach().numpy(), np.asarray(jcodes), atol=1e-6)
    assert torch.equal(codes.detach(), vq.codebook[aux["indices"].long()])
    np.testing.assert_array_equal(aux["vq_counts"].numpy(), np.asarray(jaux["vq_counts"]))
    for key in ("commit_loss", "vq_sums", "perplexity"):
        np.testing.assert_allclose(aux[key].detach().numpy(), np.asarray(jaux[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(aux["entropy_loss"].item(), float(jaux["entropy_loss"]),
                               rtol=2e-6)

    def jloss(zz):
        c, a = jvq(zz, js, weights=jnp.asarray(w))
        return (c ** 2).sum() + a["commit_loss"] + a["entropy_loss"]

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(z)))
    loss = (codes ** 2).sum() + aux["commit_loss"] + aux["entropy_loss"]
    (grad,) = torch.autograd.grad(loss, zt)
    np.testing.assert_allclose(grad.numpy(), jgrad, atol=2e-6 * np.abs(jgrad).max())


def test_ema_update_matches_jax(rng):
    """Three EMA updates without revival from the same state and batch
    statistics: every buffer at atol 1e-6."""
    state = init_vq_state(torch.Generator().manual_seed(1), N, D)
    vq, jvq = EMAVQ(N, D, decay=0.9), JEMAVQ(N, D, decay=0.9, impl="reference")
    vq.set_state(state)
    js = _jstate(state)
    for _ in range(3):
        z = rng.normal(size=(128, D)).astype(np.float32)
        w = (rng.uniform(size=128) > 0.3).astype(np.float32)
        _, aux = vq(torch.from_numpy(z), torch.from_numpy(w))
        _, jaux = jvq(jnp.asarray(z), js, weights=jnp.asarray(w))
        vq.ema_update(aux["vq_counts"], aux["vq_sums"])
        js = jvq.ema_update(js, jaux["vq_counts"], jaux["vq_sums"])
        for name in STATE_NAMES:
            np.testing.assert_allclose(getattr(vq, name).numpy(), np.asarray(getattr(js, name)),
                                       atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_allclose(float(vq.dead_code_fraction()), float(jvq.dead_code_fraction(js)))


def test_dead_code_reinit():
    """Codes unused for ``dead_steps`` consecutive updates are reseeded
    from batch latents at the fair-share count, and their ages reset."""
    gen = torch.Generator().manual_seed(0)
    vq = EMAVQ(16, 2, decay=0.0, dead_steps=2)
    vq.set_state(init_vq_state(gen, 16, 2))
    z = torch.tensor([[3.0, 3.0]]).repeat(32, 1)
    _, aux = vq(z)
    unused = aux["vq_counts"] == 0
    vq.ema_update(aux["vq_counts"], aux["vq_sums"], generator=gen, batch_z=z)
    # age 1 < dead_steps: not reseeded (decay 0 empties them to 0 instead)
    assert float((vq.codebook[unused] - 3.0).abs().min()) > 1.0
    assert float(vq.dead_code_fraction()) > 0
    _, aux1 = vq(z)
    dead = unused & (aux1["vq_counts"] == 0)
    assert int(dead.sum()) >= 14
    vq.ema_update(aux1["vq_counts"], aux1["vq_sums"], generator=gen, batch_z=z)
    torch.testing.assert_close(vq.codebook[dead], torch.full((int(dead.sum()), 2), 3.0))
    fair = 32.0 / 16  # decay 0: the counts are this batch's, 32 rows over 16 codes
    torch.testing.assert_close(vq.ema_counts[dead], torch.full((int(dead.sum()),), fair))
    torch.testing.assert_close(vq.ema_sums[dead], torch.full((int(dead.sum()), 2), 3.0 * fair))
    assert float(vq.ages.max()) == 0.0 and float(vq.dead_code_fraction()) == 0.0


def test_dead_code_reinit_respects_mask():
    """Reseeding draws from the rows ``batch_w`` marks valid only: the
    packed buffer's other rows are garbage."""
    gen = torch.Generator().manual_seed(0)
    vq = EMAVQ(16, 2, decay=0.0, dead_steps=1)
    vq.set_state(init_vq_state(gen, 16, 2))
    z = torch.cat([torch.full((8, 2), 3.0), torch.full((24, 2), 9.0)])
    w = torch.cat([torch.ones(8), torch.zeros(24)])
    _, aux = vq(z, w)
    dead = aux["vq_counts"] == 0
    vq.ema_update(aux["vq_counts"], aux["vq_sums"], generator=gen, batch_z=z, batch_w=w)
    torch.testing.assert_close(vq.codebook[dead], torch.full((int(dead.sum()), 2), 3.0))


def test_ema_update_keeps_state_when_not_ok():
    """``ok`` False (a non-finite generator step) keeps every buffer."""
    vq = EMAVQ(16, 2, decay=0.5, dead_steps=1)
    vq.set_state(init_vq_state(torch.Generator().manual_seed(0), 16, 2))
    before = {n: getattr(vq, n).clone() for n in STATE_NAMES}
    z = torch.randn(32, 2, generator=torch.Generator().manual_seed(1))
    _, aux = vq(z)
    vq.ema_update(aux["vq_counts"], aux["vq_sums"], generator=torch.Generator(), batch_z=z,
                  ok=torch.tensor(False))
    assert all(torch.equal(getattr(vq, n), before[n]) for n in STATE_NAMES)
    vq.ema_update(aux["vq_counts"], aux["vq_sums"], ok=torch.tensor(True))
    assert not torch.equal(vq.codebook, before["codebook"])


def test_data_dependent_init_spreads_usage(rng):
    """``init_vq_state_from_latents`` seeds the codebook from valid
    latents: first-step usage spreads (perplexity > 16 of 64, above a
    unit-scale random codebook's), and rows weighted 0 are never drawn."""
    z = torch.from_numpy(rng.normal(size=(128, D)).astype(np.float32) * 0.05)
    garbage = torch.full((64, D), 9.0)
    zz = torch.cat([z, garbage])
    w = torch.cat([torch.ones(128), torch.zeros(64)])
    state = init_vq_state_from_latents(torch.Generator().manual_seed(0), zz, w, 64)
    assert float(state["codebook"].abs().max()) < 1.0
    assert torch.equal(state["ema_counts"], torch.ones(64)) and torch.equal(
        state["ema_sums"], state["codebook"])
    vq = EMAVQ(64, D)
    vq.set_state(state)
    _, aux = vq(zz, w)
    bad = EMAVQ(64, D)
    bad.set_state(init_vq_state(torch.Generator().manual_seed(0), 64, D))
    _, aux_bad = bad(zz, w)
    assert float(aux["perplexity"]) > 16.0
    assert float(aux["perplexity"]) > float(aux_bad["perplexity"])


@pytest.fixture(scope="module")
def vq_pair():
    """The JAX vq tokenizer (patch (2,4,4), f32, codebook 256 x 4, seq 128)
    with its seeded random codebook, and the port with both carried over."""
    rng = np.random.default_rng(5)
    jmodel = JTiTokModel(
        JTiTok(patch_size=PATCH, dtype=jnp.float32, attn_impl="reference", quantizer="vq",
               vq_codebook_size=N, vq_dim=D),
        seq_len=128, min_grid=(2, 8, 8), seed=3)
    # a codebook around the latents: at init every token latent sits within
    # about 0.003 of one point, so the seeded N(0,1) codebook gives them all
    # one code; this one spreads them, as the data-dependent init does
    params = from_flax_params(jax.tree.map(np.asarray, jmodel.params))
    vids = synthetic_videos(np.random.default_rng(1), 3)
    b = jmodel._pack(vids, [3, 8, 5]).device_arrays()
    _, aux = jmodel.module.apply({"params": jmodel.params}, b, jmodel.vq_state,
                                 method="encode_packed")
    z = np.asarray(aux["z"])[np.asarray(b["token_mask"])]
    cb = (z.mean(0) + 2.0 * z.std(0) * rng.normal(size=(N, D))).astype(np.float32)
    jmodel.vq_state = VQState(codebook=jnp.asarray(cb), ema_counts=jnp.ones(N),
                              ema_sums=jnp.asarray(cb), ages=jnp.zeros(N))
    port = TiTokModel(TiTok(patch_size=PATCH, dtype=torch.float32, quantizer="vq",
                            vq_codebook_size=N, vq_dim=D),
                      params=params, vq_state=from_vq_state(jmodel.vq_state, ""),
                      seq_len=128, min_grid=(2, 8, 8), device="cpu")
    return jmodel, port


def test_titok_vq_forward_matches_jax(vq_pair):
    """Carried params and codebook, f32: indices exact, recon within 1e-5."""
    jmodel, port = vq_pair
    vids = synthetic_videos(np.random.default_rng(1), 3)
    tcs = [3, 8, 5]
    recon, aux = port.forward(vids, tcs)
    jrecon, jaux = jmodel.forward(vids, tcs)
    for a, b in zip(aux["indices"], jaux["indices"]):
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(np.concatenate(aux["indices"]))) > 4
    for a, b in zip(recon, jrecon):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_titok_model_vq_serving(vq_pair):
    """The list-of-videos API for the EMA-VQ family (the port of the JAX
    package's test of the same name): encode lengths and range, forward
    shapes, and decoding the encoded ids reproduces forward's
    reconstruction (the straight-through codes equal codebook[indices]);
    encode and decode_indices agree with the JAX model."""
    jmodel, port = vq_pair
    vids = synthetic_videos(np.random.default_rng(0), 2)
    tcs = [3, 5]
    idx = port.encode(vids, tcs)
    assert [len(i) for i in idx] == tcs
    assert all(((i >= 0) & (i < N)).all() for i in idx)
    for a, b in zip(idx, jmodel.encode(vids, tcs)):
        np.testing.assert_array_equal(a, b)
    recs, aux = port.forward(vids, tcs)
    assert [r.shape for r in recs] == [v.shape for v in vids]
    assert [len(i) for i in aux["indices"]] == tcs
    grids = [v.shape[1:] for v in vids]
    recs2 = port.decode_indices(idx, grids)
    for a, b, c in zip(recs, recs2, jmodel.decode_indices(idx, grids)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(b, c, atol=1e-5, rtol=0)


def test_base_vq_config_builds():
    """``make_titok`` takes ``configs/base_vq.yaml``: the vq family at base
    width, the codebook and EMA statistics in the state dict as buffers,
    not parameters; an unseeded TiTokModel draws a random codebook."""
    cfg = load_config(os.path.join(REPO, "configs", "base_vq.yaml"))
    with torch.device("meta"):
        model = make_titok(cfg)
    assert model.quantizer == "vq" and model.token_size == 8 and model.codebook_size == 16384
    sd = model.state_dict()
    assert tuple(sd["quantize.codebook"].shape) == (16384, 8)
    assert tuple(sd["quantize.ema_sums"].shape) == (16384, 8)
    assert tuple(sd["quantize.ages"].shape) == (16384,)
    assert tuple(sd["decoder.proj_in.weight"].shape) == (768, 8)
    assert not any(n.startswith("quantize.") for n, _ in model.named_parameters())
    small = TiTokModel(TiTok(patch_size=PATCH, dtype=torch.float32, quantizer="vq",
                             vq_codebook_size=N, vq_dim=D),
                       seq_len=128, min_grid=(2, 8, 8), device="cpu", seed=4)
    cb = small.module.quantize.codebook
    assert cb.shape == (N, D) and 0.8 < float(cb.std()) < 1.2
