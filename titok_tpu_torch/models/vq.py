"""EMA vector quantizer (VQ-VAE style) with commitment loss and dead-code
tracking: the quantizer family beside FSQ (the JAX package's
``titok_tpu/models/vq.py``).

Nearest-neighbour lookup through ``ops/vq_distance.py`` (the hand-written
kernel on the card), straight-through codes, and exponential-moving-average
codebook updates with Laplace smoothing (van den Oord et al. 2017 appendix,
Razavi et al. 2019):

    N_i <- decay * N_i + (1 - decay) * count_i
    m_i <- decay * m_i + (1 - decay) * sum_of_assigned_z_i
    c_i <- m_i / N_i_smoothed

The EMA state (the JAX ``VQState``: codebook, ema_counts, ema_sums, ages)
is four f32 buffers of :class:`EMAVQ`, so the module's ``state_dict()``
carries it; none is a parameter. :meth:`EMAVQ.ema_update` runs once per
train step after the optimizer, in place under ``torch.no_grad()``. Codes
unused for ``dead_steps`` consecutive steps are reseeded from random valid
batch latents; the codebook starts from the first batch's latents
(:func:`init_vq_state_from_latents`). Both guard against the cold-start
collapse of a scale-mismatched random codebook.

fp32 throughout whatever the compute dtype, like FSQ: quantization
boundaries must not move with bf16 noise.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from titok_tpu_torch.ops.vq_distance import vq_nearest

STATE_NAMES = ("codebook", "ema_counts", "ema_sums", "ages")
# rows per chunk of the entropy regulariser's [rows, N] soft assignment
ENTROPY_CHUNK = 512


def _state(codebook: torch.Tensor) -> dict[str, torch.Tensor]:
    N = codebook.shape[0]
    return {"codebook": codebook, "ema_counts": torch.ones(N, device=codebook.device),
            "ema_sums": codebook.clone(), "ages": torch.zeros(N, device=codebook.device)}


def init_vq_state(generator: torch.Generator, codebook_size: int,
                  dim: int) -> dict[str, torch.Tensor]:
    """A standard normal codebook on the generator's device, counts 1, sums
    equal to the codebook, ages 0."""
    return _state(torch.randn((codebook_size, dim), generator=generator,
                              device=generator.device))


def _draw_rows(generator: torch.Generator, weights: torch.Tensor | None, S: int,
               n: int) -> torch.Tensor:
    """``n`` row indices drawn with replacement, with probability
    proportional to ``weights`` (uniform over all rows when None, or when
    no weight is positive), without a host sync."""
    dev = generator.device
    if weights is None:
        return torch.randint(0, S, (n,), generator=generator, device=dev)
    w = weights.to(torch.float32)
    w = torch.where(w.sum() > 0, w, torch.ones_like(w))
    return torch.multinomial(w, n, replacement=True, generator=generator)


def init_vq_state_from_latents(generator: torch.Generator, z: torch.Tensor,
                               weights: torch.Tensor, codebook_size: int,
                               jitter: float = 0.05) -> dict[str, torch.Tensor]:
    """Data-dependent codebook: rows drawn with replacement from the
    first batch's *valid* latents (probability by ``weights``), plus
    per-dim jitter of ``jitter`` times the latents' weighted std, so
    duplicated picks separate. A random codebook at the wrong scale maps
    every latent to one code, and the commitment loss then glues the
    encoder to it."""
    zf = z.detach().to(torch.float32)
    w = weights.to(torch.float32)
    p = w / torch.clamp(w.sum(), min=1.0)
    pick = _draw_rows(generator, w, zf.shape[0], codebook_size)
    cb = zf[pick]
    mean = (zf * p[:, None]).sum(0)
    std = torch.sqrt(torch.clamp(((zf - mean) ** 2 * p[:, None]).sum(0), min=1e-12))
    noise = torch.randn(cb.shape, generator=generator, device=generator.device)
    return _state(cb + jitter * std * noise.to(cb.device))


class EMAVQ(nn.Module):
    """EMA-VQ codec over its own state buffers (FSQ's interface).

    ``impl``: 'auto' runs the nearest-neighbour kernel on CUDA tensors and
    its plain version on CPU tensors; 'reference' the plain version on any
    device."""

    def __init__(self, codebook_size: int, dim: int, commitment_weight: float = 0.25,
                 decay: float = 0.99, eps: float = 1e-5, dead_steps: int = 256,
                 entropy_weight: float = 0.0, entropy_tau: float = 0.2,
                 impl: str = "auto", cp_mesh=None):
        super().__init__()
        if cp_mesh is not None:
            raise NotImplementedError(
                "EMA-VQ under context parallelism (vq_nearest_cp) is not ported yet "
                "(ROADMAP.md, 'Parallel modes')")
        self.codebook_size = int(codebook_size)
        self.codebook_dim = int(dim)
        self.commitment_weight = float(commitment_weight)
        self.decay = float(decay)
        self.eps = float(eps)
        self.dead_steps = int(dead_steps)
        self.entropy_weight = float(entropy_weight)
        self.entropy_tau = float(entropy_tau)
        self.impl = impl
        N, D = self.codebook_size, self.codebook_dim
        for name, shape in zip(STATE_NAMES, ((N, D), (N,), (N, D), (N,))):
            self.register_buffer(name, torch.zeros(shape, dtype=torch.float32))

    @torch.no_grad()
    def set_state(self, state: Mapping) -> None:
        """Copy a state (``init_vq_state*`` or tensors under the buffer
        names) into the buffers, in place."""
        for name in STATE_NAMES:
            buf = getattr(self, name)
            buf.copy_(torch.as_tensor(state[name], dtype=torch.float32).to(buf.device))

    # -- forward ----------------------------------------------------------
    def forward(self, z: torch.Tensor, weights: torch.Tensor | None = None):
        """Quantize ``[S, D]`` latents. ``weights`` (f32 or bool ``[S]``,
        e.g. the token mask) scopes the statistics and losses to real slots.

        Returns ``(codes, aux)``: codes in z's dtype, equal in value to
        ``codebook[indices]`` with the gradient of z (straight-through);
        aux carries ``indices``, ``commit_loss``, the batch statistics
        ``vq_counts`` / ``vq_sums`` and ``perplexity`` (and
        ``entropy_loss`` when ``entropy_weight > 0``)."""
        orig_dtype = z.dtype
        zf = z.to(torch.float32)
        cb = self.codebook
        zs = zf.detach()
        indices, _ = vq_nearest(zs.contiguous(), cb, impl=self.impl)
        ix = indices.long()
        quantized = cb[ix]  # [S, D]; a buffer, so no gradient reaches it
        S = zf.shape[0]
        w = (torch.ones(S, dtype=torch.float32, device=z.device) if weights is None
             else weights.to(torch.float32))

        # commitment ||z - sg(q)||^2 (the codebook side is the EMA)
        commit = torch.sum(((zf - quantized) ** 2).mean(-1) * w) / torch.clamp(w.sum(), min=1.0)
        # straight-through: the value of q exactly, the gradient of z
        codes = quantized + (zf - zs)

        # batch statistics by index_add: never a one-hot [S, N]
        counts = torch.zeros(self.codebook_size, dtype=torch.float32,
                             device=z.device).index_add_(0, ix, w)
        sums = torch.zeros((self.codebook_size, self.codebook_dim), dtype=torch.float32,
                           device=z.device).index_add_(0, ix, zs * w[:, None])
        probs = counts / torch.clamp(counts.sum(), min=1.0)
        entropy = -torch.sum(torch.where(probs > 0, probs * torch.log(probs),
                                         torch.zeros_like(probs)))
        aux = {
            "indices": indices,
            "commit_loss": commit * self.commitment_weight,
            "vq_counts": counts,
            "vq_sums": sums,
            "perplexity": torch.exp(entropy),
        }
        if self.entropy_weight > 0:
            aux["entropy_loss"] = self.entropy_weight * self.entropy_loss(zf, cb, w)
        return codes.to(orig_dtype), aux

    def entropy_loss(self, zf: torch.Tensor, cb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Soft-assignment entropy regulariser (MAGVIT-v2, arXiv 2310.05737
        §3.1, adapted to EMA-VQ): the mean per-token assignment entropy
        (each token commits to one code) minus the entropy of the mean
        assignment (usage spreads). Logits are ``-d² / (tau * s)`` with the
        scale ``s = sg(mean |z|² + mean |c|²)``, so ``entropy_tau`` is
        relative. The codebook is a buffer, so the gradient shapes the
        encoder's latents.

        Computed ``ENTROPY_CHUNK`` rows at a time under activation
        checkpointing: neither the forward nor the saved activations of the
        backward hold the ``[S, N]`` assignment, only one chunk's."""
        cb2 = (cb ** 2).sum(-1)
        # the mean |z|² over S rounded up to whole chunks (the extra rows
        # count as zeros), as the JAX package pads before it takes the mean
        S = zf.shape[0]
        chunk = max(1, min(ENTROPY_CHUNK, S))
        rows = S + (-S) % chunk
        scale = self.entropy_tau * ((zf.detach() ** 2).sum() / rows + cb2.mean()) + 1e-12

        def per_chunk(z_, w_):
            d2 = (z_ ** 2).sum(-1, keepdim=True) - 2.0 * z_ @ cb.T + cb2[None]
            p = torch.softmax(-d2 / scale, dim=-1)
            h_tok = -(p * torch.log(p + 1e-30)).sum(-1)
            return (h_tok * w_).sum(), (p * w_[:, None]).sum(0)

        h_sum = zf.new_zeros(())
        p_sum = zf.new_zeros((cb.shape[0],))
        for a in range(0, S, chunk):
            z_, w_ = zf[a:a + chunk], w[a:a + chunk]
            if torch.is_grad_enabled() and z_.requires_grad:
                h, p = checkpoint(per_chunk, z_, w_, use_reentrant=False)
            else:
                h, p = per_chunk(z_, w_)
            h_sum = h_sum + h
            p_sum = p_sum + p
        wsum = torch.clamp(w.sum(), min=1.0)
        mean_p = p_sum / wsum
        diversity = -(mean_p * torch.log(mean_p + 1e-30)).sum()
        return h_sum / wsum - diversity

    # -- EMA codebook update (once per step, after the optimizer) ---------
    @torch.no_grad()
    def ema_update(self, counts: torch.Tensor, sums: torch.Tensor,
                   generator: torch.Generator | None = None,
                   batch_z: torch.Tensor | None = None,
                   batch_w: torch.Tensor | None = None,
                   ok: torch.Tensor | None = None) -> None:
        """Update the buffers in place from one step's ``counts`` / ``sums``.

        With ``generator`` and ``batch_z``: a code unused for ``dead_steps``
        consecutive steps is reseeded from a batch latent drawn from the
        rows ``batch_w`` weights (the packed buffer's other rows are
        garbage), with the fair-share count ``max(mean count, eps)``.
        Detection by age is scale-free; a count threshold would wait for the
        init count of 1 to decay. The draw happens every call, whether or not
        a code is dead, so the update never syncs with the host.

        ``ok`` (a 0-d bool tensor): where False the old state is kept, as
        the train step does after a non-finite generator step."""
        d = self.decay
        new_counts = d * self.ema_counts + (1 - d) * counts
        new_sums = d * self.ema_sums + (1 - d) * sums
        ages = torch.where(counts > 0, torch.zeros_like(self.ages), self.ages + 1.0)

        n = new_counts.sum()
        smoothed = (new_counts + self.eps) / (n + self.codebook_size * self.eps) * n
        codebook = new_sums / smoothed[:, None]

        if generator is not None and batch_z is not None:
            dead = ages >= self.dead_steps
            pick = _draw_rows(generator, batch_w, batch_z.shape[0], self.codebook_size)
            repl = batch_z.detach().to(torch.float32)[pick]
            fair = torch.clamp(new_counts.mean(), min=self.eps)
            codebook = torch.where(dead[:, None], repl, codebook)
            new_sums = torch.where(dead[:, None], repl * fair, new_sums)
            new_counts = torch.where(dead, fair, new_counts)
            ages = torch.where(dead, torch.zeros_like(ages), ages)

        for name, new in zip(STATE_NAMES, (codebook, new_counts, new_sums, ages)):
            buf = getattr(self, name)
            buf.copy_(new if ok is None else torch.where(ok, new, buf))

    # -- codec (FSQ-interface parity) --------------------------------------
    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        return self.codebook[indices.long()]

    def dead_code_fraction(self) -> torch.Tensor:
        """Fraction of codes unused for at least half the revival window (a
        leading indicator: fully dead codes are reseeded in ``ema_update``)."""
        return (self.ages >= max(self.dead_steps // 2, 1)).to(torch.float32).mean()
