"""Reconstruction + adversarial loss system over packed buffers (reference
``model/losses/loss_module.py``; the JAX package's
``titok_tpu/losses/loss_module.py``).

Generator loss (ref ``loss_module.py:111-163``): per-sample L1 (equal
weight per clip whatever its size) + LPIPS and the Gram loss over K
randomly cropped frames (``:123-137``; the frames come from the host's
``PerceptualPlan``, ``ops/frames.py``) + the relativistic GAN term
``softplus(-(fake - real))`` through the discriminator, whose parameters
the caller leaves out of the generator's gradient.

Discriminator loss (ref ``loss_module.py:166-214``): ``softplus(-(real -
fake))`` + the finite-difference R1/R2 penalty (the discriminator again on
noise-perturbed inputs, ``(logits - logits_noised)²`` weighted
``gp_weight / gp_noise²``, arXiv 2509.24935) + the centering loss
``((real + fake)²)/2``.

The discriminator is a :class:`PackedEncoder` with ``out_channels=1`` and
4 register tokens per sample; a sample's logit is the mean of its
register-token outputs. All discriminator forwards of a step run as one
packed pass (:meth:`LossSystem.disc_logits_stacked`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from titok_tpu_torch.data.packing import max_samples_for
from titok_tpu_torch.losses.lpips import LPIPS
from titok_tpu_torch.models.blocks import PackedEncoder
from titok_tpu_torch.models.titok import init_params
from titok_tpu_torch.ops.frames import extract_perceptual_frames
from titok_tpu_torch.ops.patchify import decode_rows

DISC_TOKENS = 4  # register tokens per sample (ref loss_module.py:42)


def _per_sample_mean(values_rows, segment_ids, row_mask, num_segments):
    """Masked per-segment mean of per-row scalars -> ``[num_segments-1]``
    (segment 0, the padding, dropped). Each segment's sum is a reduction of
    its row of a dense ``[num_segments, rows]`` selection, which adds in a
    fixed order on every device, so two calls give the same bits (a sum by
    ``index_add`` adds by atomics on CUDA, in an order that changes from
    call to call)."""
    w = row_mask.to(torch.float32)
    segs = torch.arange(num_segments, device=values_rows.device)
    sel = segment_ids.long()[None, :] == segs[:, None]
    zero = w.new_zeros(())
    sums = torch.where(sel, values_rows * w, zero).sum(1)
    cnts = torch.where(sel, w, zero).sum(1)
    return (sums / torch.clamp(cnts, min=1.0))[1:]


def _masked_mean(x, mask):
    m = mask.to(torch.float32)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def stacked_segment_ids(segment_ids: torch.Tensor, n: int, B1: int) -> torch.Tensor:
    """Segment ids of ``n`` copies of one disc buffer stacked along the
    rows. Copy c's sample b gets ``b + c*(B1+1)`` and its pads ``B1 +
    c*(B1+1)`` (not 0), so the stacked ids stay non-decreasing, as the
    attention kernels' interval search needs, and pads attend only pads
    of their own copy."""
    stride = B1 + 1
    return torch.cat([torch.where(segment_ids > 0, segment_ids + c * stride,
                                  torch.full_like(segment_ids, B1 + c * stride))
                      for c in range(n)])


def num_perceptual_frames(config) -> int:
    """K, the perceptual plan's frame count: ``perceptual_samples_per_step
    + 1`` (the reference keeps K+1, ``loss_module.py:90-93``), or for -1
    (the reference's every frame) the static worst case, ``max_grid[0]``
    times the most samples a batch can hold."""
    n_perc = int(config.tokenizer.losses.perceptual_samples_per_step)
    if n_perc != -1:
        return n_perc + 1
    cs = config.training.sampling
    bmax = max_samples_for(int(cs.train_seq_len), cs.min_grid,
                           config.tokenizer.model.patch_size, cs.token_range[0])
    return int(cs.max_grid[0]) * bmax


class LossSystem:
    """The discriminator and LPIPS modules and the loss math.

    The discriminator computes in bf16 with fp32 parameters whatever
    ``training.main.precision`` says, and LPIPS in fp32, as the JAX package
    builds them. LPIPS's weights are frozen; ``TrainStepBuilder.init_state``
    loads them.
    """

    def __init__(self, config):
        loss_c = config.tokenizer.losses
        loss_d = config.discriminator.losses
        model_d = config.discriminator.model

        self.perceptual_weight = float(loss_c.perceptual_weight)
        self.gram_weight = float(loss_c.gram_weight)
        self.disc_weight = float(loss_c.disc_weight)
        self.gp_weight = float(loss_d.gp_weight)
        self.gp_noise = float(loss_d.gp_noise)
        self.centering_weight = float(loss_d.centering_weight)
        self.sample_size = int(loss_c.perceptual_sampling_size)
        self.num_frames = num_perceptual_frames(config)
        self.patch_size = tuple(config.tokenizer.model.patch_size)
        self.use_perceptual = self.perceptual_weight > 0 or self.gram_weight > 0
        self.use_disc = self.disc_weight > 0
        if tuple(model_d.patch_size) != self.patch_size:
            raise ValueError("disc patch_size must equal tokenizer patch_size in the "
                             "packed pipeline (both read the same patch rows)")

        self.disc_tokens = DISC_TOKENS
        self.lpips = LPIPS().requires_grad_(False) if self.use_perceptual else None
        self.disc_model = PackedEncoder(
            model_size=model_d.model_size,
            patch_size=self.patch_size,
            in_channels=3,
            out_channels=1,
            dtype=torch.bfloat16,
            attn_impl=str(config.training.main.get("attn_impl", "auto")),
            # the stacked disc pass holds the most activations of a step
            # (n copies of the batch): the config's remat applies here too
            remat=bool(config.training.main.get("remat", False)),
        )

    # -- discriminator plumbing -------------------------------------------
    def _disc_rows(self, patch_rows, disc):
        """Regather tokenizer patch rows into the disc slot layout [Sd, P]."""
        x = patch_rows[disc["patch_gather"].long()]
        return torch.where(disc["is_patch"][:, None], x, torch.zeros_like(x))

    def disc_logits(self, rows_d, disc):
        """Disc forward -> per-sample mean over register-token outputs
        (ref ``disc_wrapper``, loss_module.py:96-101)."""
        out = self.disc_model(rows_d, disc["token_mask"], disc["segment_ids"],
                              disc["rope_cos"], disc["rope_sin"])[:, 0]
        B1 = disc["sample_valid"].shape[0] + 1
        return _per_sample_mean(out.to(torch.float32), disc["segment_ids"],
                                disc["token_mask"], B1)

    def disc_logits_stacked(self, rows_list, disc):
        """All n disc forwards of a step as one packed forward over the n
        inputs stacked along the rows (:func:`stacked_segment_ids`); the
        block-diagonal attention keeps the copies independent. Returns
        ``[n, Bmax]`` logits."""
        n = len(rows_list)
        if n == 1:
            return self.disc_logits(rows_list[0], disc)[None]
        Bmax = disc["sample_valid"].shape[0]
        B1 = Bmax + 1
        stride = B1 + 1
        segs = stacked_segment_ids(disc["segment_ids"], n, B1)
        rows = torch.cat(rows_list, dim=0)
        tmask = disc["token_mask"].repeat(n)
        cos = disc["rope_cos"].repeat(n, 1)
        sin = disc["rope_sin"].repeat(n, 1)
        out = self.disc_model(rows, tmask, segs, cos, sin)[:, 0]
        all_means = _per_sample_mean(out.to(torch.float32), segs, tmask, n * stride + 1)
        # segment c*stride + b (b in 1..Bmax) -> index c*stride + b - 1
        return torch.stack([all_means[c * stride: c * stride + Bmax] for c in range(n)])

    # -- generator loss ----------------------------------------------------
    def generator_loss(self, recon_rows, batch, disc, perc=None):
        """``(total, {"gen/...": tensor})`` for decoder rows ``[S, P]``;
        ``disc`` is the DiscBatch on the device, or None; ``perc`` the
        PerceptualPlan on the device, or None (no perceptual terms)."""
        target_rows = decode_rows(batch["patches"], torch.float32)
        recon_f = recon_rows.to(torch.float32)
        seg = batch["segment_ids"]
        patch_mask = (~batch["token_mask"]) & (seg > 0)
        valid = batch["sample_valid"]
        B1 = valid.shape[0] + 1

        loss_dict = {}
        l1_rows = torch.abs(recon_f - target_rows).mean(dim=-1)
        recon_loss = _per_sample_mean(l1_rows, seg, patch_mask, B1)  # [Bmax]
        loss_dict["recon_loss"] = _masked_mean(recon_loss, valid)

        perceptual_loss = 0.0
        gram_loss = 0.0
        if self.use_perceptual and perc is not None:
            tgt_frames = extract_perceptual_frames(target_rows, perc, self.patch_size,
                                                   self.sample_size)
            rec_frames = extract_perceptual_frames(torch.clamp(recon_f, -1.0, 1.0), perc,
                                                   self.patch_size, self.sample_size)
            lp, gr = self.lpips(rec_frames, tgt_frames)
            w = perc["weight"]
            denom = torch.clamp(w.sum(), min=1.0)
            perceptual_loss = (lp * w).sum() / denom
            gram_loss = (gr * w).sum() / denom
            if self.perceptual_weight > 0:
                loss_dict["perceptual_loss"] = perceptual_loss
            if self.gram_weight > 0:
                loss_dict["gram_loss"] = gram_loss

        g_loss_mean = 0.0
        if self.use_disc and disc is not None:
            real, fake = self.disc_logits_stacked(
                [self._disc_rows(target_rows.detach(), disc),
                 self._disc_rows(recon_f, disc)], disc)
            g_loss = F.softplus(-(fake - real))
            g_loss_mean = _masked_mean(g_loss, valid)
            loss_dict["g_loss"] = g_loss_mean

        total = (_masked_mean(recon_loss, valid)
                 + self.perceptual_weight * perceptual_loss
                 + self.gram_weight * gram_loss
                 + self.disc_weight * g_loss_mean)
        loss_dict["total_loss"] = total
        return total, {"gen/" + k: v for k, v in loss_dict.items()}

    # -- discriminator loss -------------------------------------------------
    def discriminator_loss(self, recon_rows, batch, disc, noise=None, generator=None):
        """``(total, {"disc/...": tensor})``. ``recon_rows`` is detached by
        the caller. ``noise``: standard-normal ``[Sd, P]`` for the R1/R2
        penalty (scaled by ``gp_noise`` and zeroed off patch slots here);
        drawn from ``generator`` on the rows' device when not given."""
        target_rows = decode_rows(batch["patches"], torch.float32)
        recon_f = recon_rows.to(torch.float32)
        valid = batch["sample_valid"]
        loss_dict = {}

        rows_real = self._disc_rows(target_rows, disc)
        rows_fake = self._disc_rows(recon_f, disc)

        rows_list = [rows_real, rows_fake]
        if self.gp_weight > 0:
            if noise is None:
                noise = torch.randn(rows_real.shape, generator=generator,
                                    device=rows_real.device, dtype=torch.float32)
            noise = noise.to(rows_real.device, torch.float32) * self.gp_noise
            noise = torch.where(disc["is_patch"][:, None], noise, torch.zeros_like(noise))
            rows_list += [rows_real + noise, rows_fake + noise]
        logits = self.disc_logits_stacked(rows_list, disc)
        logits_real, logits_fake = logits[0], logits[1]

        logits_relative = logits_real - logits_fake
        d_loss = F.softplus(-logits_relative)
        loss_dict["d_loss"] = _masked_mean(d_loss, valid)
        loss_dict["logits_relative"] = _masked_mean(logits_relative, valid)

        gradient_penalty = 0.0
        if self.gp_weight > 0:
            r1 = (logits_real - logits[2]) ** 2
            r2 = (logits_fake - logits[3]) ** 2
            loss_dict["r1_penalty"] = _masked_mean(r1, valid)
            loss_dict["r2_penalty"] = _masked_mean(r2, valid)
            gradient_penalty = r1 + r2

        centering = 0.0
        if self.centering_weight > 0:
            centering = ((logits_real + logits_fake) ** 2) / 2
            loss_dict["centering_loss"] = _masked_mean(centering, valid)

        total = _masked_mean(
            d_loss
            + (self.gp_weight / self.gp_noise**2) * gradient_penalty
            + self.centering_weight * centering,
            valid,
        )
        loss_dict["total_loss"] = total
        return total, {"disc/" + k: v for k, v in loss_dict.items()}

    # -- init ---------------------------------------------------------------
    def init_disc_params(self, seed: int = 0) -> dict:
        """Seeded numpy weights for the discriminator, initialised as the
        reference inits a ``PackedEncoder``."""
        return init_params(self.disc_model, seed)
