"""The TiTok train step: generator update, then discriminator update
(reference ``train.py:48-115``; the JAX package's
``titok_tpu/training/train_step.py``).

One step: the generator's forward, loss (L1, LPIPS and Gram over the
perceptual plan's frames, GAN through the discriminator, plus the
commitment and entropy terms of EMA-VQ) and
gradient with respect to the generator's parameters only; the non-finite
guard, global-norm clipping and an update (AdamW or adafactor) at the
cosine schedule's lr; for EMA-VQ the codebook's EMA update from the
forward's statistics (kept as it was after a non-finite generator step);
then the
discriminator's loss on the detached reconstruction, its gradient, guard,
clipping and update at ``lr * disc_lr_ratio``. LPIPS's weights are
frozen constants of the loss (reference ``train.py:218-220``): no grad, no
optimizer, no checkpoint.

Optimizers mirror the JAX package's optax chains: ``optimizer.name:
adamw`` (the default) is ``clip_by_global_norm(max) -> adamw(sched, b1,
b2, eps=1e-8, wd)``:

- clipping in optax's form, ``g if norm < max else g / norm * max``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
- ``torch.optim.AdamW``, whose decoupled decay ``p - lr*wd*p`` and bias
  corrections equal optax's ``p - lr*(m̂/(√v̂+ε) + wd*p)``; its lr is set
  to ``sched(step)`` before each update, as optax reads the schedule at
  the update count;
- the non-finite guard zeroes the grads and the optimizer still steps, so
  the moments decay, the count advances and weight decay applies.

``optimizer.name: adafactor`` keeps the clipping and the guard and steps
:class:`training.adafactor.Adafactor` (factored second moments, block RMS
clip, bf16 momentum ``optimizer.adafactor_momentum``, decoupled weight
decay), both generator and discriminator.

``training.main.remat`` checkpoints every ``Attn`` and ``GEGLU`` call of
the tokenizer and the discriminator (``models/transformer.py``); the step
itself does not change. ``training.main.steps_per_call: K`` takes K
steps a call over K stacked batches (:meth:`TrainStepBuilder.
make_train_step_scan`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from titok_tpu_torch import resolve_device
from titok_tpu_torch.losses.lpips import lpips_params_for
from titok_tpu_torch.models.titok import TiTok, init_params, state_tensors
from titok_tpu_torch.models.vq import init_vq_state, init_vq_state_from_latents
from titok_tpu_torch.train_utils.lr_schedulers import get_scheduler
from titok_tpu_torch.training.adafactor import Adafactor


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates: the modules (their parameters are
    the generator's and the discriminator's params; EMA-VQ's codebook and
    statistics are buffers of ``model.quantize``), the optimizers with
    their moments, the step count and the random generator of the R1/R2
    noise and of EMA-VQ's dead-code draws."""

    step: int
    model: TiTok
    disc_model: torch.nn.Module
    gen_opt: torch.optim.Optimizer
    disc_opt: torch.optim.Optimizer | None
    noise_gen: torch.Generator


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm of all grads together, f32 (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))


def optimizer_step(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor], grads,
                   lr: float, max_grad_norm: float | None = None, guard: bool = True):
    """One update of ``params`` by ``opt`` at ``lr``: the global norm of
    ``grads`` (None for an unused param counts as zeros); the non-finite
    guard (all grads zeroed when the norm is not finite, without a host
    sync); optax's ``clip_by_global_norm`` (unchanged below
    ``max_grad_norm``, else ``g / norm * max_grad_norm``); ``opt.step()``.
    Returns ``(norm, zeroed, grads)``: the norm before the guard, 1.0 for a
    zeroed step else 0.0 (None without the guard), and the grads after the
    guard."""
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    norm = global_norm(grads)
    bad = None
    if guard:
        ok = torch.isfinite(norm)
        grads = [torch.where(ok, g, torch.zeros_like(g)) for g in grads]
        bad = 1.0 - ok.to(torch.float32)
    clipped = grads
    if max_grad_norm:
        clip_norm = global_norm(grads)
        keep = clip_norm < max_grad_norm
        clipped = [torch.where(keep, g, g / clip_norm * max_grad_norm) for g in grads]
    for p, g in zip(params, clipped):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    opt.zero_grad(set_to_none=True)
    return norm, bad, grads


@dataclasses.dataclass
class TrainStepBuilder:
    """Builds the train step from config + modules."""

    model: TiTok
    loss_system: object  # losses.loss_module.LossSystem
    config: object

    def make_optimizers(self):
        """The schedules of both optimizers; raises for an unknown
        ``optimizer.name``."""
        opt_c = self.config.optimizer
        cm = self.config.training.main
        self.optimizer_name = str(opt_c.get("name", "adamw")).lower()
        if self.optimizer_name not in ("adamw", "adafactor"):
            raise ValueError(f"optimizer.name={self.optimizer_name!r}: expected 'adamw' or "
                             "'adafactor'")
        lr = float(opt_c.learning_rate)
        elr = float(opt_c.end_lr)
        dlr = float(opt_c.get("disc_lr_ratio", 1.0))
        warm = int(opt_c.warmup_steps)
        max_steps = int(cm.max_steps)
        self.gen_sched = get_scheduler("cosine", warm, max_steps, lr, elr)
        self.disc_sched = get_scheduler("cosine", warm, max_steps, lr * dlr, elr * dlr)
        return self.gen_sched, self.disc_sched

    def _optimizer(self, params) -> torch.optim.Optimizer:
        """A fresh optimizer of ``optimizer.name`` over ``params`` (its lr is
        set before each step)."""
        opt_c = self.config.optimizer
        if self.optimizer_name == "adafactor":
            return Adafactor(params, momentum=float(opt_c.get("adafactor_momentum", 0.9)),
                             weight_decay=float(opt_c.weight_decay))
        return torch.optim.AdamW(
            params, lr=0.0, betas=(float(opt_c.beta1), float(opt_c.beta2)), eps=1e-8,
            weight_decay=float(opt_c.weight_decay))

    def init_state(self, seed: int | None = None, gen_params: dict | None = None,
                   disc_params: dict | None = None, device=None,
                   batch: dict | None = None, lpips_params: dict | None = None) -> TrainState:
        """Load the params (state dicts of numpy arrays or tensors, e.g. from
        ``weights.from_flax_train_state``; seeded init when None), move both modules
        to ``device`` (``cuda`` when None) and make fresh optimizers.

        With a perceptual loss, the loss system's LPIPS gets ``lpips_params``
        (``losses/lpips.py:lpips_params_for(config)`` when None, which
        raises without weights unless the config allows random ones),
        frozen, on ``device``.

        EMA-VQ: the codebook and its statistics come from ``gen_params``'
        ``quantize.*`` entries when it has them; else the codebook is drawn
        from the valid latents of ``batch`` (a ``to_device`` dict, the
        first training batch) under a random one, as the JAX package's
        ``init_state`` does."""
        self.make_optimizers()
        dev = resolve_device(device)
        if seed is None:
            seed = int(self.config.training.main.get("seed", 0))
        ls = self.loss_system
        if gen_params is None:
            gen_params = init_params(self.model, seed)
        sd = state_tensors(gen_params)
        vq = self.model.quantizer == "vq"
        data_init = vq and "quantize.codebook" not in sd
        if data_init:
            if batch is None:
                raise ValueError("EMA-VQ without a codebook in gen_params needs the first "
                                 "batch for its data-dependent codebook init")
            q = self.model.quantize
            sd.update({f"quantize.{k}": v for k, v in init_vq_state(
                torch.Generator().manual_seed(seed + 2), q.codebook_size,
                q.codebook_dim).items()})
        self.model.load_state_dict(sd)
        self.model.to(dev).train()
        if data_init:
            with torch.no_grad():
                _, aux = self.model.encode_packed(batch)
            gen = torch.Generator(device=dev).manual_seed(seed + 2)
            self.model.quantize.set_state(init_vq_state_from_latents(
                gen, aux["z"], batch["token_mask"], self.model.quantize.codebook_size))
        disc_opt = None
        if ls.use_disc:
            if disc_params is None:
                disc_params = ls.init_disc_params(seed + 1)
            ls.disc_model.load_state_dict(state_tensors(disc_params))
            ls.disc_model.to(dev).train()
            disc_opt = self._optimizer(ls.disc_model.parameters())
        if ls.use_perceptual:
            if lpips_params is None:
                lpips_params = lpips_params_for(self.config)
            ls.lpips.load_state_dict(state_tensors(lpips_params))
            ls.lpips.to(dev).requires_grad_(False)
        noise_gen = torch.Generator(device=dev)
        noise_gen.manual_seed(seed)
        return TrainState(step=0, model=self.model, disc_model=ls.disc_model,
                          gen_opt=self._optimizer(self.model.parameters()), disc_opt=disc_opt,
                          noise_gen=noise_gen)

    def make_train_step(self) -> Callable:
        """Returns ``train_step(state, batch, disc, perc=None, *, noise=None)
        -> (state, metrics, indices)``. ``batch``/``disc``/``perc`` (the
        PerceptualPlan; None leaves the perceptual terms out) are
        ``to_device`` dicts; ``noise`` is the standard-normal ``[Sd, P]`` draw of the R1/R2
        penalty, taken from ``state.noise_gen`` when None. The state is
        updated in place; metrics are detached 0-d tensors."""
        ls = self.loss_system
        cm = self.config.training.main
        clip = cm.get("max_grad_norm", None)
        guard = bool(cm.get("skip_nonfinite_grads", True))
        log_param_norms = bool(self.config.training.eval.get("log_grad_norms", False))
        gen_sched, disc_sched = self.gen_sched, self.disc_sched

        def update(module, opt, loss, lr, prefix, metrics, tag):
            """The optimizer step of ``module``; returns the guard's
            0-d bool "grads were finite" (None without the guard)."""
            params = list(module.parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            norm, bad, grads = optimizer_step(opt, params, grads, lr, clip, guard)
            metrics[f"grad_norm/{tag}"] = norm.detach()
            if guard:
                metrics[f"nonfinite_grad/{tag}"] = bad
            if log_param_norms:  # named as the JAX package names them
                for (name, p), g in zip(module.named_parameters(), grads):
                    if p.dim() == 2 and name.endswith(".weight"):  # a Dense kernel
                        name = name[: -len("weight")] + "kernel"
                    metrics[f"grad_2.0_norm/{prefix}{name.replace('.', '/')}"] = \
                        torch.sqrt(torch.sum(g.to(torch.float32) ** 2))
            return None if bad is None else bad == 0

        def train_step(state: TrainState, batch, disc, perc=None, *, noise=None):
            metrics = {}
            # -- generator update (ref train.py:64-84) ----------------------
            recon, aux = state.model(batch)
            loss, loss_dict = ls.generator_loss(recon, batch, disc, perc)
            if "commit_loss" in aux:  # EMA-VQ commitment term
                loss = loss + aux["commit_loss"]
                loss_dict["gen/commit_loss"] = aux["commit_loss"]
                loss_dict["gen/vq_perplexity"] = aux["perplexity"]
            if "entropy_loss" in aux:  # EMA-VQ entropy regulariser
                loss = loss + aux["entropy_loss"]
                loss_dict["gen/vq_entropy_loss"] = aux["entropy_loss"]
            metrics.update({k: v.detach() for k, v in loss_dict.items()})
            gen_ok = update(state.model, state.gen_opt, loss, gen_sched(state.step), "model/",
                            metrics, "generator")
            metrics["g_lr"] = gen_sched(state.step)

            # -- EMA codebook update (EMA-VQ only), before the disc update --
            if state.model.quantizer == "vq":
                vq = state.model.quantize
                vq.ema_update(aux["vq_counts"], aux["vq_sums"], generator=state.noise_gen,
                              batch_z=aux["z"], batch_w=batch["token_mask"], ok=gen_ok)
                metrics["vq/dead_code_fraction"] = vq.dead_code_fraction()

            # -- discriminator update (ref train.py:88-108) -----------------
            if ls.use_disc:
                d_loss, d_dict = ls.discriminator_loss(recon.detach(), batch, disc,
                                                       noise=noise, generator=state.noise_gen)
                metrics.update({k: v.detach() for k, v in d_dict.items()})
                update(state.disc_model, state.disc_opt, d_loss, disc_sched(state.step),
                       "disc/", metrics, "discriminator")
                metrics["d_lr"] = disc_sched(state.step)
            state.step += 1
            return state, metrics, aux["indices"]

        return train_step

    def make_train_step_scan(self, steps_per_call: int) -> Callable:
        """K train steps a call (``training.main.steps_per_call``; the JAX
        package's ``lax.scan`` over K stacked batches). Returns
        ``scan_step(state, batches, discs, percs=None) -> (state, metrics,
        indices)``: ``batches``/``discs``/``percs`` are dicts of tensors
        stacked on a leading axis of K (``PrefetchLoader(group=K)``; a
        shorter final group takes as many steps as it holds), and the step
        of :meth:`make_train_step` runs on each slice ``[j]`` in turn.
        Metrics come back stacked ``[K]`` (device tensors; the schedule's
        learning rates as a host array) and indices ``[K, S]``, with no
        host sync inside the call. Each step's activations are freed when
        it returns, so a call holds one step's, not K."""
        step = self.make_train_step()

        def scan_step(state: TrainState, batches, discs, percs=None):
            n = len(next(iter(batches.values())))
            if n > steps_per_call:
                raise ValueError(f"a group of {n} batches for a call of {steps_per_call} steps")
            ms, idxs = [], []
            for j in range(n):
                def at(tree):
                    return None if tree is None else {k: v[j] for k, v in tree.items()}

                state, m, ix = step(state, at(batches), at(discs), at(percs))
                ms.append(m)
                idxs.append(ix)
            metrics = {k: torch.stack([m[k] for m in ms])
                       if isinstance(ms[0][k], torch.Tensor) else np.asarray([m[k] for m in ms])
                       for k in ms[0]}
            return state, metrics, torch.stack(idxs)

        return scan_step

    def make_eval_step(self) -> Callable:
        """``eval_step(batch) -> (recon, indices)`` without gradients."""
        model = self.model

        def eval_step(batch):
            with torch.no_grad():
                recon, aux = model(batch)
            return recon, aux["indices"]

        return eval_step

    def make_eval_metrics_step(self, image_metrics=()) -> Callable:
        """``eval_step(batch, plan) -> (recon, indices, stats)`` without
        gradients, with the PSNR/SSIM sums of the batch computed on the
        device (``stats``: 0-d tensors ``psnr_sse``/``psnr_cnt`` and
        ``ssim_sum``/``ssim_cnt``), so only scalars cross to the host per
        eval epoch. ``plan`` is the eval-frame plan on the device
        (``ops/frames.py:build_eval_frame_plan``) when 'ssim' is among
        ``image_metrics``, else None."""
        from titok_tpu_torch.metrics.psnr_device import packed_psnr_stats
        from titok_tpu_torch.metrics.ssim_device import ssim_frames_stats
        from titok_tpu_torch.ops.frames import gather_frames
        from titok_tpu_torch.ops.patchify import decode_rows

        model = self.model
        want_psnr = "psnr" in image_metrics
        want_ssim = "ssim" in image_metrics
        patch_size = tuple(self.config.tokenizer.model.patch_size)

        def eval_step(batch, plan=None):
            with torch.no_grad():
                recon, aux = model(batch)
                stats = {}
                if want_psnr:
                    stats["psnr_sse"], stats["psnr_cnt"] = packed_psnr_stats(recon, batch)
                if want_ssim and plan is not None:
                    rec = gather_frames(torch.clamp(recon.to(torch.float32), -1.0, 1.0),
                                        plan, patch_size)
                    tgt = gather_frames(decode_rows(batch["patches"], torch.float32), plan,
                                        patch_size)
                    stats["ssim_sum"], stats["ssim_cnt"] = ssim_frames_stats(
                        rec, tgt, plan["scale"], plan["weight"])
            return recon, aux["indices"], stats

        return eval_step
