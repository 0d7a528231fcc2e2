"""Training orchestration (reference ``train.py``; the JAX package's
``titok_tpu/training/trainer.py``): the single-device trainer.

The host loop is thin: a background thread packs batches and copies them
to the card (``data/prefetch.py``), the step (``train_step.py``) updates
the modules in place, and the loop logs scalars, runs the periodic eval
with PSNR/SSIM summed on the device, and saves checkpoints. With
``training.main.steps_per_call: K`` it takes K steps a call over K batches
stacked in one transfer (:meth:`Trainer._fit_scan`, the JAX package's
scan loop). The JAX package's parallel trainers are not ported (ROADMAP.md,
'Parallel modes').
"""

from __future__ import annotations

import copy
import os
import signal
import sys
import threading
import time
from typing import Iterator

import numpy as np
import torch

from titok_tpu_torch import resolve_device
from titok_tpu_torch.data.packing import (
    Packer,
    PackedBatch,
    build_disc_batch,
    to_device,
    unpack_indices,
    unpack_videos,
    wire_dtype,
)
from titok_tpu_torch.data.prefetch import PrefetchLoader
from titok_tpu_torch.losses.loss_module import LossSystem
from titok_tpu_torch.losses.lpips import lpips_params_for
from titok_tpu_torch.metrics.eval_metrics import EvalMetrics
from titok_tpu_torch.metrics.psnr_device import psnr_from_stats
from titok_tpu_torch.models.titok import make_titok
from titok_tpu_torch.ops.frames import (
    build_eval_frame_plan,
    build_perceptual_plan,
    max_eval_frames,
)
from titok_tpu_torch.ops.patchify import decode_rows
from titok_tpu_torch.train_utils.checkpoints import CheckpointManager, restore_weights_only
from titok_tpu_torch.train_utils.codebook_logging import CodebookLogger
from titok_tpu_torch.train_utils.logging import MetricsLogger
from titok_tpu_torch.train_utils.profiling import StepTimer, start_trace, stop_trace
from titok_tpu_torch.training.train_step import TrainStepBuilder


def synthetic_batches(config, eval: bool = False, seed: int = 0) -> Iterator[PackedBatch]:
    """Seeded random-clip stream through the packer, for data-free runs
    (``dataset.train_dataset: synthetic``): uniform [-1, 1] CTHW clips with
    each dim drawn between ``min_grid`` and ``max_grid`` in patch steps,
    rows rounded to the wire dtype. Training: endless, at
    ``train_seq_len``. ``eval``: ``eval_samples`` clips at ``eval_seq_len``,
    the partial last batch included. The same seed gives the JAX package's
    stream."""
    cs = config.training.sampling
    ps = list(config.tokenizer.model.patch_size)
    rng = np.random.default_rng(seed)

    def stream():
        n = 0
        limit = int(config.training.eval.eval_samples) if eval else None
        while limit is None or n < limit:
            dims = [int(rng.integers(lo // p, hi // p + 1)) * p
                    for lo, hi, p in zip(cs.min_grid, cs.max_grid, ps)]
            yield {"video": rng.uniform(-1, 1, size=[3] + dims).astype(np.float32), "fps": 4}
            n += 1

    packer = Packer(seq_len=int(cs.eval_seq_len if eval else cs.train_seq_len),
                    token_range=cs.token_range, patch_size=ps, min_grid=cs.min_grid, rng=rng,
                    dtype=wire_dtype(config), flush_final=eval)
    yield from packer(stream())


def select_data_backend(config):
    """Dataset backend by file extension (reference ``train.py:254-261``):
    ``.tar`` shards (``data/wds_dataset.py``) or a ``.csv`` list of clips
    (``data/csv_dataset.py``), plus ``synthetic`` for data-free runs. The
    eval set is read through the same backend."""
    path = str(config.dataset.train_dataset)
    if path == "synthetic":
        return synthetic_batches
    ext = path[-4:]
    if config.dataset.eval_dataset and str(config.dataset.eval_dataset) != "synthetic":
        if str(config.dataset.eval_dataset)[-4:] != ext:
            raise ValueError("train and eval datasets must share format")
    if ext == ".tar":
        from titok_tpu_torch.data.wds_dataset import wds_batches

        return wds_batches
    if ext == ".csv":
        from titok_tpu_torch.data.csv_dataset import csv_batches

        return csv_batches
    raise ValueError(f"Unsupported dataset format: {ext}")


def _host_scalars(metrics: dict) -> dict:
    """Metric values as floats, the device tensors fetched in one copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].detach().to(torch.float32).reshape(()) for k in keys])
        out.update(zip(keys, vals.cpu().tolist()))
    return {k: out[k] for k in metrics}


def _host_series(metrics: dict) -> dict:
    """Stacked ``[K]`` metric values as host arrays, the device tensors
    fetched in one copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: np.asarray(v, np.float64) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].detach().to(torch.float32) for k in keys]).cpu().numpy()
        out.update(zip(keys, vals))
    return {k: out[k] for k in metrics}


def _head(tree: dict | None, n: int) -> dict | None:
    """The first ``n`` entries of each stacked tensor of ``tree``."""
    return None if tree is None else {k: v[:n] for k, v in tree.items()}


class Trainer:
    def __init__(self, config, batches_fn=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        # built where they run: their default init, which init_state
        # overwrites, is then no host work (tens of seconds at large width)
        with torch.device(self.device):
            self.model = make_titok(config)
            self.loss_system = LossSystem(config)
        self.builder = TrainStepBuilder(self.model, self.loss_system, config)
        self.patch_size = list(config.tokenizer.model.patch_size)

        ce = config.training.eval
        self.codebook_logger = CodebookLogger(self.model.codebook_size) if ce.log_codebook \
            else None

        # PSNR/SSIM are summed on the device inside the eval step; SSIM's
        # device path needs frames at least as large as its 11x11 window,
        # so smaller eval grids go to the host hub, which shrinks the window
        cs = config.training.sampling
        im = [m for m in ce.log_metrics if m in ("psnr", "ssim")]
        if "ssim" in im and min(int(cs.min_grid[1]), int(cs.min_grid[2])) < 11:
            im.remove("ssim")
        self.device_im = tuple(im) if ce.get("device_metrics", True) else ()
        self.eval_metrics = EvalMetrics(config, skip=self.device_im, device=self.device)
        if "ssim" in self.device_im:
            self._eval_kmax = max_eval_frames(int(cs.eval_seq_len), cs.min_grid, self.patch_size)

        gw = config.general.wandb
        ck = config.general.checkpoints
        self.logger = MetricsLogger(out_dir=ck.get("save_path", "out_ckpt"),
                                    project=gw.get("project", ""), run_name=gw.get("run_name", ""))
        self.ckpt = CheckpointManager(ck.get("save_path", "out_ckpt"),
                                      save_interval=int(ck.get("save_interval", 1000)),
                                      keep=ck.get("keep_prior", 2))
        self.batches_fn = batches_fn or select_data_backend(config)
        # the JAX trainer's _load_lpips: raises here, before any step, when
        # the weights are missing and random ones are not allowed
        self.lpips_params = lpips_params_for(config) if self.loss_system.use_perceptual \
            else None
        self.max_grid = list(cs.max_grid)

    def _build_extras(self, batch: PackedBatch, rng: np.random.Generator) -> dict:
        """The discriminator's layout and the perceptual plan of ``batch``,
        the plan drawn from ``rng``."""
        ls = self.loss_system
        extras = {}
        if ls.use_disc:
            extras["disc"] = build_disc_batch(batch, ls.disc_tokens)
        if ls.use_perceptual:
            extras["perc"] = build_perceptual_plan(
                batch, num_frames=ls.num_frames, sample_size=ls.sample_size,
                patch_size=self.patch_size, max_grid_hw=self.max_grid[1:], rng=rng)
        return extras

    def _init_state(self, seed: int):
        """Fresh train state (seeded init; EMA-VQ draws its codebook from one
        probe batch), then resume or init from a checkpoint. On resume the
        checkpoint's weights take the seeded init's place, which is skipped:
        it would be overwritten, and at large width it is most of a
        relaunch's start-up."""
        probe = None
        if self.model.quantizer == "vq":
            batch = next(iter(self.batches_fn(self.config, eval=False, seed=seed)))
            probe = to_device(batch, self.device)
        ckpt_conf = self.config.general.checkpoints
        payload, params = None, {}
        if ckpt_conf.get("resume_from_checkpoint", None) and \
                not ckpt_conf.get("init_from_checkpoint", None):
            payload = self.ckpt.newest_payload()
            params = {"gen_params": payload["gen"], "disc_params": payload["disc"] or None}
        state = self.builder.init_state(seed=seed, device=self.device, batch=probe,
                                        lpips_params=self.lpips_params, **params)
        return self._maybe_restore(state, payload)

    def _maybe_restore(self, state, payload: dict | None = None):
        """Apply resume_from_checkpoint / init_from_checkpoint (mutually
        exclusive, reference train.py:239-241,265-267,285); ``payload``: the
        checkpoint to resume from, when already read."""
        ckpt_conf = self.config.general.checkpoints
        resume = ckpt_conf.get("resume_from_checkpoint", None)
        init = ckpt_conf.get("init_from_checkpoint", None)
        if resume and init:
            raise ValueError("Only one of resume_from_checkpoint and init_from_checkpoint "
                             "should be specified.")
        if resume:
            state = self.ckpt.restore_newest(state, payload)
            print(f"resumed from step {int(state.step)}", flush=True)
        elif init:
            state = restore_weights_only(init, state)
            print("initialized weights from checkpoint", flush=True)
        return state

    def fit(self):
        cfg = self.config
        cm = cfg.training.main
        max_steps = int(cm.max_steps)
        log_every = int(cfg.general.wandb.get("log_step_interval", 50))
        eval_every = int(cfg.training.eval.get("eval_step_interval", 1000))
        seed = int(cm.get("seed", 0))

        self._pre_fit_setup()
        state = self._init_state(seed)
        self._eval_step = self.builder.make_eval_metrics_step(self.device_im)
        steps_per_call = int(cm.get("steps_per_call", 1))
        loader = self._make_loader(seed, steps_per_call)
        previous = self._install_preemption_save()
        try:
            if steps_per_call > 1:
                return self._fit_scan(state, loader, steps_per_call, max_steps, log_every,
                                      eval_every)
            return self._fit_steps(state, loader, max_steps, log_every, eval_every)
        finally:
            loader.stop()
            self._restore_signal_handlers(previous)

    def _make_loader(self, seed: int, group: int = 1) -> PrefetchLoader:
        """The training stream prefetched to the device with its extras, in
        groups of ``group`` stacked batches when ``group > 1``; the plans'
        stream restarts at seed + 1 on resume, as JAX's does."""
        extras_rng = np.random.default_rng(seed + 1)
        return PrefetchLoader(lambda: self.batches_fn(self.config, eval=False, seed=seed),
                              build_extras=lambda b: self._build_extras(b, extras_rng),
                              device=self.device, group=group)

    def _fit_steps(self, state, loader, max_steps, log_every, eval_every):
        """One step a call."""
        cm = self.config.training.main
        train_step = self.builder.make_train_step()
        profile_dir = cm.get("profile_dir", None)
        profile_steps = cm.get("profile_steps", None)
        timer = StepTimer()
        prof = None
        t_last = time.time()
        tokens_since = 0
        last_eval = -1
        step_num = int(state.step)
        for dev_batch, batch, dev_extras in loader:
            if step_num >= max_steps:
                break
            if profile_dir and profile_steps and step_num == int(profile_steps):
                prof = start_trace(profile_dir)
            state, metrics, indices = train_step(state, dev_batch, dev_extras.get("disc"),
                                                 dev_extras.get("perc"))
            self._check_preempt(state)
            if prof is not None and step_num == int(profile_steps) + 3:
                stop_trace(prof)
                prof = None
            timer.tick()
            tokens_since += batch.seq_len

            if self.codebook_logger is not None:
                self.codebook_logger(unpack_indices(indices.cpu().numpy(), batch))

            if step_num % log_every == 0:
                scalars = {"train/" + k: v for k, v in _host_scalars(metrics).items()}
                dt = time.time() - t_last
                scalars["perf/tokens_per_sec"] = tokens_since / max(dt, 1e-9)
                scalars.update(timer.stats())
                t_last, tokens_since = time.time(), 0
                self.logger.log_metrics(scalars, step_num)
                self.logger.log_console(scalars, step_num)

            if eval_every and step_num > 0 and step_num % eval_every == 0:
                self.validate(state, step_num)
                last_eval = step_num

            self.ckpt.maybe_save(step_num, state)
            self._maybe_host_snapshot(state, step_num)
            step_num += 1
        if prof is not None:
            stop_trace(prof)

        # final eval: the loop exits at max_steps before the in-loop
        # trigger fires for that step
        if eval_every and step_num > 0 and step_num != last_eval:
            self.validate(state, step_num)
        self.ckpt.save(int(state.step), state)
        return state

    def _fit_scan(self, state, loader, K: int, max_steps, log_every, eval_every):
        """``training.main.steps_per_call: K``: K steps a call
        (``TrainStepBuilder.make_train_step_scan``) over K batches stacked
        in one transfer (``PrefetchLoader(group=K)``), with one fetch of the
        metrics and one of the indices a call (the JAX package's
        ``_fit_scan``).

        Eval, checkpoint and host snapshot fire on interval crossings: when
        a multiple of the interval falls inside a call's window of steps,
        the trigger runs at the end of that call (the state is then up to
        K - 1 steps past the multiple; exact when K divides the interval
        and the run starts aligned). Logging fetches the window's metrics
        once and logs each of its steps on the cadence. The tail of
        ``(max_steps - start) % K`` steps runs one step at a time over the
        first slices of the last stacked transfer. A preemption signal is
        acted on at the end of the call it arrived in."""
        cfg = self.config
        scan_step = self.builder.make_train_step_scan(K)
        timer = StepTimer(steps_per_tick=K)
        snap_every = int(cfg.general.checkpoints.get("host_snapshot_interval", 0))
        save_every = self.ckpt.save_interval

        def crossed(interval, start, end) -> bool:
            """A positive multiple of ``interval`` lies in (start, end]."""
            return bool(interval) and end // interval > start // interval

        t_last = time.time()
        tokens_since = 0
        last_eval = last_saved = -1
        step_num = int(state.step)
        for dev, batches, dev_extras in loader:
            if step_num >= max_steps:
                break
            take = min(len(batches), max_steps - step_num)
            if take < len(batches):  # the tail: the first slices of this transfer
                dev, batches = _head(dev, take), batches[:take]
                dev_extras = {k: _head(v, take) for k, v in dev_extras.items()}
            state, metrics, indices = scan_step(state, dev, dev_extras.get("disc"),
                                                dev_extras.get("perc"))
            self._check_preempt(state)
            start, step_num = step_num, step_num + take
            timer.tick()
            tokens_since += sum(b.seq_len for b in batches)

            if self.codebook_logger is not None:
                idx = indices.cpu().numpy()
                for j, b in enumerate(batches):
                    self.codebook_logger(unpack_indices(idx[j], b))

            if crossed(log_every, start - 1, step_num - 1) or start == 0:
                host = _host_series(metrics)  # one fetch for the window
                perf = {"perf/tokens_per_sec": tokens_since / max(time.time() - t_last, 1e-9),
                        **timer.stats()}
                t_last, tokens_since = time.time(), 0
                for j in range(take):
                    if (start + j) % log_every:
                        continue
                    scalars = {"train/" + k: float(v[j]) for k, v in host.items()}
                    scalars.update(perf)
                    self.logger.log_metrics(scalars, start + j)
                    self.logger.log_console(scalars, start + j)

            if crossed(eval_every, start, step_num):
                self.validate(state, step_num)
                last_eval = step_num
            if crossed(save_every, start, step_num):
                self.ckpt.save(step_num, state)
                last_saved = step_num
            elif crossed(snap_every, start, step_num):
                self.ckpt.save_snapshot(int(state.step), state)

        if eval_every and step_num > 0 and step_num != last_eval:
            self.validate(state, step_num)
        if last_saved != step_num:
            self.ckpt.save(int(state.step), state)
        return state

    def _maybe_host_snapshot(self, state, step_num: int):
        """Every ``general.checkpoints.host_snapshot_interval`` steps, persist
        the state as a host snapshot (skipped at periodic checkpoint steps,
        which already persist it)."""
        every = int(self.config.general.checkpoints.get("host_snapshot_interval", 0))
        if not every or step_num == 0 or step_num % every:
            return
        if self.ckpt.save_interval and step_num % self.ckpt.save_interval == 0:
            return
        self.ckpt.save_snapshot(int(state.step), state)

    def _pre_fit_setup(self):
        """``training.main.debug_nans`` turns on autograd's anomaly mode with
        NaN checks: a backward op that returns NaN raises with the trace of
        the forward op behind it (the JAX package's ``jax_debug_nans`` also
        catches NaN produced outside any backward). Then the resolved config
        is written to ``<save_path>/config.yaml``."""
        if self.config.training.main.get("debug_nans", False):
            torch.autograd.set_detect_anomaly(True, check_nan=True)
        out_dir = getattr(self.logger, "out_dir", "")
        if out_dir:
            with open(os.path.join(out_dir, "config.yaml"), "w") as f:
                f.write(self.config.to_yaml())

    # -- preemption ----------------------------------------------------------

    def _install_preemption_save(self) -> dict:
        """Failure recovery beyond the reference: on SIGTERM / SIGINT the run
        saves its state and stops. A torch step updates the modules in
        place, so a save from inside the handler could catch the generator
        updated and the discriminator not: the handler only notes the
        signal, and the loop saves at the next step boundary
        (:meth:`_check_preempt`). Returns the handlers it replaced."""
        self._preempt_signal = None

        def handler(signum, frame):
            self._preempt_signal = signum
            print(f"preemption signal {signum}: saving at the next step boundary", flush=True)

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):  # not the main thread
                pass
        return previous

    @staticmethod
    def _restore_signal_handlers(previous: dict) -> None:
        for sig, h in previous.items():
            signal.signal(sig, h)

    def _check_preempt(self, state):
        """At a step boundary after a preemption signal: save (time-bounded)
        and stop, with exit code 143 for SIGTERM, KeyboardInterrupt for
        SIGINT."""
        signum = getattr(self, "_preempt_signal", None)
        if signum is None:
            return
        self._save_with_fallback(state)
        if signum == signal.SIGINT:
            raise KeyboardInterrupt
        sys.exit(143)

    def _save_with_fallback(self, state, timeout_s: float | None = None) -> bool:
        """Preemption save with a bounded wait
        (``general.checkpoints.preemption_save_timeout_s``, default 180): the
        save runs in a worker thread and the caller gives up after the
        budget; the last host snapshot is then the newest state on disk."""
        if timeout_s is None:
            timeout_s = float(self.config.general.checkpoints.get(
                "preemption_save_timeout_s", 180.0))
        done = threading.Event()

        def attempt():
            try:
                self.ckpt.save(int(state.step), state)
                done.set()
            except Exception as e:  # pragma: no cover - diagnostics only
                print(f"preemption save failed: {e}", flush=True)

        t = threading.Thread(target=attempt, daemon=True)
        t.start()
        t.join(timeout_s)
        if done.is_set():
            print(f"preemption save at step {int(state.step)}", flush=True)
            return True
        print(f"preemption save did not finish within {timeout_s:.0f}s; relying on the "
              "last host snapshot", flush=True)
        return False

    # -- validation (reference train.py:118-163) -----------------------------

    def _eval_batches(self, cache_attr: str, config, cache: bool = True):
        """The packed eval stream of ``config`` (deterministic: seed 0),
        cached after its first pass when ``cache``."""
        if not cache:
            return self.batches_fn(config, eval=True, seed=0)
        if getattr(self, cache_attr, None) is None:
            setattr(self, cache_attr, list(self.batches_fn(config, eval=True, seed=0)))
        return getattr(self, cache_attr)

    def _eval_pass(self, batch, eval_step):
        """One eval batch on the device: ``(recon, stats)``."""
        plan = None
        if "ssim" in self.device_im:
            plan = to_device(build_eval_frame_plan(
                batch, num_frames=self._eval_kmax, patch_size=self.patch_size,
                max_grid_hw=self.max_grid[1:]), self.device)
        recon, _, stats = eval_step(to_device(batch, self.device), plan)
        return recon, stats

    def _device_scores(self, acc: dict | None, prefix: str) -> dict:
        """PSNR and SSIM from the device sums of an eval epoch."""
        acc = {} if acc is None else _host_scalars(acc)
        out = {}
        if "psnr" in self.device_im and acc:
            out[f"{prefix}psnr"] = psnr_from_stats(acc["psnr_sse"], acc["psnr_cnt"])
        if "ssim" in self.device_im and acc.get("ssim_cnt", 0) > 0:
            out[f"{prefix}ssim"] = acc["ssim_sum"] / acc["ssim_cnt"]
        return out

    def validate(self, state, step_num: int):
        ce = self.config.training.eval
        num_recon = int(ce.get("log_recon_num", 0))
        eval_samples = int(ce.get("eval_samples", 256))
        if ce.get("random_recon", False):
            recon_indexes = set(np.random.default_rng(step_num)
                                .permutation(eval_samples)[:num_recon].tolist())
        else:
            recon_indexes = set(range(num_recon))
        eval_step = getattr(self, "_eval_step", None) or \
            self.builder.make_eval_metrics_step(self.device_im)

        acc = None  # the device sums stay on the card until the epoch ends
        seen = shown = 0
        for batch in self._eval_batches("_eval_cache", self.config,
                                        bool(ce.get("cache_eval_batches", True))):
            recon_rows, stats = self._eval_pass(batch, eval_step)
            acc = stats if acc is None else {k: acc[k] + stats[k] for k in acc}
            # host rows only when a host metric or the recon logger needs them
            want_recon = any(i in recon_indexes
                             for i in range(seen, seen + batch.num_samples))
            if self.eval_metrics.metrics or want_recon:
                recon = unpack_videos(recon_rows.to(torch.float32).cpu().numpy(), batch,
                                      self.patch_size)
                target = unpack_videos(decode_rows(batch.patches, np.float32), batch,
                                       self.patch_size)
                self.eval_metrics.update(recon, target)
                for i, (x, y) in enumerate(zip(recon, target)):
                    if seen + i in recon_indexes:
                        shown += 1
                        merged = np.concatenate([y, np.clip(x, -1, 1)], axis=-1)
                        merged = merged.transpose(1, 2, 3, 0)  # CTHW -> THWC, W-concat
                        merged = ((merged + 1) / 2 * 255).astype(np.uint8)
                        self.logger.log_video(
                            f"Video recon {shown}", merged, step_num,
                            fps=float(batch.fps[i]) or 4,
                            caption=f"{int(batch.token_counts[i])} tokens")
            seen += batch.num_samples

        scores = self.eval_metrics.compute()
        self.eval_metrics.reset()
        scores.update(self._device_scores(acc, "eval/"))
        scores.update(self._train_probe_scores(state, eval_step))
        self.logger.log_metrics(scores, step_num)
        self.logger.log_console(scores, step_num)
        if self.codebook_logger is not None and self.codebook_logger.is_score_ready():
            self.logger.log_metrics(self.codebook_logger.get_scores(), step_num)
        return scores

    def _train_probe_scores(self, state, eval_step) -> dict:
        """Device PSNR/SSIM over a held-IN probe of TRAIN clips
        (``training.eval.train_probe_dataset``, same format as the eval set):
        ``eval/train_psnr`` / ``eval/train_ssim`` with the held-out
        protocol, to tell capacity limits from overfitting."""
        ce = self.config.training.eval
        probe_spec = ce.get("train_probe_dataset", None)
        if not probe_spec or not self.device_im:
            return {}
        pc = copy.deepcopy(self.config)
        pc.dataset.eval_dataset = probe_spec
        pc.training.eval.eval_samples = int(ce.get("train_probe_samples", 64))
        acc = None
        for batch in self._eval_batches("_train_probe_cache", pc):
            _, stats = self._eval_pass(batch, eval_step)
            acc = stats if acc is None else {k: acc[k] + stats[k] for k in acc}
        return self._device_scores(acc, "eval/train_") if acc is not None else {}
