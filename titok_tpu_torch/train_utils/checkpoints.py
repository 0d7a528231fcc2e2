"""Checkpoints of the port's train state, with the reference's two load
modes (the JAX package's ``titok_tpu/train_utils/checkpoints.py``, whose
semantics this keeps in torch's own format: no orbax on the card).

A checkpoint is one directory per step, ``<save_path>/<step>/state.pt``:
``torch.save`` of a dict holding ``step``, the generator's and the
discriminator's state dicts (EMA-VQ's codebook and statistics are buffers
of the generator, so they travel with it), both optimizers' state dicts
and the ``noise_gen`` state of the R1/R2 noise and of EMA-VQ's dead-code
draws, all copied to the host first. It is written under a temporary name
and renamed, so a reader never sees half a checkpoint.

- periodic saves as orbax's policy makes them: a step is saved when no
  checkpoint exists yet or ``step % save_interval == 0``, and never at or
  below the newest; ``save_interval <= 0`` means no periodic saves;
- the ``keep_prior`` newest checkpoints are kept (-1 keeps all);
- re-saving an existing step is a no-op;
- host snapshots (``host_snapshot/<step>``, the newest only), and
  ``restore_newest`` takes the newer of checkpoint and snapshot;
- ``init_from_checkpoint``: :func:`restore_weights_only` loads the
  generator and discriminator weights by key (torch ``strict=False``),
  keeping fresh init for missing and mismatched keys.

A checkpoint of the JAX package (orbax) is read on a machine with JAX by
``tools/convert_orbax_to_torch.py``, which writes it in this format with
weights only (``step``, ``gen``, ``disc``; no optimizer or noise state):
:func:`restore_weights_only` loads it, and :meth:`CheckpointManager.restore`
refuses it with a message that names ``init_from_checkpoint``.
"""

from __future__ import annotations

import os
import shutil

import torch

STATE_FILE = "state.pt"


def _host(obj):
    """A copy of ``obj`` (nested dicts, lists, tensors) with every tensor
    on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def state_payload(state) -> dict:
    """What a checkpoint holds of a ``TrainState``, on the host."""
    return _host({
        "step": int(state.step),
        "gen": state.model.state_dict(),
        "disc": state.disc_model.state_dict() if state.disc_opt is not None else {},
        "gen_opt": state.gen_opt.state_dict(),
        "disc_opt": state.disc_opt.state_dict() if state.disc_opt is not None else None,
        "noise_gen": state.noise_gen.get_state(),
    })


def load_payload(state, payload: dict):
    """Put a checkpoint's contents into ``state`` (in place): weights,
    buffers, optimizer moments, step and the noise generator's state."""
    state.model.load_state_dict(payload["gen"])
    state.gen_opt.load_state_dict(payload["gen_opt"])
    if state.disc_opt is not None:
        state.disc_model.load_state_dict(payload["disc"])
        state.disc_opt.load_state_dict(payload["disc_opt"])
    state.noise_gen.set_state(payload["noise_gen"])
    state.step = int(payload["step"])
    return state


def _write(path: str, payload: dict) -> None:
    """``payload`` to ``path/state.pt``, written to a temporary directory
    and renamed into place."""
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    os.replace(tmp, path)


def _read(path: str) -> dict:
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=False)


def _read_full(path: str) -> dict:
    """A checkpoint to resume from: one that holds the optimizers' state.
    A weights-only one (``tools/convert_orbax_to_torch.py``) raises, naming
    the load modes that take it."""
    payload = _read(path)
    if "gen_opt" not in payload:
        raise ValueError(
            f"{path} holds weights only (no optimizer state), so a run cannot resume from it: "
            "load it with general.checkpoints.init_from_checkpoint=<its dir> or score it with "
            "python -m titok_tpu_torch.tools.evaluate --ckpt <its dir>")
    return payload


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.exists(os.path.join(directory, n, STATE_FILE)))


class CheckpointManager:
    def __init__(self, directory: str, save_interval: int = 1000, keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.save_interval = int(save_interval)
        self.keep = None if keep in (-1, None) else int(keep)
        os.makedirs(self.directory, exist_ok=True)
        self.snapshot_dir = os.path.join(self.directory, "host_snapshot")

    def all_steps(self) -> list[int]:
        return _steps(self.directory)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def maybe_save(self, step: int, state) -> bool:
        """Save if the interval policy wants this step (orbax's: the first
        save, or a multiple of ``save_interval``, above the newest)."""
        if self.save_interval <= 0:
            return False
        latest = self.latest_step()
        if latest is not None and latest >= int(step):
            return False
        if latest is not None and int(step) % self.save_interval:
            return False
        return self.save(step, state)

    def save(self, step: int, state) -> bool:
        """Save ``state`` as checkpoint ``step``; False if it exists."""
        step = int(step)
        if step in self.all_steps():
            return False
        _write(os.path.join(self.directory, str(step)), state_payload(state))
        if self.keep is not None:
            for old in self.all_steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        return True

    def restore(self, state, step: int | None = None):
        """Restore the full train state (resume mode), in place."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return load_payload(state, _read_full(os.path.join(self.directory, str(step))))

    # -- host snapshots -----------------------------------------------------

    def save_snapshot(self, step: int, state) -> None:
        """Persist ``state`` as the host snapshot of ``step``; keeps only the
        newest snapshot."""
        path = os.path.join(self.snapshot_dir, str(int(step)))
        if os.path.exists(path):
            return
        os.makedirs(self.snapshot_dir, exist_ok=True)
        _write(path, state_payload(state))
        for name in os.listdir(self.snapshot_dir):
            if name.isdigit() and int(name) != int(step):
                shutil.rmtree(os.path.join(self.snapshot_dir, name), ignore_errors=True)

    def latest_snapshot_step(self) -> int | None:
        steps = _steps(self.snapshot_dir)
        return steps[-1] if steps else None

    def restore_newest(self, state):
        """Resume from whichever is newer: the latest checkpoint or the
        latest host snapshot."""
        ckpt_step = self.latest_step()
        snap_step = self.latest_snapshot_step()
        if ckpt_step is None and snap_step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        if snap_step is not None and (ckpt_step is None or snap_step > ckpt_step):
            print(f"restored host snapshot at step {snap_step} "
                  f"(newer than checkpoint {ckpt_step})")
            return load_payload(state, _read_full(os.path.join(self.snapshot_dir, str(snap_step))))
        return self.restore(state, ckpt_step)


def _merge_by_key(module: torch.nn.Module, src: dict, prefix: str, report: dict) -> None:
    """Torch ``load_state_dict(strict=False)`` with shape checks: entries of
    ``module``'s state dict present in ``src`` with the same shape are
    loaded; missing and shape-mismatched ones keep their value and are
    reported; extra ``src`` entries are reported and ignored."""
    dst = module.state_dict()
    take = {}
    for k, v in dst.items():
        if k not in src:
            report["missing"].append(f"{prefix}/{k}")
        elif tuple(src[k].shape) != tuple(v.shape):
            report["mismatched"].append(f"{prefix}/{k}")
        else:
            take[k] = src[k]
    report["unexpected"] += [f"{prefix}/{k}" for k in src if k not in dst]
    module.load_state_dict(take, strict=False)
    report["loaded"] += len(take)


def restore_weights_only(path: str, state, verbose: bool = True, report: dict | None = None):
    """``init_from_checkpoint``: load the generator's (and, when both have
    one, the discriminator's) weights from a checkpoint directory (or its
    ``state.pt``) into ``state``, keeping the optimizers and step fresh.

    Tolerant like the reference's ``strict=False`` load: a disc-off
    checkpoint loads into a disc-on state and back, missing and
    shape-mismatched keys keep their fresh init. EMA-VQ's codebook and
    statistics are generator buffers, so they travel with the encoder.
    ``report``, when given, is filled with the count loaded and the keys
    missing, unexpected and mismatched (as printed)."""
    raw = _read(os.path.abspath(path))
    report = {} if report is None else report
    report.update({"loaded": 0, "missing": [], "unexpected": [], "mismatched": []})
    _merge_by_key(state.model, raw.get("gen", {}), "gen", report)
    if state.disc_opt is not None:
        _merge_by_key(state.disc_model, raw.get("disc", {}), "disc", report)
    if verbose:
        msg = f"init_from_checkpoint: {report['loaded']} tensors loaded"
        for k in ("missing", "unexpected", "mismatched"):
            if report[k]:
                msg += f"; {len(report[k])} {k} (kept init): {report[k][:4]}"
        print(msg)
    return state
