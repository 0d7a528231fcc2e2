"""Supervised training: ``python -m titok_tpu_torch.train``, restarted after a
crash or a planned stop (the JAX package's ``tools/train_supervised.py``,
whose behaviour this keeps; it imports nothing of it).

- **failure recovery**: a child that dies unexpectedly (a crash, an OOM
  kill) is relaunched with ``resume_from_checkpoint=true`` and continues
  from the newest checkpoint or host snapshot;
- **memory-bound restart**: when the child's RSS passes ``--rss-limit-gb``
  (after ``--min-lifetime-sec``, once the trainer's SIGTERM handler is
  installed), the supervisor sends SIGTERM; the trainer saves the current
  step and exits 143 (``Trainer._check_preempt``), and the relaunch resumes
  there, losing no step. A child that ignores SIGTERM for
  :data:`TERM_GRACE_SEC` is killed, and the relaunch resumes from the last
  save;
- **stopping the supervisor** (SIGTERM or SIGINT) forwards SIGTERM to the
  child and exits with the child's code without relaunching, so a later
  supervisor over the same run directory never finds a second trainer on
  it;
- a first launch over a run directory that already holds a checkpoint
  resumes it, with ``init_from_checkpoint=null`` appended last;
- ``--fast-fail-limit`` consecutive exits other than 143 within
  :data:`FAST_FAIL_SEC` of their launch (a bad override, missing weights)
  stop the supervisor: that is a crash loop, not a recovery.

Usage (the training CLI's arguments, ``--device`` too, plus the
supervisor's flags), from any directory:

    python -m titok_tpu_torch.tools.train_supervised config=configs/tiny.yaml \\
        [dotted.overrides=...] [--rss-limit-gb 80] [--poll-sec 20] \\
        [--max-restarts 50] [--min-lifetime-sec 180] [--fast-fail-limit 3]

The child is ``python -m titok_tpu_torch.train`` with this checkout's root
first on its ``PYTHONPATH``, in the supervisor's working directory. The
exit code is the child's last one (0: trained to ``max_steps``).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if __name__ == "__main__" and not __package__:  # run by its path
    sys.path.insert(0, REPO)

from titok_tpu_torch.config import load_config, parse_cli_overrides  # noqa: E402
from titok_tpu_torch.train_utils.checkpoints import CheckpointManager  # noqa: E402

# a child that ignores SIGTERM this long (a save that hangs) is killed
TERM_GRACE_SEC = 600.0
# an exit this soon after its launch counts toward --fast-fail-limit
FAST_FAIL_SEC = 120.0
DEFAULT_SAVE_PATH = "out_ckpt"


def _rss_gb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / (1024 * 1024)
    except OSError:
        pass
    return 0.0


def resolve_save_path(child_args: list[str]) -> str:
    """The run's checkpoint directory as the trainer resolves it: the YAML
    of ``config=`` through the port's ``config.py``, then the dotted
    overrides, the last one winning. An argument that is no ``key=value``
    (``--device cpu``, or a typo the child will refuse) is left out."""
    cli = parse_cli_overrides([a for a in child_args if "=" in a])
    save_path = DEFAULT_SAVE_PATH
    if "config" in cli:
        try:
            save_path = load_config(cli["config"]).get_dotted(
                "general.checkpoints.save_path") or save_path
        except Exception as e:  # noqa: BLE001 - the override below may still name it
            print(f"[supervisor] could not read save_path from the config: {e}", flush=True)
    return str(cli.get_dotted("general.checkpoints.save_path") or save_path)


def have_checkpoint(save_path: str) -> bool:
    """Whether ``save_path`` holds a checkpoint or a host snapshot that the
    trainer's resume (``CheckpointManager.restore_newest``) would take."""
    if not os.path.isdir(save_path):
        return False
    ckpt = CheckpointManager(save_path)
    return ckpt.latest_step() is not None or ckpt.latest_snapshot_step() is not None


def launch_args(child_args: list[str], have_ckpt: bool) -> list[str]:
    """The child's arguments: resume whenever the run directory holds a
    checkpoint, on the supervisor's first launch too (a supervisor started
    over an existing run continues it rather than train a fresh model over
    its checkpoints). ``init_from_checkpoint`` is cleared last: the weights
    were loaded in the run's first life, and the trainer refuses resume and
    init together."""
    if not have_ckpt:
        return list(child_args)
    return [*child_args,
            "general.checkpoints.resume_from_checkpoint=true",
            "general.checkpoints.init_from_checkpoint=null"]


def child_env() -> dict:
    """The supervisor's environment with this checkout's root first on
    ``PYTHONPATH``, so the child finds the package from any directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def main(argv: list[str]) -> int:
    rss_limit = 80.0
    poll_sec = 20.0
    max_restarts = 50
    fast_fail_limit = 3
    min_lifetime = 180.0
    child_args = []
    it = iter(argv)
    for a in it:
        if a == "--rss-limit-gb":
            rss_limit = float(next(it))
        elif a == "--poll-sec":
            poll_sec = float(next(it))
        elif a == "--max-restarts":
            max_restarts = int(next(it))
        elif a == "--min-lifetime-sec":
            min_lifetime = float(next(it))
        elif a == "--fast-fail-limit":
            fast_fail_limit = int(next(it))
        else:
            child_args.append(a)

    save_path = resolve_save_path(child_args)
    sup = {"child": None, "shutdown": False, "term_at": None}

    def on_signal(sig, frame):
        sup["shutdown"] = True
        c = sup["child"]
        print(f"[supervisor] received signal {sig}: forwarding SIGTERM to the child and "
              "exiting once it stops", flush=True)
        if c is not None and c.poll() is None:
            c.send_signal(signal.SIGTERM)
            if sup["term_at"] is None:
                sup["term_at"] = time.time()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    restarts = 0
    fast_fails = 0
    while True:
        args = launch_args(child_args, have_checkpoint(save_path))
        child = subprocess.Popen([sys.executable, "-m", "titok_tpu_torch.train", *args],
                                 env=child_env())
        sup["child"], sup["term_at"] = child, None
        if sup["shutdown"]:  # a signal that came while the child was launched
            child.send_signal(signal.SIGTERM)
            sup["term_at"] = time.time()
        print(f"[supervisor] launch (restart {restarts}, pid {child.pid}): {' '.join(args)}",
              flush=True)
        t_start = time.time()
        while True:
            rc = child.poll()
            if rc is not None:
                break
            rss = _rss_gb(child.pid)
            if (rss > rss_limit and sup["term_at"] is None and not sup["shutdown"]
                    and time.time() - t_start > min_lifetime):
                print(f"[supervisor] RSS {rss:.1f} GB > {rss_limit} GB: SIGTERM for "
                      "checkpoint-and-restart", flush=True)
                child.send_signal(signal.SIGTERM)
                sup["term_at"] = time.time()
            elif sup["term_at"] is not None and time.time() - sup["term_at"] > TERM_GRACE_SEC:
                print(f"[supervisor] the child ignored SIGTERM for {TERM_GRACE_SEC:.0f} s "
                      "(a save that hangs?): SIGKILL", flush=True)
                child.kill()
                sup["term_at"] = None
            time.sleep(poll_sec)

        if sup["shutdown"]:
            print(f"[supervisor] shutdown requested: the child exited rc={rc}, not "
                  "relaunching", flush=True)
            return rc
        if rc == 0:
            print("[supervisor] the child completed", flush=True)
            return 0
        if rc != 143 and time.time() - t_start < FAST_FAIL_SEC:
            fast_fails += 1
            if fast_fails >= fast_fail_limit:
                print(f"[supervisor] {fast_fails} consecutive exits with rc={rc} within "
                      f"{FAST_FAIL_SEC:.0f} s of launch: a deterministic failure, NOT "
                      "relaunching (fix the config or the arguments)", flush=True)
                return rc
        else:
            fast_fails = 0
        restarts += 1
        if restarts > max_restarts:
            print(f"[supervisor] giving up after {restarts} restarts (last rc={rc})",
                  flush=True)
            return rc
        kind = "planned (preemption save)" if rc == 143 else f"unexpected rc={rc}"
        print(f"[supervisor] the child exited: {kind}; resuming", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
