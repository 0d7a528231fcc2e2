"""The port's training supervisor (``titok_tpu_torch/tools/train_supervised.py``)
with the behaviours of the JAX package's (``tests/test_tools.py``): the save
path from the YAML through the port's config, resume on the first launch
over an existing run, the stop on a fast crash loop, SIGTERM forwarded to
the child without a relaunch; the checkpoint probe on the port's layout;
the RSS-triggered recycle and the SIGKILL of a child that ignores SIGTERM,
with fake children; and one real run on the CPU: ``python -m
titok_tpu_torch.train --device cpu`` under the supervisor, its child
SIGKILLed after the first checkpoint, the relaunch resuming and the run
ending rc 0 at ``max_steps``; and a resume that skips the seeded init. No
JAX here."""

import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.util import tiny_config
from titok_tpu_torch.config import Config
from titok_tpu_torch.tools import train_supervised as ts
from titok_tpu_torch.train_utils.checkpoints import STATE_FILE, CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def keep_signal_handlers():
    """``ts.main`` installs SIGTERM and SIGINT handlers: put the test
    process's back afterwards."""
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in old.items():
        signal.signal(s, h)


def _touch_checkpoint(path):
    os.makedirs(path, exist_ok=True)
    open(os.path.join(path, STATE_FILE), "wb").close()


def test_supervisor_resolves_save_path_from_yaml(tmp_path):
    """The YAML's save_path counts, not only the dotted override, or a
    relaunch after a crash would start again from step 0; the override wins,
    as in the trainer; ``--device`` is no override."""
    cfgpath = str(tmp_path / "cfg.yaml")
    with open(cfgpath, "w") as f:
        f.write("general:\n  checkpoints:\n    save_path: /tmp/from_yaml\n")
    assert ts.resolve_save_path([f"config={cfgpath}"]) == "/tmp/from_yaml"
    assert ts.resolve_save_path([f"config={cfgpath}", "--device", "cpu"]) == "/tmp/from_yaml"
    assert ts.resolve_save_path(
        [f"config={cfgpath}", "general.checkpoints.save_path=/tmp/cli"]) == "/tmp/cli"
    assert ts.resolve_save_path([]) == "out_ckpt"
    # the shipped config through the port's loader
    tiny = os.path.join(REPO, "configs", "tiny.yaml")
    assert ts.resolve_save_path([f"config={tiny}"]) == "out_ckpt"


def test_supervisor_resumes_on_first_launch_over_existing_run():
    """A supervisor started over a run directory with checkpoints resumes
    it, and clears a stale init_from_checkpoint after it (the overrides
    apply left to right)."""
    base = ["config=c.yaml", "training.main.max_steps=10"]
    assert ts.launch_args(base, have_ckpt=False) == base
    got = ts.launch_args(base, have_ckpt=True)
    assert got[:2] == base
    assert "general.checkpoints.resume_from_checkpoint=true" in got
    assert "general.checkpoints.init_from_checkpoint=null" in got
    withinit = base + ["general.checkpoints.init_from_checkpoint=w/5"]
    got = ts.launch_args(withinit, have_ckpt=True)
    assert got.index("general.checkpoints.init_from_checkpoint=null") > \
        got.index("general.checkpoints.init_from_checkpoint=w/5")


def test_checkpoint_probe_matches_the_port_layout(tmp_path):
    """The probe sees what ``CheckpointManager.restore_newest`` takes, so
    the two never disagree: a half-written ``<step>.tmp-<pid>`` directory
    or a step directory without ``state.pt`` is no checkpoint; a
    ``host_snapshot/<step>`` is one, and so is ``<step>/state.pt``."""
    run = str(tmp_path / "run")
    assert not ts.have_checkpoint(run)
    assert not os.path.exists(run)  # the probe creates nothing
    _touch_checkpoint(os.path.join(run, "4.tmp-123"))
    os.makedirs(os.path.join(run, "6"))
    assert not ts.have_checkpoint(run)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(run).restore_newest(None)
    _touch_checkpoint(os.path.join(run, "host_snapshot", "3"))
    assert ts.have_checkpoint(run)
    assert CheckpointManager(run).latest_snapshot_step() == 3
    ckpt_only = str(tmp_path / "ckpt")
    _touch_checkpoint(os.path.join(ckpt_only, "2"))
    assert ts.have_checkpoint(ckpt_only)


def test_supervisor_aborts_on_fast_crash_loop(monkeypatch, keep_signal_handlers, tmp_path):
    """A child that dies right after every launch fails deterministically:
    the supervisor stops after ``--fast-fail-limit`` attempts instead of
    relaunching up to ``--max-restarts``."""
    launches = []

    class FakeChild:
        pid = 4242

        def poll(self):
            return 1

    def fake_popen(args, **kw):
        launches.append(args)
        return FakeChild()

    monkeypatch.setattr(ts.subprocess, "Popen", fake_popen)
    rc = ts.main(["config=/nonexistent.yaml", f"general.checkpoints.save_path={tmp_path}",
                  "--fast-fail-limit", "3"])
    assert rc == 1
    assert len(launches) == 3
    assert launches[0][:3] == [sys.executable, "-m", "titok_tpu_torch.train"]


def test_supervisor_forwards_sigterm(monkeypatch, keep_signal_handlers, tmp_path):
    """SIGTERM to the supervisor goes on to the child, which saves and
    exits 143, and the supervisor exits 143 without a relaunch: a
    supervisor started later never finds a second trainer on the run."""
    launches, children = [], []

    class FakeChild:
        pid = os.getpid()  # read only for the RSS poll

        def __init__(self):
            self.got = []
            self.polls = 0

        def poll(self):
            self.polls += 1
            if self.got:
                return 143
            if self.polls == 1:
                os.kill(os.getpid(), signal.SIGTERM)  # to the supervisor
            return None

        def send_signal(self, sig):
            self.got.append(sig)

    def fake_popen(args, **kw):
        launches.append(args)
        children.append(FakeChild())
        return children[-1]

    monkeypatch.setattr(ts.subprocess, "Popen", fake_popen)
    rc = ts.main(["config=/nonexistent.yaml", f"general.checkpoints.save_path={tmp_path}",
                  "--poll-sec", "0.05"])
    assert rc == 143
    assert len(launches) == 1
    assert children[0].got == [signal.SIGTERM]


def test_supervisor_recycles_a_child_over_the_rss_limit(monkeypatch, keep_signal_handlers,
                                                        tmp_path, capsys):
    """Over ``--rss-limit-gb`` after ``--min-lifetime-sec`` the child gets
    SIGTERM (once), saves and exits 143; the relaunch resumes the run, and
    the supervisor exits with its code."""
    launches, children = [], []

    class FakeChild:
        pid = os.getpid()  # this process's RSS is over the limit below

        def __init__(self, rc_after_term):
            self.got = []
            self.rc = rc_after_term

        def poll(self):
            if self is children[-1] and len(children) == 2:
                return 0
            return self.rc if self.got else None

        def send_signal(self, sig):
            self.got.append(sig)
            _touch_checkpoint(str(tmp_path / "7"))  # the preemption save

    def fake_popen(args, **kw):
        launches.append(args)
        children.append(FakeChild(143))
        return children[-1]

    monkeypatch.setattr(ts.subprocess, "Popen", fake_popen)
    rc = ts.main(["config=/nonexistent.yaml", f"general.checkpoints.save_path={tmp_path}",
                  "--rss-limit-gb", "0.001", "--min-lifetime-sec", "0", "--poll-sec", "0.01"])
    out = capsys.readouterr().out
    assert rc == 0
    assert children[0].got == [signal.SIGTERM] and children[1].got == []
    assert "SIGTERM for checkpoint-and-restart" in out and "planned (preemption save)" in out
    assert "general.checkpoints.resume_from_checkpoint=true" not in launches[0]
    assert launches[1][-2:] == ["general.checkpoints.resume_from_checkpoint=true",
                                "general.checkpoints.init_from_checkpoint=null"]


def test_supervisor_kills_a_child_that_ignores_sigterm(monkeypatch, keep_signal_handlers,
                                                       tmp_path, capsys):
    """A child whose save hangs after SIGTERM is killed once the grace has
    passed (:data:`TERM_GRACE_SEC`, 600 s; 0.05 s here)."""
    children = []

    class FakeChild:
        pid = os.getpid()

        def __init__(self):
            self.got = []
            self.killed = False
            self.polls = 0

        def poll(self):
            self.polls += 1
            if self.killed:
                return -9
            if self.polls == 1:
                os.kill(os.getpid(), signal.SIGTERM)  # stop the supervisor
            return None

        def send_signal(self, sig):
            self.got.append(sig)

        def kill(self):
            self.killed = True

    def fake_popen(args, **kw):
        children.append(FakeChild())
        return children[-1]

    monkeypatch.setattr(ts, "TERM_GRACE_SEC", 0.05)
    monkeypatch.setattr(ts.subprocess, "Popen", fake_popen)
    rc = ts.main(["config=/nonexistent.yaml", f"general.checkpoints.save_path={tmp_path}",
                  "--poll-sec", "0.01"])
    assert rc == -9 and len(children) == 1
    assert children[0].got == [signal.SIGTERM] and children[0].killed
    assert "ignored SIGTERM" in capsys.readouterr().out


def _wait(cond, timeout: float, what: str, log=None):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"{what} within {timeout} s" + (
                f":\n{open(log).read()[-3000:]}" if log else ""))
        time.sleep(0.01)


def test_supervisor_resumes_a_killed_child_on_the_cpu(tmp_path):
    """The supervisor, started by its path from another directory, runs
    ``python -m titok_tpu_torch.train --device cpu`` on a tiny config; the
    child is SIGKILLed once its first checkpoint exists; the supervisor
    reports the unexpected exit and relaunches with resume, and the run
    ends rc 0 with its final checkpoint at ``max_steps``. (A checkpoint
    directory ``k`` holds the state after step ``k``, whose count is
    ``k + 1``, as the JAX trainer names them.)"""
    run = tmp_path / "run"
    cfg = Config(tiny_config(**{
        "dataset.train_dataset": "synthetic", "dataset.eval_dataset": "synthetic",
        "training.main.attn_impl": "flash_v1", "training.main.max_steps": 16,
        "training.eval.eval_step_interval": 0, "general.checkpoints.save_interval": 2,
        "general.checkpoints.save_path": str(run)}).to_dict())
    (tmp_path / "cfg.yaml").write_text(cfg.to_yaml())
    log = str(tmp_path / "supervisor.log")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    work = tmp_path / "elsewhere"
    work.mkdir()
    with open(log, "w") as out:
        sup = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "titok_tpu_torch", "tools", "train_supervised.py"),
             f"config={tmp_path / 'cfg.yaml'}", "--device", "cpu", "--poll-sec", "0.05"],
            cwd=str(work), env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        def launches():
            return re.findall(r"\[supervisor\] launch \(restart \d+, pid (\d+)\)", open(log).read())

        _wait(lambda: launches(), 60, "no launch line", log)
        _wait(lambda: CheckpointManager(str(run)).latest_step() is not None, 90,
              "no checkpoint", log)
        os.kill(int(launches()[0]), signal.SIGKILL)
        _wait(lambda: "unexpected rc=-9" in open(log).read(), 30, "no report of the kill", log)
        killed_at = CheckpointManager(str(run)).latest_step()
        assert sup.wait(timeout=120) == 0, open(log).read()[-3000:]
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait()
    text = open(log).read()
    assert len(launches()) == 2, text[-3000:]
    assert "unexpected rc=-9; resuming" in text
    second = text[text.index("launch (restart 1"):]
    assert "general.checkpoints.resume_from_checkpoint=true" in second.splitlines()[0]
    resumed = int(re.search(r"resumed from step (\d+)", second).group(1))
    assert resumed == killed_at + 1
    assert "the child completed" in text
    ckpt = CheckpointManager(str(run))
    assert ckpt.latest_step() == 16
    state = torch.load(os.path.join(str(run), "16", STATE_FILE), weights_only=False)
    assert state["step"] == 16 and state["optimizer"] == "adamw"


def test_resume_skips_the_seeded_init(tmp_path, monkeypatch, capsys):
    """A relaunch resumes without drawing the seeded init (the checkpoint's
    weights take its place; at large width it is most of a relaunch's
    start-up), and still trains on from the checkpoint."""
    from titok_tpu_torch.training import train_step
    from titok_tpu_torch.training.trainer import Trainer

    cfg = Config(tiny_config(**{
        "dataset.train_dataset": "synthetic", "dataset.eval_dataset": "synthetic",
        "training.main.attn_impl": "flash_v1", "training.main.max_steps": 1,
        "training.eval.eval_step_interval": 0,
        "general.checkpoints.save_path": str(tmp_path)}).to_dict())
    Trainer(cfg, device="cpu").fit()

    def no_init(*args, **kw):
        raise AssertionError("the seeded init ran on resume")

    monkeypatch.setattr(train_step, "init_params", no_init)
    cfg.set_dotted("training.main.max_steps", 2)
    cfg.set_dotted("general.checkpoints.resume_from_checkpoint", True)
    state = Trainer(cfg, device="cpu").fit()
    assert state.step == 2 and "resumed from step 1" in capsys.readouterr().out
