"""The port's fault-tolerant trainer on the CPU, at the reference's sizes
(``tests/test_trainer_runtime.py``: reduced qwen2-7b at d 64, 2 layers,
vocab 256, B 4 x 32 tokens): the loss falls; a failure injected at step
13 with checkpoints every 8 resumes at 8 and its losses equal the
uninterrupted run's bit for bit (every op on the CPU path is
deterministic), also when each checkpoint's write is held until the next
step has updated the parameters and moments in place; a straggler alarm snapshots at once; the first steps'
losses equal the JAX trainer's within float32 tolerance; and
``python -m repro_torch.launch.train --device cpu`` runs.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_arch as j_get_arch  # noqa: E402
from repro.data.tokens import TokenStream as JStream  # noqa: E402
from repro.data.tokens import TokenStreamConfig as JStreamConfig  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.launch.train import reduced_variant as j_reduced  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import make_data_fn, reduced_variant  # noqa: E402
from repro_torch.runtime.straggler import StepTimeMonitor  # noqa: E402
from repro_torch.runtime.trainer import (SimulatedFailure, Trainer,  # noqa: E402
                                         TrainerConfig)

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# the first steps' losses against JAX's: float32 sums in another order
# through forward, backward and update, compounding over the steps
# (measured at most 8.1e-8 relative over the three)
LOSS_RTOL = 1e-5


def _cfg():
    return dataclasses.replace(reduced_variant(get_arch("qwen2-7b"),
                                               d_model=64, n_layers=2),
                               vocab_size=256)


def _setup(tmp_path, total=24, fail_at=None, ckpt_every=8):
    cfg = _cfg()
    model = steps.make_model(cfg)
    opt = steps.make_optimizer(cfg, peak_lr=1e-3, warmup=5, total=total)
    data_fn = make_data_fn(cfg, 4, 32, torch.device("cpu"))
    params = model.init_params(0, device="cpu")
    return Trainer(TrainerConfig(
        total_steps=total, checkpoint_every=ckpt_every,
        checkpoint_dir=str(tmp_path), log_every=1000,
        fail_at_step=fail_at), steps.make_train_step(model, opt),
        data_fn, params, opt.init(params), logger=lambda s: None)


def test_loss_decreases(tmp_path):
    hist = _setup(tmp_path / "a", total=30).run()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, (first, last)


def test_failure_injection_and_exact_restart(tmp_path):
    ref_hist = _setup(tmp_path / "ref", total=20, ckpt_every=8).run()
    crash = _setup(tmp_path / "crash", total=20, fail_at=13, ckpt_every=8)
    # a step slowed by a loaded host can raise a straggler alarm and a
    # snapshot between the periodic ones: no alarm here (the alarm's own
    # snapshots are held to the same restart in the straggler tests)
    crash.monitor = StepTimeMonitor(z_thresh=float("inf"))
    with pytest.raises(SimulatedFailure):
        crash.run()
    assert [h["step"] for h in crash.history] == list(range(13))
    resume = _setup(tmp_path / "crash", total=20, ckpt_every=8)
    assert resume.maybe_restore()
    assert resume.start_step == 8
    resume_hist = resume.run()
    assert [h["step"] for h in resume_hist] == list(range(8, 20))
    ref_by_step = {h["step"]: h["loss"] for h in ref_hist}
    for h in resume_hist:
        assert h["loss"] == ref_by_step[h["step"]], h["step"]
    for h in crash.history:
        assert h["loss"] == ref_by_step[h["step"]], h["step"]


def _hold_writes(monkeypatch):
    """Hold every checkpoint write (``np.savez`` on the write thread) until
    one more step than at its start has run, or 10 s; returns the wrapper
    for a step function that counts the steps it ran."""
    done = []
    savez = np.savez

    def held_savez(*args, **kw):
        start, deadline = len(done), time.monotonic() + 10.0
        while len(done) <= start and time.monotonic() < deadline:
            time.sleep(0.002)
        return savez(*args, **kw)

    monkeypatch.setattr(np, "savez", held_savez)

    def counted(step_fn):
        def run(*args):
            out = step_fn(*args)
            done.append(threading.get_ident())
            return out
        return run
    return counted


def test_save_copies_cpu_leaves_before_the_write(tmp_path, monkeypatch):
    """``Checkpointer.save`` copies CPU leaves at the call: a tensor (and a
    QTensor payload) updated in place while the write is held still
    restores as it was when saved."""
    from repro_torch.optim.quantized import quantize
    counted = _hold_writes(monkeypatch)
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    qt = quantize(torch.linspace(-1.0, 1.0, 8))
    tree = {"w": w, "m": qt}
    want = {"w": w.clone(), "q": qt.q.clone(), "scale": qt.scale.clone()}
    ckpt = Checkpointer(tmp_path / "c")
    ckpt.save(3, tree, metadata={"step": 3})

    def bump():
        w.add_(1.0)
        qt.q.add_(1)
        qt.scale.mul_(2.0)
    counted(bump)()
    ckpt.wait()
    got, meta = ckpt.restore(tree, step=3)
    assert meta["step"] == 3
    assert torch.equal(got["w"], want["w"])
    assert torch.equal(got["m"].q, want["q"])
    assert torch.equal(got["m"].scale, want["scale"])


def test_exact_restart_with_writes_held_past_the_next_step(tmp_path,
                                                            monkeypatch):
    """As the restart test, with each checkpoint's write held until the
    following step has updated the parameters and AdamW's moments in
    place: the checkpoint labelled 8 holds step 8's state, and the rerun's
    losses equal the uninterrupted run's bit for bit."""
    ref = {h["step"]: h["loss"]
           for h in _setup(tmp_path / "ref", total=20).run()}
    counted = _hold_writes(monkeypatch)
    crash = _setup(tmp_path / "crash", total=20, fail_at=13)
    crash.step_fn = counted(crash.step_fn)
    # a held write slows the step it overlaps, which can raise a straggler
    # alarm and a snapshot at 10 between the periodic ones: no alarm here
    crash.monitor = StepTimeMonitor(z_thresh=float("inf"))
    with pytest.raises(SimulatedFailure):
        crash.run()
    resume = _setup(tmp_path / "crash", total=20)
    resume.step_fn = counted(resume.step_fn)
    resume.monitor = StepTimeMonitor(z_thresh=float("inf"))
    assert resume.maybe_restore() and resume.start_step == 8
    hist = resume.run()
    assert [h["step"] for h in hist] == list(range(8, 20))
    for h in hist:
        assert h["loss"] == ref[h["step"]], h["step"]


def test_straggler_snapshot_with_its_write_held_restarts_exactly(
        tmp_path, monkeypatch):
    """A straggler snapshot whose write is held until the next step has
    updated the state in place: the alarm planted on step 10 snapshots 11
    between the periodic 8 and the crash at 13, and the rerun resumes from
    it bit for bit as the uninterrupted run."""
    ref = {h["step"]: h["loss"]
           for h in _setup(tmp_path / "ref", total=20).run()}
    counted = _hold_writes(monkeypatch)
    crash = _setup(tmp_path / "crash", total=20, fail_at=13)
    crash.step_fn = counted(crash.step_fn)
    calls = []

    def observe(dt):
        calls.append(dt)
        return "straggler: injected" if len(calls) == 11 else None

    crash.monitor.observe = observe
    with pytest.raises(SimulatedFailure):
        crash.run()
    assert Checkpointer(tmp_path / "crash").all_steps() == [8, 11]
    resume = _setup(tmp_path / "crash", total=20)
    resume.step_fn = counted(resume.step_fn)
    resume.monitor.observe = lambda dt: None
    assert resume.maybe_restore() and resume.start_step == 11
    hist = resume.run()
    assert [h["step"] for h in hist] == list(range(11, 20))
    for h in hist:
        assert h["loss"] == ref[h["step"]], h["step"]


def test_straggler_alarm_snapshots(tmp_path):
    """A step the monitor flags is checkpointed at once, beside the
    periodic checkpoints, labelled with the steps it holds (the alarm on
    step 5 comes after it ran: 6); a run restored from it goes on bit for
    bit as the uninterrupted run."""
    trainer = _setup(tmp_path / "s", total=10, ckpt_every=8)
    calls = []

    def observe(dt):
        calls.append(dt)
        return "straggler: injected" if len(calls) == 6 else None

    trainer.monitor.observe = observe
    ref = {h["step"]: h["loss"] for h in trainer.run()}
    ckpt = Checkpointer(tmp_path / "s")
    assert ckpt.all_steps() == [6, 8]
    shutil.rmtree(tmp_path / "s" / "step_0000000008")
    resume = _setup(tmp_path / "s", total=10, ckpt_every=8)
    assert resume.maybe_restore() and resume.start_step == 6
    for h in resume.run():
        assert h["loss"] == ref[h["step"]], h["step"]


def test_first_losses_match_the_jax_trainer(tmp_path):
    """The same arch, init (PRNGKey(0) by threefry), token stream,
    schedule, clip and AdamW: the first three steps' losses."""
    n = 3
    port = _setup(tmp_path / "p", total=n, ckpt_every=100).run()
    jcfg = dataclasses.replace(j_reduced(j_get_arch("qwen2-7b"), d_model=64,
                                         n_layers=2), vocab_size=256)
    jm = j_steps.make_model(jcfg)
    jopt = j_steps.make_optimizer(jcfg, peak_lr=1e-3, warmup=5, total=n)
    step = jax.jit(j_steps.make_train_step(jm, jopt))
    stream = JStream(JStreamConfig(vocab_size=256, seq_len=32,
                                   global_batch=4))
    params = jm.init_params(jax.random.PRNGKey(0))
    state = jopt.init(params)
    for h in port:
        x, y = stream.train_pair(h["step"])
        params, state, m = step(params, state, {"inputs": jnp.asarray(x),
                                                "labels": jnp.asarray(y)})
        assert abs(h["loss"] - float(m["loss"])) <= LOSS_RTOL * float(
            m["loss"]), h["step"]


def test_train_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduce", "--steps", "4", "--batch", "2", "--seq", "16",
         "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "arch=qwen2-7b-reduced params=8.1M" in res.stdout
    assert "[train] done: first loss" in res.stdout
    assert Checkpointer(tmp_path / "ck").all_steps() == [2, 4]
