"""The port's in-process fault injectors (``repro_torch.runtime.faults``):
each fault's trigger and latch, the hooks, and the seven ``--smoke``
scenarios on the CPU (NaN rollback, kernel fallback, preempt and resume,
host loss on two gloo ranks, corrupt restore, index audit, a process kill
under the supervisor), with the injectors' fields and defaults held to the
JAX package's.
"""
import dataclasses
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.runtime import faults as j_faults  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.kernels import fallback  # noqa: E402
from repro_torch.runtime import faults  # noqa: E402
from repro_torch.runtime.faults import (CorruptShard, FaultScript,  # noqa: E402
                                        IndexCorruption,
                                        InjectedKernelFault,
                                        KernelLaunchFault, NaNChunk,
                                        Preempted, Preemption)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_registry():
    fallback.reset()
    yield
    fallback.reset()


def _state(n=40):
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    cfg = tf.FuncSNEConfig(n_points=n, dim_hd=4, k_hd=8, k_ld=4, c_hd_rev=2)
    return tf.init_state(X, cfg, device="cpu")


@pytest.mark.parametrize("name", ["NaNChunk", "IndexCorruption",
                                  "CorruptShard", "KernelLaunchFault",
                                  "Preemption", "HostLoss", "ProcessKill"])
def test_fault_fields_equal_jax(name):
    """The same fields and defaults as the JAX injector, ``shard`` (one
    rank's replica) included."""
    ours = [(f.name, f.default) for f in
            dataclasses.fields(getattr(faults, name))]
    theirs = [(f.name, f.default) for f in
              dataclasses.fields(getattr(j_faults, name))]
    assert ours == theirs


def test_nan_chunk_poisons_a_copy_once():
    st = _state()
    f = NaNChunk(at_step=4, rows=3)
    assert f.apply(st, 3) is st and not f.fired
    bad = f.apply(st, 4)
    assert f.fired
    assert bool(bad.Y[:3].isnan().all()) and bool(bad.Y[3:].isfinite().all())
    assert bool(st.Y.isfinite().all())       # the caller's state untouched
    assert f.apply(st, 8) is st              # one-shot
    g = NaNChunk(at_step=0, once=False, field="vel")
    assert bool(g.apply(st, 0).vel[:8].isnan().all())
    assert bool(g.apply(st, 1).vel[:8].isnan().all())


@pytest.mark.parametrize("field", ["hd_idx", "ld_idx", "rev_idx"])
def test_index_corruption_is_finite_and_out_of_range(field):
    st = _state()
    bad = IndexCorruption(at_step=0, field=field, rows=2).apply(st, 0)
    arr = getattr(bad, field)
    assert bool((arr[:2] == 40 + 12345).all())
    assert torch.equal(arr[2:], getattr(st, field)[2:])
    assert arr.dtype == torch.int32


def test_kernel_launch_fault_counts_its_family():
    f = KernelLaunchFault("knn_merge", at_launch=2)
    f.check("ne_forces")                 # another family: not counted
    f.check("knn_merge")
    f.check("knn_merge")
    with pytest.raises(InjectedKernelFault, match="launch 2"):
        f.check("knn_merge")
    f.check("knn_merge")                 # one-shot: latched
    assert f.fired


def test_preemption_fires_at_first_boundary_past_its_step():
    f = Preemption(at_step=6)
    f.check(4)
    with pytest.raises(Preempted) as ei:
        f.check(8)
    assert ei.value.step == 8
    f.check(12)


def test_host_loss_raises_once_at_first_boundary_past_its_step():
    f = faults.HostLoss(at_step=8, host=1)
    f.check(4)
    with pytest.raises(faults.HostLost) as ei:
        f.check(9)
    assert (ei.value.step, ei.value.host) == (9, 1)
    f.check(12)                     # one-shot: latched
    faults.maybe_host_loss(9)       # no script: a no-op
    with faults.active(faults.FaultScript(faults.HostLoss(at_step=0,
                                                          host=2))):
        with pytest.raises(faults.HostLost, match="host 2 at step 4"):
            faults.maybe_host_loss(4)


def test_process_kill_sigkills_only_its_pod_past_its_chunk():
    """In a child process: another pod's boundary and an earlier one leave
    it alive; its own boundary past ``at_chunk`` is a SIGKILL."""
    import os
    import subprocess
    import sys
    code = ("from repro_torch.runtime import faults\n"
            "k = faults.ProcessKill(at_chunk=8, pod=1)\n"
            "with faults.active(faults.FaultScript(k)):\n"
            "    faults.maybe_process_kill(12, 0)\n"
            "    faults.maybe_process_kill(4, 1)\n"
            "    print('alive', flush=True)\n"
            "    faults.maybe_process_kill(8, 1)\n"
            "print('survived', flush=True)\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=src))
    assert r.returncode == -9 and r.stdout == "alive\n", (r.returncode,
                                                          r.stdout, r.stderr)


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "delete"])
def test_corrupt_shard_damages_newest_committed_step(tmp_path, mode):
    ck = Checkpointer(tmp_path)
    for s in (1, 2):
        ck.save(s, {"Y": torch.arange(64.0)})
    f = CorruptShard(at_step=2, mode=mode)
    f.check(1, ck)
    assert not f.fired
    f.check(2, ck)                       # waits for the write in flight
    assert f.damaged == str(tmp_path / "step_0000000002" / "arrays.npz")
    _, meta, fbs = ck.restore_verified({"Y": torch.zeros(64)})
    assert meta["step"] == 1 and [b["step"] for b in fbs] == [2]
    with pytest.raises(ValueError, match="unknown"):
        CorruptShard(at_step=0, mode="melt").check(3, ck)


def test_hooks_are_no_ops_without_a_script(tmp_path):
    st = _state()
    assert faults.current() is None
    assert faults.corrupt_state(st, 100) is st
    faults.maybe_preempt(100)
    faults.check_kernel("knn_merge")
    faults.maybe_corrupt_checkpoint(100, Checkpointer(tmp_path))
    faults.maybe_corrupt_checkpoint(100, None)


def test_active_scripts_nest_and_restore():
    outer, inner = FaultScript(), FaultScript(Preemption(at_step=0))
    with faults.active(outer) as got:
        assert got is outer and faults.current() is outer
        with faults.active(inner):
            with pytest.raises(Preempted):
                faults.maybe_preempt(0)
        assert faults.current() is outer
    assert faults.current() is None


def test_script_dispatches_by_kind():
    st = _state()
    script = FaultScript(NaNChunk(at_step=0), IndexCorruption(at_step=0),
                         KernelLaunchFault("ne_forces"), Preemption(at_step=9))
    bad = script.corrupt_state(st, 0)
    assert bool(bad.Y[0].isnan().all()) and int(bad.hd_idx[0, 0]) == 12385
    script.maybe_preempt(8)
    with pytest.raises(InjectedKernelFault):
        script.check_kernel("ne_forces")
    script.check_kernel("knn_merge")


@pytest.mark.parametrize("name", sorted(faults.SCENARIOS))
def test_smoke_scenario(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        info = faults.SCENARIOS[name](device="cpu")
    assert isinstance(info, dict) and info
    assert faults.current() is None and not fallback.is_enabled()


def test_smoke_main_exit_code_and_lines(capsys):
    assert faults.main(["--smoke", "--device", "cpu", "--only",
                        "nan_rollback,preempt_resume"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "[faults] nan_rollback", "[faults] preempt_resume"]
    assert all(": OK in " in line for line in out)
    assert set(faults.SCENARIOS) == {"nan_rollback", "kernel_fallback",
                                     "preempt_resume", "host_loss",
                                     "corrupt_restore", "index_audit",
                                     "process_kill"}


def test_smoke_main_reports_a_failing_scenario(monkeypatch, capsys):
    def broken(device):
        raise AssertionError("recovery path broke")
    monkeypatch.setitem(faults.SCENARIOS, "nan_rollback", broken)
    assert faults.main(["--smoke", "--device", "cpu", "--only",
                        "nan_rollback"]) == 1
    assert "nan_rollback: FAILED" in capsys.readouterr().out
