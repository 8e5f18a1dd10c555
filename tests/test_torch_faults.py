"""The port's in-process fault injectors (``repro_torch.runtime.faults``):
each fault's trigger and latch, the hooks, and the five ``--smoke``
scenarios on the CPU (NaN rollback, kernel fallback, preempt and resume,
corrupt restore, index audit), with the injectors' fields and defaults
held to the JAX package's.
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
                                  "Preemption"])
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
                                     "preempt_resume", "corrupt_restore",
                                     "index_audit"}


def test_smoke_main_reports_a_failing_scenario(monkeypatch, capsys):
    def broken(device):
        raise AssertionError("recovery path broke")
    monkeypatch.setitem(faults.SCENARIOS, "nan_rollback", broken)
    assert faults.main(["--smoke", "--device", "cpu", "--only",
                        "nan_rollback"]) == 1
    assert "nan_rollback: FAILED" in capsys.readouterr().out
