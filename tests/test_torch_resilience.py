"""The port's resilience layer (``core/resilience.py``, ``fit``'s policy
loop, ``kernels/fallback.py``, ``runtime/straggler.py``) against the JAX
package's contracts (``tests/test_resilience.py``), on the CPU:

  * the chunk's health telemetry on a healthy and a NaN run (with the
    first bad step), equal to the JAX chunk's; ``health_metrics=False``;
  * the policy's trip logic, failing closed on NaN telemetry;
  * injected NaN chunk -> rollback + backoff -> a finite embedding, and
    persistent divergence -> ``EmbeddingDiverged`` after ``max_retries``;
  * a clean run under a policy bit-identical to ``resilience=None``;
    preempt and resume bit-identical to the uninterrupted run, with the
    backoff scales carried in the checkpoint;
  * ``guarded`` a pass-through unless enabled, sticky demotion when
    enabled on the CPU, a demoted run bit-identical to a pre-demoted one;
    on the card a fault logged and raised, never demoted, and a run
    resumed past it bit-identical; build errors never demoted,
    ``LAUNCHES`` counting only launches that ran;
  * the health telemetry computed only under a policy;
  * the audit-triggered rollback and the straggler's early checkpoint.
"""
import dataclasses
import threading
import time
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import funcsne as jf  # noqa: E402
from repro.core import resilience as j_res  # noqa: E402
from repro.runtime import straggler as j_straggler  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.core.resilience import (EmbeddingDiverged,  # noqa: E402
                                         ResiliencePolicy)
from repro_torch.kernels import _build, fallback  # noqa: E402
from repro_torch.kernels.knn_merge import ops as merge_ops  # noqa: E402
from repro_torch.launch import embed as t_embed  # noqa: E402
from repro_torch.runtime import faults  # noqa: E402
from repro_torch.runtime.faults import (FaultScript,  # noqa: E402
                                        IndexCorruption, KernelLaunchFault,
                                        NaNChunk, Preempted, Preemption)
from repro_torch.runtime.straggler import StepTimeMonitor  # noqa: E402

torch.set_num_threads(1)
N, DIM = 48, 5


def _data(n=N, dim=DIM, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(2, dim)) * 5.0
    X = centers[rng.integers(0, 2, size=n)] + rng.normal(size=(n, dim))
    return X.astype(np.float32)


def _cfg(n=N, dim=DIM, **kw):
    kw.setdefault("n_negatives", 4)
    kw.setdefault("k_hd", min(32, n // 2))
    kw.setdefault("k_ld", min(16, n // 4))
    return tf.FuncSNEConfig(n_points=n, dim_hd=dim, **kw)


def _fit(X, **kw):
    return tf.fit(X, device="cpu", **kw)


def _assert_state_equal(a, b):
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), \
            f"state field {name!r} differs"


@pytest.fixture(autouse=True)
def _clean_registry():
    fallback.reset()
    yield
    fallback.reset()


# ---------------------------------------------------------------------------
# Health telemetry of the chunk runner


def _start(n=N):
    X, cfg = _data(n=n), _cfg(n=n)
    Xt = torch.from_numpy(X)
    hp = tf.default_hparams(n, device="cpu")
    st = tf.init_state(Xt, cfg, device="cpu")
    return Xt, cfg, hp, st


def test_health_metrics_healthy_run():
    X, cfg, hp, st = _start()
    _, _, m = tf.make_chunked_step(cfg, 4)(st, X, hp)
    assert float(m.finite_frac) == 1.0
    assert float(m.y_max_abs) > 0.0
    assert int(m.bad_step) == -1


def test_health_metrics_flag_nan_and_first_bad_step():
    X, cfg, hp, st = _start()
    Y = st.Y.clone()
    Y[0] = float("nan")
    _, _, m = tf.make_chunked_step(cfg, 4)(st._replace(Y=Y), X, hp)
    assert float(m.finite_frac) < 1.0
    assert int(m.bad_step) == 0          # poisoned before the first step
    # the max-|Y| probe ignores the non-finite entries it reports
    assert np.isfinite(float(m.y_max_abs))


def test_health_metrics_off_keep_initial_values():
    """``health_metrics=False`` computes no probe: the fields hold 1.0, 0.0
    and -1 even on a NaN run, as the JAX chunk's do, and a healthy chunk's
    state is the one the probed chunk gives."""
    X, cfg, hp, st = _start()
    st_off, _, _ = tf.make_chunked_step(cfg, 4, health_metrics=False)(
        st, X, hp)
    st_on, _, _ = tf.make_chunked_step(cfg, 4)(st, X, hp)
    _assert_state_equal(st_off, st_on)
    Y = st.Y.clone()
    Y[0] = float("nan")
    _, _, m = tf.make_chunked_step(cfg, 4, health_metrics=False)(
        st._replace(Y=Y), X, hp)
    assert (float(m.finite_frac), float(m.y_max_abs), int(m.bad_step)) \
        == (1.0, 0.0, -1)
    jcfg = jf.FuncSNEConfig(n_points=N, dim_hd=DIM, backend="xla",
                            n_negatives=4, k_hd=cfg.k_hd, k_ld=cfg.k_ld)
    jst = jf.init_state(jax.random.PRNGKey(0), jnp.asarray(_data()), jcfg)
    _, _, jm = jf.make_chunked_step(jcfg, 4, health_metrics=False)(
        jst._replace(Y=jst.Y.at[0].set(jnp.nan)), jnp.asarray(_data()),
        jf.default_hparams(N))
    assert (float(jm.finite_frac), float(jm.y_max_abs), int(jm.bad_step)) \
        == (1.0, 0.0, -1)


@pytest.mark.parametrize("poison_at", [None, 0, 3])
def test_health_metrics_match_jax(poison_at):
    """From one bridged state (Y poisoned at step ``poison_at`` of the
    chunk's input, or clean): the same first bad step, finite fraction and
    max |Y| as the JAX chunk's."""
    rng = np.random.default_rng(0)
    x = rng.integers(-12, 13, (4, 8))[rng.integers(0, 4, 64)] \
        + rng.integers(-3, 4, (64, 8))
    X = (x / 4.0).astype(np.float32)
    jcfg = jf.FuncSNEConfig(n_points=64, dim_hd=8, backend="xla")
    tcfg = tf.FuncSNEConfig(n_points=64, dim_hd=8)
    jst = jf.init_state(jax.random.PRNGKey(3), jnp.asarray(X), jcfg)
    if poison_at is not None:
        jst = jst._replace(Y=jst.Y.at[5].set(jnp.nan),
                           step=jnp.int32(poison_at))
    fields = {k: np.asarray(v) for k, v in jst._asdict().items()
              if k != "rng"}
    fields["rng"] = np.asarray(jax.random.key_data(jst.rng))
    tst = convert.state_from_numpy(fields, tcfg, "cpu")
    _, _, jm = jf.make_chunked_step(jcfg, 4)(
        jst, jnp.asarray(X), jf.default_hparams(64))
    _, _, tm = tf.make_chunked_step(tcfg, 4)(
        tst, torch.from_numpy(X), tf.default_hparams(64, device="cpu"))
    assert int(tm.bad_step) == int(jm.bad_step)
    assert float(tm.finite_frac) == float(jm.finite_frac)
    np.testing.assert_allclose(float(tm.y_max_abs), float(jm.y_max_abs),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# The policy


def test_policy_fields_and_defaults_equal_jax():
    """Every field of the JAX ResiliencePolicy, with its default; and the
    straggler monitor's."""
    for ours, theirs in ((ResiliencePolicy, j_res.ResiliencePolicy),
                         (StepTimeMonitor, j_straggler.StepTimeMonitor)):
        a = [(f.name, f.default) for f in dataclasses.fields(ours)]
        b = [(f.name, f.default) for f in dataclasses.fields(theirs)]
        assert a == b


def test_policy_check_trips_and_fails_closed():
    p = ResiliencePolicy()
    healthy = {"finite_frac": 1.0, "y_max_abs": 3.0, "bad_step": -1}

    class M:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    assert p.check(M(**healthy)) is None
    assert "non-finite" in p.check(M(**{**healthy, "finite_frac": 0.9,
                                        "bad_step": 7}))
    assert "explosion" in p.check(M(**{**healthy, "y_max_abs": 1e12}))
    # NaN telemetry must trip, not pass, every comparison
    assert p.check(M(**{**healthy, "finite_frac": float("nan")})) is not None
    assert p.check(M(**{**healthy, "y_max_abs": float("nan")})) is not None
    # the same reasons as the JAX policy's, on tensors too
    jp = j_res.ResiliencePolicy()
    for kw in (dict(finite_frac=0.5, bad_step=3), dict(y_max_abs=2e8)):
        m = M(**{k: torch.tensor(v) for k, v in {**healthy, **kw}.items()})
        assert p.check(m) == jp.check(M(**{**healthy, **kw}))


def test_audit_check_names_violations():
    X, cfg, _, st = _start()
    p = ResiliencePolicy()
    assert p.audit_check(tf.audit_state(st, cfg, X)) is None
    bad = st.hd_idx.clone()
    bad[0, 0] = N + 5
    reason = p.audit_check(tf.audit_state(st._replace(hd_idx=bad), cfg))
    assert reason == "state audit violation: hd_oob=1"


def test_event_log_and_sink():
    seen = []
    p = ResiliencePolicy(on_event=seen.append)
    ev = p.log("rollback", step=4, retry=1)
    assert ev == {"kind": "rollback", "step": 4, "retry": 1}
    assert p.events == seen == [ev]


# ---------------------------------------------------------------------------
# Rollback and retry


def test_nan_fault_rollback_recovers():
    X, cfg = _data(), _cfg()
    policy = ResiliencePolicy(max_retries=2)
    with faults.active(FaultScript(NaNChunk(at_step=4))):
        st, _ = _fit(X, cfg=cfg, n_iter=12, chunk_size=4, resilience=policy)
    assert bool(torch.isfinite(st.Y).all())
    assert int(st.step) == 12
    rollbacks = [e for e in policy.events if e["kind"] == "rollback"]
    assert len(rollbacks) == 1
    assert rollbacks[0]["lr_scale"] == pytest.approx(0.5)
    assert rollbacks[0]["step"] == 4
    assert "non-finite" in rollbacks[0]["reason"]


def test_rollback_retries_from_the_anchor_with_backoff():
    """The retried chunk starts from the clean anchor with lr halved: the
    run equals a clean run whose later chunks use the backed-off lr."""
    X, cfg = _data(), _cfg()
    policy = ResiliencePolicy(max_retries=2)
    hold = lambda it, n, h: h           # noqa: E731
    with faults.active(FaultScript(NaNChunk(at_step=4))):
        st, _ = _fit(X, cfg=cfg, n_iter=8, chunk_size=4, resilience=policy,
                     schedule=hold)
    hp = tf.default_hparams(N, device="cpu")
    ref, _ = _fit(X, cfg=cfg, n_iter=4, chunk_size=4, schedule=hold)
    ref, _ = _fit(X, cfg=cfg, n_iter=4, chunk_size=4, schedule=hold,
                  state=ref, hparams=tf._scaled_hp(hp, 0.5, 1.0))
    _assert_state_equal(st, ref)


def test_persistent_divergence_exhausts_retries():
    X, cfg = _data(), _cfg()
    policy = ResiliencePolicy(max_retries=2)
    with faults.active(FaultScript(NaNChunk(at_step=0, once=False))):
        with pytest.raises(EmbeddingDiverged) as ei:
            _fit(X, cfg=cfg, n_iter=8, chunk_size=4, resilience=policy)
    assert ei.value.retries == 2
    assert ei.value.step == 0
    kinds = [e["kind"] for e in policy.events]
    assert kinds.count("rollback") == 2 and "giving_up" in kinds


def test_clean_run_under_policy_is_bit_identical(tmp_path):
    X, cfg = _data(), _cfg()
    kw = dict(cfg=cfg, n_iter=8, chunk_size=4)
    st_plain, _ = _fit(X, **kw)
    policy = ResiliencePolicy(checkpoint_dir=str(tmp_path), audit_every=1,
                              sticky_fallback=False)
    st_pol, _ = _fit(X, resilience=policy, **kw)
    _assert_state_equal(st_plain, st_pol)
    assert policy.events == []
    assert fallback.demotions() == {}


def test_scaled_hp_identity_at_one():
    hp = tf.default_hparams(N, device="cpu")
    assert tf._scaled_hp(hp, 1.0, 1.0) is hp
    sc = tf._scaled_hp(hp, 0.5, 0.25)
    assert float(sc.lr) == float(hp.lr) * 0.5
    assert float(sc.exaggeration) == float(hp.exaggeration) * 0.25
    assert sc.lr.dtype == torch.float32


# ---------------------------------------------------------------------------
# Checkpoint / preemption / resume


def test_preempt_and_resume_is_bit_identical(tmp_path):
    X, cfg = _data(), _cfg()
    kw = dict(cfg=cfg, n_iter=12, chunk_size=4)
    st_ref, _ = _fit(X, **kw)

    ckdir = str(tmp_path / "ck")
    with faults.active(FaultScript(Preemption(at_step=8))):
        with pytest.raises(Preempted) as ei:
            _fit(X, resilience=ResiliencePolicy(checkpoint_dir=ckdir), **kw)
    assert ei.value.step == 8
    assert Checkpointer(ckdir).all_steps() == [4, 8]
    st_res, _ = _fit(X, resume_from=ckdir, resilience=ResiliencePolicy(
        checkpoint_dir=ckdir), **kw)
    assert int(st_res.step) == 12
    _assert_state_equal(st_ref, st_res)


def test_resume_without_policy_is_bit_identical(tmp_path):
    X, cfg = _data(), _cfg(c_hd_rev=2, cand_fused=False)
    kw = dict(cfg=cfg, n_iter=12, chunk_size=4)
    st_ref, _ = _fit(X, **kw)
    with faults.active(FaultScript(Preemption(at_step=4))):
        with pytest.raises(Preempted):
            _fit(X, resilience=ResiliencePolicy(
                checkpoint_dir=str(tmp_path)), **kw)
    st_res, _ = _fit(X, resume_from=str(tmp_path), **kw)
    _assert_state_equal(st_ref, st_res)


def test_resume_restores_backoff_scales(tmp_path):
    """The lr/exaggeration backoff survives a kill: the scales ride in the
    checkpoint's metadata, and the resumed run keeps them."""
    X, cfg = _data(), _cfg()
    ckdir = str(tmp_path / "ck")
    hold = lambda it, n, h: h           # noqa: E731
    kw = dict(cfg=cfg, n_iter=12, chunk_size=4, schedule=hold)
    policy = ResiliencePolicy(checkpoint_dir=ckdir, max_retries=2,
                              exaggeration_backoff=0.5)
    with faults.active(FaultScript(NaNChunk(at_step=4),
                                   Preemption(at_step=8))):
        with pytest.raises(Preempted):
            _fit(X, resilience=policy, **kw)
    _, meta = Checkpointer(ckdir).restore(
        tf.init_state(torch.from_numpy(X), cfg, device="cpu"))
    assert meta["lr_scale"] == pytest.approx(0.5)
    assert meta["ex_scale"] == pytest.approx(0.5)
    # the uninterrupted faulted run and the resumed one end equal
    with faults.active(FaultScript(NaNChunk(at_step=4))):
        st_ref, _ = _fit(X, resilience=ResiliencePolicy(
            max_retries=2, exaggeration_backoff=0.5), **kw)
    st_res, _ = _fit(X, resume_from=ckdir, resilience=ResiliencePolicy(
        checkpoint_dir=ckdir), **kw)
    _assert_state_equal(st_ref, st_res)


def test_fit_surfaces_async_checkpoint_failure(tmp_path, monkeypatch):
    X, cfg = _data(), _cfg()
    import repro_torch.checkpoint.checkpointer as ckm

    def boom(*a, **kw):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(ckm.np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        _fit(X, cfg=cfg, n_iter=8, chunk_size=4,
             resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path)))


def test_unobserved_write_error_warns_on_close(tmp_path, monkeypatch):
    import repro_torch.checkpoint.checkpointer as ckm

    def boom(*a, **kw):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(ckm.np, "savez", boom)
    ck = Checkpointer(tmp_path)
    ck.save(1, {"a": np.zeros(3)})
    with pytest.warns(RuntimeWarning, match="disk full"):
        ck.close()
    ck.wait()       # delivered once: nothing left to raise


# ---------------------------------------------------------------------------
# Sticky kernel fallback


def test_guarded_passthrough_when_disabled():
    def boom():
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        fallback.guarded("fam_test", boom, lambda: "ref")
    assert not fallback.is_demoted("fam_test")
    assert not fallback.is_enabled()


def test_guarded_demotes_sticky_when_enabled():
    calls = {"kernel": 0}

    def boom():
        calls["kernel"] += 1
        raise RuntimeError("launch failed")

    with fallback.enabled():
        with pytest.warns(RuntimeWarning, match="fam_test"):
            assert fallback.guarded("fam_test", boom, lambda: "ref") == "ref"
        assert fallback.guarded("fam_test", boom, lambda: "ref") == "ref"
    assert calls["kernel"] == 1          # sticky: no second launch try
    assert fallback.is_demoted("fam_test")
    assert not fallback.is_enabled()     # the scope restored the flag
    (ev,) = fallback.events()
    assert ev["kind"] == "kernel_demoted" and ev["family"] == "fam_test"


def test_guarded_on_card_reraises_and_never_demotes():
    """With no plain version given (the card), an enabled guard logs a
    raising launch as a kernel_fault event and raises it again: nothing is
    demoted, and the next call launches again.  A family demoted on the
    CPU still launches its kernel on the card."""
    calls = {"kernel": 0}

    def flaky():
        calls["kernel"] += 1
        if calls["kernel"] == 1:
            raise RuntimeError("launch failed")
        return "kernel"

    with fallback.enabled():
        with pytest.raises(RuntimeError, match="launch failed"):
            fallback.guarded("fam_test", flaky)
        assert fallback.guarded("fam_test", flaky) == "kernel"
        with pytest.warns(RuntimeWarning):
            fallback.demote("fam_cpu", "demoted on the CPU")
        assert fallback.guarded("fam_cpu", lambda: "kernel") == "kernel"
    assert calls["kernel"] == 2
    assert not fallback.is_demoted("fam_test")
    ev = fallback.events()
    assert [e["kind"] for e in ev] == ["kernel_fault", "kernel_demoted"]
    assert ev[0]["family"] == "fam_test" and "launch failed" in ev[0]["reason"]
    assert fallback.n_events() == 2 and fallback.events(1)[0]["family"] \
        == "fam_cpu"


def test_kernel_fault_on_card_surfaces_and_resumes(tmp_path, monkeypatch):
    """The card's contract, driven on the CPU by handing the guard no
    plain version: a KernelLaunchFault under sticky_fallback propagates
    out of fit as InjectedKernelFault with a kernel_fault event in
    policy.events and no demotion, and fit(resume_from=) of the last
    committed boundary ends bit for bit on the uninterrupted run."""
    monkeypatch.setattr(_build, "guarded",
                        lambda family, launch, ref=None:
                        fallback.guarded(family, launch or ref))
    X, cfg = _data(n=32), _cfg(n=32)
    kw = dict(cfg=cfg, n_iter=8, chunk_size=2)
    st_ref, _ = _fit(X, **kw)
    policy = ResiliencePolicy(checkpoint_dir=str(tmp_path),
                              checkpoint_every=1)
    # two knn_merge calls a step: launch 9 is in step 4, the third chunk
    with faults.active(FaultScript(KernelLaunchFault("knn_merge",
                                                     at_launch=9))):
        with pytest.raises(faults.InjectedKernelFault):
            _fit(X, resilience=policy, **kw)
    assert fallback.demotions() == {}
    (ev,) = [e for e in policy.events if e["kind"] == "kernel_fault"]
    assert ev["family"] == "knn_merge"
    assert not [e for e in policy.events if e["kind"] == "kernel_demoted"]
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
    st_res, _ = _fit(X, resilience=ResiliencePolicy(),
                     resume_from=str(tmp_path), **kw)
    _assert_state_equal(st_res, st_ref)


def test_fit_computes_health_only_under_a_policy(monkeypatch):
    """Nothing reads the health telemetry without a policy, so fit's
    chunks skip it there; the state is the same either way."""
    seen = []
    make = tf.make_chunked_step

    def spy(*a, **kw):
        seen.append(kw["health_metrics"])
        return make(*a, **kw)
    monkeypatch.setattr(tf, "make_chunked_step", spy)
    X, cfg = _data(n=32), _cfg(n=32)
    st0, _ = _fit(X, cfg=cfg, n_iter=4, chunk_size=2)
    st1, _ = _fit(X, cfg=cfg, n_iter=4, chunk_size=2,
                  resilience=ResiliencePolicy())
    assert seen == [False, True]
    _assert_state_equal(st0, st1)


@pytest.mark.parametrize("family,flags", [
    ("knn_merge", {}), ("ne_forces", {}), ("ne_forces", {"gather_fused": False}),
    ("pairwise_sqdist", {"merge_fused": False})])
def test_kernel_fault_demotes_and_matches_predemoted_run(family, flags):
    """A KernelLaunchFault under sticky_fallback demotes its family (a
    warning and an event in policy.events), and the run equals one with
    the family demoted beforehand, bit for bit."""
    X, cfg = _data(n=32), _cfg(n=32, **flags)
    kw = dict(cfg=cfg, n_iter=4, chunk_size=2)
    policy = ResiliencePolicy()
    with faults.active(FaultScript(KernelLaunchFault(family, at_launch=1))):
        with pytest.warns(RuntimeWarning, match=family):
            st_fault, _ = _fit(X, resilience=policy, **kw)
    assert family in fallback.demotions()
    dem = [e for e in policy.events if e["kind"] == "kernel_demoted"]
    assert len(dem) == 1 and dem[0]["family"] == family
    assert "InjectedKernelFault" in dem[0]["reason"]

    fallback.reset()
    with pytest.warns(RuntimeWarning):
        fallback.demote(family, "pre-demoted (parity reference)")
    with fallback.enabled():
        st_ref, _ = _fit(X, resilience=ResiliencePolicy(), **kw)
    _assert_state_equal(st_fault, st_ref)


def test_sticky_fallback_off_forces_the_guard_off():
    """sticky_fallback=False turns the guard off for the run, even inside
    an enabled scope: guarded is a pass-through, which consults no fault
    and demotes nothing; the scope's flag is back after the run."""
    X, cfg = _data(n=32), _cfg(n=32)
    fault = KernelLaunchFault("knn_merge")
    seen = []
    with faults.active(FaultScript(fault)), fallback.enabled():
        _fit(X, cfg=cfg, n_iter=2, chunk_size=2,
             resilience=ResiliencePolicy(sticky_fallback=False),
             callback=lambda it, st: seen.append(fallback.is_enabled()))
        assert fallback.is_enabled()
    assert seen == [False]
    assert not fault.fired and fallback.demotions() == {}


def _meta_merge_call():
    """A B4 HD call on meta tensors (no data: the C call is stubbed)."""
    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return (t((64, 8), torch.float32), t((64,), torch.int32),
            t((64, 16), torch.int32), t((64, 16), torch.float32),
            t((64, 10), torch.int32))


def test_build_error_is_never_demoted(monkeypatch):
    """The kernels build before the guarded launch: a build failure raises
    even with the guard on, and demotes nothing."""
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    monkeypatch.setattr(_build, "library", no_nvcc)
    with fallback.enabled():
        with pytest.raises(RuntimeError, match="nvcc"):
            merge_ops.knn_merge(*_meta_merge_call())
    assert fallback.demotions() == {}


def test_launches_count_only_launches_that_ran(monkeypatch):
    """On the card a faulting call raises and runs no plain version; the
    launches before and after the fault count, the faulting one does
    not."""
    launched, refs = [], []
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    monkeypatch.setattr(_build, "library", lambda: None)
    monkeypatch.setattr(merge_ops, "_run",
                        lambda entry, a, x: launched.append(entry))
    monkeypatch.setattr(merge_ops, "knn_merge_ref",
                        lambda *a, **kw: refs.append(a[0].device) or "ref")
    kernels.reset_launches()
    with faults.active(FaultScript(KernelLaunchFault("knn_merge",
                                                     at_launch=2))):
        with fallback.enabled():
            for i in range(4):
                if i == 2:
                    with pytest.raises(faults.InjectedKernelFault):
                        merge_ops.knn_merge(*_meta_merge_call())
                else:
                    merge_ops.knn_merge(*_meta_merge_call())
    assert launched == ["repro_knn_merge_lanes"] * 3
    assert kernels.LAUNCHES["knn_merge_lanes"] == 3
    assert refs == [] and fallback.demotions() == {}
    assert [e["kind"] for e in fallback.events()] == ["kernel_fault"]
    # disabled, the same launch path runs and counts as before
    fallback.reset()
    merge_ops.knn_merge(*_meta_merge_call())
    assert kernels.LAUNCHES["knn_merge_lanes"] == 4


def test_fallback_registry_is_thread_safe_under_churn():
    """One thread demotes fresh families and logs card faults while another
    reads events()/demotions()/is_demoted(): every access holds the lock,
    so no reader ever iterates a container mid-append."""
    stop = threading.Event()
    errors = []

    def boom():
        raise RuntimeError("launch failed")

    def writer():
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                i = 0
                while not stop.is_set():
                    fallback.demote(f"fam_{i}", "stress")
                    with fallback.enabled():
                        try:
                            fallback.guarded(f"card_{i}", boom)
                        except RuntimeError:
                            pass
                    i += 1
        except Exception as e:          # pragma: no cover - fail surface
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                for ev in fallback.events():
                    assert "kind" in ev
                d = fallback.demotions()
                assert all(isinstance(r, str) for r in d.values())
                fallback.is_demoted("fam_0")
                fallback.n_events()
                fallback.is_enabled()
        except Exception as e:          # pragma: no cover - fail surface
            errors.append(e)

    threads = [threading.Thread(target=writer),
               threading.Thread(target=reader)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors
    assert len(fallback.demotions()) > 0
    assert any(e["kind"] == "kernel_fault" for e in fallback.events())


# ---------------------------------------------------------------------------
# The chunk-boundary audit and the straggler watchdog


def test_audit_trips_rollback_in_fit_and_control_misses():
    """Finite index corruption is invisible to the NaN probes; with
    audit_every it trips the rollback path, without it the damage survives
    to the final state (the positive control)."""
    X, cfg = _data(), _cfg()
    Xt = torch.from_numpy(X)
    kw = dict(cfg=cfg, n_iter=16, chunk_size=4)

    policy = ResiliencePolicy(max_retries=2, audit_every=1)
    with faults.active(FaultScript(IndexCorruption(at_step=8))):
        st, _ = _fit(X, resilience=policy, **kw)
    kinds = [e["kind"] for e in policy.events]
    assert "audit_violation" in kinds and "rollback" in kinds, kinds
    assert int(st.step) == 16
    assert policy.audit_check(tf.audit_state(st, cfg, Xt)) is None

    ctrl = ResiliencePolicy(max_retries=2, audit_every=0)
    with faults.active(FaultScript(IndexCorruption(at_step=8))):
        st0, _ = _fit(X, resilience=ctrl, **kw)
    assert "rollback" not in [e["kind"] for e in ctrl.events]
    assert ctrl.audit_check(tf.audit_state(st0, cfg, Xt)) is not None


def test_step_time_monitor_alarms():
    m = StepTimeMonitor(warmup_steps=3, z_thresh=4.0, hang_timeout=5.0)
    assert [m.observe(0.1) for _ in range(3)] == [None] * 3
    assert m.observe(0.1) is None
    assert "straggler" in m.observe(1.0)
    assert "hang" in m.observe(6.0)
    jm = j_straggler.StepTimeMonitor(warmup_steps=3, z_thresh=4.0,
                                     hang_timeout=5.0)
    seq = [0.1, 0.12, 0.09, 0.1, 0.5, 0.11, 7.0, 0.1]
    m2 = StepTimeMonitor(warmup_steps=3, z_thresh=4.0, hang_timeout=5.0)
    assert [m2.observe(s) for s in seq] == [jm.observe(s) for s in seq]
    assert m2.mean == pytest.approx(jm.mean)


def test_straggler_alarm_triggers_early_checkpoint(tmp_path):
    """With the checkpoint cadence effectively off, every alarm still
    commits the boundary just reached (a kill after an alarm loses at most
    one chunk), and that boundary resumes bit-identically."""
    X, cfg = _data(), _cfg()
    # hang_timeout=0 makes every chunk an alarm; cadence 1000 means every
    # committed boundary below is an early one
    policy = ResiliencePolicy(checkpoint_dir=str(tmp_path),
                              checkpoint_every=1000,
                              hang_timeout=0.0, straggler_warmup=0)
    st, _ = _fit(X, cfg=cfg, n_iter=16, chunk_size=4, resilience=policy)
    kinds = [e["kind"] for e in policy.events]
    assert kinds.count("early_checkpoint") == 4, kinds
    assert kinds.count("straggler") == 4, kinds
    assert Checkpointer(tmp_path).latest_step() == 16
    st_res, _ = _fit(X, cfg=cfg, n_iter=16, chunk_size=4,
                     resilience=ResiliencePolicy(),
                     resume_from=str(tmp_path))
    _assert_state_equal(st, st_res)


# ---------------------------------------------------------------------------
# The CLI and the session example


def test_embed_cli_checkpoint_resume_and_audit(tmp_path, capsys):
    ckdir = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--dataset", "blobs", "--n", "200",
            "--iters", "20", "--chunk", "10", "--checkpoint-dir", ckdir,
            "--audit-every", "1"]
    t_embed.main(argv)
    assert Checkpointer(ckdir).all_steps() == [10, 20]
    steps = sorted((tmp_path / "ck").glob("step_*"))
    blob = bytearray((steps[-1] / "arrays.npz").read_bytes())
    blob[len(blob) // 2] ^= 0x01
    (steps[-1] / "arrays.npz").write_bytes(bytes(blob))
    t_embed.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "1 damaged boundary(ies) skipped" in out
    assert out.count("R_NX AUC=") == 2
    with pytest.raises(SystemExit):
        t_embed.main(["--device", "cpu", "--resume"])


def test_dynamic_stream_session_small(tmp_path):
    """The example's session at a small size: waves add rows, the removal
    keeps Y finite, the checkpoints span the session, no event fires."""
    from repro_torch.data.synthetic import blobs
    from repro_torch.examples import dynamic_stream

    X, labels = blobs(n=240, dim=8, n_centers=4, center_std=6.0, seed=0)
    waves = [np.arange(i * 80, (i + 1) * 80) for i in range(3)]
    lines = []
    st, policy, report = dynamic_stream.run_session(
        X, labels, waves, n_iter=20, remove_iters=10, chunk_size=10,
        sample=64, ckdir=str(tmp_path), log=lines.append, device="cpu")
    assert [r["active"] for r in report[:3]] == [80, 160, 240]
    assert report[3]["finite"] and report[3]["active"] \
        == 240 - int((labels == 0).sum())
    assert all(0.0 <= r["recall"] <= 1.0 for r in report[:3])
    assert report[0]["recall"] > 0.5
    assert policy.events == []
    # each fit counts its own healthy chunks: every wave commits step 20
    # (its second chunk), the removal's single chunk none
    assert Checkpointer(tmp_path).all_steps() == [20]
    assert len(lines) == 6 and lines[0].startswith("wave 0: 80 active")
