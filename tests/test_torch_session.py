"""The port's session controls against the JAX package's: adding and
removing points, the state audit, ``rescale_embedding``, and ``fit``'s
``callback`` / ``early_stop`` / ``auto_rescale`` with the per-step host
loop for schedules that need a Python ``it``.

States are made by JAX and carried across with
``repro_torch.core.convert``.  Discrete results (the new lists of
``add_points``, the audit's counts) must be equal; steps are held as in
tests/test_torch_step.py (X quantised, discrete fields exact, floats
within F_RTOL of each field's largest entry).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import affinities as ja  # noqa: E402
from repro.core import funcsne as jf  # noqa: E402
from repro.core.knn import SENTINEL  # noqa: E402
from repro.data.synthetic import blobs  # noqa: E402
from repro_torch.core import affinities as ta  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.core import knn as tk  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.checkpoint import CheckpointNotFound  # noqa: E402
from repro_torch.core.resilience import ResiliencePolicy  # noqa: E402

torch.set_num_threads(1)
F_RTOL, F_ATOL = 1e-4, 1e-6
GAINS_FRAC = 0.01
BETA_RTOL = 1e-5
PERPLEXITY = 20.0


def _fields(st):
    out = {k: np.asarray(v) for k, v in st._asdict().items() if k != "rng"}
    out["rng"] = np.asarray(jax.random.key_data(st.rng))
    return out


def _problem(n=150, m=10, seed=0, inactive=0.0, **flags):
    """Quantised blobs and one JAX-made state (a share ``inactive`` of rows
    off, every k-th) bridged to the port."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-12, 13, (4, m))
    x = centers[rng.integers(0, 4, n)] + rng.integers(-3, 4, (n, m))
    X = (x / 4.0).astype(np.float32)
    active = np.ones(n, bool)
    if inactive:
        active[::int(round(1 / inactive))] = False
    jcfg = jf.FuncSNEConfig(n_points=n, dim_hd=m, backend="xla", **flags)
    tcfg = tf.FuncSNEConfig(n_points=n, dim_hd=m, **flags)
    jhp = jf.default_hparams(n, perplexity=PERPLEXITY)
    jst = jf.init_state(jax.random.PRNGKey(seed + 3), jnp.asarray(X), jcfg,
                        active=jnp.asarray(active), perplexity=jhp.perplexity)
    thp = tf.default_hparams(n, perplexity=PERPLEXITY, device="cpu")
    tst = convert.state_from_numpy(_fields(jst), tcfg, "cpu")
    return X, jcfg, tcfg, jhp, thp, jst, tst


def _assert_states_match(jst, tst, exact=False):
    a, b = _fields(jst), convert.state_to_numpy(tst)
    for name in ("hd_idx", "ld_idx", "new_flag", "active", "step", "rng",
                 "hd_d", "rev_idx", "rev_step"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    if exact:
        for name in a:
            np.testing.assert_array_equal(b[name], a[name], err_msg=name)
        return
    for name in ("Y", "vel", "ld_d"):
        fin = np.isfinite(a[name])
        np.testing.assert_array_equal(np.isfinite(b[name]), fin, err_msg=name)
        np.testing.assert_allclose(
            b[name][fin], a[name][fin], rtol=0,
            atol=F_RTOL * np.abs(a[name][fin]).max() + F_ATOL, err_msg=name)
    assert (b["gains"] != a["gains"]).mean() <= GAINS_FRAC
    np.testing.assert_allclose(b["beta"], a["beta"], rtol=BETA_RTOL)
    for name in ("zhat", "ema_new_frac"):
        np.testing.assert_allclose(b[name], a[name], rtol=1e-5, err_msg=name)


def _at_step(jst, tst, step):
    """Both states with their step count set to ``step``."""
    return (jst._replace(step=jnp.int32(step)),
            tst._replace(step=torch.tensor(step, dtype=torch.int32)))


def _jstep(jcfg):
    return jax.jit(lambda s, x, h: jf.funcsne_step(jcfg, s, x, h))


# --------------------------------------------------------------------------
# make_step, inactive rows, add_points / remove_points


def test_make_step_is_funcsne_step():
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(n=60)
    Xt = torch.from_numpy(X)
    a = tf.make_step(tcfg)(tst, Xt, thp)
    b = tf.funcsne_step(tcfg, tst, Xt, thp)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("flags", [{}, dict(scatter_fused=False),
                                   dict(cand_fused=False)])
def test_steps_with_inactive_rows_match_jax(flags):
    """Three steps with 20% of the rows inactive: the default path (B1-B3),
    B5 with the segment sum, and the threefry path with B4."""
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(inactive=0.2, **flags)
    assert int((~tst.active).sum()) == 30
    step = _jstep(jcfg)
    Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    for _ in range(3):
        jst = step(jst, Xj, jhp)
        tst = tf.funcsne_step(tcfg, tst, Xt, thp)
        _assert_states_match(jst, tst)
    off = ~tst.active
    np.testing.assert_array_equal(tst.vel[off].numpy(), 0.0)


@pytest.mark.parametrize("seed", [0, 5])
def test_add_points_lists_match_jax(seed):
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(inactive=0.5)
    ids = np.arange(0, 150, 2)[: 40]         # inactive rows, then active ones
    ids = np.concatenate([ids, [1, 3]])
    j2 = jf.add_points(jst, jnp.asarray(ids), jax.random.PRNGKey(seed))
    t2 = tf.add_points(tst, torch.from_numpy(ids), threefry.prng_key(seed))
    _assert_states_match(j2, t2, exact=True)
    assert t2.active[torch.from_numpy(ids)].all()
    assert torch.isinf(t2.hd_d[torch.from_numpy(ids)]).all()
    # a row's fresh list never holds the row and holds no duplicate
    rows = t2.hd_idx[torch.from_numpy(ids)]
    assert not (rows == torch.from_numpy(ids)[:, None]).any()
    assert int(tf.audit_state(t2, tcfg).hd_dup) == 0
    # then steps from the grown state, both packages, at steps 1-3: no
    # sigma refresh there.  (An added row's lists hold no more valid
    # neighbours than the perplexity at first, so no beta reaches its
    # target entropy and rounding decides the bisection's branches; ROADMAP,
    # "Observations".)
    j2, t2 = _at_step(j2, t2, 1)
    step = _jstep(jcfg)
    for _ in range(3):
        j2 = step(j2, jnp.asarray(X), jhp)
        t2 = tf.funcsne_step(tcfg, t2, torch.from_numpy(X), thp)
    _assert_states_match(j2, t2)


def test_remove_points_matches_jax():
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem()
    ids = np.arange(100, 150)
    j2 = jf.remove_points(jst, jnp.asarray(ids))
    t2 = tf.remove_points(tst, torch.from_numpy(ids))
    _assert_states_match(j2, t2, exact=True)
    j2, t2 = _at_step(j2, t2, 1)        # as above: no sigma refresh
    step = _jstep(jcfg)
    for _ in range(3):
        j2 = step(j2, jnp.asarray(X), jhp)
        t2 = tf.funcsne_step(tcfg, t2, torch.from_numpy(X), thp)
    _assert_states_match(j2, t2)


def test_rescale_embedding_matches_jax():
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(n=60)
    for _ in range(2):
        tst = tf.funcsne_step(tcfg, tst, torch.from_numpy(X), thp)
    big = tst._replace(Y=tst.Y * 1e4)
    jbig = jf.FuncSNEState(**{k: jnp.asarray(v) for k, v in
                              convert.state_to_numpy(big).items()
                              if k != "rng"}, rng=jst.rng)
    for factor in (1e-2, 0.5):
        small = tf.rescale_embedding(big, factor)
        _assert_states_match(jf.rescale_embedding(jbig, factor), small,
                             exact=True)
        assert float(small.vel.abs().max()) == 0.0
    assert torch.equal(tf.rescale_embedding(big).Y, big.Y * 0.01)


def test_dynamic_add_points():
    """The JAX test of the same name: a third of the rows held out, then
    activated mid-run; they find real HD neighbours."""
    X, _ = blobs(n=300, dim=8, n_centers=3, center_std=5.0, seed=2)
    cfg = tf.FuncSNEConfig(n_points=300, dim_hd=8)
    active0 = torch.arange(300) < 200
    st = tf.init_state(X, cfg, seed=0, active=active0, device="cpu")
    step = tf.make_step(cfg)
    hp = tf.default_hparams(300, device="cpu")
    Xt = torch.from_numpy(X)
    for _ in range(60):
        st = step(st, Xt, hp)
    st = tf.add_points(st, torch.arange(200, 300), threefry.prng_key(5))
    for _ in range(120):
        st = step(st, Xt, hp)
    assert torch.isfinite(st.Y).all()
    new_d = st.hd_d[200:]
    assert float(new_d[torch.isfinite(new_d)].mean()) > 0
    assert (torch.isfinite(new_d).sum(1) >= cfg.k_hd // 2).all()


def test_remove_points_stops_their_influence():
    X, _ = blobs(n=200, dim=8, seed=3)
    cfg = tf.FuncSNEConfig(n_points=200, dim_hd=8)
    st = tf.init_state(X, cfg, seed=0, device="cpu")
    st = tf.remove_points(st, torch.arange(100, 200))
    step = tf.make_step(cfg)
    hp = tf.default_hparams(200, device="cpu")
    y_before = st.Y[100:].clone()
    for _ in range(30):
        st = step(st, torch.from_numpy(X), hp)
    assert torch.equal(st.Y[100:], y_before)


def test_forces_match_exact_gradient_direction():
    """With full neighbour sets one force step aligns with the exact Eq. 5
    gradient (cos > 0.9), as the JAX test of the same name."""
    Xn = (np.random.default_rng(0).normal(size=(48, 6)).astype(np.float32)
          * 2.0)
    X = torch.from_numpy(Xn)
    n, k = 48, 47
    cfg = tf.FuncSNEConfig(n_points=n, dim_hd=6, dim_ld=2, k_hd=k, k_ld=k,
                           n_negatives=4)
    st = tf.init_state(X, cfg, seed=0, init="random", device="cpu")
    hd_idx, hd_d = tk.exact_knn(X, k)
    st = st._replace(hd_idx=hd_idx, hd_d=hd_d,
                     beta=ta.solve_beta(hd_d, 30.0),
                     new_flag=torch.zeros(n, dtype=torch.bool))
    ld_idx, ld_d = tk.exact_knn(st.Y, k)
    st = st._replace(ld_idx=ld_idx, ld_d=ld_d)
    hp = tf.default_hparams(n, lr=1.0, momentum=0.0, device="cpu")
    st2 = tf._forces_update(cfg, st, hp, tk.key_salt(st.rng), tf.KERNELS)
    dY = (st2.Y - st.Y).double().ravel()
    P = tb.exact_p_matrix(X, 30.0)
    g = tb.exact_tsne_grad(st.Y, P, 1.0).double().ravel()
    cos = float(dY @ (-g) / (dY.norm() * g.norm()))
    assert cos > 0.9, cos


# --------------------------------------------------------------------------
# audit_state


def _corrupted(st, n, nan_row=0):
    """(name, state) pairs: each one planted fault, and all of them."""
    def setat(t, idx, v):
        t = t.clone()
        t[idx] = v
        return t
    hd1 = st.hd_idx[0, 1]
    return {
        "clean": st,
        "hd_oob": st._replace(hd_idx=setat(st.hd_idx, (0, 0), n + 5)),
        "ld_oob_neg": st._replace(ld_idx=setat(st.ld_idx, (3, 2), -2)),
        "hd_dup": st._replace(hd_idx=setat(st.hd_idx, (0, 0), hd1)),
        "ld_dup": st._replace(ld_idx=setat(st.ld_idx, (5, 1),
                                           st.ld_idx[5, 4])),
        "sentinel_finite": st._replace(
            hd_idx=setat(st.hd_idx, (2, 0), SENTINEL),
            hd_d=setat(st.hd_d, (2, 0), 1.0)),
        "sentinel_inf": st._replace(
            hd_idx=setat(setat(st.hd_idx, (2, 0), SENTINEL), (2, 1),
                         SENTINEL),
            hd_d=setat(setat(st.hd_d, (2, 0), np.inf), (2, 1), np.inf)),
        "y_nan": st._replace(Y=setat(st.Y, (nan_row, 0), np.nan)),
        "y_inf_off": st._replace(Y=setat(st.Y, (1, 1), np.inf),
                                 active=setat(st.active, 1, False)),
    }


@pytest.mark.parametrize("c_hd_rev", [0, 3])
def test_audit_counts_match_jax(c_hd_rev):
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(n=60, c_hd_rev=c_hd_rev)
    if c_hd_rev:     # a rebuilt reverse table (the step's first refinement)
        jst = _jstep(jcfg)(jst, jnp.asarray(X), jhp)
        tst = convert.state_from_numpy(_fields(jst), tcfg, "cpu")
    cases = _corrupted(tst, 60)
    if c_hd_rev:
        rev = tst.rev_idx.clone()
        rev[0, 0], rev[7, 2] = -3, 60
        cases["rev_oob"] = tst._replace(rev_idx=rev)
    Xbad = X.copy()
    Xbad[4, 1] = np.nan
    Xbad[1, 0] = np.inf
    for name, st in cases.items():
        jst_c = jax.tree.map(jnp.asarray, jf.FuncSNEState(**{
            k: v for k, v in convert.state_to_numpy(st).items()
            if k != "rng"}, rng=jst.rng))
        for x in (None, X, Xbad):
            want = jf.audit_state(jst_c, jcfg,
                                  None if x is None else jnp.asarray(x))
            got = tf.audit_state(st, tcfg,
                                 None if x is None else torch.from_numpy(x))
            assert isinstance(got, tf.AuditResult)
            for f in tf.AuditResult._fields:
                g = getattr(got, f)
                assert g.dtype == torch.int32 and g.ndim == 0, (name, f)
                assert int(g) == int(getattr(want, f)), (name, f, x is None)
    got = tf.audit_state(cases["clean"], tcfg, torch.from_numpy(X))
    assert all(int(v) == 0 for v in got)
    planted = tf.audit_state(cases["hd_dup"], tcfg)
    assert int(planted.hd_dup) == 1 and int(planted.hd_oob) == 0


# --------------------------------------------------------------------------
# fit: early_stop, auto_rescale, callback, the host loop


def _fit_problem(n=64, dim=6, seed=4):
    X, _ = blobs(n=n, dim=dim, n_centers=2, center_std=5.0, seed=seed)
    return X, tf.FuncSNEConfig(n_points=n, dim_hd=dim)


def _equal(a, b):
    for name in tf.FuncSNEState._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _ident(it, n, h):
    return h


def _host_schedule(it, n, h):         # int(it): the host loop
    return h if int(it) >= 0 else h


def test_fit_early_stop_halts_converged_run():
    """lr 0 holds vel at 0 (disp_ema 0): fit stops after the first chunk."""
    X, cfg = _fit_problem()
    hp = tf.default_hparams(64, device="cpu")._replace(lr=torch.tensor(0.0))
    st, _ = tf.fit(X, cfg=cfg, n_iter=60, hparams=hp, schedule=_ident,
                   chunk_size=10, early_stop=1e-9, device="cpu")
    assert int(st.step) == 10, int(st.step)


def test_fit_early_stop_lets_moving_run_finish():
    X, cfg = _fit_problem()
    st, _ = tf.fit(X, cfg=cfg, n_iter=20, chunk_size=10, early_stop=1e-30,
                   device="cpu")
    assert int(st.step) == 20, int(st.step)
    st_none, _ = tf.fit(X, cfg=cfg, n_iter=20, chunk_size=10, device="cpu")
    _equal(st_none, st)


def test_fit_early_stop_host_loop_fallback():
    X, cfg = _fit_problem(n=48, dim=5, seed=5)
    hp = tf.default_hparams(48, device="cpu")._replace(lr=torch.tensor(0.0))
    st, _ = tf.fit(X, cfg=cfg, n_iter=30, hparams=hp,
                   schedule=_host_schedule, early_stop=1e-9, device="cpu")
    assert int(st.step) == 1, int(st.step)


def test_fit_early_stop_matches_jax():
    """The same threshold stops both packages after the same chunk.  From
    one bridged state the normalised displacement falls from about 1.1 to
    about 0.2 at the third chunk of 10 (the early exaggeration ends at
    step 15), so a threshold of 0.5 lies far from both packages' values
    (the runs part by ~15% later, in the noise of negative sampling)."""
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(n=80)
    kw = dict(n_iter=60, chunk_size=10, early_stop=0.5)
    j_st, _ = jf.fit(jnp.asarray(X), cfg=jcfg, hparams=jhp, state=jst, **kw)
    t_st, _ = tf.fit(X, cfg=tcfg, hparams=thp, state=tst, device="cpu", **kw)
    assert int(t_st.step) == int(j_st.step) == 30, (int(t_st.step),
                                                    int(j_st.step))


@pytest.mark.parametrize("host", [False, True])
def test_fit_auto_rescale_triggers_and_matches_manual_loop(host):
    """An always-firing threshold rescales after every chunk (every step
    on the host loop) but the last: the manual loop's state exactly."""
    X, _ = blobs(n=120, dim=6, n_centers=3, seed=6)
    cfg = tf.FuncSNEConfig(n_points=120, dim_hd=6)
    hp = tf.default_hparams(120, device="cpu")
    Xt = torch.from_numpy(X)
    st_f, _ = tf.fit(X, cfg=cfg, n_iter=12 if host else 30, hparams=hp,
                     schedule=_host_schedule if host else _ident,
                     chunk_size=10, auto_rescale=1e9, device="cpu")
    st = tf.init_state(X, cfg, seed=0, perplexity=hp.perplexity,
                       device="cpu")
    if host:
        for it in range(12):
            st = tf.funcsne_step(cfg, st, Xt, hp)
            if it < 11:
                st = tf.rescale_embedding(st)
    else:
        chunk = tf.make_chunked_step(cfg, 10)
        for i in range(3):
            st, _, _ = chunk(st, Xt, hp)
            if i < 2:
                st = tf.rescale_embedding(st)
    _equal(st_f, st)
    st_zero, _ = tf.fit(X, cfg=cfg, n_iter=20, hparams=hp, schedule=_ident,
                        chunk_size=10, auto_rescale=0.0, device="cpu")
    st_plain, _ = tf.fit(X, cfg=cfg, n_iter=20, hparams=hp, schedule=_ident,
                         chunk_size=10, device="cpu")
    _equal(st_zero, st_plain)


def test_fit_auto_rescale_matches_jax():
    """lr 0: Y only moves by the rescales, 0.01 after each chunk but the
    last, in both packages."""
    X, jcfg, tcfg, jhp, thp, jst, tst = _problem(n=80)
    kw = dict(n_iter=30, chunk_size=10, schedule=lambda it, n, h: h,
              auto_rescale=1e9)
    j_st, _ = jf.fit(jnp.asarray(X), cfg=jcfg, state=jst,
                     hparams=jhp._replace(lr=jnp.float32(0.0)), **kw)
    t_st, _ = tf.fit(X, cfg=tcfg, state=tst, device="cpu",
                     hparams=thp._replace(lr=torch.tensor(0.0)), **kw)
    _assert_states_match(j_st, t_st)
    np.testing.assert_allclose(t_st.Y.numpy(), tst.Y.numpy() * 1e-4,
                               rtol=1e-6)


def test_fit_callback_per_step_and_per_chunk():
    X, cfg = _fit_problem(n=50, dim=5, seed=1)
    seen = []
    st, _ = tf.fit(X, cfg=cfg, n_iter=7, device="cpu",
                   callback=lambda it, s: seen.append((it, int(s.step))))
    assert seen == [(i, i + 1) for i in range(7)]      # chunk_size 1
    seen.clear()
    st2, _ = tf.fit(X, cfg=cfg, n_iter=7, chunk_size=3, device="cpu",
                    callback=lambda it, s: seen.append((it, int(s.step))))
    assert seen == [(2, 3), (5, 6), (6, 7)]
    _equal(st, st2)
    seen.clear()
    tf.fit(X, cfg=cfg, n_iter=4, schedule=_host_schedule, device="cpu",
           callback=lambda it, s: seen.append((it, int(s.step))))
    assert seen == [(i, i + 1) for i in range(4)]


def test_fit_bit_invariant_to_chunk_size_with_options():
    """With callback, never-firing early_stop and auto_rescale and
    snapshots set, fit is bit-invariant to chunk_size; the host loop (a
    host-only schedule) gives the same state and snapshots."""
    X, _ = blobs(n=80, dim=7, n_centers=3, center_std=5.0, seed=1)
    cfg = tf.FuncSNEConfig(n_points=80, dim_hd=7)
    runs = []
    for cs, sched in ((8, None), (29, None), (1, None),
                      (None, lambda it, n, h: tf.default_schedule(
                          int(it), n, h))):
        calls = []
        st, snaps = tf.fit(X, cfg=cfg, n_iter=29, snapshot_every=10,
                           chunk_size=cs, schedule=sched, early_stop=1e-30,
                           auto_rescale=1e-30, device="cpu",
                           callback=lambda it, s: calls.append(it))
        assert calls[-1] == 28
        runs.append((st, snaps))
    for st, snaps in runs[1:]:
        _equal(st, runs[0][0])
        assert len(snaps) == len(runs[0][1]) == 2
        for a, b in zip(snaps, runs[0][1]):
            np.testing.assert_array_equal(a, b)


def test_host_only_schedules_route_as_jax(tmp_path):
    """Every schedule the JAX package's chunk-runner tests use goes where JAX
    sends it: traceable ones to the chunks, int(it) ones to the host
    loop; state / resilience / resume_from refuse the host loop and run
    in the chunks."""
    traceable = (tf.default_schedule, _ident, lambda it, n, h: h._replace(
        lr=h.lr * 0.5))
    host = (_host_schedule,
            lambda it, n, h: h if int(it) < 2 else h._replace(lr=h.lr * 0.5),
            lambda it, n, h: h if it < n else h)
    assert not any(tf._host_only(s, 10) for s in traceable)
    assert all(tf._host_only(s, 10) for s in host)
    for s in traceable:      # and JAX agrees
        jax.eval_shape(lambda it: s(it, 10, jf.default_hparams(10))
                       if s is not tf.default_schedule
                       else jf.default_schedule(it, 10,
                                                jf.default_hparams(10)),
                       jax.ShapeDtypeStruct((), jnp.int32))
    X, cfg = _fit_problem(n=16, dim=4)
    cfg = tf.FuncSNEConfig(n_points=16, dim_hd=4, k_hd=8, k_ld=4)
    st = tf.init_state(X, cfg, device="cpu")
    for kw in (dict(state=st), dict(resilience=object()),
               dict(resume_from="ckpt")):
        with pytest.raises(ValueError, match="traceable schedule"):
            tf.fit(X, cfg=cfg, n_iter=4, schedule=_host_schedule,
                   device="cpu", **kw)
    st_r, _ = tf.fit(X, cfg=cfg, n_iter=4, device="cpu",
                     resilience=ResiliencePolicy())
    assert int(st_r.step) == 4
    with pytest.raises(CheckpointNotFound):
        tf.fit(X, cfg=cfg, n_iter=4, device="cpu",
               resume_from=str(tmp_path / "ckpt"))
