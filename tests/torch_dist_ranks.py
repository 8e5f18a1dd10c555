"""Shared pieces of the port's distributed tests (not collected itself).

``jax_reference`` runs the JAX package's ``make_distributed_step`` in one
subprocess on XLA's fake CPU devices (4 at most: more make XLA's
rendezvous miss its deadline under a loaded host) and writes its states to
an ``.npz``; the ``*_rank`` functions are what each spawned gloo rank of
the port runs (``repro_torch.launch.mesh.run_ranks``).  This module
imports nothing of JAX, so the ranks do not either.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N, DIM = 256, 16
# each multi-process call's own limit: a deadlock fails one test
RANKS_TIMEOUT = 240.0


def quantised_blobs(n=N, dim=DIM, seed=0):
    """``blobs(n, dim, 5 centres, centre std 6)`` rounded to quarters:
    squared distances are exact in float32, so the discrete fields of both
    packages must agree exactly."""
    from repro_torch.data.synthetic import blobs
    X, _ = blobs(n=n, dim=dim, n_centers=5, center_std=6.0, seed=seed)
    return (np.round(X * 4.0) / 4.0).astype(np.float32)


_JAX_SCRIPT = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.core import funcsne

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
X = jnp.asarray(np.load(spec["x"]))
n, m = X.shape
res = {}

def fields(st, prefix):
    for k, v in st._asdict().items():
        res[prefix + k] = np.asarray(jax.random.key_data(v) if k == "rng"
                                     else v)

for case in spec["cases"]:
    cfg = funcsne.FuncSNEConfig(n_points=n, dim_hd=m, backend="xla",
                                **case["flags"])
    st0 = funcsne.init_state(jax.random.PRNGKey(case["seed"]), X, cfg)
    hp = funcsne.default_hparams(n)
    tag = case["tag"]
    fields(st0, f"{tag}/init/")
    data, model = case["mesh"]
    mesh = compat.make_mesh((data, model), ("data", "model"),
                            devices=jax.devices()[:data * model])
    Xs = jax.device_put(X, NamedSharding(mesh, P(None, "model")))
    cp = lambda s: jax.device_put(
        jax.tree.map(lambda a: jnp.array(a, copy=True), s),
        NamedSharding(mesh, P()))
    step, _ = funcsne.make_distributed_step(cfg, mesh)
    st = cp(st0)
    for i in range(1, max(case["steps"]) + 1):
        st = step(st, Xs, hp)
        if i in case["steps"]:
            fields(st, f"{tag}/step{i}/")
    if case.get("chunk"):
        fn, _ = funcsne.make_distributed_step(
            cfg, mesh, chunk=case["chunk"],
            snapshot_every=case.get("snapshot_every", 0))
        st_c, snaps, met = fn(cp(st0), Xs, hp)
        fields(st_c, f"{tag}/chunk/")
        res[f"{tag}/snaps"] = np.asarray(snaps)
        for k, v in met._asdict().items():
            res[f"{tag}/metrics/{k}"] = np.asarray(v)
np.savez(out_path, **res)
print("OK", len(res))
"""


def jax_reference(tmp_path, cases, X, timeout=300):
    """Run ``cases`` (dicts: tag, mesh, flags, seed, steps, chunk,
    snapshot_every) through the JAX package on 4 fake CPU devices; returns
    the ``.npz`` contents."""
    x_path = os.path.join(str(tmp_path), "x.npy")
    out = os.path.join(str(tmp_path), "jax_ref.npz")
    np.save(x_path, X)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT), out,
         json.dumps({"x": x_path, "cases": cases})],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(out))


def run(fn, world, *args):
    """``fn`` on ``world`` gloo ranks on the CPU, one thread each, under
    RANKS_TIMEOUT."""
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(fn, world, args, device="cpu", timeout=RANKS_TIMEOUT,
                     threads=1)


DISCRETE = ("hd_idx", "ld_idx", "new_flag", "active", "step", "rng",
            "rev_idx", "rev_step")


def assert_state_close(got, want, steps, tol, what=""):
    """The port's state ``got`` against JAX's ``want`` after ``steps``
    distributed steps, with a test file's tolerances ``tol`` (F_RTOL,
    F_ATOL, GAINS_FRAC, BETA_RTOL, Z_RTOL, HD_D_RTOL, BF16_ULP, MOM; each
    file derives them in its docstring)."""
    for name in DISCRETE:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{what} {name}")
    np.testing.assert_array_equal(got["ld_d"], want["ld_d"],
                                  err_msg=f"{what} ld_d")
    fin = np.isfinite(want["hd_d"])
    np.testing.assert_array_equal(np.isfinite(got["hd_d"]), fin)
    np.testing.assert_allclose(got["hd_d"][fin], want["hd_d"][fin],
                               rtol=tol["HD_D_RTOL"], atol=0,
                               err_msg=f"{what} hd_d")
    mom = tol["MOM"]
    vmax = float(np.abs(want["vel"]).max())
    # vel carries one wire rounding a step with weight MOM**k (a geometric
    # sum); Y adds up vel's error over the steps
    wire = tol["BF16_ULP"] * (1 + mom) * vmax / (1 - mom)
    for name, w_err in (("Y", steps * wire), ("vel", wire)):
        w = want[name]
        np.testing.assert_allclose(
            got[name], w, rtol=0,
            atol=tol["F_RTOL"] * np.abs(w).max() + tol["F_ATOL"] + w_err,
            err_msg=f"{what} {name}")
    np.testing.assert_allclose(got["beta"], want["beta"],
                               rtol=tol["BETA_RTOL"], err_msg=f"{what} beta")
    for name in ("zhat", "ema_new_frac"):
        np.testing.assert_allclose(got[name], want[name], rtol=tol["Z_RTOL"],
                                   err_msg=f"{what} {name}")
    assert (got["gains"] != want["gains"]).mean() <= tol["GAINS_FRAC"], what


def assert_bitwise(a, b, what):
    for name in a:
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{what} {name}")


def fields_of(ref, prefix):
    """The state fields stored under ``prefix`` in a reference ``.npz``."""
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def _numpy(st):
    from repro_torch.core import convert
    return convert.state_to_numpy(st)


def parity_rank(rank, world, dev, case, fields0, X):
    """One rank of ``case`` (as in :func:`jax_reference`) on the port: the
    states after the steps listed, the chunk (state, ring, metrics) and
    ``chunk`` steps one by one, as numpy."""
    from repro_torch.core import convert
    from repro_torch.core import funcsne as tf
    from repro_torch.launch.mesh import Grid

    n, m = X.shape
    cfg = tf.FuncSNEConfig(n_points=n, dim_hd=m, **case["flags"])
    grid = Grid(tuple(case["mesh"]))
    hp = tf.default_hparams(n, device=dev)
    st0 = convert.state_from_numpy(fields0, cfg, dev)
    Xb = grid.column_block(torch.from_numpy(X).to(dev))
    step, _ = tf.make_distributed_step(cfg, grid)
    out = {"coords": dict(grid.coords)}
    st = st0
    for i in range(1, max(case["steps"]) + 1):
        st = step(st, Xb, hp)
        if i in case["steps"]:
            out[f"step{i}"] = _numpy(st)
    if case.get("chunk"):
        fn, _ = tf.make_distributed_step(
            cfg, grid, chunk=case["chunk"],
            snapshot_every=case.get("snapshot_every", 0))
        st_c, snaps, met = fn(st0, Xb, hp)
        out["chunk"] = _numpy(st_c)
        out["snaps"] = snaps.cpu().numpy()
        out["metrics"] = {k: v.cpu().numpy() for k, v in
                          met._asdict().items()}
        st = st0
        for _ in range(case["chunk"]):
            st = step(st, Xb, hp)
        out["seq"] = _numpy(st)
    return out


def probe_rank(rank, world, dev, fields0, X, reduce):
    """The reference's shard-confined NaN probe on a (world, 1) grid:
    ``NaNChunk(shard=3, field="vel", rows=4)`` before a one-step chunk;
    returns (finite_frac, bad_step) as this rank reads them."""
    from repro_torch.core import convert
    from repro_torch.core import funcsne as tf
    from repro_torch.launch.mesh import Grid
    from repro_torch.runtime import faults

    n, m = X.shape
    cfg = tf.FuncSNEConfig(n_points=n, dim_hd=m)
    grid = Grid((world, 1))
    hp = tf.default_hparams(n, device=dev)
    st = convert.state_from_numpy(fields0, cfg, dev)
    st = faults.NaNChunk(at_step=0, shard=3, field="vel", rows=4).apply(st, 0)
    fn, _ = tf.make_distributed_step(cfg, grid, chunk=1, health_reduce=reduce)
    _, _, met = fn(st, grid.column_block(torch.from_numpy(X).to(dev)), hp)
    return float(met.finite_frac), int(met.bad_step)


def probe_both_rank(rank, world, dev, X):
    """:func:`probe_rank` reduced and per replica: ((ff, bad), (ff, bad))."""
    fields0 = _numpy(_init(X, dev))
    return (probe_rank(rank, world, dev, fields0, X, True),
            probe_rank(rank, world, dev, fields0, X, False))


def _init(X, dev):
    from repro_torch.core import funcsne as tf
    n, m = X.shape
    return tf.init_state(X, tf.FuncSNEConfig(n_points=n, dim_hd=m), seed=0,
                         device=dev)


def rollback_rank(rank, world, dev, X):
    """The reference's shard-confined rollback on the coordinator, twice:
    ``NaNChunk(at_step=8, shard=world - 1, field="vel", rows=4)`` under
    ``ResiliencePolicy(max_retries=2)``, 16 steps in chunks of 4."""
    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.runtime import faults
    from repro_torch.runtime.coordinator import fit_elastic

    runs = []
    for _ in range(2):
        policy = ResiliencePolicy(max_retries=2)
        with faults.active(faults.FaultScript(faults.NaNChunk(
                at_step=8, shard=world - 1, field="vel", rows=4))):
            st = fit_elastic(torch.from_numpy(X), n_iter=16, chunk_size=4,
                             resilience=policy, device=dev)
        runs.append({"state": _numpy(st), "events": policy.events})
    return runs


def resume_rank(rank, world, dev, X, root, model):
    """A clean ``fit_elastic`` run under a checkpointing policy, then one
    preempted at step 8 (``faults.Preemption``) and resumed from its
    directory; returns both final states and the resumed run's events."""
    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.runtime import faults
    from repro_torch.runtime.coordinator import fit_elastic

    def fit(**kw):
        return fit_elastic(torch.from_numpy(X), n_iter=16, chunk_size=4,
                           model=model, device=dev, **kw)
    clean = fit(resilience=ResiliencePolicy(
        checkpoint_dir=os.path.join(root, "clean"), audit_every=2))
    pre_dir = os.path.join(root, "pre")
    preempted = False
    with faults.active(faults.FaultScript(faults.Preemption(at_step=8))):
        try:
            fit(resilience=ResiliencePolicy(checkpoint_dir=pre_dir))
        except faults.Preempted:
            preempted = True
    policy = ResiliencePolicy(checkpoint_dir=pre_dir)
    resumed = fit(resilience=policy, resume_from=pre_dir)
    return {"clean": _numpy(clean), "resumed": _numpy(resumed),
            "preempted": preempted, "events": policy.events}


def idle_rank(rank, world, dev, X):
    """``fit_elastic(devices=world - 1)``: the last rank is left out of the
    grid and takes no step."""
    import warnings

    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.runtime.coordinator import fit_elastic

    policy = ResiliencePolicy()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        st = fit_elastic(torch.from_numpy(X), n_iter=4, chunk_size=2,
                         devices=world - 1, resilience=policy, device=dev)
    return {"state": None if st is None else _numpy(st),
            "events": policy.events,
            "warned": [str(w.message) for w in seen]}


def grid_rank(rank, world, dev):
    """The collectives of a (2, 2) grid on this rank: gathers along each
    axis set, sums (bf16 and float32), min, max, its column block and the
    collective counters."""
    from repro_torch.launch import mesh as mesh_lib

    grid = mesh_lib.Grid((2, 2))
    x = torch.tensor([rank * 10, rank * 10 + 1], dtype=torch.int32)
    vals = (torch.arange(8, dtype=torch.float32) * 0.37 + rank) ** 3
    mesh_lib.reset_collectives()
    out = {"coords": dict(grid.coords),
           "index": {a: grid.axis_index(a) for a in
                     ("data", "model", ("data", "model"))},
           "gather": {a: grid.all_gather(x, a).tolist() for a in
                      ("data", "model", ("data", "model"))},
           "sum_bf16": grid.all_reduce(vals.to(torch.bfloat16),
                                       ("data", "model"), tag="b").float(),
           "sum_f32": grid.all_reduce(vals, "model", tag="f"),
           "min": float(grid.all_reduce(vals[0], ("data", "model"), "min")),
           "max": float(grid.all_reduce(vals[0], "data", "max")),
           "block": grid.column_block(
               torch.arange(12.0).reshape(2, 6)).tolist(),
           "counts": {k: list(v) for k, v in mesh_lib.COLLECTIVES.items()}}
    try:
        grid.axis_index(("model", "data"))
    except ValueError:
        out["order_checked"] = True
    return out


def tail_rank(rank, world, dev, X):
    """One distributed step at a row count the grid does not divide: the
    rows past ``world * (n // world)`` belong to no rank's slice, so their
    lists stay as they were; returns the states before and after."""
    from repro_torch.core import funcsne as tf
    from repro_torch.launch.mesh import Grid

    st0 = _init(X, dev)
    n, m = X.shape
    cfg = tf.FuncSNEConfig(n_points=n, dim_hd=m)
    grid = Grid((world, 1))
    step, _ = tf.make_distributed_step(cfg, grid)
    st = step(st0, grid.column_block(torch.from_numpy(X).to(dev)),
              tf.default_hparams(n, device=dev))
    return _numpy(st0), _numpy(st)


# --------------------------------------------------------------------------
# Host loss (tests/test_torch_host_loss.py)

_JAX_HOST_LOSS_SCRIPT = """
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import funcsne
from repro.core.resilience import ResiliencePolicy
from repro.runtime import faults
from repro.runtime.coordinator import fit_elastic

out_dir, spec = sys.argv[1], json.loads(sys.argv[2])
X = jnp.asarray(np.load(spec["x"]))
n, m = X.shape
cfg = funcsne.FuncSNEConfig(n_points=n, dim_hd=m, backend="xla")

def fields(st):
    return {k: np.asarray(jax.random.key_data(v) if k == "rng" else v)
            for k, v in st._asdict().items()}

st0 = funcsne.init_state(jax.random.PRNGKey(0), X, cfg, validate=False)
np.savez(os.path.join(out_dir, "init.tmp.npz"), **fields(st0))
os.replace(os.path.join(out_dir, "init.tmp.npz"),
           os.path.join(out_dir, "init.npz"))
# the same start on one device: the states after spec["single"] - 1 and
# spec["single"] steps, around the sigma refresh of the last one
step, hp = funcsne.make_step(cfg), funcsne.default_hparams(n)
s = jax.tree.map(lambda a: jnp.array(a, copy=True), st0)
single = {}
for i in range(1, spec["single"] + 1):
    s = step(s, X, hp)
    if i >= spec["single"] - 1:
        single.update({f"{i}/{k}": v for k, v in fields(s).items()})
np.savez(os.path.join(out_dir, "single.npz"), **single)
ck = os.path.join(out_dir, "ckpt")
policy = ResiliencePolicy(checkpoint_dir=ck, checkpoint_every=1)
with faults.active(faults.FaultScript(faults.HostLoss(
        at_step=spec["at"], host=1))):
    st = fit_elastic(X, cfg=cfg, n_iter=spec["n_iter"],
                     chunk_size=spec["chunk"], n_hosts=spec["hosts"],
                     resilience=policy, state=st0)
np.savez(os.path.join(out_dir, "final.npz"), **fields(st))
with open(os.path.join(out_dir, "events.json"), "w") as f:
    json.dump(policy.events, f)
print("OK", jax.device_count())
"""


def jax_host_loss_start(out_dir, X, spec):
    """Start the JAX package's ``fit_elastic`` host-loss run (``spec``: at,
    n_iter, chunk, hosts) on 4 fake CPU devices in a subprocess; it writes
    ``init.npz`` (its starting state) first, then ``single.npz`` (the
    states of a one-device ``make_step`` run from that start after
    ``spec["single"] - 1`` and ``spec["single"]`` steps), ``final.npz``,
    ``events.json`` and its checkpoints under ``out_dir/ckpt``.  Returns
    the ``Popen``."""
    x_path = os.path.join(str(out_dir), "x.npy")
    np.save(x_path, X)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_HOST_LOSS_SCRIPT),
         str(out_dir), json.dumps(dict(spec, x=x_path))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def host_loss_rank(rank, world, dev, fields0, X, root, spec):
    """The port's side of the host-loss parity test on ``world`` ranks:

    * ``fit_elastic(n_hosts=spec["hosts"])`` from ``fields0`` under a
      checkpointing policy, with ``HostLoss(spec["at"], host=1)``; rank 0
      copies the checkpoint directory when the ``remesh`` event is logged
      (the boundary the loss restored is then its newest);
    * the fresh run: ``fit_elastic`` on the survivors' rank count from the
      same start, resuming from that copy;
    * a host loss with nothing committed (``checkpoint_every`` past the
      run), which must raise ``HostLost`` on every rank.
    Returns the final states (None on a rank outside the grid), the events
    and whether the last run raised."""
    import shutil

    from repro_torch.core import convert
    from repro_torch.core import funcsne as tf
    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.launch.mesh import host_device_blocks
    from repro_torch.runtime import faults
    from repro_torch.runtime.coordinator import fit_elastic

    n, m = X.shape
    cfg = tf.FuncSNEConfig(n_points=n, dim_hd=m)
    Xt = torch.from_numpy(X)
    kw = dict(cfg=cfg, n_iter=spec["n_iter"], chunk_size=spec["chunk"],
              device=dev)
    copy = os.path.join(root, "restored")

    def copier(e):
        if rank == 0 and e["kind"] == "remesh":
            shutil.copytree(os.path.join(root, "run"), copy)
    policy = ResiliencePolicy(checkpoint_dir=os.path.join(root, "run"),
                              checkpoint_every=1, on_event=copier)
    loss = faults.FaultScript(faults.HostLoss(at_step=spec["at"], host=1))
    with faults.active(loss):
        st = fit_elastic(Xt, n_hosts=spec["hosts"], resilience=policy,
                         state=convert.state_from_numpy(fields0, cfg, dev),
                         **kw)
    # the same count on every rank, the lost ones included
    survivors = world - len(host_device_blocks(range(world),
                                               spec["hosts"])[1])
    fresh_policy = ResiliencePolicy(checkpoint_dir=copy, checkpoint_every=1)
    fresh = fit_elastic(Xt, devices=survivors, resilience=fresh_policy,
                        state=convert.state_from_numpy(fields0, cfg, dev),
                        resume_from=copy, **kw)
    raised = None
    with faults.active(faults.FaultScript(faults.HostLoss(at_step=4,
                                                          host=1))):
        try:
            fit_elastic(Xt, n_hosts=spec["hosts"],
                        resilience=ResiliencePolicy(
                            checkpoint_dir=os.path.join(root, "none"),
                            checkpoint_every=1000),
                        state=convert.state_from_numpy(fields0, cfg, dev),
                        **dict(kw, n_iter=8))
        except faults.HostLost as e:
            raised = (e.step, e.host)
    return {"state": None if st is None else _numpy(st),
            "events": policy.events,
            "fresh": None if fresh is None else _numpy(fresh),
            "fresh_events": fresh_policy.events, "raised": raised}
