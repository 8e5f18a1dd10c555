"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's format and contracts (``tests/test_checkpoint_verify.py``), on
the CPU:

  * the on-disk layout is the JAX package's: ``step_%010d/arrays.npz`` and
    ``meta.json`` with the CRC32 and the array manifest, the same leaf keys,
    dtypes (the key as uint32 words) and shapes, the same ``cfg_compat``;
  * a port checkpoint passes ``repro.checkpoint.verify.verify_dir`` and the
    JAX ``Checkpointer`` restores it into the arrays ``core.convert`` gives;
    a JAX checkpoint restores into the port and five further steps agree
    with JAX's (lists, gates and key exact; floats within
    tests/test_torch_step.py's tolerances);
  * damage (truncated, bit-flipped or deleted file) is detected at restore
    time; ``restore_verified`` walks back to the last intact boundary;
    pruning keeps the last verified boundary; a config mismatch raises
    ``CheckpointIncompatible``; a flipped byte is CORRUPT in both
    verifiers, with the same lines and exit code.
"""
import io
import json
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import checkpoint as j_ck  # noqa: E402
from repro.checkpoint import verify as j_verify  # noqa: E402
from repro.core import funcsne as jf  # noqa: E402
from repro.core import resilience as j_res  # noqa: E402
from repro_torch.checkpoint import (CheckpointCorrupt,  # noqa: E402
                                    CheckpointError, CheckpointIncompatible,
                                    CheckpointNotFound, Checkpointer,
                                    cfg_compat)
from repro_torch.checkpoint import verify as t_verify  # noqa: E402
from repro_torch.checkpoint.verify import verify_dir  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402
from repro_torch.core.resilience import ResiliencePolicy  # noqa: E402
from repro_torch.runtime.faults import (CorruptShard, FaultScript,  # noqa: E402
                                        Preempted, Preemption, active)

torch.set_num_threads(1)
N, DIM = 48, 5
# tests/test_torch_step.py's tolerances for a step from one bridged state
F_RTOL, F_ATOL = 1e-4, 1e-6
GAINS_FRAC = 0.01
BETA_RTOL = 1e-5


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


def _jcfg(tcfg):
    return jf.FuncSNEConfig(backend="xla", **{
        f: getattr(tcfg, f) for f in tf.FuncSNEConfig.__dataclass_fields__})


def _tree(n=12, d=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"Y": torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)),
            "idx": torch.from_numpy(rng.integers(0, n, size=(n, 3))
                                    .astype(np.int32)),
            "step": torch.tensor(7, dtype=torch.int32)}


def _like(n=12, d=2):
    return {"Y": torch.zeros((n, d)), "idx": torch.zeros((n, 3), dtype=torch.int32),
            "step": torch.tensor(0, dtype=torch.int32)}


def _save_steps(ck, steps, n=12, meta=None):
    tree = _tree(n=n)
    for s in steps:
        ck.save(s, tree, metadata=dict(meta or {}), blocking=True)
    return tree


def _file(ck, step):
    return ck.dir / f"step_{step:010d}" / "arrays.npz"


def _flip(path):
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    path.write_bytes(bytes(blob))


def _jax_fields(st):
    out = {k: np.asarray(v) for k, v in st._asdict().items() if k != "rng"}
    out["rng"] = np.asarray(jax.random.key_data(st.rng))
    return out


# ---------------------------------------------------------------------------
# Manifest, verify and the layout


def test_save_writes_manifest_and_roundtrip_verifies(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=5)
    tree = _save_steps(ck, [3])
    meta = json.loads(
        (tmp_path / "step_0000000003" / "meta.json").read_text())
    man = meta["manifest"]
    assert man["n_hosts"] == 1 and set(man["files"]) == {"arrays.npz"}
    fman = man["files"]["arrays.npz"]
    assert isinstance(fman["crc32"], int)
    assert fman["arrays"]["['Y']"] == {"dtype": "float32", "shape": [12, 2]}
    assert fman["arrays"]["['step']"] == {"dtype": "int32", "shape": []}
    got, m = ck.restore(_like())
    assert m["step"] == 3 and m["n_hosts"] == 1
    for k in tree:
        assert torch.equal(got[k], tree[k]) and got[k].dtype == tree[k].dtype
    # the JAX reader agrees on the same directory
    jgot, jm = j_ck.Checkpointer(tmp_path).restore(
        {k: np.asarray(v) for k, v in _like().items()})
    np.testing.assert_array_equal(np.asarray(jgot["Y"]), tree["Y"].numpy())
    assert jm["step"] == 3


def test_fit_checkpoint_layout_equals_jax(tmp_path):
    """A FuncSNEState checkpoint of the port and of JAX for one config: the
    same leaf keys, dtypes and shapes, the same compat record, and the
    reference's scales."""
    X, cfg = _data(), _cfg(c_hd_rev=2)
    tf.fit(X, cfg=cfg, n_iter=4, chunk_size=4, device="cpu",
           resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path / "t")))
    jf.fit(jnp.asarray(X), cfg=_jcfg(cfg), n_iter=4, chunk_size=4,
           resilience=j_res.ResiliencePolicy(
               checkpoint_dir=str(tmp_path / "j")))
    tm, jm = (json.loads((tmp_path / w / "step_0000000004" / "meta.json")
                         .read_text()) for w in "tj")
    ta = tm["manifest"]["files"]["arrays.npz"]["arrays"]
    ja = jm["manifest"]["files"]["arrays.npz"]["arrays"]
    assert ta == ja
    assert ta[".rng"] == {"dtype": "uint32", "shape": [2]}
    assert list(ta) == [f".{f}" for f in tf.FuncSNEState._fields]
    for key in ("compat", "lr_scale", "ex_scale", "step", "n_hosts"):
        assert tm[key] == jm[key], key
    assert set(tm) == set(jm)


@pytest.mark.parametrize("flags", [{}, {"cand_fused": False},
                                   {"gather_fused": False, "c_hd_rev": 3}])
def test_cfg_compat_equals_jax(flags):
    cfg = _cfg(**flags)
    assert cfg_compat(cfg) == j_ck.cfg_compat(_jcfg(cfg))


@pytest.mark.parametrize("mode", ["truncate", "bitflip", "delete"])
def test_damage_detected_at_restore(tmp_path, mode):
    ck = Checkpointer(tmp_path, keep_last=5)
    _save_steps(ck, [4])
    target = _file(ck, 4)
    if mode == "delete":
        target.unlink()
    elif mode == "truncate":
        target.write_bytes(target.read_bytes()[:40])
    else:
        blob = bytearray(target.read_bytes())
        blob[len(blob) // 2] ^= 0x04
        target.write_bytes(bytes(blob))
    with pytest.raises(CheckpointCorrupt) as ei:
        ck.restore(_like())
    assert ei.value.step == 4
    assert isinstance(ei.value, CheckpointError)


def test_stray_file_and_missing_manifest_detected(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=5)
    _save_steps(ck, [1])
    d = tmp_path / "step_0000000001"
    (d / "extra.npz").write_bytes(b"junk")
    with pytest.raises(CheckpointCorrupt, match="not in manifest"):
        ck.verify_step(1)
    (d / "extra.npz").unlink()
    meta = json.loads((d / "meta.json").read_text())
    del meta["manifest"]
    (d / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(CheckpointCorrupt, match="manifest"):
        ck.verify_step(1)


def test_multihost_checkpoint_verifies_but_is_refused(tmp_path):
    """A JAX checkpoint in the multi-host layout (row-sliced shard files)
    passes the port's fsck, and its restore merges the shards by row
    offset into the tree the JAX ``Checkpointer`` restores, bit for bit
    (the port's restore no longer refuses the layout)."""
    jck = j_ck.Checkpointer(tmp_path, keep_last=5)
    tree = {k: np.asarray(v) for k, v in _tree().items()}
    for h in range(2):
        jck.save(1, tree, host_shard_filter=j_ck.row_shard_filter(h, 2, 12),
                 host_id=h, n_hosts=2)
    jck.wait()
    ck = Checkpointer(tmp_path)
    assert ck.verify_step(1)["manifest"]["n_hosts"] == 2
    out = io.StringIO()
    assert verify_dir(tmp_path, out=out) == 0
    assert out.getvalue() == "step 1: OK (2 shard file(s), n_hosts=2)\n"
    want, jmeta = j_ck.Checkpointer(tmp_path).restore(
        {k: np.zeros_like(v) for k, v in tree.items()})
    for got, meta in (ck.restore(_like()), ck.restore_verified(_like())[:2]):
        assert meta["n_hosts"] == 2 and meta["step"] == jmeta["step"] == 1
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
            np.testing.assert_array_equal(got[k].numpy(), tree[k],
                                          err_msg=k)


def test_row_coverage_gap_detected(tmp_path):
    """The fsck's row-coverage check on a JAX two-host checkpoint whose
    manifest was rewritten to drop one host's shard consistently."""
    jck = j_ck.Checkpointer(tmp_path, keep_last=5)
    tree = {k: np.asarray(v) for k, v in _tree().items()}
    for h in range(2):
        jck.save(2, tree, host_shard_filter=j_ck.row_shard_filter(h, 2, 12),
                 host_id=h, n_hosts=2)
    jck.wait()
    d = tmp_path / "step_0000000002"
    meta = json.loads((d / "meta.json").read_text())
    gone = "shard001-of-002.npz"
    del meta["manifest"]["files"][gone]
    meta["manifest"]["n_hosts"] = 1
    (d / gone).unlink()
    (d / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(CheckpointCorrupt) as ei:
        Checkpointer(tmp_path).verify_step(2)
    assert "uncovered" in ei.value.reason


# ---------------------------------------------------------------------------
# Not found, the fallback chain and pruning


def test_restore_missing_step_names_available(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=5)
    with pytest.raises(CheckpointNotFound) as ei:
        ck.restore(_like())
    assert ei.value.available == []
    assert isinstance(ei.value, FileNotFoundError)
    _save_steps(ck, [2, 5])
    with pytest.raises(CheckpointNotFound) as ei:
        ck.restore(_like(), step=3)
    assert ei.value.available == [2, 5] and ei.value.step == 3
    with pytest.raises(CheckpointNotFound):
        ck.restore_verified(_like(), step=1)   # nothing committed <= 1


def test_restore_verified_walks_to_last_intact_boundary(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=5)
    tree = _save_steps(ck, [1, 2, 3])
    for s in (2, 3):    # damage the two newest
        f = _file(ck, s)
        f.write_bytes(f.read_bytes()[:30])
    got, meta, fbs = ck.restore_verified(_like())
    assert meta["step"] == 1
    assert [f["step"] for f in fbs] == [3, 2]
    assert all("CRC32" in f["reason"] for f in fbs)
    assert torch.equal(got["Y"], tree["Y"])
    _file(ck, 1).unlink()
    with pytest.raises(CheckpointCorrupt, match="every committed step"):
        ck.restore_verified(_like())


def test_prune_never_evicts_last_verified_boundary(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=1)
    _save_steps(ck, [1, 2, 3])
    assert ck.all_steps() == [3]        # keep_last=1 pruned 1 and 2
    _, meta, fbs = ck.restore_verified(_like())
    assert meta["step"] == 3 and fbs == []
    # newer saves have not been verified: pruning keeps step 3
    _save_steps(ck, [4, 5])
    assert 3 in ck.all_steps() and 5 in ck.all_steps()
    ck.restore_verified(_like())        # lands on 5
    _save_steps(ck, [6])
    assert ck.all_steps() == [5, 6]


def test_keep_last_zero_keeps_nothing(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=0)
    _save_steps(ck, [1, 2])
    assert ck.all_steps() == []


def test_async_save_commits_on_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    ck.save(9, tree)
    ck.wait()
    assert ck.latest_step() == 9
    assert not list(tmp_path.glob(".tmp-*"))
    got, _ = ck.restore(_like())
    assert torch.equal(got["idx"], tree["idx"])


# ---------------------------------------------------------------------------
# Compat fingerprints


def test_cfg_compat_mismatch_raises_structured(tmp_path):
    cfg = _cfg()
    ck = Checkpointer(tmp_path, keep_last=5)
    _save_steps(ck, [2], meta={"compat": cfg_compat(cfg)})
    ck.restore(_like(), expect_compat=cfg_compat(cfg))
    for other in (_cfg(n=N + 16), _cfg(dim=DIM + 1),
                  _cfg(cand_fused=not cfg.cand_fused)):
        with pytest.raises(CheckpointIncompatible) as ei:
            ck.restore(_like(), expect_compat=cfg_compat(other))
        assert ei.value.mismatches, ei.value
    # a mismatch never falls back to older boundaries
    _save_steps(ck, [3], meta={"compat": cfg_compat(cfg)})
    with pytest.raises(CheckpointIncompatible):
        ck.restore_verified(_like(), expect_compat=cfg_compat(_cfg(n=N + 16)))


def test_fit_resume_mismatched_cfg_raises(tmp_path):
    X, cfg = _data(), _cfg()
    tf.fit(X, cfg=cfg, n_iter=8, chunk_size=4, device="cpu",
           resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path)))
    bad_cfg = _cfg(cand_fused=not cfg.cand_fused)
    with pytest.raises(CheckpointIncompatible):
        tf.fit(X, cfg=bad_cfg, n_iter=8, chunk_size=4, device="cpu",
               resilience=ResiliencePolicy(), resume_from=str(tmp_path))


def test_fit_corrupt_fallback_resume_bit_identical(tmp_path):
    """A damaged newest boundary: the resume falls back one chunk and
    replays it bit-identically."""
    X, cfg = _data(), _cfg()
    kw = dict(cfg=cfg, n_iter=16, chunk_size=4, device="cpu")
    st_ref, _ = tf.fit(X, resilience=ResiliencePolicy(), **kw)
    fault = CorruptShard(at_step=8, mode="truncate")
    with pytest.raises(Preempted):
        with active(FaultScript(fault, Preemption(at_step=8))):
            tf.fit(X, resilience=ResiliencePolicy(
                checkpoint_dir=str(tmp_path)), **kw)
    assert fault.damaged is not None
    policy = ResiliencePolicy(checkpoint_dir=str(tmp_path))
    st_res, _ = tf.fit(X, resilience=policy, resume_from=str(tmp_path), **kw)
    fbs = [e for e in policy.events if e["kind"] == "checkpoint_fallback"]
    assert [f["step"] for f in fbs] == [8], policy.events
    for a, b in zip(st_res, st_ref):
        assert torch.equal(a, b)
    assert int(st_res.step) == 16
    # without a policy the skipped boundary is a warning
    _flip(_file(Checkpointer(tmp_path), 16))
    with pytest.warns(RuntimeWarning, match="skipping damaged boundary"):
        tf.fit(X, resume_from=str(tmp_path), **kw)


# ---------------------------------------------------------------------------
# Across the two packages


def test_port_checkpoint_passes_reference_verify_and_restore(tmp_path):
    X, cfg = _data(), _cfg()
    st, _ = tf.fit(X, cfg=cfg, n_iter=8, chunk_size=4, device="cpu",
                   resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path)))
    out = io.StringIO()
    assert j_verify.verify_dir(tmp_path, out=out) == 0
    assert out.getvalue() == ("step 4: OK (1 shard file(s), n_hosts=1)\n"
                              "step 8: OK (1 shard file(s), n_hosts=1)\n")
    like = jf.init_state(jax.random.PRNGKey(0), jnp.asarray(X), _jcfg(cfg))
    jtree, meta = j_ck.Checkpointer(tmp_path).restore(
        like, expect_compat=j_ck.cfg_compat(_jcfg(cfg)))
    assert meta["step"] == 8
    want = convert.state_to_numpy(st)
    got = _jax_fields(jtree)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)
        assert got[name].dtype == a.dtype, name


def test_jax_checkpoint_restores_into_port_and_steps_on(tmp_path):
    """JAX writes a checkpoint of its fit on quantised blobs; the port
    restores it to the fields ``core.convert`` gives, and five further
    steps of both packages agree (lists, flags, step and key exact; floats
    within tests/test_torch_step.py's tolerances)."""
    rng = np.random.default_rng(0)
    x = rng.integers(-12, 13, (4, 12))[rng.integers(0, 4, 160)] \
        + rng.integers(-3, 4, (160, 12))
    X = (x / 4.0).astype(np.float32)
    tcfg = tf.FuncSNEConfig(n_points=160, dim_hd=12)
    jcfg = _jcfg(tcfg)
    jhp = jf.default_hparams(160, perplexity=20.0)
    thp = tf.default_hparams(160, perplexity=20.0, device="cpu")
    jst, _ = jf.fit(jnp.asarray(X), cfg=jcfg, n_iter=10, chunk_size=5,
                    hparams=jhp, resilience=j_res.ResiliencePolicy(
                        checkpoint_dir=str(tmp_path)))
    like = tf.init_state(torch.from_numpy(X), tcfg, device="cpu")
    tst, meta, fbs = Checkpointer(tmp_path).restore_verified(
        like, expect_compat=cfg_compat(tcfg))
    assert meta["step"] == 10 and fbs == []
    assert tst.rng.dtype == torch.int64
    want = _jax_fields(jst)
    got = convert.state_to_numpy(tst)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)

    Xt = torch.from_numpy(X)
    jstep = jax.jit(lambda s, h: jf.funcsne_step(jcfg, s, jnp.asarray(X), h))
    for it in range(10, 15):
        jst = jstep(jst, jf.default_schedule(it, 20, jhp))
        tst = tf.funcsne_step(tcfg, tst, Xt, tf.default_schedule(it, 20, thp))
    a, b = _jax_fields(jst), convert.state_to_numpy(tst)
    for name in ("hd_idx", "ld_idx", "new_flag", "active", "step", "rng",
                 "hd_d", "rev_idx", "rev_step"):
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    for name in ("Y", "vel", "ld_d"):
        np.testing.assert_allclose(
            b[name], a[name], rtol=0,
            atol=F_RTOL * np.abs(a[name][np.isfinite(a[name])]).max() + F_ATOL,
            err_msg=name)
    assert (b["gains"] != a["gains"]).mean() <= GAINS_FRAC
    np.testing.assert_allclose(b["beta"], a["beta"], rtol=BETA_RTOL)
    for name in ("zhat", "ema_new_frac"):
        np.testing.assert_allclose(b[name], a[name], rtol=1e-5, err_msg=name)


def test_port_resumes_a_jax_run(tmp_path):
    """fit(resume_from=) on a JAX run's directory continues from its step
    with the port's own loop."""
    X, cfg = _data(), _cfg()
    jf.fit(jnp.asarray(X), cfg=_jcfg(cfg), n_iter=8, chunk_size=4,
           resilience=j_res.ResiliencePolicy(checkpoint_dir=str(tmp_path)))
    seen = []
    st, _ = tf.fit(X, cfg=cfg, n_iter=12, chunk_size=4, device="cpu",
                   resume_from=str(tmp_path),
                   callback=lambda it, s: seen.append(it))
    assert seen == [11] and int(st.step) == 12
    assert bool(torch.isfinite(st.Y).all())


def test_flipped_byte_corrupt_in_both_verifiers(tmp_path, capsys):
    """One flipped byte in the newest boundary of a port run: both fscks
    print the same lines and return the same exit code."""
    X, cfg = _data(), _cfg()
    tf.fit(X, cfg=cfg, n_iter=8, chunk_size=4, device="cpu",
           resilience=ResiliencePolicy(checkpoint_dir=str(tmp_path)))
    _flip(_file(Checkpointer(tmp_path), 8))
    outs = []
    for mod in (t_verify, j_verify):
        out = io.StringIO()
        assert mod.verify_dir(tmp_path, out=out) == 1
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "step 4: OK" in outs[0] and "step 8: CORRUPT" in outs[0]
    assert "CRC32" in outs[0]
    codes = [(t_verify.main([str(tmp_path)]),
              j_verify.main([str(tmp_path)])),
             (t_verify.main([str(tmp_path), "--step", "4"]),
              j_verify.main([str(tmp_path), "--step", "4"])),
             (t_verify.main([str(tmp_path), "--step", "9"]),
              j_verify.main([str(tmp_path), "--step", "9"]))]
    assert codes == [(1, 1), (0, 0), (1, 1)]
    # each verifier's two failing calls (the CORRUPT step, the missing one)
    err = capsys.readouterr().err
    assert err.count("1 damaged step(s)") == 4


def test_verify_cli_reports_damage_and_exit_code(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=5)
    _save_steps(ck, [1, 2])
    _flip(_file(ck, 2))
    out = io.StringIO()
    assert verify_dir(tmp_path, out=out) == 1
    text = out.getvalue()
    assert "step 1: OK" in text and "step 2: CORRUPT" in text
    assert "CRC32" in text
    assert t_verify.main([str(tmp_path)]) == 1
    assert t_verify.main([str(tmp_path), "--step", "1"]) == 0
    assert t_verify.main([str(tmp_path), "--step", "9"]) == 1
    shutil.rmtree(tmp_path / "step_0000000002")
    assert t_verify.main([str(tmp_path)]) == 0
    empty = tmp_path / "empty"
    out = io.StringIO()
    assert verify_dir(empty, out=out) == 0
    assert out.getvalue() == f"no committed checkpoints under {empty}\n"
