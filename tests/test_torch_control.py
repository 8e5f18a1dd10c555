"""The port's multi-process elastic runtime (``repro_torch.runtime.control``,
``runtime.elastic``'s liveness, the generation-tagged checkpoint shards),
case for case against the reference's tests/test_process_elastic.py, and
across the two packages:

  * heartbeat freshness from counters and the observer's clock only; the
    observer, tuple counters, the beat writer, ``_read_beat`` and the sweep
    of stale beat files;
  * generation-tagged shards: round trip, stale-generation eviction, the
    commit claim, the race loser that never destroys a committed boundary,
    a planted stray shard left out by the manifest, ``committed_steps``;
  * against the reference: ``surviving_pods`` and the observer's survivors
    on hypothesis-drawn beat sequences; a two-host generation-tagged
    checkpoint written by the port passes the reference's fsck and its
    ``Checkpointer`` restores the same arrays bit for bit, one the
    reference wrote restores bit for bit in the port, and the file names
    and ``meta.json`` keys are the same;
  * ``scenario_process_kill(device="cpu")``: two real worker processes
    (gloo), a SIGKILL at chunk 8 of 16, every assertion of the reference's
    scenario, in a subprocess under its own time limit; the supervisor
    loads no torch, so it initialises neither CUDA nor a process group.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from repro_torch.checkpoint import (CheckpointCorrupt, Checkpointer,
                                    row_shard_filter)
from repro_torch.runtime import control
from repro_torch.runtime.elastic import (Beat, HeartbeatObserver,
                                         surviving_pods)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SCENARIO_TIMEOUT = 300


# --------------------------------------------------------------------------
# Heartbeat freshness: counters and the observer's clock, never pod clocks


def test_surviving_pods_ignores_pod_clocks():
    # pod 1's counter (3) could be a skewed timestamp for all the observer
    # cares: freshness comes only from the observer's stamp
    beats = {0: (7, 100.0), 1: (3, 50.0)}
    assert surviving_pods(beats, timeout_s=30.0, now=110.0) == [0]
    assert surviving_pods(beats, timeout_s=70.0, now=110.0) == [0, 1]


def test_boundary_equal_gap_counts_fresh():
    beats = {0: Beat(counter=5, stamped=100.0)}
    assert surviving_pods(beats, timeout_s=10.0, now=110.0) == [0]
    assert surviving_pods(beats, timeout_s=10.0, now=110.0001) == []


def test_observer_stamps_changes_only():
    obs = HeartbeatObserver()
    assert obs.observe("a", 1, now=0.0)          # first sighting stamps
    for t in (1.0, 5.0, 9.0):
        assert not obs.observe("a", 1, now=t)   # a stale file never refreshes
    assert obs.survivors(timeout_s=8.0, now=9.0) == []
    assert obs.observe("a", 2, now=9.0)
    assert obs.survivors(timeout_s=8.0, now=9.0) == ["a"]


def test_observer_startup_grace_signal_and_forget():
    obs = HeartbeatObserver()
    obs.observe("a", 1, now=0.0)
    assert obs.beats["a"].changes == 0
    obs.observe("a", 2, now=3.0)
    assert obs.beats["a"].changes == 1
    obs.forget("a")
    assert obs.survivors(timeout_s=100.0, now=3.0) == []


def test_tuple_counters_cross_generations():
    obs = HeartbeatObserver()
    obs.observe(0, (0, 9), now=0.0)
    assert not obs.observe(0, (0, 9), now=50.0)
    assert obs.observe(0, (1, 1), now=50.0)
    assert obs.survivors(timeout_s=10.0, now=55.0) == [0]


# --------------------------------------------------------------------------
# Generation-tagged checkpoint shards


def _tree(seed, n=12, d=3):
    rng = np.random.default_rng(seed)
    return {"Y": torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)),
            "step": torch.tensor(seed, dtype=torch.int32)}


def _save_shard(ck, step, tree, host_id, n_hosts, generation, n=12):
    ck.save(step, tree, blocking=True, host_id=host_id, n_hosts=n_hosts,
            generation=generation,
            host_shard_filter=row_shard_filter(host_id, n_hosts, n))


def test_generation_tagged_shard_roundtrip(tmp_path):
    tree = _tree(7)
    # two writers on the shared directory, as two processes; the one
    # completing the set commits the merged boundary
    _save_shard(Checkpointer(tmp_path), 4, tree, 0, 2, generation=3)
    assert not (tmp_path / "step_0000000004").exists()   # half-staged
    _save_shard(Checkpointer(tmp_path), 4, tree, 1, 2, generation=3)
    d = tmp_path / "step_0000000004"
    names = sorted(p.name for p in d.glob("*.npz"))
    assert names == ["shard000-of-002-g000003.npz",
                     "shard001-of-002-g000003.npz"]
    got, meta = Checkpointer(tmp_path).restore(_tree(0))
    assert meta["generation"] == 3
    assert torch.equal(got["Y"], tree["Y"])


def test_stale_generation_shard_evicted_on_commit(tmp_path):
    # generation 0 died after staging only host 0's part of step 8;
    # generation 1 (remeshed to one host) checkpoints the same step
    _save_shard(Checkpointer(tmp_path), 8, _tree(0), 0, 2, generation=0)
    _save_shard(Checkpointer(tmp_path), 8, _tree(1), 0, 1, generation=1)
    d = tmp_path / "step_0000000008"
    names = sorted(p.name for p in d.iterdir())
    assert names == ["meta.json", "shard000-of-001-g000001.npz"]
    meta = json.loads((d / "meta.json").read_text())
    assert meta["generation"] == 1
    assert any("g000000" in f for f in meta["evicted_stale"])
    got, _ = Checkpointer(tmp_path).restore(_tree(9))
    assert torch.equal(got["Y"], _tree(1)["Y"])


def test_commit_claim_gates_completing_writer(tmp_path):
    ck = Checkpointer(tmp_path)
    _save_shard(ck, 8, _tree(0), 0, 2, generation=2)
    claim = tmp_path / ".tmp-8.claim-g000002"
    claim.touch()
    _save_shard(ck, 8, _tree(0), 1, 2, generation=2)  # full set, claimed
    assert not (tmp_path / "step_0000000008").exists()
    claim.unlink()
    _save_shard(ck, 8, _tree(0), 1, 2, generation=2)
    assert (tmp_path / "step_0000000008" / "meta.json").exists()
    assert not claim.exists()


def test_commit_race_loser_never_destroys_committed_boundary(tmp_path):
    _save_shard(Checkpointer(tmp_path), 4, _tree(1), 0, 1, generation=1)
    d = tmp_path / "step_0000000004"
    winner_meta = (d / "meta.json").read_text()
    # a straggling writer completes its own staged set of the same step
    # afterwards: its commit fails soft, the boundary stays the winner's
    ck = Checkpointer(tmp_path)
    _save_shard(ck, 4, _tree(2), 0, 2, generation=1)
    _save_shard(ck, 4, _tree(2), 1, 2, generation=1)   # completing write
    assert (d / "meta.json").read_text() == winner_meta
    got, meta = Checkpointer(tmp_path).restore(_tree(0))
    assert meta["generation"] == 1
    assert torch.equal(got["Y"], _tree(1)["Y"])


def test_manifest_filters_planted_stray_shard(tmp_path):
    _save_shard(Checkpointer(tmp_path), 8, _tree(1), 0, 1, generation=1)
    d = tmp_path / "step_0000000008"
    np.savez(d / "shard000-of-001-g000000.npz",
             **{"['Y']||@rows0": _tree(0)["Y"].numpy()})
    got, _ = Checkpointer(tmp_path).restore(_tree(9), verify=False)
    assert torch.equal(got["Y"], _tree(1)["Y"])
    with pytest.raises(CheckpointCorrupt, match="not in manifest"):
        Checkpointer(tmp_path).verify_step(8)


# --------------------------------------------------------------------------
# Supervisor-side helpers


def test_committed_steps_listing(tmp_path):
    for s, committed in [(4, True), (8, True), (12, False)]:
        d = tmp_path / f"step_{s:010d}"
        d.mkdir()
        if committed:
            (d / "meta.json").write_text("{}")
    assert control.committed_steps(tmp_path) == [4, 8]
    assert control.committed_steps(tmp_path / "missing") == []


def test_beat_writer_feeds_observer(tmp_path):
    beat = control._beat_writer(tmp_path, pod=1, generation=2)
    obs = HeartbeatObserver()
    for it, t in [(0, 0.0), (4, 1.0)]:
        beat(it)
        rec = json.loads((tmp_path / "pod1.beat").read_text())
        assert rec["generation"] == 2 and rec["step"] == it
        assert obs.observe(1, (rec["generation"], rec["counter"]), now=t)
    assert obs.beats[1].changes == 1


def test_read_beat_returns_counter_and_step(tmp_path):
    sup = control.Supervisor(tmp_path, n_pods=1)
    assert sup._read_beat(0) is None        # absent file: no reading
    (sup.hb_dir / "pod0.beat").write_text(json.dumps(
        {"pod": 0, "generation": 3, "counter": 5, "step": 12}))
    assert sup._read_beat(0) == ((3, 5), 12)
    (sup.hb_dir / "pod0.beat").write_text("{torn")
    assert sup._read_beat(0) is None        # torn file: no reading


def test_spawn_sweeps_stale_beat_files(tmp_path):
    sup = control.Supervisor(tmp_path, n_pods=2)
    (sup.hb_dir / "pod0.beat").write_text(json.dumps(
        {"pod": 0, "generation": 0, "counter": 7, "step": 8}))
    (sup.hb_dir / "pod1.beat.tmp").write_text("torn atomic-write stray")
    sup._clear_beats()
    assert list(sup.hb_dir.iterdir()) == []


# --------------------------------------------------------------------------
# Across the two packages

jax = pytest.importorskip("jax")
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.checkpoint import row_shard_filter as j_row_shard_filter  # noqa: E402
from repro.checkpoint import verify as j_verify  # noqa: E402
from repro.runtime import elastic as j_elastic  # noqa: E402

_beat_seq = hst.lists(
    hst.tuples(hst.integers(0, 3),                       # pod
               hst.tuples(hst.integers(0, 2), hst.integers(0, 4)),  # counter
               hst.floats(0.0, 5.0)),                    # time step
    min_size=1, max_size=30)


@settings(max_examples=60, deadline=None)
@given(seq=_beat_seq, timeout=hst.floats(0.0, 20.0),
       wait=hst.floats(0.0, 20.0))
def test_liveness_agrees_with_reference(seq, timeout, wait):
    ours, theirs = HeartbeatObserver(), j_elastic.HeartbeatObserver()
    now = 0.0
    for pod, counter, dt in seq:
        now += dt
        assert ours.observe(pod, counter, now) == \
            theirs.observe(pod, counter, now)
    now += wait
    assert ours.survivors(timeout, now) == theirs.survivors(timeout, now)
    tuples = {p: (b.counter, b.stamped) for p, b in ours.beats.items()}
    assert surviving_pods(tuples, timeout, now) == \
        j_elastic.surviving_pods(tuples, timeout, now)
    assert {p: (b.counter, b.stamped, b.changes)
            for p, b in ours.beats.items()} == \
        {p: (b.counter, b.stamped, b.changes)
         for p, b in theirs.beats.items()}


def _np_tree(tree):
    return {k: v.numpy() for k, v in tree.items()}


def _write_both(tmp_path, generation=3, n=12):
    """The same two-host generation-tagged step 4 written by the port and
    by the reference, in two directories."""
    tree = _tree(5, n=n)
    for h in range(2):
        Checkpointer(tmp_path / "port").save(
            4, tree, blocking=True, host_id=h, n_hosts=2,
            generation=generation,
            host_shard_filter=row_shard_filter(h, 2, n))
        JCheckpointer(tmp_path / "ref").save(
            4, _np_tree(tree), blocking=True, host_id=h, n_hosts=2,
            generation=generation,
            host_shard_filter=j_row_shard_filter(h, 2, n))
    return tree


def test_port_shards_pass_reference_verify_and_restore(tmp_path):
    import io
    tree = _write_both(tmp_path)
    out = io.StringIO()
    assert j_verify.verify_dir(tmp_path / "port", out=out) == 0
    assert out.getvalue() == "step 4: OK (2 shard file(s), n_hosts=2)\n"
    got, meta = JCheckpointer(tmp_path / "port").restore(
        {k: np.zeros_like(v) for k, v in _np_tree(tree).items()})
    assert meta["generation"] == 3 and meta["n_hosts"] == 2
    for k, v in _np_tree(tree).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got[k].dtype == v.dtype


def test_reference_shards_restore_in_port(tmp_path):
    tree = _write_both(tmp_path)
    got, meta = Checkpointer(tmp_path / "ref").restore(_tree(0))
    assert meta["generation"] == 3
    for k in tree:
        assert torch.equal(got[k], tree[k]), k


def test_shard_names_and_meta_keys_equal_reference(tmp_path):
    _write_both(tmp_path)
    d_port = tmp_path / "port" / "step_0000000004"
    d_ref = tmp_path / "ref" / "step_0000000004"
    assert sorted(p.name for p in d_port.iterdir()) == \
        sorted(p.name for p in d_ref.iterdir()) == [
            "meta.json", "shard000-of-002-g000003.npz",
            "shard001-of-002-g000003.npz"]
    mp = json.loads((d_port / "meta.json").read_text())
    mr = json.loads((d_ref / "meta.json").read_text())
    assert sorted(mp) == sorted(mr)
    assert mp["manifest"]["n_hosts"] == mr["manifest"]["n_hosts"] == 2
    assert {f: m["arrays"] for f, m in mp["manifest"]["files"].items()} == \
        {f: m["arrays"] for f, m in mr["manifest"]["files"].items()}
    # the same bytes, so the same CRC32
    for f in mp["manifest"]["files"]:
        assert (d_port / f).read_bytes() == (d_ref / f).read_bytes(), f


# --------------------------------------------------------------------------
# The real thing: two processes, gloo, SIGKILL, supervised resume


_SCENARIO = """
import json, sys
from repro_torch.runtime import control, faults
info = faults.scenario_process_kill(device="cpu")
import torch, torch.distributed as dist
print(json.dumps({"info": info, "cuda": torch.cuda.is_initialized(),
                  "group": dist.is_initialized()}))
"""


def test_process_kill_smoke_two_real_processes(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _SCENARIO], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=SCENARIO_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["info"] == {"resumed_at": res["info"]["resumed_at"],
                           "final_step": 16, "generations": 2}
    assert 0 < res["info"]["resumed_at"] < 16
    # the supervisor's process neither initialised CUDA nor joined a group
    assert res["cuda"] is False and res["group"] is False


def test_supervisor_loads_no_torch(tmp_path):
    code = ("import sys\n"
            "from repro_torch.runtime import control, elastic\n"
            f"sup = control.Supervisor({str(tmp_path)!r}, n_pods=2)\n"
            "sup._clear_beats()\n"
            "print('torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def test_entry_points_run_on_the_card_unless_given_the_cpu(tmp_path,
                                                           monkeypatch):
    """Without CUDA the new entry points raise unless given the CPU: the
    scenarios at their default device, and a supervised pod, whose workers
    raise (each logs ``worker_failed``) so that no pod survives."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.runtime import faults
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        faults.scenario_host_loss()
    if torch.cuda.is_available():       # pragma: no cover - a card here
        return
    monkeypatch.undo()      # the workers are fresh interpreters
    sup = control.Supervisor(tmp_path, n_pods=1, total_timeout=120.0)
    with pytest.raises(control.SupervisorError,
                       match="CUDA is not available") as ei:
        sup.run()
    assert [e["kind"] for e in ei.value.events if e["src"] == "worker"] \
        == ["worker_failed"]
