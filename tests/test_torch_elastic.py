"""The port's elastic loop on a grid of gloo ranks (CPU), against the
reference's contracts (tests/test_elastic_resume.py, tests/test_resilience.py):

  * the shard-confined NaN: ``NaNChunk(shard=3, field="vel", rows=4)`` on 4
    ranks at grid (4, 1), n = 128 (32 rows a rank): the reduced probe reads
    finite_frac 28/32 and bad_step 0 on every rank, the per-replica probe
    1.0 and -1 on rank 0 (the reference's numbers);
  * ``fit_elastic`` rolls such a fault back and finishes finite, and two
    runs are bit-identical;
  * ``remesh`` uses every rank or reports the ranks left out, and a rank
    left out of the grid takes no step;
  * a preempted run resumed from its checkpoints ends bit for bit on the
    clean run's state, and the reference's fsck accepts the directory;
  * the CLI's ``--devices 2 --model 2`` runs; each multi-host option alone
    does what the reference's does (a one-device run, or the reference's
    argument error), and ``fit_elastic``'s ``n_hosts`` / ``generation`` on
    one rank behave as the reference's (its ValueError; the
    generation-tagged layout, which the reference restores).
Every multi-process call has its own time limit (``run_ranks``).
"""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_ranks as tdr
from repro_torch.core import convert
from repro_torch.launch import embed as t_embed
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import coordinator, elastic

torch.set_num_threads(1)


def test_shard_confined_nan_trips_reduced_probe_only():
    X = tdr.quantised_blobs(n=128)
    outs = tdr.run(tdr.probe_both_rank, 4, X)
    for rank, (reduced, blind) in enumerate(outs):
        np.testing.assert_allclose(reduced[0], 28.0 / 32.0, rtol=1e-6)
        assert reduced[1] == 0, (rank, reduced)
        if rank != 3:
            # the per-replica probe of a clean replica sees nothing
            assert blind == (1.0, -1), (rank, blind)
    # rank 3's own replica holds the NaN rows
    assert outs[3][1][1] == 0


def test_multi_rank_entry_points_raise_without_cuda(monkeypatch):
    """``run_ranks`` and ``fit_elastic`` run on the card unless the caller
    asks for the CPU: without CUDA they raise before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = tdr.quantised_blobs(n=64)
    for call in (lambda: mesh_lib.run_ranks(tdr.grid_rank, 2),
                 lambda: coordinator.fit_elastic(torch.from_numpy(X),
                                                 n_iter=1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_shard_confined_nan_rolls_back_deterministically():
    X = tdr.quantised_blobs(n=128)
    outs = tdr.run(tdr.rollback_rank, 2, X)
    for runs in outs:
        a, b = runs
        kinds = [e["kind"] for e in a["events"]]
        assert "rollback" in kinds, kinds
        assert int(a["state"]["step"]) == 16
        assert np.isfinite(a["state"]["Y"]).all()
        tdr.assert_bitwise(a["state"], b["state"], "run a vs run b")
        assert [e["kind"] for e in b["events"]] == kinds
    tdr.assert_bitwise(outs[0][0]["state"], outs[1][0]["state"],
                       "rank 0 vs rank 1")


def test_remesh_uses_every_rank_or_reports_drops():
    elastic.reset_events()
    grid = elastic.remesh(6, model=4)
    assert grid.shape == {"data": 2, "model": 3} and grid.size == 6
    assert elastic.n_events() == 0
    grid = elastic.remesh(6, model=4, divides=(8,))
    assert grid.shape == {"data": 3, "model": 2}
    seen = []
    grid = elastic.remesh(6, model=4, exact_model=True, on_event=seen.append)
    assert grid.shape == {"data": 1, "model": 4} and grid.ranks == [0, 1, 2, 3]
    (ev,) = seen
    assert ev["kind"] == "devices_dropped" and ev["n_dropped"] == 2
    assert ev["dropped"] == ["rank 4", "rank 5"]
    assert elastic.events()[-1] == ev


def test_rows_past_the_slices_keep_their_lists():
    """n = 129 over 2 ranks: each rank owns 64 rows, so row 128 is in no
    slice (the reference's ``n // shards``); its HD and LD lists stay, the
    rest move, and both replicas agree."""
    X = tdr.quantised_blobs(n=129)
    outs = tdr.run(tdr.tail_rank, 2, X)
    (before, after), (_, after1) = outs
    tdr.assert_bitwise(after, after1, "ranks")
    for name in ("hd_idx", "ld_idx"):
        np.testing.assert_array_equal(after[name][128], before[name][128])
        assert (after[name][:128] != before[name][:128]).any(), name
    assert int(after["step"]) == 1 and np.isfinite(after["Y"]).all()


def test_host_device_blocks_and_batch_axes():
    assert mesh_lib.host_device_blocks(range(6), 2) == [[0, 1, 2],
                                                        [3, 4, 5]]
    assert mesh_lib.host_device_blocks(range(5), 2) == [[0, 1], [2, 3, 4]]
    with pytest.raises(ValueError):
        mesh_lib.host_device_blocks(range(2), 3)
    assert mesh_lib.batch_axes(mesh_lib.Grid((1, 1))) == ("data",)


def test_rank_outside_the_grid_takes_no_step():
    X = tdr.quantised_blobs(n=128)
    outs = tdr.run(tdr.idle_rank, 3, X)
    for o in outs[:2]:
        assert int(o["state"]["step"]) == 4 and not o["warned"]
    tdr.assert_bitwise(outs[0]["state"], outs[1]["state"], "ranks 0, 1")
    assert outs[2]["state"] is None
    assert [e["kind"] for e in outs[2]["events"]] == ["rank_idle"]
    assert "takes no step" in outs[2]["warned"][0]


@pytest.mark.parametrize("model", [1, 2])
def test_preempt_and_resume_is_bit_identical(tmp_path, model):
    X = tdr.quantised_blobs(n=128)
    outs = tdr.run(tdr.resume_rank, 2, X, str(tmp_path), model)
    for o in outs:
        assert o["preempted"]
        assert [e["kind"] for e in o["events"]] == ["restore"]
        assert o["events"][0]["step"] == 8
        tdr.assert_bitwise(o["resumed"], o["clean"], "resumed vs clean")
    tdr.assert_bitwise(outs[0]["clean"], outs[1]["clean"], "ranks")
    jax = pytest.importorskip("jax")  # noqa: F841
    from repro.checkpoint import verify as j_verify
    for d in ("clean", "pre"):
        out = io.StringIO()
        assert j_verify.verify_dir(tmp_path / d, out=out) == 0, out.getvalue()
        assert "OK" in out.getvalue()


def test_cli_devices_two_model_two():
    env = dict(os.environ, PYTHONPATH=tdr.SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.embed", "--devices", "2",
         "--model", "2", "--device", "cpu", "--dataset", "blobs", "--n",
         "256", "--iters", "20"], capture_output=True, text=True,
        timeout=tdr.RANKS_TIMEOUT, env=env)
    assert r.returncode == 0, r.stderr
    line = [s for s in r.stdout.splitlines() if s.startswith("[embed]")]
    assert len(line) == 1, r.stdout
    assert "devices=2 model=2" in line[0] and "backend=gloo" in line[0]
    assert "R_NX AUC=" in line[0]


@pytest.mark.parametrize("argv", [["--hosts", "2"], ["--num-processes", "2"],
                                  ["--process-id", "0"],
                                  ["--coordinator", "localhost:1234"]],
                         ids=lambda a: a[0])
def test_multi_host_options_raise(argv, monkeypatch, capsys):
    """Each multi-host option alone, as the reference reads it: ``--hosts``,
    ``--process-id`` and ``--coordinator`` leave a run of one process on
    one device, which finishes on the one-device path; ``--num-processes 2``
    without ``--process-id`` / ``--coordinator`` is the reference's
    argument error, word for word."""
    if argv[0] == "--num-processes":
        pytest.importorskip("jax")
        from repro.launch import embed as j_embed

        def error(run):
            with pytest.raises(SystemExit) as ei:
                run()
            assert ei.value.code == 2
            return capsys.readouterr().err.splitlines()[-1]
        monkeypatch.setattr(sys, "argv", ["embed.py"] + argv)
        want = error(j_embed.main)
        assert error(lambda: t_embed.main(argv + ["--device", "cpu"])) \
            == want
        assert "requires --process-id and --coordinator" in want
        return
    t_embed.main(argv + ["--device", "cpu", "--dataset", "blobs", "--n",
                         "64", "--iters", "2"])
    line = [s for s in capsys.readouterr().out.splitlines()
            if s.startswith("[embed]")]
    assert len(line) == 1 and "it/s" in line[0] and "devices=" not in line[0]


@pytest.mark.parametrize("kw", [{"n_hosts": 2}, {"generation": 0}],
                         ids=lambda k: next(iter(k)))
def test_fit_elastic_multi_host_raises(kw, tmp_path):
    """On one rank: ``n_hosts=2`` raises the reference's ValueError (two
    hosts need two devices); ``generation=0`` runs and writes the
    generation-tagged layout of one host, which the reference's fsck and
    ``Checkpointer`` accept."""
    jax = pytest.importorskip("jax")
    from repro import checkpoint as j_ck
    from repro.checkpoint import verify as j_verify
    from repro.core.funcsne import FuncSNEState as JState
    from repro.runtime.coordinator import fit_elastic as j_fit_elastic

    from repro_torch.core.resilience import ResiliencePolicy

    X = torch.from_numpy(tdr.quantised_blobs(n=64))
    if "n_hosts" in kw:
        with pytest.raises(ValueError) as ej:
            j_fit_elastic(X.numpy(), n_iter=2, devices=jax.devices()[:1],
                          **kw)
        with pytest.raises(ValueError) as et:
            coordinator.fit_elastic(X, n_iter=2, device="cpu", **kw)
        assert str(et.value) == str(ej.value) == "n_hosts=2 for 1 devices"
        return
    st = coordinator.fit_elastic(
        X, n_iter=4, chunk_size=2, device="cpu", resilience=ResiliencePolicy(
            checkpoint_dir=str(tmp_path)), **kw)
    assert int(st.step) == 4
    for s in (2, 4):
        d = tmp_path / f"step_{s:010d}"
        assert sorted(p.name for p in d.iterdir()) == [
            "meta.json", "shard000-of-001-g000000.npz"]
    assert j_verify.verify_dir(tmp_path) == 0
    want = convert.state_to_numpy(st)
    got, meta = j_ck.Checkpointer(tmp_path).restore(
        JState(**{k: np.zeros_like(v) for k, v in want.items()}))
    assert meta["generation"] == 0 and meta["step"] == 4
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
