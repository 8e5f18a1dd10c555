"""The segment sum's ordering on the card, in plain PyTorch, against the
stable sort; and its wrapper's checks and launches.

``segment_runs`` is ``csrc/segment_sum.cu``'s stable counting sort by row
step for step (each chunk of CHUNK_IDS ids counted by group of rows, those
counts scanned over chunks and groups, each chunk's ids ranked within their
group by PLACE_WARPS warps of WARP_IDS ids and placed, then each group's
run ranked by row), with the kernel's constants.  Whatever the
ids, it must give the stable sort's order and run starts, so that each
row's values are added in increasing e: the CPU's sequential
``index_add_`` bit for bit.  Held here on the cases that take
the kernel's other branches: a row with more ids than a chunk and than a
group's shared-memory capacity, the clamped -1 slots piling onto row 0,
empty rows, groups of more rows (large n), and n = 0.  (The kernel itself
is held bit for bit to the CPU's ``index_add_`` on the card, by
``chip_smoke.py``.)
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.segment_sum import ops
from repro_torch.kernels.segment_sum.ops import (CHUNK_IDS, PLACE_WARPS,
                                                 WARP_IDS, group_rows,
                                                 segment_sum)
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

GROUP_WARPS = 16     # kGroupWarps: warps of a block of the last pass


def _starts(counts: list) -> list:
    """Exclusive scan, with the total appended."""
    starts, acc = [], 0
    for c in counts:
        starts.append(acc)
        acc += c
    return starts + [acc]


def _rank(keys: list, bins: int, part: int, warps: int) -> list:
    """The kernel's stable ranking of ``keys`` (bin numbers, -1 for none)
    in one block: warp q < warps takes keys [q part, (q + 1) part) in order
    and counts them by bin; the counts, scanned over bins and then over
    warps, give each warp's start in each bin; each key goes to its warp's
    start plus the earlier keys of its bin in its warp.  Returns each key's
    position (None for -1)."""
    parts = [keys[q * part:(q + 1) * part] for q in range(warps)]
    cw = [[0] * bins for _ in range(warps)]
    for q, ks in enumerate(parts):
        for k in ks:
            if k >= 0:
                cw[q][k] += 1
    lstart = _starts([sum(cw[q][b] for q in range(warps))
                      for b in range(bins)])
    for b in range(bins):
        run = lstart[b]
        for q in range(warps):
            cw[q][b], run = run, run + cw[q][b]
    pos = []
    for q, ks in enumerate(parts):
        for k in ks:
            if k < 0:
                pos.append(None)
                continue
            pos.append(cw[q][k])
            cw[q][k] += 1
    return pos


def segment_runs(idx, n: int):
    """The kernel's ordering of ``idx`` in plain PyTorch: ((E,) int64 ids
    by row, each row's in increasing e; (n + 1,) int64 run starts), which
    is the stable sort's (perm, starts).

    Pass 0 counts each chunk's ids by group (groups of ``group_rows(n)``
    rows); pass 1 scans those counts over the chunks and the groups'
    totals over the groups; pass 2 ranks each chunk's ids within their
    groups (``_rank``: PLACE_WARPS warps of WARP_IDS ids) and puts each at
    its group's start plus the earlier chunks' ids of its group plus its
    rank; pass 3 ranks each group's run by row the same way (GROUP_WARPS
    warps, each a contiguous part of the run, a multiple of 32 long),
    which gives each row its ids in increasing e.
    """
    rows = idx.long().cpu().tolist()
    size = group_rows(n)
    e_count, ng = len(rows), -(-n // size)
    chunks = -(-e_count // CHUNK_IDS)
    hist = [[0] * ng for _ in range(chunks)]
    for e, r in enumerate(rows):
        hist[e // CHUNK_IDS][r // size] += 1
    hpre = [[0] * ng for _ in range(chunks)]
    totals = []
    for g in range(ng):
        run = 0
        for b in range(chunks):
            hpre[b][g], run = run, run + hist[b][g]
        totals.append(run)
    gstart = _starts(totals)
    seg = [0] * e_count
    for b in range(chunks):
        ids = list(range(b * CHUNK_IDS, min(e_count, (b + 1) * CHUNK_IDS)))
        groups = [rows[e] // size for e in ids]
        pos = _rank(groups, ng, WARP_IDS, PLACE_WARPS)
        lstart = _starts([groups.count(k) for k in range(ng)])
        for e, g, p in zip(ids, groups, pos):
            seg[gstart[g] + hpre[b][g] + p - lstart[g]] = e
    perm, counts = [], []
    for g in range(ng):
        run = seg[gstart[g]:gstart[g + 1]]
        g_rows = min(size, n - g * size)
        local = [rows[e] - g * size for e in run]
        part = -(-len(run) // (GROUP_WARPS * 32)) * 32
        pos = _rank(local, g_rows, part, GROUP_WARPS)
        by_row = [0] * len(run)
        for e, p in zip(run, pos):
            by_row[p] = e
        perm += by_row
        counts += [local.count(r) for r in range(g_rows)]
    return (torch.tensor(perm, dtype=torch.long),
            torch.tensor(_starts(counts), dtype=torch.long))


torch.set_num_threads(1)


def _ids(case, rng):
    """(ids, n) of one case."""
    if case == "random":
        return torch.from_numpy(rng.integers(0, 50, 4000)), 50
    if case == "row_over_a_chunk":
        # row 3 holds 20,000 of 24,000 ids: more than a chunk (4,608) and
        # more than a group holds in shared memory (12,288)
        idx = torch.from_numpy(rng.integers(0, 300, 24_000))
        idx[torch.from_numpy(rng.permutation(24_000)[:20_000])] = 3
        return idx, 300
    if case == "clamped_minus_one":
        # invalid slots (-1) clamped to row 0, as the step's targets are
        idx = torch.from_numpy(rng.integers(-1, 200, (400, 30)))
        idx[torch.from_numpy(rng.random((400, 30)) < 0.4)] = -1
        return idx.clamp(0, 199).reshape(-1), 200
    if case == "empty_rows":
        return torch.from_numpy(rng.choice([2, 7, 130, 499], 3000)), 500
    if case == "large_n":
        # 300,000 rows: groups of 256 rows (at most 2,048 groups)
        return torch.from_numpy(rng.integers(0, 300_000, 20_000)), 300_000
    if case == "n_zero":
        return torch.zeros(0, dtype=torch.long), 0
    raise KeyError(case)


CASES = ["random", "row_over_a_chunk", "clamped_minus_one", "empty_rows",
         "large_n", "n_zero"]


@pytest.mark.parametrize("case", CASES)
def test_segment_runs_is_the_stable_sort(case):
    idx, n = _ids(case, np.random.default_rng(CASES.index(case)))
    perm, offs = segment_runs(idx, n)
    assert perm.dtype == offs.dtype == torch.long
    assert torch.equal(perm, torch.sort(idx, stable=True).indices)
    counts = torch.bincount(idx, minlength=n) if n else torch.zeros(0)
    assert offs.shape == (n + 1,) and int(offs[0]) == 0
    assert torch.equal(offs[1:], torch.cumsum(counts, 0).long())
    if case == "clamped_minus_one":
        assert int(offs[1]) > 4000      # row 0 holds the pile
    if case == "empty_rows":
        assert int((counts == 0).sum()) == n - 4


@pytest.mark.parametrize("case", ["row_over_a_chunk", "clamped_minus_one"])
def test_sum_in_run_order_is_the_sequential_index_add(case):
    """Each row's values added in ``segment_runs``' order, one float32 add
    at a time, equal ``segment_sum`` on the CPU (the sequential
    ``index_add_``) bit for bit."""
    rng = np.random.default_rng(7)
    idx, n = _ids(case, rng)
    val = torch.from_numpy((rng.normal(size=(idx.shape[0], 2))
                            * np.exp(rng.normal(size=(idx.shape[0], 1)) * 2))
                           .astype(np.float32))
    perm, offs = segment_runs(idx, n)
    acc = torch.zeros((n, 2))
    starts, ends = offs[:-1].tolist(), offs[1:].tolist()
    vals = val[perm]
    for i in range(int((offs[1:] - offs[:-1]).max())):
        rows = torch.tensor([r for r in range(n) if starts[r] + i < ends[r]])
        acc[rows] += vals[torch.tensor([starts[r] + i for r in rows.tolist()])]
    assert torch.equal(acc, segment_sum(idx, val, n))
    assert torch.equal(acc, segment_sum_ref(idx, val, n))


@pytest.fixture
def launched(monkeypatch):
    """Stub the segment sum's C call on meta tensors: record each launch's
    argument block, with the device check answering 'cuda'."""
    calls = []
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(ops, "_run", lambda a, dev, stream: calls.append(
        {f: getattr(a, f) for f, _ in a._fields_}))
    kernels.reset_launches()
    return calls


def test_wrapper_launches_all_passes(launched):
    """On the card the wrapper launches the kernel (all four passes, one
    C call) once, with the int32 ids as they come (no copy) and a
    workspace of ``work_ints``; n = 0 launches nothing."""
    idx = torch.empty(4900, dtype=torch.int32, device="meta")
    val = torch.empty((4900, 3), device="meta")
    out = segment_sum(idx, val, 100)
    assert out.shape == (100, 3) and out.dtype == torch.float32
    assert kernels.LAUNCHES["segment_sum"] == 1
    (a,) = launched
    assert (a["e"], a["n"], a["d"]) == (4900, 100, 3)
    segment_sum(torch.empty(0, dtype=torch.int32, device="meta"),
                torch.empty((0, 3), device="meta"), 0)
    assert kernels.LAUNCHES["segment_sum"] == 1 and len(launched) == 1
    # each id's value (d words), row (half a word) and slot (a word)
    assert ops.work_ints(100, 4900, 3) >= 4900 * (3 + 1) + 4900 // 2


@pytest.mark.parametrize("bad", ["float_ids", "int64_ids", "short_val",
                                 "val_dtype", "strided_val", "n_too_large",
                                 "d_too_large", "small_work"])
def test_wrapper_input_checks(launched, bad):
    """What the kernel does not take raises before any launch, on the card
    (int64 ids too: they are not converted); nothing falls back."""
    e, n, d = 640, 64, 2
    idx = torch.empty(e, dtype=torch.int32, device="meta")
    val = torch.empty((e, d), device="meta")
    out = torch.empty((n, d), device="meta")
    work = torch.empty(ops.work_ints(n, e, d), dtype=torch.int32,
                       device="meta")
    if bad == "float_ids":
        idx = torch.empty(e, device="meta")
    if bad == "int64_ids":
        idx = torch.empty(e, dtype=torch.int64, device="meta")
    if bad == "short_val":
        val = torch.empty((e - 1, d), device="meta")
    if bad == "val_dtype":
        val = torch.empty((e, d), dtype=torch.float64, device="meta")
    if bad == "strided_val":
        val = torch.empty((e, 2 * d), device="meta")[:, :d]
    if bad == "n_too_large":
        n = ops.MAX_N + 1
        out = torch.empty((n, d), device="meta")
    if bad == "d_too_large":
        d = ops.MAX_D + 1
        val = torch.empty((e, d), device="meta")
        out = torch.empty((n, d), device="meta")
        work = torch.empty(ops.work_ints(n, e, d), dtype=torch.int32,
                           device="meta")
    if bad == "small_work":
        work = work[:-1]
    with pytest.raises(ValueError):
        ops.launch(idx, val, n, out, work)
    if bad == "int64_ids":
        with pytest.raises(ValueError):
            segment_sum(idx, val, n)
    assert launched == [] and kernels.LAUNCHES["segment_sum"] == 0


def test_cpu_runs_the_plain_version():
    idx = torch.tensor([2, 0, 2, 1])
    val = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    kernels.reset_launches()
    got = segment_sum(idx, val, 4)
    assert torch.equal(got, segment_sum_ref(idx, val, 4))
    assert kernels.LAUNCHES["segment_sum"] == 0
