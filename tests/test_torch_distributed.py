"""The port's distributed step against the JAX package's, mesh by mesh.

One JAX subprocess (4 fake CPU devices, ``backend="xla"``) runs
``make_distributed_step`` at meshes (1, 1), (2, 1), (1, 2) and (2, 2) from
one state and writes its states to an ``.npz``; the port runs the same
state, passed through ``repro_torch.core.convert``, on a grid of one rank
in this process and on 2 or 4 gloo ranks (``launch.mesh.run_ranks``).  X is
``blobs(n=256, dim=16)`` rounded to quarters, so squared HD distances are
exact and the discrete fields must agree exactly.

Tolerances (written before the first run):
  * discrete fields (``hd_idx``, ``ld_idx``, ``new_flag``, ``active``,
    ``step``, ``rng``, ``rev_idx``, ``rev_step``) exact;
  * ``hd_d`` crosses the wire in bf16 (H11): within one bf16 ulp,
    ``HD_D_RTOL = 2**-7`` relative (bf16 keeps 8 significant bits, so
    neighbouring values differ by at most 2**-7 of either);
  * Y, vel: the force buffer crosses the wire in bf16 (H10a), and a 1-ulp
    float32 difference between the two compilers' local buffers can flip a
    bf16 rounding: one bf16 ulp of an entry of the buffer, through
    ``vel = mom * vel + lr * gains * 4 * buf``, moves vel by at most
    ``2**-7 * |lr * gains * 4 * buf| <= 2**-7 * (1 + MOM) * max|vel|``; it
    stays in vel with weight MOM**k, so vel moves by at most
    ``2**-7 * (1 + MOM) * max|vel| / (1 - MOM)`` whatever the step count,
    and Y, which adds vel up, by at most s times that after s steps; both
    on top of the single-device float tolerance ``F_RTOL * max|x| +
    F_ATOL`` of tests/test_torch_step.py.  Observed with these inputs (the
    same comparisons on the CPU, every mesh alike): max |dY| 0 after one
    step, 7.5e-9 after three, 1.5e-8 after the chunk of four; max |dvel| 0,
    3.7e-9 and 7.5e-9 (max|vel| 1.0e-2, 5.4e-2 and 1.0e-1; the wire terms
    above 7.0e-4 to 2.9e-2), so no bf16 rounding flipped here;
  * gains equal on all but GAINS_FRAC of entries, beta within BETA_RTOL,
    zhat and ema_new_frac within Z_RTOL (the Z sum over 4 ranks may add
    in another order);
  * ``ld_d`` is the zeros placeholder on both sides (H10b): exact.
The port's chunk equals ``chunk`` sequential distributed steps bit for
bit, and every rank ends with the same replica bit for bit.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import torch_dist_ranks as tdr  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import funcsne as tf  # noqa: E402

torch.set_num_threads(1)
F_RTOL, F_ATOL = 1e-4, 1e-6
GAINS_FRAC = 0.01
BETA_RTOL = 1e-5
Z_RTOL = 1e-5
HD_D_RTOL = 2.0 ** -7
BF16_ULP = 2.0 ** -7
MOM = 0.8               # default_hparams' momentum (no schedule here)

TOL = dict(F_RTOL=F_RTOL, F_ATOL=F_ATOL, GAINS_FRAC=GAINS_FRAC,
           BETA_RTOL=BETA_RTOL, Z_RTOL=Z_RTOL, HD_D_RTOL=HD_D_RTOL,
           BF16_ULP=BF16_ULP, MOM=MOM)

MESHES = ((1, 1), (2, 1), (1, 2), (2, 2))
STEPS = (1, 3)
CHUNK, SNAP = 4, 2


def _case(mesh, flags=None, tag=None):
    return {"tag": tag or f"m{mesh[0]}x{mesh[1]}", "mesh": list(mesh),
            "flags": flags or {}, "seed": 0, "steps": list(STEPS),
            "chunk": CHUNK, "snapshot_every": SNAP}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    X = tdr.quantised_blobs()
    out = tdr.jax_reference(tmp_path_factory.mktemp("jax"),
                            [_case(m) for m in MESHES], X)
    return X, out


def _run_port(case, fields0, X):
    world = case["mesh"][0] * case["mesh"][1]
    if world == 1:
        return [tdr.parity_rank(0, 1, torch.device("cpu"), case, fields0, X)]
    return tdr.run(tdr.parity_rank, world, case, fields0, X)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_distributed_step_matches_jax(ref, mesh):
    X, jref = ref
    case = _case(mesh)
    tag = case["tag"]
    fields0 = tdr.fields_of(jref, f"{tag}/init/")
    outs = _run_port(case, fields0, X)
    got = outs[0]
    # rank order r = d * model + m
    assert [o["coords"] for o in outs] == [
        {"data": r // mesh[1], "model": r % mesh[1]}
        for r in range(len(outs))]
    for s in STEPS:
        tdr.assert_state_close(got[f"step{s}"],
                               tdr.fields_of(jref, f"{tag}/step{s}/"), s, TOL,
                               f"{tag} step {s}")
    # the chunk: state, snapshot ring and metrics against JAX's chunk
    tdr.assert_state_close(got["chunk"],
                           tdr.fields_of(jref, f"{tag}/chunk/"), CHUNK, TOL,
                           f"{tag} chunk")
    met = tdr.fields_of(jref, f"{tag}/metrics/")
    assert int(got["metrics"]["step"]) == int(met["step"]) == CHUNK
    assert int(got["metrics"]["n_snapshots"]) == int(met["n_snapshots"]) == 2
    snaps = jref[f"{tag}/snaps"]
    assert got["snaps"].shape == snaps.shape == (CHUNK // SNAP + 1, tdr.N, 2)
    vmax = float(np.abs(tdr.fields_of(jref, f"{tag}/chunk/")["vel"]).max())
    for i in range(2):
        np.testing.assert_allclose(
            got["snaps"][i], snaps[i], rtol=0,
            atol=F_RTOL * np.abs(snaps[i]).max() + F_ATOL
            + CHUNK * BF16_ULP * (1 + MOM) * vmax / (1 - MOM))
    for name in ("zhat", "ema_new_frac", "finite_frac", "y_max_abs",
                 "disp_ema"):
        np.testing.assert_allclose(got["metrics"][name], met[name],
                                   rtol=1e-3, err_msg=name)
    assert int(got["metrics"]["bad_step"]) == int(met["bad_step"]) == -1
    # the port's chunk is its sequential steps bit for bit
    tdr.assert_bitwise(got["chunk"], got["seq"], f"{tag} chunk vs steps")
    # every rank holds the same replica
    for r, o in enumerate(outs[1:], 1):
        for key in ("step3", "chunk"):
            tdr.assert_bitwise(o[key], got[key], f"{tag} rank {r} {key}")
        np.testing.assert_array_equal(o["snaps"], got["snaps"])


def test_single_device_keeps_ld_d_and_chunk_equals_steps():
    """Without a grid (``AxisCtx()``) no wire format applies: ``ld_d``
    keeps its distances (not the grid's zeros placeholder) and the chunk
    of ``make_chunked_step`` equals its steps one by one."""
    X = tdr.quantised_blobs()
    cfg = tf.FuncSNEConfig(n_points=tdr.N, dim_hd=tdr.DIM)
    hp = tf.default_hparams(tdr.N, device="cpu")
    st0 = tf.init_state(X, cfg, seed=0, device="cpu")
    chunk = tf.make_chunked_step(cfg, 3)
    st_c, _, _ = chunk(st0, torch.from_numpy(X), hp)
    st = st0
    for _ in range(3):
        st = tf.funcsne_step(cfg, st, torch.from_numpy(X), hp)
    tdr.assert_bitwise(convert.state_to_numpy(st_c),
                       convert.state_to_numpy(st),
                       "single-device chunk vs steps")
    assert bool((st.ld_d[torch.isfinite(st.ld_d)] > 0).any())


def test_grid_collectives_on_four_ranks():
    """The (2, 2) grid's axes and collectives: rank r = d * 2 + m; gathers
    in axis-index order along each axis set; a sum added in rank order in
    float32 and, for bf16, rounded once (XLA's psum on the CPU); min and
    max; the column block of the rank's model index; the counters."""
    outs = tdr.run(tdr.grid_rank, 4)
    vals = [(torch.arange(8, dtype=torch.float32) * 0.37 + r) ** 3
            for r in range(4)]
    for r, o in enumerate(outs):
        d, m = divmod(r, 2)
        assert o["coords"] == {"data": d, "model": m}
        assert o["index"] == {"data": d, "model": m, ("data", "model"): r}
        assert o["gather"]["data"] == [m * 10, m * 10 + 1,
                                       (2 + m) * 10, (2 + m) * 10 + 1]
        assert o["gather"]["model"] == [2 * d * 10, 2 * d * 10 + 1,
                                        (2 * d + 1) * 10,
                                        (2 * d + 1) * 10 + 1]
        assert o["gather"][("data", "model")] == [
            v for q in range(4) for v in (q * 10, q * 10 + 1)]
        acc = vals[0].to(torch.bfloat16).float()
        for v in vals[1:]:
            acc = acc + v.to(torch.bfloat16).float()
        assert torch.equal(o["sum_bf16"], acc.to(torch.bfloat16).float())
        assert torch.equal(o["sum_f32"], vals[2 * d] + vals[2 * d + 1])
        assert o["min"] == float(vals[0][0])
        assert o["max"] == float(vals[2 + m][0])
        assert o["block"] == [[float(c) for c in range(3 * m, 3 * m + 3)],
                              [float(c) for c in range(6 + 3 * m,
                                                       9 + 3 * m)]]
        # a sum counts its buffer; untagged calls are not counted
        assert o["counts"] == {"b": [1, 16, 0.0], "f": [1, 32, 0.0]}
        assert o.get("order_checked")
