"""The port's distributed step against the JAX package's at mesh (2, 2) on
the flag paths: ``scatter_fused=False`` (B5 and the segment-sum
symmetrisation into the buffer the grid sums), ``gather_fused=False`` (B6
on gathered column blocks, B7), ``cand_fused=False`` (threefry, the keys
folded by the rank's points / points x feat index) and ``c_hd_rev=4``
(the replicated reverse-edge table, its fill from the key before the
fold).

As in tests/test_torch_distributed.py: one JAX subprocess on 4 fake CPU
devices, the same quantised blobs, the port on 4 gloo ranks from the
converted JAX state, the states after 1 and 3 steps compared.

Tolerances (written before the first run), derived as in
tests/test_torch_distributed.py:
  * discrete fields exact;
  * ``hd_d`` within one bf16 ulp, ``HD_D_RTOL = 2**-7`` (H11);
  * Y, vel within ``F_RTOL * max|x| + F_ATOL`` plus, for one bf16 ulp of
    the summed force buffer per step (H10a) carried by the momentum,
    ``2**-7 * (1 + MOM) * max|vel| / (1 - MOM)`` for vel and s times that
    for Y after s steps.  Observed with these inputs (the same comparisons
    on the CPU, all four paths): max |dY| 0 after one step and 7.5e-9
    after three, max |dvel| 0 and 3.7e-9 (max|vel| 9.0e-3 to 1.0e-2 and
    4.6e-2 to 5.7e-2);
  * gains equal on all but GAINS_FRAC of entries, beta within BETA_RTOL,
    zhat and ema_new_frac within Z_RTOL; ``ld_d`` the zeros placeholder.
Every rank ends with the same replica bit for bit.
"""
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import torch_dist_ranks as tdr  # noqa: E402

torch.set_num_threads(1)
F_RTOL, F_ATOL = 1e-4, 1e-6
GAINS_FRAC = 0.01
BETA_RTOL = 1e-5
Z_RTOL = 1e-5
HD_D_RTOL = 2.0 ** -7
BF16_ULP = 2.0 ** -7
MOM = 0.8
TOL = dict(F_RTOL=F_RTOL, F_ATOL=F_ATOL, GAINS_FRAC=GAINS_FRAC,
           BETA_RTOL=BETA_RTOL, Z_RTOL=Z_RTOL, HD_D_RTOL=HD_D_RTOL,
           BF16_ULP=BF16_ULP, MOM=MOM)

MESH = (2, 2)
STEPS = (1, 3)
FLAGS = {"scatter_unfused": {"scatter_fused": False},
         "gather_unfused": {"gather_fused": False},
         "threefry": {"cand_fused": False},
         "rev4": {"c_hd_rev": 4}}


def _case(tag):
    return {"tag": tag, "mesh": list(MESH), "flags": FLAGS[tag], "seed": 0,
            "steps": list(STEPS)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    X = tdr.quantised_blobs()
    out = tdr.jax_reference(tmp_path_factory.mktemp("jax"),
                            [_case(t) for t in FLAGS], X)
    return X, out


@pytest.mark.parametrize("tag", list(FLAGS))
def test_distributed_flag_path_matches_jax(ref, tag):
    X, jref = ref
    case = _case(tag)
    outs = tdr.run(tdr.parity_rank, MESH[0] * MESH[1], case,
                   tdr.fields_of(jref, f"{tag}/init/"), X)
    for s in STEPS:
        tdr.assert_state_close(outs[0][f"step{s}"],
                               tdr.fields_of(jref, f"{tag}/step{s}/"), s, TOL,
                               f"{tag} step {s}")
    for r, o in enumerate(outs[1:], 1):
        tdr.assert_bitwise(o["step3"], outs[0]["step3"], f"{tag} rank {r}")
    if tag == "rev4":
        # the table was rebuilt at the first refinement, on every replica
        assert int(outs[0]["step3"]["rev_step"]) >= 0
