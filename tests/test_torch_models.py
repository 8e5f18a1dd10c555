"""The port's LM stack and the latents pipeline against the JAX package on
the CPU: MusicGen-large's smoke variant in float32.

  * ``init_params(0)`` draws JAX's ``init_params(PRNGKey(0))``: every
    normal-drawn tensor within ``threefry.normal``'s 4 float32 ulps, the
    rest exact;
  * ``hidden_states`` on weights carried across (``lm_params_from_jax``)
    matches JAX's on one numpy batch within rtol 1e-5 plus 1e-5 of the
    largest |h| (float32 with another summation order; measured 4e-7 of
    the largest);
  * the same in bfloat16 compute (the full config's), which holds the
    port's rounding points (rms_norm and RoPE in float32 then cast, silu
    rounded before the product, bf16 matmuls) to JAX's: see BF16_REL;
  * ``one_nn_accuracy`` draws JAX's prototypes exactly and gives its
    accuracy for a given Z;
  * the smoke pipeline ``python -m repro_torch.examples.embed_latents
    --device cpu --smoke`` runs and reports three accuracies.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_arch as j_get_arch  # noqa: E402
from repro.configs.base import smoke_variant as j_smoke  # noqa: E402
from repro.core import quality as j_quality  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models.transformer import LMModel as JModel  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_arch, smoke_variant  # noqa: E402
from repro_torch.core import convert, quality, threefry  # noqa: E402
from repro_torch.examples import embed_latents  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models.transformer import LMModel  # noqa: E402

torch.set_num_threads(1)
MAX_ULPS = 4
H_RTOL = 1e-5
# bfloat16 compute, port against JAX: relative Frobenius error of the hidden
# states and the share of entries that differ at all.  Where both round at
# the same points, entries part only where two float32 sums taken in another
# order fall on either side of a bf16 rounding boundary, which is rare
# (measured 1.5e-4 and 0.16%); a rounding point dropped or moved changes a
# half-ulp (2^-9 = 2e-3) in most entries (measured: silu not rounded before
# the product 5.4e-3 and 61%, RoPE left in float32 6.4e-3 and 64%, rms_norm
# not cast back 1.7e-3 and 99.97%).  XLA's excess precision is turned off
# for the reference, as by default it may drop a cast pair inside a fusion
BF16_REL = 5e-4
BF16_DIFF_SHARE = 0.02


@pytest.fixture(scope="module")
def musicgen():
    """(JAX cfg, JAX model, JAX params as numpy, port model)."""
    jcfg = j_smoke(j_get_arch("musicgen-large"))
    jm = JModel(jcfg)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return jcfg, jm, jp, LMModel(smoke_variant(get_arch("musicgen-large")))


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def test_configs_match_jax():
    for name in ARCH_IDS:
        a, b = get_arch(name), j_get_arch(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        assert dataclasses.asdict(smoke_variant(a)) == \
            dataclasses.asdict(j_smoke(b)), name


def test_init_params_match_jax(musicgen):
    _, _, jp, tm = musicgen
    tp = tm.init_params(0, device="cpu")
    assert len(tp["blocks"]) == jp["blocks"]["ln_attn"].shape[0]
    for i, blk in enumerate(tp["blocks"]):
        for grp in ("attn", "mlp"):
            for name, w in blk[grp].items():
                want = jp["blocks"][grp][name][i]
                assert w.shape == want.shape, (i, grp, name)
                assert _ulps(w.numpy(), want) <= MAX_ULPS, (i, grp, name)
        for name in ("ln_attn", "ln_mlp"):
            np.testing.assert_array_equal(blk[name].numpy(),
                                          jp["blocks"][name][i])
    assert _ulps(tp["lm_head"].numpy(), jp["lm_head"]) <= MAX_ULPS
    np.testing.assert_array_equal(tp["final_norm"].numpy(), jp["final_norm"])
    assert set(tp) == set(jp)


def test_hidden_states_match_jax(musicgen):
    jcfg, jm, jp, tm = musicgen
    x = np.random.default_rng(5).normal(size=(3, 24, jcfg.d_model)) \
        .astype(np.float32)
    want = np.asarray(jm.hidden_states(jax.tree.map(jnp.asarray, jp),
                                       jnp.asarray(x)))
    tp = convert.lm_params_from_jax(jp, device="cpu")
    atol = H_RTOL * np.abs(want).max()
    for model in (tm, LMModel(tm.cfg, attention=t_attn.flash_chunked_ref)):
        got = model.hidden_states(tp, torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=H_RTOL, atol=atol)


def test_hidden_states_match_jax_bf16(musicgen):
    jcfg, _, jp, tm = musicgen
    jm = JModel(dataclasses.replace(jcfg, compute_dtype="bfloat16"))
    cfg = dataclasses.replace(tm.cfg, compute_dtype="bfloat16")
    x = np.random.default_rng(5).normal(size=(3, 24, jcfg.d_model)) \
        .astype(np.float32)
    args = (jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    exact = jax.jit(jm.hidden_states).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(exact(*args).astype(jnp.float32))
    tp = convert.lm_params_from_jax(jp, device="cpu")
    for model in (LMModel(cfg), LMModel(cfg, attention=t_attn.flash_chunked_ref)):
        got = model.hidden_states(tp, torch.from_numpy(x))
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        got = got.float().numpy()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_REL, rel
        assert (got != want).mean() <= BF16_DIFF_SHARE, (got != want).mean()


def test_primitives_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(5)[None, :]
    pairs = [
        (j_common.rms_norm(jnp.asarray(x), jnp.asarray(w), plus_one=True),
         t_common.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                           plus_one=True)),
        (j_common.swiglu(jnp.asarray(x), jnp.asarray(x[::-1].copy())),
         t_common.swiglu(torch.from_numpy(x), torch.from_numpy(x[::-1].copy()))),
        (j_common.gelu(jnp.asarray(x)), t_common.gelu(torch.from_numpy(x))),
        (j_common.softcap(jnp.asarray(x), 2.0),
         t_common.softcap(torch.from_numpy(x), 2.0)),
        (j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0),
         t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             500.0)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_unported_families_raise():
    for name in ("gemma2-2b", "olmoe-1b-7b", "mamba2-130m", "zamba2-2.7b"):
        cfg = smoke_variant(get_arch(name))
        with pytest.raises(NotImplementedError, match=cfg.family):
            LMModel(cfg)
    with pytest.raises(NotImplementedError, match="decode"):
        t_attn.gqa_apply({}, torch.zeros(1, 2, 4), None, cache={})


def test_one_shot_prototypes_match_jax():
    labels = np.random.default_rng(4).integers(0, 6, 300)
    key = threefry.prng_key(1)
    classes = torch.unique(torch.from_numpy(labels))
    lj = jnp.asarray(labels)
    for t in range(5):
        got = quality.one_shot_prototypes(torch.from_numpy(labels), classes,
                                          threefry.fold_in(key, t))
        r = jax.random.fold_in(jax.random.PRNGKey(1), t)
        want = []
        for ci in range(6):
            members = jnp.nonzero(lj == ci, size=300, fill_value=0)[0]
            count = jnp.sum(lj == ci)
            want.append(int(members[jax.random.randint(
                jax.random.fold_in(r, ci), (), 0, jnp.maximum(count, 1))]))
        assert got.tolist() == want


@pytest.mark.parametrize("one_shot", [True, False])
def test_one_nn_accuracy_matches_jax(one_shot):
    rng = np.random.default_rng(9)
    labels = rng.integers(0, 5, 240)
    Z = (rng.normal(size=(5, 6))[labels] * 0.8
         + rng.normal(size=(240, 6))).astype(np.float32)
    want = float(j_quality.one_nn_accuracy(
        jnp.asarray(Z), jnp.asarray(labels), jax.random.PRNGKey(1),
        n_trials=5, one_shot=one_shot))
    got = quality.one_nn_accuracy(torch.from_numpy(Z),
                                  torch.from_numpy(labels),
                                  threefry.prng_key(1), n_trials=5,
                                  one_shot=one_shot)
    assert got.dtype == torch.float32
    assert float(got) == want
    assert 0.3 < want < 1.0          # neither trivial nor degenerate


def test_lm_params_from_jax_layout(musicgen):
    _, _, jp, _ = musicgen
    tp = convert.lm_params_from_jax(jp, device="cpu")
    L = jp["blocks"]["ln_attn"].shape[0]
    assert len(tp["blocks"]) == L and set(tp) == set(jp)
    np.testing.assert_array_equal(tp["blocks"][L - 1]["attn"]["wo"].numpy(),
                                  jp["blocks"]["attn"]["wo"][L - 1])


def test_embed_latents_smoke_pipeline(capsys):
    """The example at its smoke size on the CPU: three accuracies (the JAX
    example gives 1.000 on all three), the 8-D embedding well separated,
    and no kernel launched."""
    kernels.reset_launches()
    acc = embed_latents.main(["--device", "cpu", "--smoke"])
    assert set(acc) == {"backbone latents", "pca16", "funcsne8"}
    assert all(0.0 <= a <= 1.0 for a in acc.values())
    assert acc["funcsne8"] >= 0.95
    assert sum(kernels.LAUNCHES.values()) == 0
    assert capsys.readouterr().out.count("one-shot 1-NN accuracy") == 3
