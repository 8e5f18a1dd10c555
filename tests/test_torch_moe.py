"""The port's routed experts and the Gemma2 / OLMoE forward against the JAX
package on the CPU (smoke variants, float32 unless stated).

  * ``moe_apply`` at ample capacity (64 tokens, capacity factor 8) and at
    8,192 tokens with capacity factor 0.05, where more than a tenth of the
    assignments drop (``tests/test_models.py``'s two MoE cases): the top-k
    expert ids, the stable order, each assignment's slot and ``keep``, and
    ``dropped_frac`` equal the reference's exactly; the output within
    ``OUT_RTOL`` of its largest entry and the two router losses within
    ``AUX_RTOL``;
  * the combine adds each token's contributions in ascending expert id,
    from zero, in the compute dtype: bit for bit a sequential sum;
  * the dispatch buffer equals the reference's ``buf.at[se, posc].add``;
  * in bfloat16 compute, ``moe_apply`` against the reference compiled
    without excess precision (see ``BF16_REL``);
  * ``init_params`` of both families draws JAX's weights, and
    ``hidden_states`` matches JAX's on one batch.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_arch as j_get_arch  # noqa: E402
from repro.configs.base import smoke_variant as j_smoke  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.common import NO_SHARD  # noqa: E402
from repro.models.transformer import LMModel as JModel  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_variant  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.transformer import LMModel  # noqa: E402

torch.set_num_threads(1)
# float32, port against JAX: the same products summed in another order;
# measured 4.3e-7 of the largest output entry and 1.2e-7 relative on the
# losses.  One expert chosen differently would move an output row by O(1)
OUT_RTOL = 1e-5
AUX_RTOL = 1e-5
# bfloat16 compute at OLMoE's top-8 (of 16 experts): relative Frobenius
# error of the output and the share of entries that differ at all.  Both
# round the expert GEMMs, silu and each of the k additions to bf16 at the
# same points, so entries part only where two float32 sums taken in another
# order fall on either side of a rounding boundary: measured 1.8e-4 and
# 0.039% at capacity factor 8, bit for bit at 0.05 (7/8 dropped).  Adding
# the k contributions in descending expert id measured 5.0e-3 and 61%, in
# float32 rounded once 4.0e-3 and 51%
BF16_REL = 1e-3
BF16_DIFF_SHARE = 0.01
MAX_ULPS = 4
H_RTOL = 1e-5


def _cfg(pkg, **kw):
    get, smoke = (j_get_arch, j_smoke) if pkg == "jax" else (get_arch,
                                                             smoke_variant)
    return dataclasses.replace(smoke(get("olmoe-1b-7b")), **kw)


def _jax_plan(x, router, k, C):
    """The discrete steps of the JAX ``moe_apply``, line for line."""
    logits = x.astype(jnp.float32) @ router
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(-1).astype(jnp.int32)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    E = router.shape[1]
    starts = jnp.searchsorted(se, jnp.arange(E, dtype=jnp.int32))
    pos = jnp.arange(flat_e.shape[0], dtype=jnp.int32) - starts[se]
    return {"top_e": np.asarray(top_e), "order": np.asarray(order),
            "pos": np.asarray(pos), "keep": np.asarray(pos < C)}


@pytest.fixture(scope="module")
def moe_params():
    jcfg = _cfg("jax")
    jp = j_moe.init_moe(jax.random.PRNGKey(0), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("n_tok,cf", [(64, 8.0), (8192, 0.05)])
def test_moe_apply_matches_jax(moe_params, n_tok, cf):
    jp, tp = moe_params
    jcfg, tcfg = _cfg("jax", capacity_factor=cf), _cfg("torch",
                                                       capacity_factor=cf)
    x = np.random.default_rng(1).normal(size=(n_tok, tcfg.d_model)) \
        .astype(np.float32)
    want, jaux = j_moe.moe_apply(jp, jnp.asarray(x), jcfg, NO_SHARD)
    got, taux = t_moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    C = t_moe.moe_capacity(n_tok, tcfg.n_experts, tcfg.moe_top_k, cf)
    plan = t_moe.plan(torch.from_numpy(x), tp["router"], tcfg.moe_top_k, C)
    ref = _jax_plan(jnp.asarray(x), jp["router"], jcfg.moe_top_k, C)
    for name in ("top_e", "order", "pos", "keep"):
        np.testing.assert_array_equal(plan[name].numpy(), ref[name], name)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    if cf == 8.0:
        assert float(taux["dropped_frac"]) == 0.0
        assert 0.8 < float(taux["load_balance"]) < 1.6
    else:
        assert float(taux["dropped_frac"]) > 0.1
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=OUT_RTOL * np.abs(want).max())
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=AUX_RTOL)


def test_dispatch_equals_scatter_add(moe_params):
    """The gathered (E, C, D) buffer equals the reference's
    ``zeros.at[se, posc].add(x[stok] * keep)`` at a capacity that drops."""
    _, tp = moe_params
    cfg = _cfg("torch")
    T, k, E = 8192, cfg.moe_top_k, cfg.n_experts
    C = t_moe.moe_capacity(T, E, k, 0.05)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(T, cfg.d_model)).astype(np.float32))
    r = t_moe.plan(x, tp["router"], k, C)
    got = t_moe.dispatch(x, r["order"], r["starts"], r["counts"], k, C,
                         torch.float32)
    se = r["top_e"].reshape(-1)[r["order"]]
    stok = r["order"] // k
    want = torch.zeros((E, C, cfg.d_model))
    want.index_put_((se, r["pos"].clamp(0, C - 1)),
                    x[stok] * r["keep"][:, None].float(), accumulate=True)
    assert bool(r["keep"].logical_not().any())
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_is_sequential_sum(dtype):
    """``combine`` equals, bit for bit, a loop that adds each token's kept
    contributions in ascending expert id, from zero, rounding each sum to
    the compute dtype; dropped assignments add zero."""
    rng = np.random.default_rng(3)
    T, E, C, k, D = 40, 8, 6, 3, 16
    out_e = torch.from_numpy(rng.normal(size=(E, C, D)).astype(np.float32)) \
        .to(dtype)
    top_e = torch.from_numpy(np.stack([rng.permutation(E)[:k]
                                       for _ in range(T)]))
    top_p = torch.from_numpy(rng.random((T, k)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, C + 3, (T, k)))
    got = t_moe.combine(out_e, top_e, top_p, pos, dtype)
    want = torch.zeros((T, D), dtype=dtype)
    for t in range(T):
        acc = torch.zeros((D,), dtype=dtype)
        for j in sorted(range(k), key=lambda j: int(top_e[t, j])):
            w = float(top_p[t, j]) if pos[t, j] < C else 0.0
            c = out_e[top_e[t, j], min(int(pos[t, j]), C - 1)] \
                * torch.tensor(w, dtype=torch.float32).to(dtype)
            acc = acc + c
        want[t] = acc
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


@pytest.mark.parametrize("cf", [8.0, 0.05])
def test_moe_apply_bf16_matches_jax(cf):
    kw = dict(compute_dtype="bfloat16", capacity_factor=cf, n_experts=16,
              moe_top_k=8)
    jcfg, tcfg = _cfg("jax", **kw), _cfg("torch", **kw)
    jp = j_moe.init_moe(jax.random.PRNGKey(0), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).normal(size=(2048, tcfg.d_model)) \
        .astype(np.float32)
    fn = jax.jit(lambda p, xx: j_moe.moe_apply(p, xx, jcfg, NO_SHARD))
    exact = fn.lower(jp, jnp.asarray(x)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want, jaux = exact(jp, jnp.asarray(x))
    want = np.asarray(want.astype(jnp.float32))
    got, taux = t_moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.bfloat16
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    got = got.float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL, rel
    assert (got != want).mean() <= BF16_DIFF_SHARE, (got != want).mean()


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b"])
def test_init_params_match_jax(arch):
    """Every leaf of every layer within ``threefry.normal``'s 4 float32
    ulps of JAX's draw (the norms and biases exactly)."""
    jm = JModel(j_smoke(j_get_arch(arch)))
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tp = LMModel(smoke_variant(get_arch(arch))).init_params(0, device="cpu")
    assert set(tp) == set(jp)

    def walk(t, j, name):
        if isinstance(t, dict):
            assert set(t) == set(j), name
            for k in t:
                yield from walk(t[k], j[k], f"{name}.{k}")
        else:
            yield name, t, j

    pairs = [(f"blocks{i}", blk, jax.tree.map(lambda a: a[i], jp["blocks"]))
             for i, blk in enumerate(tp["blocks"])]
    pairs += [(k, tp[k], jp[k]) for k in tp if k != "blocks"]
    n = 0
    for top, t, j in pairs:
        for name, w, want in walk(t, j, top):
            assert w.shape == want.shape and w.numpy().dtype == want.dtype, \
                name
            assert _ulps(w.numpy(), want) <= MAX_ULPS, name
            n += 1
    assert n > 10
    if arch == "olmoe-1b-7b":
        assert tp["blocks"][0]["ffn"]["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b"])
def test_hidden_states_match_jax(arch):
    """One numpy batch through both packages' ``hidden_states`` (B8's
    plain version and ``flash_chunked_ref``), within H_RTOL of the
    largest |h|.  Gemma2 at local window 8, so S = 24 runs past it."""
    kw = {"local_window": 8} if arch == "gemma2-2b" else {}
    jcfg = dataclasses.replace(j_smoke(j_get_arch(arch)), **kw)
    tcfg = dataclasses.replace(smoke_variant(get_arch(arch)), **kw)
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(2))
    x = np.random.default_rng(5).integers(0, tcfg.vocab_size, (3, 24)) \
        .astype(np.int32)
    want = np.asarray(jm.hidden_states(jp, jnp.asarray(x)))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    for model in (LMModel(tcfg),
                  LMModel(tcfg, attention=t_attn.flash_chunked_ref)):
        got = model.hidden_states(tp, torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=H_RTOL,
                                   atol=H_RTOL * np.abs(want).max())
