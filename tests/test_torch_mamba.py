"""Mamba2 (SSD) and Zamba2 (Mamba2 with one shared attention block)
against the JAX package on the CPU.

  * ``init_mamba2`` against JAX's from one key: the normal draws within
    ``normal``'s 4 ulps; ``A_log`` and ``dt_bias`` (uniform draws through
    float32 ``log``, ``exp`` and ``expm1``, where XLA's transcendentals and
    torch's may differ by an ulp) within ``LOG_RTOL``;
  * ``_causal_conv_hp``, ``_gated_norm``, ``_ssd_chunk_scan`` at chunks
    16 / 32 / 96 against the port's and JAX's ``ssd_reference`` (the
    reference's own test and tolerance) and against JAX's chunk scan;
  * ``mamba2_apply`` in float32, prefill (chunk scan and ``use_reference``)
    and decode (the conv and SSM states written in place);
  * the smoke variants of Mamba2-130m and Zamba2-2.7b: ``init_params``,
    ``hidden_states`` and 24 teacher-forced ``serve_step`` calls against
    JAX from float32 caches (logits and every state), decode against the
    port's own prefill within the reference's 2e-2, a resume from a
    mid-decode JAX cache, and Zamba2's (L, e) stacks as nested lists.

Inputs come from numpy seeds; parameters and caches cross from JAX through
``repro_torch.core.convert``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_arch as j_get_arch  # noqa: E402
from repro.configs.base import smoke_variant as j_smoke  # noqa: E402
from repro.models import mamba2 as j_mamba  # noqa: E402
from repro.models.common import NO_SHARD  # noqa: E402
from repro.models.transformer import LMModel as JModel  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_variant  # noqa: E402
from repro_torch.core import convert, threefry  # noqa: E402
from repro_torch.models import mamba2 as t_mamba  # noqa: E402
from repro_torch.models.transformer import LMModel  # noqa: E402

torch.set_num_threads(1)
ARCHS = ("mamba2-130m", "zamba2-2.7b")
B, S = 2, 24
# port against JAX in float32: |got - want| <= RTOL * max|want|.  The same
# float32 arithmetic in another order (matmul blocking, cumsum, XLA's
# fusions); measured below 1.2e-6 of the largest logit and state entry
RTOL = 1e-5
# threefry's normal is JAX's within 4 float32 ulps (core.threefry)
INIT_RTOL = 5e-7
# A_log = log(u), dt_bias = dt + log(-expm1(-dt)) with dt = exp(u'): three
# float32 transcendentals, each within an ulp or two of XLA's
LOG_RTOL = 1e-6
DECODE_PREFILL = 2e-2      # the reference's own bound (test_models.py)
SSD_TOL = 1e-4             # the reference's own (test_ssd_chunked_...)


def _configs(arch, **kw):
    return (dataclasses.replace(j_smoke(j_get_arch(arch)), **kw),
            dataclasses.replace(smoke_variant(get_arch(arch)), **kw))


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX model, JAX params, port model, port params)."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _configs(arch)
        jm = JModel(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(1))
        tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                        device="cpu")
        out[arch] = (jm, jp, LMModel(tcfg), tp)
    return out


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _leaves(tree, name=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{name}.{k}")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{name}[{i}]")
    else:
        yield name, tree


def test_init_mamba2_matches_jax():
    jcfg, tcfg = _configs("mamba2-130m")
    want = j_mamba.init_mamba2(jax.random.PRNGKey(5), jcfg)
    got = t_mamba.init_mamba2(threefry.prng_key(5), tcfg, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype)[6:] == str(want[k].dtype), k
        rtol = LOG_RTOL if k in ("A_log", "dt_bias") else INIT_RTOL
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=0, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_jax(models, arch):
    """The whole tree from one seed, as JAX draws it (Zamba2's shared block
    from ``ks[2]``, its Mamba2 blocks from ``split(layer key, e)``)."""
    jm, jp, tm, tp = models[arch]
    got = dict(_leaves(tm.init_params(1, device="cpu")))
    want = dict(_leaves(tp))
    assert set(got) == set(want)
    if arch.startswith("zamba"):
        assert ".shared.attn.wq" in got and ".blocks[0].mamba[1].ln" in got
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        rtol = LOG_RTOL if k.endswith(("A_log", "dt_bias")) else INIT_RTOL
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=rtol,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 9, 3, 5)).astype(np.float32)
    w = rng.normal(size=(4, 3, 5)).astype(np.float32)
    st = rng.normal(size=(B, 3, 3, 5)).astype(np.float32) if with_state \
        else None
    want = j_mamba._causal_conv_hp(jnp.asarray(x), jnp.asarray(w),
                                   None if st is None else jnp.asarray(st))
    got = t_mamba._causal_conv_hp(torch.from_numpy(x), torch.from_numpy(w),
                                  None if st is None else torch.from_numpy(st))
    for g, wt, name in zip(got, want, ("y", "state")):
        _close(g.numpy(), wt, name)


def test_gated_norm_matches_jax():
    rng = np.random.default_rng(2)
    y = rng.normal(size=(B, 6, 4, 8)).astype(np.float32)
    z = rng.normal(size=(B, 6, 4, 8)).astype(np.float32)
    sc = rng.normal(size=(4, 8)).astype(np.float32)
    want = j_mamba._gated_norm(*map(jnp.asarray, (y, z, sc)))
    got = t_mamba._gated_norm(*map(torch.from_numpy, (y, z, sc)))
    _close(got.numpy(), want, "gated norm")


def _ssd_inputs(seed=0, s=96):
    """The reference test's shapes and scales (B 2, S 96, H 4, P 8, N 16)."""
    rng = np.random.default_rng(seed)
    Bb, H, P, N = 2, 4, 8, 16
    xh = rng.normal(size=(Bb, s, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bb, s, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(Bb, s, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(Bb, s, N)) * 0.5).astype(np.float32)
    Dsk = rng.normal(size=(H,)).astype(np.float32)
    return xh, dt, A, Bm, Cm, Dsk


@pytest.mark.parametrize("chunk", [16, 32, 96])
def test_ssd_chunk_scan_matches_references(chunk):
    """The chunked SSD equals the O(S) recurrence, the port's and JAX's
    (the reference's tolerance), and JAX's own chunk scan (RTOL)."""
    args = _ssd_inputs()
    t_args = [torch.from_numpy(a) for a in args]
    j_args = [jnp.asarray(a) for a in args]
    got = t_mamba._ssd_chunk_scan(*t_args, chunk=chunk).numpy()
    ref_t = t_mamba.ssd_reference(*t_args).numpy()
    ref_j = np.asarray(j_mamba.ssd_reference(*j_args))
    np.testing.assert_allclose(got, ref_t, rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(got, ref_j, rtol=SSD_TOL, atol=SSD_TOL)
    _close(ref_t, ref_j, "ssd_reference")
    _close(got, j_mamba._ssd_chunk_scan(*j_args, chunk=chunk), "chunk scan")


def test_ssd_chunk_scan_needs_whole_chunks():
    t_args = [torch.from_numpy(a) for a in _ssd_inputs(s=40)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_mamba._ssd_chunk_scan(*t_args, chunk=16)


def _mixer(models, arch="mamba2-130m", layer=0):
    jm, jp, tm, tp = models[arch]
    jl = jax.tree.map(lambda a: a[layer], jp["blocks"])["mixer"]
    return jm.cfg, jl, tm.cfg, tp["blocks"][layer]["mixer"]


@pytest.mark.parametrize("use_reference", [False, True])
def test_mamba2_prefill_matches_jax(models, use_reference):
    jcfg, jl, tcfg, tl = _mixer(models)
    h = np.random.default_rng(3).normal(
        size=(B, 64, tcfg.d_model)).astype(np.float32)
    want, wc = j_mamba.mamba2_apply(jl, jnp.asarray(h), jcfg, NO_SHARD,
                                    use_reference=use_reference)
    got, gc = t_mamba.mamba2_apply(tl, torch.from_numpy(h), tcfg,
                                   use_reference=use_reference)
    assert wc is None and gc is None
    _close(got.numpy(), want, "mamba2 prefill")


def test_mamba2_decode_matches_jax(models):
    """One decode token from seeded conv and SSM states: the output and
    both states, written into the given tensors in place."""
    jcfg, jl, tcfg, tl = _mixer(models, layer=1)
    rng = np.random.default_rng(4)
    h = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    H, P = tcfg.ssm_nheads, tcfg.ssm_headdim
    cache = {"conv": rng.normal(size=(B, tcfg.ssm_conv - 1, H, P))
             .astype(np.float32),
             "ssm": rng.normal(size=(B, H, tcfg.ssm_state, P))
             .astype(np.float32)}
    want, wc = j_mamba.mamba2_apply(
        jl, jnp.asarray(h), jcfg, NO_SHARD,
        cache={k: jnp.asarray(v) for k, v in cache.items()})
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ssm = tc["ssm"]
    got, gc = t_mamba.mamba2_apply(tl, torch.from_numpy(h), tcfg, cache=tc)
    assert gc is tc and gc["ssm"] is ssm
    _close(got.numpy(), want, "mamba2 decode")
    for k in cache:
        _close(gc[k].numpy(), wc[k], f"state {k}")


def _inputs(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_states_match_jax(models, arch):
    jm, jp, tm, tp = models[arch]
    x = _inputs(tm.cfg, 3)
    _close(tm.hidden_states(tp, torch.from_numpy(x)).numpy(),
           jm.hidden_states(jp, jnp.asarray(x)), "hidden states")


def _jax_decode(jm, jp, x, n, cache, start=0):
    step = jax.jit(jm.serve_step)
    out = []
    for t in range(start, start + n):
        lg, cache = step(jp, cache, jnp.asarray(x[:, t:t + 1]),
                         jnp.int32(t + 1))
        out.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(out, 1), cache


def _port_decode(tm, tp, x, n, cache, start=0):
    out = []
    for t in range(start, start + n):
        lg, cache = tm.serve_step(tp, cache, torch.from_numpy(x[:, t:t + 1]),
                                  torch.tensor(t + 1, dtype=torch.int32))
        out.append(lg[:, 0].float())
    return torch.stack(out, 1).numpy(), cache


def _cache_pairs(jcache, tcache):
    """(name, port tensor, JAX slice) over every cache tensor: JAX's
    ``blocks`` leaves stacked over the layers, Zamba2's ``mamba`` ones
    over (layer, block), where the port holds a list."""
    jb = jax.tree.map(np.asarray, jcache["blocks"])

    def walk(t, j, idx, name):
        if isinstance(t, dict):
            for k in t:
                yield from walk(t[k], j[k], idx, f"{name}.{k}")
        elif isinstance(t, list):
            for e, te in enumerate(t):
                yield from walk(te, j, idx + (e,), f"{name}[{e}]")
        else:
            yield name, t, j[idx]
    for i, layer in enumerate(tcache["blocks"]):
        yield from walk(layer, jb, (i,), f"layer {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_jax(models, arch):
    """24 teacher-forced steps from float32 caches: every step's logits and
    every final state (conv, SSM; Zamba2's shared block's K / V)."""
    jm, jp, tm, tp = models[arch]
    x = _inputs(tm.cfg, 5)
    want, jc = _jax_decode(jm, jp, x, S,
                           jm.init_cache(B, S, dtype=jnp.float32))
    cache = tm.init_cache(B, S, dtype=torch.float32, device="cpu")
    got, tc = _port_decode(tm, tp, x, S, cache)
    assert tc is cache
    for t in range(S):
        _close(got[:, t], want[:, t], f"logits of step {t}")
    pairs = list(_cache_pairs(jc, tc))
    n_layer = (tm.cfg.shared_attn_every * 2 + 2 if arch.startswith("zamba")
               else 2)
    assert len(pairs) == tm.n_stack * n_layer
    for name, g, w in pairs:
        assert tuple(g.shape) == w.shape, name
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(models, arch):
    """The reference's check on the port (bf16 conv cache, float32 SSM
    state; the smoke variants compute in float32)."""
    _, _, tm, _ = models[arch]
    tp = tm.init_params(1, device="cpu")
    x = _inputs(tm.cfg, 6)
    full = tm._logits_fn(tp)(tm.hidden_states(tp, torch.from_numpy(x)))
    full = full.float().numpy()
    cache = tm.init_cache(B, S, device="cpu")
    assert cache["blocks"][0]["mamba"][0]["ssm"].dtype == torch.float32 \
        if arch.startswith("zamba") else \
        cache["blocks"][0]["ssm"].dtype == torch.float32
    dec, _ = _port_decode(tm, tp, x, S, cache)
    err = float(np.abs(dec - full).max()) / (float(np.abs(full).max()) + 1e-9)
    assert err < DECODE_PREFILL, err


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_from_jax_cache(models, arch):
    """JAX decodes 12 steps; the port takes its cache through
    ``convert.lm_cache_from_jax`` (Zamba2's (L, e) stacks into nested
    lists) and decodes the next 12 as JAX does."""
    jm, jp, tm, tp = models[arch]
    x = _inputs(tm.cfg, 7)
    _, jc = _jax_decode(jm, jp, x, 12, jm.init_cache(B, S, dtype=jnp.float32))
    tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc),
                                   device="cpu")
    layer = tc["blocks"][0]
    if arch.startswith("zamba"):
        assert isinstance(layer["mamba"], list)
        assert len(layer["mamba"]) == tm.cfg.shared_attn_every
        assert set(layer["attn"]) == {"k", "v"}
    else:
        assert set(layer) == {"conv", "ssm"}
    want, _ = _jax_decode(jm, jp, x, 12, jc, start=12)
    got, _ = _port_decode(tm, tp, x, 12, tc, start=12)
    for t in range(12):
        _close(got[:, t], want[:, t], f"logits of step {12 + t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout(models, arch):
    """The port's cache holds JAX's per-layer shapes and dtypes: the conv
    state in the cache dtype, the SSM state in float32."""
    jm, _, tm, _ = models[arch]
    cache = tm.init_cache(B, 8, device="cpu")
    jc = jax.eval_shape(lambda: jm.init_cache(B, 8))
    pairs = list(_cache_pairs(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jc), cache))
    assert pairs
    for name, g, w in pairs:
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype)[6:] == str(w.dtype), name
