"""The port's LM serving path against the JAX package on the CPU: smoke
variants of Qwen2-7B (dense), MusicGen-large (embeds), Gemma2-2b (local /
global pairs, softcaps) and OLMoE-1B-7B (routed experts), in float32, with
parameters carried across by ``convert.lm_params_from_jax``.

  * ``serve_step`` over S = 24 teacher-forced steps from one float32
    ``init_cache`` on both packages: every step's logits and the final
    cache within ``RTOL`` of the largest entry (float32 sums in another
    order; the caches hold the same K / V projections);
  * decode against the port's own prefill within the reference's 2e-2
    (``tests/test_models.py::test_decode_matches_prefill``: the default
    bf16 cache);
  * Gemma2 with ``local_window=8`` in both packages, so that 24 steps run
    past the window of the local layers' decode mask;
  * a step resumed from a mid-decode JAX cache (``lm_cache_from_jax``);
  * ``cur_len`` past ``max_len``: the write clamped to the last slot as
    ``dynamic_update_slice`` clamps, the mask and RoPE position not.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_arch as j_get_arch  # noqa: E402
from repro.configs.base import smoke_variant as j_smoke  # noqa: E402
from repro.models.transformer import LMModel as JModel  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_variant  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models.transformer import LMModel  # noqa: E402

torch.set_num_threads(1)
ARCHS = ("qwen2-7b", "musicgen-large", "gemma2-2b", "olmoe-1b-7b")
B, S = 2, 24
# port against JAX, float32: |got - want| <= RTOL * max|want| for each
# step's logits and each cache tensor.  Both run the same float32
# arithmetic in another order (einsum and matmul blocking, XLA's fusions);
# measured at most 7.9e-7 of the largest logit and 5.4e-7 of the largest
# cache entry over the four configs.  A wrong RoPE position, mask or cache
# slot moves logits by 1e-2 and more
RTOL = 1e-5
DECODE_PREFILL = 2e-2      # the reference's own bound (test_models.py)


def _configs(arch, **kw):
    """(JAX cfg, port cfg): the smoke variant with Gemma2's local window
    at 8, so S = 24 runs past it."""
    extra = {"local_window": 8} if arch == "gemma2-2b" else {}
    extra.update(kw)
    return (dataclasses.replace(j_smoke(j_get_arch(arch)), **extra),
            dataclasses.replace(smoke_variant(get_arch(arch)), **extra))


def _inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _step_in(x, t):
    return x[:, t:t + 1]


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX model, JAX params (jnp), port model, port params)."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _configs(arch)
        jm = JModel(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(1))
        tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                        device="cpu")
        out[arch] = (jm, jp, LMModel(tcfg), tp)
    return out


def _jax_decode(jm, jp, x, steps_, cache, start=0):
    step = jax.jit(jm.serve_step)
    logits = []
    for t in range(start, start + steps_):
        lg, cache = step(jp, cache, jnp.asarray(_step_in(x, t)),
                         jnp.int32(t + 1))
        logits.append(np.asarray(lg[:, 0], np.float32))
    return np.stack(logits, 1), cache


def _port_decode(tm, tp, x, steps_, cache, start=0):
    logits = []
    for t in range(start, start + steps_):
        lg, cache = tm.serve_step(tp, cache, torch.from_numpy(_step_in(x, t)),
                                  torch.tensor(t + 1, dtype=torch.int32))
        logits.append(lg[:, 0].float())
    return torch.stack(logits, 1).numpy(), cache


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, (what, err, scale)


def _cache_pairs(jcache, tcache):
    """(name, port tensor, JAX layer slice) over every cache tensor."""
    jb = jax.tree.map(np.asarray, jcache["blocks"])
    for i, layer in enumerate(tcache["blocks"]):
        def walk(t, j, name):
            if isinstance(t, dict):
                for k in t:
                    yield from walk(t[k], j[k], f"{name}.{k}")
            else:
                yield name, t.float().numpy(), np.asarray(j[i], np.float32)
        yield from walk(layer, jb, f"layer{i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_jax(models, arch):
    jm, jp, tm, tp = models[arch]
    x = _inputs(tm.cfg)
    want, jcache = _jax_decode(jm, jp, x, S,
                               jm.init_cache(B, S, dtype=jnp.float32))
    cache = tm.init_cache(B, S, dtype=torch.float32, device="cpu")
    got, tcache = _port_decode(tm, tp, x, S, cache)
    assert tcache is cache            # written in place
    assert got.shape == (B, S, tm.cfg.vocab_size)
    for t in range(S):
        _close(got[:, t], want[:, t], f"logits of step {t}")
    for name, g, w in _cache_pairs(jcache, tcache):
        _close(g, w, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Teacher-forced decode reproduces the port's own prefill logits
    (B8's plain version on the CPU), the reference's check on the port."""
    _, cfg = _configs(arch, capacity_factor=8.0)      # no MoE drops
    tm = LMModel(cfg)
    tp = tm.init_params(1, device="cpu")
    x = _inputs(cfg)
    h = tm.hidden_states(tp, torch.from_numpy(x))
    full = tm._logits_fn(tp)(h).float()
    if cfg.final_softcap:
        full = cfg.final_softcap * torch.tanh(full / cfg.final_softcap)
    dec, _ = _port_decode(tm, tp, x, S, tm.init_cache(B, S, device="cpu"))
    scale = float(full.abs().max()) + 1e-9
    err = float(np.abs(dec - full.numpy()).max())
    assert err / scale < DECODE_PREFILL, (arch, err / scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_from_jax_cache(models, arch):
    """JAX decodes 12 steps; the port takes its cache and decodes the next
    12, matching JAX's own next 12 steps."""
    jm, jp, tm, tp = models[arch]
    x = _inputs(tm.cfg, seed=4)
    _, jcache = _jax_decode(jm, jp, x, 12,
                            jm.init_cache(B, S, dtype=jnp.float32))
    tcache = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                       device="cpu")
    want, _ = _jax_decode(jm, jp, x, 12, jcache, start=12)
    got, _ = _port_decode(tm, tp, x, 12, tcache, start=12)
    for t in range(12):
        _close(got[:, t], want[:, t], f"logits of step {12 + t}")


@pytest.mark.parametrize("arch", ("qwen2-7b", "gemma2-2b"))
def test_cur_len_past_max_len_clamps(models, arch):
    """With max_len 8: steps at cur_len 1..8, then cur_len 11 -- the write
    goes to slot 7 (clamped), RoPE at position 10, every slot unmasked."""
    jm, jp, tm, tp = models[arch]
    x = _inputs(tm.cfg, seed=5)
    step = jax.jit(jm.serve_step)
    jcache = jm.init_cache(B, 8, dtype=jnp.float32)
    tcache = tm.init_cache(B, 8, dtype=torch.float32, device="cpu")
    for t, cur in [(t, t + 1) for t in range(8)] + [(8, 11)]:
        want, jcache = step(jp, jcache, jnp.asarray(_step_in(x, t)),
                            jnp.int32(cur))
        got, tcache = tm.serve_step(tp, tcache,
                                    torch.from_numpy(_step_in(x, t)),
                                    torch.tensor(cur, dtype=torch.int32))
        _close(got.float().numpy(), np.asarray(want, np.float32),
               f"cur_len {cur}")
    for name, g, w in _cache_pairs(jcache, tcache):
        _close(g, w, name)


def test_gemma2_final_softcap_bounds_logits():
    """The reference's bound on the port (``test_models.py``): the final
    softcap keeps every logit within +-30, in float32."""
    cfg = smoke_variant(get_arch("gemma2-2b"))
    tm = LMModel(cfg)
    tp = tm.init_params(0, device="cpu")
    x = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 16))
    logits, _ = tm.serve_step(tp, tm.init_cache(1, 16, device="cpu"),
                              torch.from_numpy(x[:, :1]),
                              torch.tensor(1, dtype=torch.int32))
    assert logits.dtype == torch.float32
    assert float(logits.abs().max()) <= cfg.final_softcap + 1e-3


def test_gqa_apply_decode_writes_cache_in_place(models):
    """``gqa_apply`` with a cache (the branch that raised before A8.1):
    K / V land in slot ``cur_len - 1`` of the given tensors, the rest stay
    zero, and the output is one token."""
    _, _, tm, tp = models["qwen2-7b"]
    cfg = tm.cfg
    h = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, 1, cfg.d_model)).astype(np.float32))
    cache = tm.init_cache(B, 6, dtype=torch.float32, device="cpu")["blocks"][0]
    k0 = cache["k"]
    out, nc = t_attn.gqa_apply(tp["blocks"][0]["attn"], h, cfg, cache=cache,
                               cur_len=torch.tensor(4, dtype=torch.int32))
    assert out.shape == (B, 1, cfg.d_model)
    assert nc is cache and nc["k"] is k0
    written = (k0.abs().sum(dim=(0, 2, 3)) > 0).tolist()
    assert written == [False, False, False, True, False, False]


@pytest.mark.parametrize("arch", ARCHS)
def test_make_serve_step(models, arch):
    """``launch.steps.make_serve_step`` is the model's ``serve_step``; the
    cache from ``init_cache`` matches the JAX layout (per layer)."""
    jm, _, tm, tp = models[arch]
    step = steps.make_serve_step(steps.make_model(tm.cfg))
    cache = tm.init_cache(B, 4, device="cpu")
    jc = jax.eval_shape(lambda: jm.init_cache(B, 4))
    assert len(cache["blocks"]) == jax.tree.leaves(jc["blocks"])[0].shape[0]
    for _, g, w in _cache_pairs(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), jc), cache):
        assert g.shape == w.shape
    assert cache["blocks"][0][next(iter(cache["blocks"][0]))] is not None
    x = _inputs(tm.cfg)
    lg, _ = step(tp, cache, torch.from_numpy(_step_in(x, 0)),
                 torch.tensor(1, dtype=torch.int32))
    assert lg.shape == (B, 1, tm.cfg.vocab_size)
    assert bool(torch.isfinite(lg).all())
