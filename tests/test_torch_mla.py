"""MLA (DeepSeek-V2's latent-compressed attention) and B8 with a value
width of its own (Dv != D) against the JAX package on the CPU.

  * ``init_mla`` against JAX's from one key: ``normal``'s 4 ulps;
  * ``mla_apply`` in float32, prefill (the non-absorbed form, through the
    plain ``flash_chunked``) and decode (the absorbed form over a latent
    cache filled with seeded values, written in place at ``cur_len - 1``),
    within ``RTOL`` of the largest entry;
  * ``flash_chunked_ref`` and ``flash_attention_ref`` (B8's plain
    versions) with Dv != D against JAX's ``flash_chunked``;
  * DeepSeek-V2's smoke variant: ``init_params``, ``hidden_states`` and 24
    teacher-forced ``serve_step`` calls against JAX from float32 caches
    (logits and the latent caches), decode against the port's own prefill
    within the reference's 2e-2, and a resume from a mid-decode JAX cache;
  * B8's route and input checks for Dv != D on meta tensors with the C
    call stubbed: bf16 (192, 128) launches the tensor-core kernel, every
    other pair the SIMT kernel, and a Dv that neither takes raises before
    any launch.

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
from repro.models import attention as j_attn  # noqa: E402
from repro.models.common import NO_SHARD  # noqa: E402
from repro.models.transformer import LMModel as JModel  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import get_arch, smoke_variant  # noqa: E402
from repro_torch.core import convert, threefry  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models.transformer import LMModel  # noqa: E402

torch.set_num_threads(1)
ARCH = "deepseek-v2-236b"
B, S = 2, 24
# port against JAX in float32: |got - want| <= RTOL * max|want|.  The same
# float32 arithmetic in another order (matmul blocking, XLA's fusions);
# measured below 1.2e-6 of the largest logit and cache entry.  A wrong RoPE
# position, mask or cache slot moves logits by 1e-2 and more
RTOL = 1e-5
# threefry's normal is JAX's within 4 float32 ulps (core.threefry)
INIT_RTOL = 5e-7
DECODE_PREFILL = 2e-2      # the reference's own bound (test_models.py)
# B8's plain versions against JAX's flash_chunked, as in
# test_torch_attention.py: the same float32 arithmetic in another order
ATTN_TOL = 2e-5


def _configs(**kw):
    return (dataclasses.replace(j_smoke(j_get_arch(ARCH)), **kw),
            dataclasses.replace(smoke_variant(get_arch(ARCH)), **kw))


@pytest.fixture(scope="module")
def model():
    """(JAX model, JAX params, port model, port params from JAX's)."""
    jcfg, tcfg = _configs(capacity_factor=8.0)
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = convert.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return jm, jp, LMModel(tcfg), tp


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


def test_init_mla_matches_jax():
    jcfg, tcfg = _configs()
    want = j_attn.init_mla(jax.random.PRNGKey(5), jcfg)
    got = t_attn.init_mla(threefry.prng_key(5), tcfg, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=INIT_RTOL, atol=0, err_msg=k)


def test_init_params_match_jax(model):
    """The smoke variant's whole tree (the dense first layer with MLA, the
    MoE layers' MLA and experts) from one seed, as JAX draws it."""
    jm, jp, tm, tp = model
    got = dict(_leaves(tm.init_params(1, device="cpu")))
    want = dict(_leaves(tp))
    assert set(got) == set(want) and any(".attn.w_uk" in k for k in got)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   rtol=INIT_RTOL, atol=0, err_msg=k)


def _h(cfg, seed, s=S):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("window", [0, 9])
def test_mla_prefill_matches_jax(model, window):
    """The non-absorbed form: per-head K (nope + the shared RoPE key) and
    V from the latent, through the plain flash_chunked at D 48, Dv 32."""
    jm, jp, tm, tp = model
    cfg = tm.cfg
    h = _h(cfg, 2)
    lp = jax.tree.map(lambda a: a[0], jp["blocks"])["attn"]
    want, wc = j_attn.mla_apply(lp, jnp.asarray(h), jm.cfg, NO_SHARD,
                                window=window)
    got, gc = t_attn.mla_apply(tp["blocks"][0]["attn"], torch.from_numpy(h),
                               cfg, window=window)
    assert wc is None and gc is None
    _close(got.numpy(), want, "mla prefill")


def _latent_cache(cfg, seed, smax=S):
    rng = np.random.default_rng(seed)
    return {"latent": rng.normal(size=(B, smax, cfg.kv_lora_rank))
            .astype(np.float32),
            "k_rope": rng.normal(size=(B, smax, cfg.q_rope_dim))
            .astype(np.float32)}


@pytest.mark.parametrize("cur_len", [1, 7, S])
def test_mla_decode_matches_jax(model, cur_len):
    """The absorbed form over a seeded latent cache: the new token's
    latent pair lands in slot cur_len - 1 of the given tensors (in place),
    the scores see slots 0 .. cur_len - 1."""
    jm, jp, tm, tp = model
    cfg = tm.cfg
    h = _h(cfg, 3, s=1)
    cache = _latent_cache(cfg, 4)
    lp = jp["first"]["attn"]                 # the dense first layer's
    want, wc = j_attn.mla_apply(
        lp, jnp.asarray(h), jm.cfg, NO_SHARD,
        cache={k: jnp.asarray(v) for k, v in cache.items()},
        cur_len=jnp.int32(cur_len))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    lat = tc["latent"]
    got, gc = t_attn.mla_apply(tp["first"]["attn"], torch.from_numpy(h),
                               cfg, cache=tc,
                               cur_len=torch.tensor(cur_len,
                                                    dtype=torch.int32))
    assert gc is tc and gc["latent"] is lat
    _close(got.numpy(), want, "mla decode")
    for k in cache:
        _close(gc[k].numpy(), wc[k], f"cache {k}")
        changed = (gc[k].numpy() != cache[k]).any(axis=(0, 2))
        assert changed.tolist() == [i == cur_len - 1 for i in range(S)], k


@pytest.mark.parametrize("d,dv,hq,hkv,opts", [
    (48, 32, 4, 4, {}), (48, 32, 4, 2, {"window": 9}),
    (192, 128, 2, 2, {}), (24, 40, 6, 3, {"cap": 4.0, "window": 13})])
def test_plain_versions_with_dv_match_jax(d, dv, hq, hkv, opts):
    """B8's plain versions take Dv != D: ``flash_chunked_ref`` in the
    model's (B, S, H, D) layout and ``flash_attention_ref`` in B8's (B, H,
    S, D), both against JAX's ``flash_chunked``."""
    rng = np.random.default_rng(d + dv)
    s = 40
    q = (rng.normal(size=(B, s, hq, d)) * 0.4).astype(np.float32)
    k = (rng.normal(size=(B, s, hkv, d)) * 0.4).astype(np.float32)
    v = rng.normal(size=(B, s, hkv, dv)).astype(np.float32)
    kw = dict(chunk_k=8, scale=d ** -0.5, cap=opts.get("cap", 0.0),
              window=opts.get("window", 0))
    want = np.asarray(j_attn.flash_chunked(*map(jnp.asarray, (q, k, v)),
                                           **kw))
    assert want.shape == (B, s, hq, dv)
    got = t_attn.flash_chunked_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got2 = flash_attention_ref(tq, tk, tv, scale=kw["scale"],
                               softcap=kw["cap"], window=kw["window"])
    np.testing.assert_allclose(got2.transpose(1, 2).numpy(), want,
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    # the CPU route of the model's call and of B8's entry point
    np.testing.assert_allclose(
        t_attn.flash_chunked(tq.transpose(1, 2), tk.transpose(1, 2),
                             tv.transpose(1, 2), **kw).numpy(), want,
        rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(
        ops.flash_attention(tq, tk, tv, scale=kw["scale"], softcap=kw["cap"],
                            window=kw["window"]).transpose(1, 2).numpy(),
        want, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_hidden_states_match_jax(model):
    jm, jp, tm, tp = model
    x = np.random.default_rng(3).integers(0, tm.cfg.vocab_size,
                                          (B, S)).astype(np.int32)
    want = jm.hidden_states(jp, jnp.asarray(x))
    got = tm.hidden_states(tp, torch.from_numpy(x))
    _close(got.numpy(), want, "hidden states")


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


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


def test_serve_step_matches_jax(model):
    """24 teacher-forced steps from float32 caches: every step's logits and
    the final latent caches (the dense first layer's and each MoE
    layer's)."""
    jm, jp, tm, tp = model
    x = _tokens(tm.cfg, 5)
    want, jc = _jax_decode(jm, jp, x, S,
                           jm.init_cache(B, S, dtype=jnp.float32))
    cache = tm.init_cache(B, S, dtype=torch.float32, device="cpu")
    got, tc = _port_decode(tm, tp, x, S, cache)
    assert tc is cache
    for t in range(S):
        _close(got[:, t], want[:, t], f"logits of step {t}")
    for k in ("latent", "k_rope"):
        _close(tc["first"][k].numpy(), jc["first"][k], f"first {k}")
        for i, layer in enumerate(tc["blocks"]):
            assert tuple(layer[k].shape) == jc["blocks"][k].shape[1:]
            _close(layer[k].numpy(), jc["blocks"][k][i], f"layer {i} {k}")


def test_decode_matches_prefill(model):
    """The reference's check on the port: teacher-forced decode (absorbed,
    bf16 latent cache) reproduces the prefill's logits (non-absorbed)."""
    _, _, tm, _ = model
    tp = tm.init_params(1, device="cpu")
    x = _tokens(tm.cfg, 6)
    full = tm._logits_fn(tp)(tm.hidden_states(tp, torch.from_numpy(x)))
    full = full.float().numpy()
    dec, _ = _port_decode(tm, tp, x, S, tm.init_cache(B, S, device="cpu"))
    err = float(np.abs(dec - full).max()) / (float(np.abs(full).max()) + 1e-9)
    assert err < DECODE_PREFILL, err


def test_resume_from_jax_cache(model):
    """JAX decodes 12 steps; the port takes its latent caches through
    ``convert.lm_cache_from_jax`` and decodes the next 12 as JAX does."""
    jm, jp, tm, tp = model
    x = _tokens(tm.cfg, 7)
    _, jc = _jax_decode(jm, jp, x, 12, jm.init_cache(B, S, dtype=jnp.float32))
    tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc),
                                   device="cpu")
    assert set(tc) == {"blocks", "first"} and set(tc["first"]) == {
        "latent", "k_rope"}
    want, _ = _jax_decode(jm, jp, x, 12, jc, start=12)
    got, _ = _port_decode(tm, tp, x, 12, tc, start=12)
    for t in range(12):
        _close(got[:, t], want[:, t], f"logits of step {12 + t}")


def test_init_cache_layout(model):
    """One latent pair a layer and one for the dense first layer, as the
    JAX cache's (per layer)."""
    jm, _, tm, _ = model
    cache = tm.init_cache(B, 8, device="cpu")
    jc = jax.eval_shape(lambda: jm.init_cache(B, 8))
    assert len(cache["blocks"]) == jc["blocks"]["latent"].shape[0]
    for k in ("latent", "k_rope"):
        assert tuple(cache["first"][k].shape) == jc["first"][k].shape
        assert cache["first"][k].dtype == torch.bfloat16
        for layer in cache["blocks"]:
            assert tuple(layer[k].shape) == jc["blocks"][k].shape[1:]


@pytest.fixture
def launched(monkeypatch):
    """Stub B8's C call on meta tensors: record the entry each launch
    would call, with the device check answering 'cuda'."""
    entries = []
    monkeypatch.setattr(_build, "kernel_device", lambda *t: "cuda")
    monkeypatch.setattr(ops, "_run", lambda entry, *a: entries.append(entry))
    kernels.reset_launches()
    return entries


@pytest.mark.parametrize("dtype,d,dv,route", [
    (torch.bfloat16, 192, 128, "wgmma"), (torch.bfloat16, 192, 192, "simt"),
    (torch.bfloat16, 128, 64, "simt"), (torch.bfloat16, 80, 80, "wgmma"),
    (torch.float32, 192, 128, "simt"), (torch.float32, 64, 128, "simt"),
    (torch.float32, 128, 128, "tf32")])
def test_route_by_d_and_dv(launched, dtype, d, dv, route):
    """A CUDA tensor takes the kernel its dtype, D and Dv name, through
    ``flash_attention`` (B8's layout) and the model's ``flash_chunked``
    (strides over (B, S, H, D)); the output is Dv wide."""
    assert ops.kernel_route(dtype, d, dv) == route
    q = torch.empty((2, 4, 24, d), dtype=dtype, device="meta")
    k = torch.empty((2, 2, 24, d), dtype=dtype, device="meta")
    v = torch.empty((2, 2, 24, dv), dtype=dtype, device="meta")
    out = ops.flash_attention(q, k, v)
    assert out.shape == (2, 4, 24, dv) and out.dtype == dtype
    out2 = t_attn.flash_chunked(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), scale=d ** -0.5)
    assert out2.shape == (2, 24, 4, dv)
    assert launched == [f"repro_flash_attention_{route}"] * 2
    assert kernels.LAUNCHES[f"flash_attention_{route}"] == 2


@pytest.mark.parametrize("bad", ["dv_small", "dv_large", "dv_step",
                                 "out_width", "wgmma_pair", "tf32_pair"])
def test_dv_input_checks(launched, bad):
    """What no kernel takes raises ``ValueError`` before any launch: Dv
    outside 8..256 or off the steps of 8 (the SIMT kernel), an out that is
    not Dv wide, a pair the tensor-core kernel lacks, D != Dv on the
    3xTF32 kernel."""
    dt, d, dv, fn = torch.bfloat16, 192, 128, ops.launch
    if bad == "dv_small":
        dv = 4
    if bad == "dv_large":
        dv = 264
    if bad == "dv_step":
        dv = 36
    if bad == "wgmma_pair":
        dv, fn = 64, ops.launch_wgmma
    if bad == "tf32_pair":
        dt, d, dv, fn = torch.float32, 128, 64, ops.launch_tf32
    q = torch.empty((1, 4, 16, d), dtype=dt, device="meta")
    k = torch.empty((1, 2, 16, d), dtype=dt, device="meta")
    v = torch.empty((1, 2, 16, dv), dtype=dt, device="meta")
    out = torch.empty((1, 4, 16, dv + (8 if bad == "out_width" else 0)),
                      dtype=dt, device="meta")
    with pytest.raises(ValueError):
        fn(q, k, v, out, scale=1.0)
    assert launched == [] and sum(kernels.LAUNCHES.values()) == 0
