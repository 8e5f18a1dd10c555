"""The port's ``optim`` and ``data.tokens`` against the JAX package's on
the CPU, on one tree of float32 leaves (a matrix, a vector, a 0-d scalar,
a last dim of 300 whose int8 block is 150) and numpy-made gradients:

  * ``adamw`` over several steps, float32 moments and int8 (QTensor)
    moments: parameters and float32 moments within ULPS of the larger of
    their magnitude and the step's size lr (the same float32 operations;
    XLA may contract products and sums into fused multiply-adds, and each
    package rounds the bias corrections' ``pow`` its own way: every check
    here also passes at 1 ulp on this tree); int8 payloads exact, scales
    within 1 ulp;
  * ``sgdm`` with and without nesterov, ``clip_by_global_norm`` and the
    three schedules, within ULPS;
  * ``quantize`` / ``dequantize`` at 0-d and at a last dim of 300;
  * ``compression``: top-k with error feedback exact, and the int8
    stochastic rounding with its noise from ``threefry.uniform``, exact;
  * ``TokenStream`` batches exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.data.tokens import TokenStream as JStream  # noqa: E402
from repro.data.tokens import TokenStreamConfig as JStreamConfig  # noqa: E402
from repro.optim import compression as j_comp  # noqa: E402
from repro.optim import optimizers as j_opt  # noqa: E402
from repro.optim import quantized as j_quant  # noqa: E402
from repro.optim import schedules as j_sched  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.data.tokens import TokenStream, TokenStreamConfig  # noqa: E402
from repro_torch.optim import compression, optimizers, quantized, schedules  # noqa: E402,E501

torch.set_num_threads(1)
ULPS = 4
LR = 1e-2
SHAPES = {"w": (24, 40), "b": (40,), "s": (), "wide": (6, 300)}
N_STEPS = 4


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            SHAPES.items()}


def _grads(step):
    return _tree(100 + step)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, scale=0.0, ulps=ULPS):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), scale)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= ulps * np.spacing(mag)).all(), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_adamw_steps_match_jax(moment_dtype):
    sched = dict(peak_lr=LR, warmup_steps=2, total_steps=10)
    j = j_opt.adamw(j_sched.warmup_cosine(**sched), moment_dtype=moment_dtype)
    t = optimizers.adamw(schedules.warmup_cosine(**sched),
                         moment_dtype=moment_dtype)
    jp = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    js = j.init(jp)
    tp = _t(_tree(0))
    ts = t.init(tp)
    for step in range(N_STEPS):
        g = _grads(step)
        jp, js = j.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = t.update(_t(g), ts, tp)
        assert int(ts.count) == int(js.count) == step + 1
        for k in SHAPES:
            _close(tp[k], jp[k], LR)
            for tm, jm in ((ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
                if moment_dtype == "float32":
                    _close(tm, jm)
                    continue
                assert isinstance(tm, quantized.QTensor)
                assert tm.shape == tuple(jm.shape)
                assert tm.block == jm.block
                np.testing.assert_array_equal(
                    tm.q.numpy().reshape(np.shape(jm.q)), np.asarray(jm.q))
                _close(tm.scale, jm.scale, ulps=1)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgdm_matches_jax(nesterov):
    j = j_opt.sgdm(LR, momentum=0.9, nesterov=nesterov)
    t = optimizers.sgdm(LR, momentum=0.9, nesterov=nesterov)
    jp = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    js = j.init(jp)
    tp = _t(_tree(0))
    ts = t.init(tp)
    for step in range(N_STEPS):
        g = _grads(step)
        jp, js = j.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = t.update(_t(g), ts, tp)
        for k in SHAPES:
            _close(tp[k], jp[k], LR)
            _close(ts.mom[k], js.mom[k])


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """The global norm (a sum over the leaves in another order) and the
    clipped gradients; a norm below max_norm leaves them as they are."""
    g = _grads(0)
    jg, jn = j_opt.clip_by_global_norm({k: jnp.asarray(v) for k, v in
                                        g.items()}, max_norm)
    tg, tn = optimizers.clip_by_global_norm(_t(g), max_norm)
    _close(tn, jn)
    for k in SHAPES:
        _close(tg[k], jg[k])
    if max_norm > float(tn):
        for k in SHAPES:
            np.testing.assert_array_equal(tg[k].numpy(), g[k])


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("warmup_cosine", (1e-3, 5, 20)),
    ("warmup_cosine", (1e-3, 0, 4)), ("linear_decay", (1e-3, 10))])
def test_schedules_match_jax(name, args):
    j, t = getattr(j_sched, name)(*args), getattr(schedules, name)(*args)
    for count in (0, 1, 3, 5, 9, 20, 30):
        got = t(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        _close(got, j(jnp.asarray(count, jnp.int32)))


@pytest.mark.parametrize("shape", [(), (7,), (3, 300), (2, 512), (5, 1)])
def test_quantize_layout_and_values_match_jax(shape):
    """The block is the largest divisor of the last dim <= 256 (150 at
    300); the payload keeps the source's shape (JAX's 0-d payload is
    (1,), the port's (); one element either way) and equals JAX's."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jq = j_quant.quantize(jnp.asarray(x))
    tq = quantized.quantize(torch.from_numpy(np.array(x)))
    assert tq.shape == tuple(jq.shape) == shape
    assert tq.block == jq.block
    if shape == (3, 300):
        assert tq.block == 150
    np.testing.assert_array_equal(tq.q.numpy().reshape(np.shape(jq.q)),
                                  np.asarray(jq.q))
    _close(tq.scale, jq.scale, ulps=1)
    _close(quantized.dequantize(tq), j_quant.dequantize(jq))


def test_quantize_zeros_and_checkpoint_layout():
    """An all-zero block takes scale 1 (as JAX); QTensor is a NamedTuple
    (q, scale), so the port's checkpointer flattens it as .q and .scale."""
    tq = quantized.quantize(torch.zeros(4, 8))
    assert torch.equal(tq.scale, torch.ones(4, 1))
    assert tq._fields == ("q", "scale")
    assert torch.equal(quantized.dequantize(tq), torch.zeros(4, 8))


def test_topk_and_error_feedback_match_jax():
    g = _grads(0)
    jef = j_comp.init_ef({k: jnp.asarray(v) for k, v in g.items()})
    tef = compression.init_ef(_t(g))
    for step in range(3):
        g = _grads(step)
        js, jef, jd = j_comp.compress_with_error_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jef, 0.1)
        ts, tef, td = compression.compress_with_error_feedback(_t(g), tef,
                                                              0.1)
        for k in SHAPES:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(tef.residual[k].numpy(),
                                          np.asarray(jef.residual[k]))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    x = _grads(5)["w"]
    sp, mask = compression.topk_sparsify(torch.from_numpy(x), 0.25)
    jsp, jmask = j_comp.topk_sparsify(jnp.asarray(x), 0.25)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("seed", [0, 3])
def test_int8_stochastic_rounding_matches_jax(seed):
    """The noise is threefry's uniform draws, JAX's bits: the payload and
    the scale are exact."""
    g = _grads(seed)["wide"] * 1e-3
    jq, js = j_comp.quantize_int8_stochastic(jnp.asarray(g),
                                             jax.random.PRNGKey(seed))
    tq, ts = compression.quantize_int8_stochastic(torch.from_numpy(g),
                                                  threefry.prng_key(seed))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        compression.dequantize_int8(tq, ts).numpy(),
        np.asarray(j_comp.dequantize_int8(jq, js)))


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_token_stream_matches_jax(n_hosts):
    kw = dict(vocab_size=300, seq_len=17, global_batch=4, seed=5)
    for host in range(n_hosts):
        j = JStream(JStreamConfig(**kw), host_id=host, n_hosts=n_hosts)
        t = TokenStream(TokenStreamConfig(**kw), host_id=host,
                        n_hosts=n_hosts)
        for step in (0, 1, 7):
            np.testing.assert_array_equal(t.batch(step), j.batch(step))
            for a, b in zip(t.train_pair(step), j.train_pair(step)):
                np.testing.assert_array_equal(a, b)
