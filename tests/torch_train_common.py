"""Shared set-up of the LM training parity tests (``test_torch_train.py``,
``test_torch_train_moe.py``): one family's smoke variant run through the
JAX package (``jax.value_and_grad(loss_and_aux)``, ``adamw``'s update on
those gradients with float32 and int8 moments, one whole
``make_train_step``) and the same inputs and weights, carried across by
``repro_torch.core.convert``, through the port.

Tolerances, all float32 (the smoke variants compute in float32):

* ``LOSS_RTOL`` 1e-6: the loss, the NLL and the router losses (measured at
  most 1.4e-7 relative over the eight families);
* ``GRAD_RTOL`` 5e-5 of each gradient leaf's largest |entry| (measured at
  most 1.1e-5, on Zamba2's ``A_log``, whose gradient sums over the SSD
  recurrence; the rest below 3.2e-6): the same float32 quantities summed
  in another order through the backward;
* ``UPDATE_ULPS`` 4: ``opt.update`` on JAX's own gradients, each moment
  within 4 ulps of its value (measured: equal); ``PARAM_ULPS`` 8: each
  parameter within 8 ulps of the largest of its old value, its new value
  and the step's size ``lr`` (|m / sqrt(v)| is about 1 at the first step),
  measured at most 3.7 over the eight families.  The step m / c1 / (sqrt(v
  / c2) + eps) carries the rounding of each bias correction c = 1 - b^t
  (a ``pow`` and a difference in each package), and XLA fuses the update
  into one loop whose products and sums it may contract into fused
  multiply-adds that round once where torch rounds twice; where the new
  value is small, the step's own rounding shows; int8 payloads exact,
  scales within 1 ulp;
* one whole train step: the gradients differ by the ``GRAD_RTOL`` above,
  and the first AdamW step moves each parameter by about ``lr sign(g)``
  (m / sqrt(v) = g / |g| when the moments start at zero), so where a
  near-zero gradient's sign differs the parameter moves by up to 2 lr the
  other way: every entry within ``2 lr`` plus 8 ulps, and the share of
  entries that part by more than 1e-6 at most ``STEP_SHARE_MAX`` 1e-3
  (measured: 4 to 17 entries a family, a share of 1.1e-5 to 3.5e-5, the
  largest gap 3.9e-5 against 2 lr = 4e-4).
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import jax
import jax.numpy as jnp
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import smoke_variant as j_smoke
from repro.launch.steps import make_optimizer as j_make_optimizer
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models.transformer import LMModel as JModel
from repro.optim import adamw as j_adamw
from repro.optim.schedules import warmup_cosine as j_warmup_cosine
from repro_torch.configs.base import get_arch, smoke_variant
from repro_torch.core import convert
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models.transformer import LMModel
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.optim.quantized import QTensor

FAMILIES = {"dense": "qwen2-7b", "vlm": "chameleon-34b",
            "audio": "musicgen-large", "gemma2": "gemma2-2b",
            "moe_gqa": "olmoe-1b-7b", "moe_mla": "deepseek-v2-236b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b"}
B, S = 2, 16
LOSS_RTOL = 1e-6
GRAD_RTOL = 5e-5
UPDATE_ULPS = 4
PARAM_ULPS = 8
STEP_SHARE_MAX = 1e-3
# the schedule of every update here: warmup_cosine(1e-3, 5, 20), so the
# first step's lr is 2e-4
PEAK_LR, WARMUP, TOTAL = 1e-3, 5, 20
LR_1 = PEAK_LR / WARMUP


def configs(arch, **kw):
    return (dataclasses.replace(j_smoke(j_get_arch(arch)), **kw),
            dataclasses.replace(smoke_variant(get_arch(arch)), **kw))


def batch_np(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    y = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return x, y


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_case(arch):
    """What the JAX package computes on one family's smoke variant:
    params, the loss, metrics and gradients, ``adamw``'s first update on
    those gradients with float32 and int8 moments, and one whole train
    step (all as numpy; one jitted program, so one compile a family)."""
    jcfg, _ = configs(arch)
    jm = JModel(jcfg)
    jp = jax.jit(jm.init_params)(jax.random.PRNGKey(1))
    x, y = batch_np(jcfg)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    opts = {dt: j_adamw(j_warmup_cosine(PEAK_LR, WARMUP, TOTAL),
                        moment_dtype=dt) for dt in ("float32", "int8")}
    opt = j_make_optimizer(jcfg, peak_lr=PEAK_LR, warmup=WARMUP, total=TOTAL)
    train_step = j_make_train_step(jm, opt)

    def everything(p):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p_: jm.loss_and_aux(p_, xj, yj), has_aux=True)(p)
        upd = {dt: o.update(grads, o.init(p), p) for dt, o in opts.items()}
        step = train_step(p, opt.init(p), {"inputs": xj, "labels": yj})
        return loss, metrics, grads, upd, (step[0], step[2])

    loss, metrics, grads, upd, step = to_np(jax.jit(everything)(jp))
    out = {"arch": arch, "cfg": jcfg, "x": x, "y": y, "params": to_np(jp),
           "loss": float(loss), "metrics": {k: float(v) for k, v in
                                            metrics.items()},
           "grads": grads,
           "step": (step[0], {k: float(v) for k, v in step[1].items()})}
    for dt, pair in upd.items():
        out[f"update_{dt}"] = pair
    return out


def port_params(case):
    return convert.lm_params_from_jax(case["params"], device="cpu")


def port_batch(case):
    return torch.from_numpy(case["x"]), torch.from_numpy(case["y"])


def port_loss_and_grads(case):
    """The port's loss, metrics and gradients (in the parameter tree's
    leaf order) on the case's weights and batch."""
    model = LMModel(configs(case["arch"])[1])
    params = port_params(case)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = model.loss_and_aux(params, *port_batch(case))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss, metrics, grads


def np_leaves(tree_np):
    """Leaves of a JAX tree given as numpy, in the port's order (unstacked
    by ``lm_params_from_jax``)."""
    return [t.numpy() for t in tree_leaves(convert.lm_params_from_jax(
        tree_np, device="cpu"))]


def within_ulps(got, want, ulps, like=None):
    """|got - want| <= ulps * spacing(max(|want|, |like|)), elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.abs(want) if like is None else np.maximum(
        np.abs(want), np.abs(np.asarray(like, np.float32)))
    return np.abs(got - want) <= ulps * np.spacing(mag)


def port_update(case, moment_dtype):
    """The port's ``adamw`` update on JAX's own gradients, carried
    across."""
    opt = adamw(warmup_cosine(PEAK_LR, WARMUP, TOTAL),
                moment_dtype=moment_dtype)
    params = port_params(case)
    grads = convert.lm_params_from_jax(case["grads"], device="cpu")
    return opt.update(grads, opt.init(params), params)


def port_step(case):
    tcfg = configs(case["arch"])[1]
    model = LMModel(tcfg)
    opt = make_optimizer(tcfg, peak_lr=PEAK_LR, warmup=WARMUP, total=TOTAL)
    params = port_params(case)
    x, y = port_batch(case)
    return make_train_step(model, opt)(params, opt.init(params),
                                       {"inputs": x, "labels": y})


def qtensor_leaves(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, QTensor)]


class _Outputs(TorchDispatchMode):
    """Records a weak reference to the storage of every op's output."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                st = t.untyped_storage()
                self.refs.append((StorageWeakRef(st), st.data_ptr(),
                                  st.nbytes()))
        return out


def held_bytes(model, params, inputs, labels):
    """Bytes of the tensors that ``loss_and_aux``'s forward leaves alive
    for the backward: the storages of op outputs still alive once the loss
    is computed, less the parameters' own (views of the weights).

    ``torch.autograd.graph.saved_tensors_hooks`` cannot read this under
    rematerialisation: inside a checkpointed region the checkpoint's own
    hooks take the saved tensors, and a selective checkpoint keeps its
    saved products in a cache of its own, so an outer hook sees the same
    few inputs under "nothing" and "dots_no_batch"."""
    mode = _Outputs()
    with mode:
        loss, _ = model.loss_and_aux(params, inputs, labels)
    gc.collect()
    own = {t.untyped_storage().data_ptr() for t in tree_leaves(params)}
    own |= {inputs.untyped_storage().data_ptr(),
            labels.untyped_storage().data_ptr()}
    live = {}
    for ref, ptr, nb in mode.refs:
        if not ref.expired() and ptr not in own:
            live[ptr] = nb
    del loss
    return sum(live.values())


# --------------------------------------------------------------------------
# The tests, collected in each file that imports them with its own
# ``case`` fixture (one family's ``jax_case``)


def test_loss_metrics_and_grads_match_jax(case):
    """loss_and_aux and every gradient leaf against
    jax.value_and_grad(loss_and_aux) on the same weights and batch."""
    loss, metrics, grads = port_loss_and_grads(case)
    loss = loss.detach()
    assert abs(float(loss) - case["loss"]) <= LOSS_RTOL * abs(case["loss"])
    assert set(metrics) == set(case["metrics"])
    for k, v in case["metrics"].items():
        assert abs(float(metrics[k]) - v) <= LOSS_RTOL * max(abs(v), 1.0), k
    want = np_leaves(case["grads"])
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_RTOL * max(float(np.abs(w).max()), 1e-30), err


def test_adamw_update_on_jax_grads_matches_jax(case):
    """opt.update on JAX's own gradients, carried across, against JAX's
    update: parameters within PARAM_ULPS, float32 moments within
    UPDATE_ULPS, and int8 moments with their payloads exact and scales
    within 1 ulp."""
    for dt in ("float32", "int8"):
        params, state = port_update(case, dt)
        want_p, want_s = case[f"update_{dt}"]
        for g, w, w0 in zip(tree_leaves(params), np_leaves(want_p),
                            np_leaves(case["params"])):
            assert within_ulps(g.numpy(), w, PARAM_ULPS,
                               like=np.maximum(np.abs(w0), LR_1)).all(), dt
        assert int(state.count) == int(want_s.count) == 1
        if dt == "float32":
            for mom, jmom in ((state.m, want_s.m), (state.v, want_s.v)):
                for g, w in zip(tree_leaves(mom), np_leaves(jmom)):
                    assert within_ulps(g.numpy(), w, UPDATE_ULPS).all()
            continue
        for mom, jmom in ((state.m, want_s.m), (state.v, want_s.v)):
            got = qtensor_leaves(mom)
            want = qtensor_leaves(convert.adamw_state_from_jax(
                want_s, device="cpu").m if mom is state.m else
                convert.adamw_state_from_jax(want_s, device="cpu").v)
            assert len(got) == len(want) == len(tree_leaves(params))
            for g, w in zip(got, want):
                assert torch.equal(g.q, w.q)
                assert within_ulps(g.scale.numpy(), w.scale.numpy(), 1).all()


def test_train_step_matches_jax(case):
    """One whole train step (loss, gradients, clip, AdamW at lr 2e-4)
    against JAX's make_train_step: the loss and the gradient norm within
    float32 tolerance; each parameter within 2 lr plus 8 ulps of JAX's,
    and at most STEP_SHARE_MAX of the entries more than 1e-6 apart (the
    near-zero gradients whose sign differs)."""
    params, state, metrics = port_step(case)
    want_p, want_m = case["step"]
    assert abs(float(metrics["loss"]) - want_m["loss"]) <= \
        LOSS_RTOL * abs(want_m["loss"])
    assert abs(float(metrics["grad_norm"]) - want_m["grad_norm"]) <= \
        GRAD_RTOL * want_m["grad_norm"]
    n = n_far = 0
    for g, w, w0 in zip(tree_leaves(params), np_leaves(want_p),
                        np_leaves(case["params"])):
        diff = np.abs(g.detach().numpy() - w)
        assert (diff <= 2 * LR_1 + PARAM_ULPS * np.spacing(
            np.maximum(np.abs(w), np.abs(w0)))).all()
        n += diff.size
        n_far += int((diff > 1e-6).sum())
    assert n_far <= STEP_SHARE_MAX * n, (n_far, n)
    assert int(state.count) == 1
