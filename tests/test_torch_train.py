"""The port's LM training path against the JAX package on the CPU, the
dense, vlm, audio and gemma2 families (``test_torch_train_moe.py`` holds
the other four): ``loss_and_aux`` and its gradients, ``adamw``'s update on
JAX's gradients (float32 and int8 moments), one whole train step (see
``torch_train_common`` for the tolerances and why), and rematerialisation:
``remat_policy`` "nothing", "dots_no_batch" and "none" give bit-identical
gradients, and keep alive, between the forward and the backward, fewer
bytes in that order.
"""
import dataclasses

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import torch_train_common as common  # noqa: E402
from torch_train_common import (  # noqa: E402,F401
    test_adamw_update_on_jax_grads_matches_jax,
    test_loss_metrics_and_grads_match_jax, test_train_step_matches_jax)
from repro_torch.configs.base import get_arch, smoke_variant  # noqa: E402
from repro_torch.models.transformer import LMModel  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

torch.set_num_threads(1)
FAMILIES = ("dense", "vlm", "audio", "gemma2")


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    return common.jax_case(common.FAMILIES[request.param])


def _remat_model(policy, remat=True):
    cfg = dataclasses.replace(smoke_variant(get_arch("qwen2-7b")),
                              remat=remat, remat_policy=policy)
    return LMModel(cfg)


def _params_and_batch():
    model = _remat_model("none", remat=False)
    params = model.init_params(1, device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, model.cfg.vocab_size, (common.B, common.S),
                      generator=g)
    y = torch.randint(0, model.cfg.vocab_size, (common.B, common.S),
                      generator=g)
    return params, x, y


def test_remat_policies_give_bit_identical_gradients():
    params, x, y = _params_and_batch()
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    grads = {}
    for policy in ("nothing", "dots_no_batch", "none"):
        loss, _ = _remat_model(policy).loss_and_aux(params, x, y)
        grads[policy] = torch.autograd.grad(loss, leaves)
    for policy in ("nothing", "dots_no_batch"):
        assert all(torch.equal(a, b) for a, b in
                   zip(grads[policy], grads["none"])), policy


def test_remat_policies_order_the_bytes_kept_for_the_backward():
    """nothing < dots_no_batch < none, in the bytes the forward leaves
    alive for the backward (``common.held_bytes``)."""
    params, x, y = _params_and_batch()
    for t in tree_leaves(params):
        t.requires_grad_(True)
    held = {policy: common.held_bytes(_remat_model(policy), params, x, y)
            for policy in ("nothing", "dots_no_batch", "none")}
    assert held["nothing"] < held["dots_no_batch"] < held["none"], held


def test_remat_is_off_without_a_backward(monkeypatch):
    """A forward that records no backward (under no_grad, or on weights
    that need no grad, as serving and hidden_states run) enters no
    checkpoint, and its output equals the remat-free model's bit for bit;
    with weights that require grad each stacked block is checkpointed."""
    from repro_torch.models import transformer
    entered = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: entered.append(1) or real(*a, **k))
    params, x, _ = _params_and_batch()
    b = _remat_model("none", remat=False).hidden_states(params, x)
    a = _remat_model("nothing").hidden_states(params, x)
    with torch.no_grad():
        for t in tree_leaves(params):
            t.requires_grad_(True)
        c = _remat_model("nothing").hidden_states(params, x)
    assert entered == [] and torch.equal(a, b) and torch.equal(c, b)
    _remat_model("nothing").hidden_states(params, x)
    assert len(entered) == _remat_model("none").cfg.n_layers
