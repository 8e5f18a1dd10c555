"""The port's LM training path against the JAX package on the CPU, the
moe families, OLMoE's GQA and DeepSeek-V2's MLA (``test_torch_train.py``
and ``test_torch_train_ssm.py`` hold the other six): ``loss_and_aux`` with
the router losses and its gradients, ``adamw``'s update on JAX's gradients
(float32 and int8 moments) and one whole train step (see
``torch_train_common`` for the tolerances and why); and remat on
DeepSeek-V2's smoke variant, whose dense first layer is not
rematerialised (as in JAX) while its MoE blocks are.
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
FAMILIES = ("moe_gqa", "moe_mla")


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    return common.jax_case(common.FAMILIES[request.param])


@pytest.mark.parametrize("policy", ["nothing", "dots_no_batch"])
def test_moe_remat_gradients_equal_no_remat(policy):
    base = smoke_variant(get_arch("deepseek-v2-236b"))
    assert base.moe_dense_first
    params = LMModel(base).init_params(1, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(0)
    x, y = (torch.randint(0, base.vocab_size, (common.B, common.S),
                          generator=g) for _ in range(2))
    grads = []
    for cfg in (base, dataclasses.replace(base, remat=True,
                                          remat_policy=policy)):
        loss, _ = LMModel(cfg).loss_and_aux(params, x, y)
        grads.append(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
