"""The port's LM training path against the JAX package on the CPU, the
ssm (Mamba2) and hybrid (Zamba2) families (``test_torch_train.py`` and
``test_torch_train_moe.py`` hold the other six): ``loss_and_aux`` and its
gradients through the SSD chunk scan, ``adamw``'s update on JAX's
gradients (float32 and int8 moments) and one whole train step (see
``torch_train_common`` for the tolerances and why).
"""
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import torch_train_common as common  # noqa: E402
from torch_train_common import (  # noqa: E402,F401
    test_adamw_update_on_jax_grads_matches_jax,
    test_loss_metrics_and_grads_match_jax, test_train_step_matches_jax)

torch.set_num_threads(1)
FAMILIES = ("ssm", "hybrid")


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    return common.jax_case(common.FAMILIES[request.param])
