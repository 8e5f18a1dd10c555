"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper dispatches on its tensors' device: a CPU tensor runs the
plain PyTorch version (``ref.py``), a CUDA tensor launches the CUDA kernel
(``repro_torch/csrc``) or raises.  Nothing falls back.

``LAUNCHES`` counts kernel launches per wrapper (plain versions are not
counted), so a run can show that its path went through the kernels.
"""
from __future__ import annotations

LAUNCHES = {
    "pairwise_sqdist_gather": 0,
    "knn_merge_cand_hd": 0,
    "knn_merge_cand_ld": 0,
    "knn_merge_hd": 0,
    "knn_merge_ld": 0,
    "ne_forces_scatter": 0,
    "pairwise_sqdist": 0,
    "ne_forces": 0,
    "ne_forces_gather": 0,
    "segment_sum": 0,
    "flash_attention": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
