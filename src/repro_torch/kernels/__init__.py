"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper dispatches on its tensors' device: a CPU tensor runs the
plain PyTorch version (``ref.py``), a CUDA tensor launches the CUDA kernel
(``repro_torch/csrc``) or raises; no plain version ever runs on CUDA
tensors in a kernel's place.  The families the JAX package guards (B1-B7)
run their call through ``fallback.guarded``, a pass-through until
``fallback.enabled`` (``fit`` under a ``ResiliencePolicy`` with
``sticky_fallback``): then a fault demotes the family on the CPU (a
warning and an event) and is logged and raised again on the card.

``LAUNCHES`` counts kernel launches per wrapper (plain versions are not
counted), so a run can show that its path went through the kernels.
"""
from __future__ import annotations

LAUNCHES = {
    "pairwise_sqdist_gather": 0,
    "pairwise_sqdist_gather_lanes": 0,
    "pairwise_sqdist_gather_ring": 0,
    "knn_merge_cand_hd": 0,
    "knn_merge_cand_ld": 0,
    "knn_merge_hd": 0,
    "knn_merge_ld": 0,
    "knn_merge_cand_lanes": 0,
    "knn_merge_lanes": 0,
    "knn_merge_cand_ring": 0,
    "knn_merge_ring": 0,
    "ne_forces_scatter": 0,
    "pairwise_sqdist": 0,
    "ne_forces": 0,
    "ne_forces_rounds": 0,
    "ne_forces_staged": 0,
    "ne_forces_gather": 0,
    "ne_forces_gather_rounds": 0,
    "ne_forces_gather_staged": 0,
    "segment_sum": 0,
    "flash_attention_wgmma": 0,
    "flash_attention_tf32": 0,
    "flash_attention_simt": 0,
    "flash_attention_bwd": 0,
    "flash_attention_bwd_wgmma": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
