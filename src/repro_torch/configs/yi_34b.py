"""Yi-34B [dense]: llama-arch GQA kv=8 (arXiv:2403.04652)."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    rope_theta=5000000.0,
    param_dtype="bfloat16", opt_state_dtype="int8",
    logits_chunks=4,
))
