"""Zamba2-2.7B [hybrid]: Mamba2 backbone + shared attention block applied
every 6 layers (arXiv:2411.15242).  54 mamba layers -> 9 super-blocks."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    shared_attn_every=6,
    rope_theta=10000.0,
    supports_long=True,
))
