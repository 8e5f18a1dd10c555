"""Mamba2-130M [ssm]: pure SSD, attention-free (arXiv:2405.21060)."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    supports_long=True,
    pure_dp=True,               # §Perf H9: model axis as extra DP
))
