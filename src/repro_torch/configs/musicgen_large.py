"""MusicGen-large [audio]: decoder-only over EnCodec tokens
(arXiv:2306.05284).  The EnCodec frontend is a stub:
input_specs feeds precomputed (B, S, d_model) frame embeddings; targets are
codebook tokens (vocab 2048)."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    input_mode="embeds",
    rope_theta=10000.0,
))
