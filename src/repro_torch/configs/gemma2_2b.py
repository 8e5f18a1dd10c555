"""Gemma2-2B [dense/gemma2]: alternating local(4096)/global attention,
attn softcap 50, final softcap 30, sandwich norms, GeGLU
(arXiv:2408.00118)."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="gemma2-2b", family="gemma2",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_ff=9216, vocab_size=256000, head_dim=256,
    alt_local_global=True, local_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    post_block_norm=True, norm_plus_one=True, mlp_act="geglu",
    scale_embeddings=True, tie_embeddings=True,
    rope_theta=10000.0,
    logits_chunks=16,
))
