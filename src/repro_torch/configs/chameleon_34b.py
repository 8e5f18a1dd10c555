"""Chameleon-34B [vlm]: early-fusion mixed-modal decoder (arXiv:2405.09818).

VQ image tokens share the 65536-entry vocab, so the backbone is a dense
GQA decoder in token mode; the VQ-GAN tokenizer frontend is a stub (tokens
arrive pre-quantised).
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536, head_dim=128,
    rope_theta=10000.0,
    param_dtype="bfloat16", opt_state_dtype="int8",   # 34B on 16 GiB chips
    logits_chunks=8,
))
