"""OLMoE-1B-7B [moe]: 64 experts, top-8, d_ff_expert=1024 (arXiv:2409.02060)."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    n_experts=64, moe_top_k=8, d_ff_expert=1024,
    rope_theta=10000.0,
    logits_chunks=2,
    moe_impl="a2a",            # §Perf H1: shard_map all-to-all EP
))
