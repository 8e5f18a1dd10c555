"""DeepSeek-V2 236B [moe]: MLA (kv_lora=512) + 2 shared + 160 routed top-6
experts (arXiv:2405.04434).  First layer dense FFN per the paper."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288,                       # dense first-layer FFN width
    vocab_size=102400, head_dim=128,
    n_experts=160, moe_top_k=6, n_shared_experts=2, d_ff_expert=1536,
    moe_dense_first=True,
    kv_lora_rank=512, q_nope_dim=128, q_rope_dim=64, v_head_dim=128,
    rope_theta=10000.0,
    param_dtype="bfloat16", opt_state_dtype="int8",   # 236B on 16 GiB chips
    logits_chunks=8,
    moe_impl="a2a",            # §Perf H1: shard_map all-to-all EP
))
