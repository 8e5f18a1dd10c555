"""ArchConfig: one dataclass describing every architecture of the repo
(the port's copy of ``repro.configs.base``, field for field).

The 10 architectures are registered by their own module in this package;
``get_arch(id)`` resolves them.  ``smoke_variant`` shrinks any config to a
CPU-runnable size (same family/topology, tiny widths).  The port runs the
dense/audio family (MusicGen-large); the other nine are data only.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | gemma2 | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    scale_embeddings: bool = False      # gemma: h *= sqrt(d_model)
    input_mode: str = "tokens"          # 'tokens' | 'embeds' (modality stub)
    # gemma2
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    local_window: int = 0
    alt_local_global: bool = False
    post_block_norm: bool = False
    norm_plus_one: bool = False         # gemma: scale = (1 + w)
    mlp_act: str = "swiglu"             # 'swiglu' | 'geglu'
    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 0.001
    moe_dense_first: bool = False       # DeepSeek-V2: first layer dense FFN
    moe_impl: str = "gspmd"             # 'gspmd' | 'a2a' (shard_map EP)
    # mla (DeepSeek-V2); kv_lora_rank > 0 enables MLA attention
    kv_lora_rank: int = 0
    q_nope_dim: int = 128
    q_rope_dim: int = 64
    v_head_dim: int = 128
    # ssm (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_ngroups: int = 1
    # hybrid (zamba2): shared attn+mlp block applied every k mamba layers
    shared_attn_every: int = 0
    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"    # 'int8' enables quantised Adam moments
    remat: bool = True
    remat_policy: str = "nothing"       # 'nothing' | 'dots_no_batch' | 'none'
    # treat the model axis as extra data parallelism when the global batch
    # divides the full mesh (right call for sub-1B archs; §Perf H9)
    pure_dp: bool = False
    logits_chunks: int = 1
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    # which shapes this arch supports ('long_500k' only for sub-quadratic)
    supports_long: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "chameleon-34b", "olmoe-1b-7b", "deepseek-v2-236b", "zamba2-2.7b",
    "mamba2-130m", "yi-34b", "qwen2.5-14b", "gemma2-2b", "qwen2-7b",
    "musicgen-large",
]

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        importlib.import_module(
            f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return _REGISTRY[name]


def list_archs():
    return list(ARCH_IDS)


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    ssm_headdim = 16 if cfg.ssm_state else cfg.ssm_headdim
    repl = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.shared_attn_every else 2),
        d_model=128, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        head_dim=32, d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 8), d_ff_expert=64 if cfg.is_moe else 0,
        moe_top_k=min(cfg.moe_top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        kv_lora_rank=32 if cfg.is_mla else 0,
        q_nope_dim=32 if cfg.is_mla else cfg.q_nope_dim,
        q_rope_dim=16 if cfg.is_mla else cfg.q_rope_dim,
        v_head_dim=32 if cfg.is_mla else cfg.v_head_dim,
        ssm_state=min(cfg.ssm_state, 16), ssm_headdim=ssm_headdim,
        ssm_chunk=32,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        local_window=64 if cfg.local_window else 0,
        logits_chunks=1, attn_chunk_q=64, attn_chunk_k=64,
        param_dtype="float32", compute_dtype="float32",
        opt_state_dtype="float32", remat=False,
        name=cfg.name + "-smoke",
    )
    return dataclasses.replace(cfg, **repl)
