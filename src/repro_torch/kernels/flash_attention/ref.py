"""Plain PyTorch version of causal GQA attention (B8): the materialised
softmax of ``repro.kernels.flash_attention.ref``."""
from __future__ import annotations

import torch

_NEG = -1e30


def flash_attention_ref(q, k, v, *, scale: float | None = None,
                        softcap: float = 0.0, window: int = 0):
    """Materialised-softmax causal attention.

    Args:
      q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0 (query
        head h reads KV head h // (Hq // Hkv)).
      scale: logit scale (default D^-0.5).
      softcap: if > 0, logits are soft-capped ``cap * tanh(s / cap)``.
      window: if > 0, each row sees the last ``window`` positions
        (itself included).
    Returns (B, Hq, S, D) in q's dtype; scores and sums in float32.
    """
    S, D = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    if scale is None:
        scale = D ** -0.5
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = cols <= rows
    if window > 0:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, _NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
