"""Plain PyTorch versions of causal GQA attention (B8): the materialised
softmax of ``repro.kernels.flash_attention.ref``, the arithmetic of the two
tensor-core kernels, and B8's backward (``flash_attention_bwd_ref``, the
plain version of ``csrc/flash_attention_bwd.cu``)."""
from __future__ import annotations

import torch

_NEG = -1e30


def flash_attention_ref(q, k, v, *, scale: float | None = None,
                        softcap: float = 0.0, window: int = 0):
    """Materialised-softmax causal attention.

    Args:
      q: (B, Hq, S, D); k: (B, Hkv, S, D); v: (B, Hkv, S, Dv) with Hq %
        Hkv == 0 (query head h reads KV head h // (Hq // Hkv)).
      scale: logit scale (default D^-0.5).
      softcap: if > 0, logits are soft-capped ``cap * tanh(s / cap)``.
      window: if > 0, each row sees the last ``window`` positions
        (itself included).
    Returns (B, Hq, S, Dv) in q's dtype; scores and sums in float32.
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



def flash_attention_bwd_ref(q, k, v, out, dout, *, scale: float,
                            softcap: float = 0.0, window: int = 0):
    """The gradients of ``flash_attention_ref`` by explicit formulas.

    Layout and arguments as ``flash_attention_ref``; ``out`` (B, Hq, S, Dv)
    is the forward's output and ``dout`` the gradient that reaches it.  In
    float32: each row's log-sum-exp recomputed over the keys it sees,
    ``delta = sum(dout * out)`` a row, P = exp(s - lse), dV = P^T dO, dP =
    dO V^T, dS = P (dP - delta), times ``1 - tanh(raw / cap)^2`` under a
    softcap (``raw`` the scaled score before the cap), dQ = scale dS K and
    dK = scale dS^T Q; dK and dV summed over the ``Hq / Hkv`` query heads of
    their group.  Returns (dq, dk, dv) in the dtypes of q, k and v.
    """
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    qf, of, dof = q.float(), out.float(), dout.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    raw = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    s = raw
    if softcap > 0.0:
        t = torch.tanh(raw / softcap)
        s = softcap * t
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = cols <= rows
    if window > 0:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True))
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    if softcap > 0.0:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(B, Hkv, group, S, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, group, S, v.shape[3]).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

def flash_attention_split_p_ref(q, k, v, *, scale: float | None = None,
                                softcap: float = 0.0, window: int = 0,
                                block_k: int = 64, split_p: bool = True):
    """The arithmetic of B8's tensor-core kernel in plain PyTorch.

    Scores q.k in float32 (the products of bf16 values are exact there),
    an online softmax over tiles of ``block_k`` keys with a float32 running
    max and denominator (summed from float32 p), and P.V accumulated in
    float32 as p_hi.V + p_lo.V, where p_hi = bf16(p) and p_lo = bf16(p -
    p_hi): the two register-A products of the kernel.  ``split_p=False``
    is the variant not taken, P rounded once to bf16.  Arguments and
    result as ``flash_attention_ref``.
    """
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    if scale is None:
        scale = D ** -0.5
    k = k.repeat_interleave(group, dim=1).float()
    v = v.repeat_interleave(group, dim=1).float()
    qf = q.float()
    rows = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, Hq, S, 1), _NEG, device=q.device)
    l = torch.zeros((B, Hq, S, 1), device=q.device)
    acc = torch.zeros((B, Hq, S, v.shape[3]), device=q.device)
    for c0 in range(0, S, block_k):
        kc, vc = k[:, :, c0:c0 + block_k], v[:, :, c0:c0 + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        cols = torch.arange(c0, c0 + kc.shape[2], device=q.device)[None, :]
        mask = cols <= rows
        if window > 0:
            mask = mask & (cols > rows - window)
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where((s > _NEG / 2) & (m_new > _NEG / 2),
                        torch.exp(s - m_new), 0.0)
        corr = torch.where(m > _NEG / 2, torch.exp(m - m_new), 0.0)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vc
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vc
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


TF32_TERMS = ("hl", "lh", "hh")


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to tf32 (10 fraction bits), to nearest with ties
    away from zero, as B8's float32 tensor-core kernel does on the bits:
    (u + 0x1000) & ~0x1fff."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(a, b, terms):
    """a @ b^T over the last dims from tf32 parts: x = hi + lo with hi =
    tf32_rna(x), lo = tf32_rna(x - hi); the sum of the ``terms`` products
    ("hh" hi.hi, "hl" hi.lo, "lh" lo.hi), each exact in float32 before
    it is summed."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    parts = {"hh": (a_hi, b_hi), "hl": (a_hi, tf32_rna(b - b_hi)),
             "lh": (tf32_rna(a - a_hi), b_hi)}
    out = None
    for term in terms:
        x, y = parts[term]
        prod = x @ y.transpose(-1, -2)
        out = prod if out is None else out + prod
    return out


def flash_attention_tf32_ref(q, k, v, *, scale: float | None = None,
                             softcap: float = 0.0, window: int = 0,
                             block_k: int | None = None,
                             terms=TF32_TERMS):
    """The arithmetic of B8's float32 tensor-core kernel in plain PyTorch.

    Q K^T and P V each as three products of tf32 parts (``_tf32_product``:
    hi.lo + lo.hi + hi.hi, the lo.lo term dropped), an online softmax over
    tiles of ``block_k`` keys (the kernel's: 64 at D = 64, 32 at D = 128)
    with a float32 running max and denominator summed from float32 p, and
    P split like the other operands.  ``terms`` names the products kept:
    ``("hh",)`` is one TF32 pass, the variant not taken.  Arguments and
    result as ``flash_attention_ref``, float32.
    """
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    if scale is None:
        scale = D ** -0.5
    if block_k is None:
        block_k = 64 if D <= 64 else 32
    k = k.repeat_interleave(group, dim=1).float()
    v = v.repeat_interleave(group, dim=1).float()
    qf = q.float()
    rows = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, Hq, S, 1), _NEG, device=q.device)
    l = torch.zeros((B, Hq, S, 1), device=q.device)
    acc = torch.zeros((B, Hq, S, v.shape[3]), device=q.device)
    for c0 in range(0, S, block_k):
        kc, vc = k[:, :, c0:c0 + block_k], v[:, :, c0:c0 + block_k]
        s = _tf32_product(qf, kc, terms) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        cols = torch.arange(c0, c0 + kc.shape[2], device=q.device)[None, :]
        mask = cols <= rows
        if window > 0:
            mask = mask & (cols > rows - window)
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where((s > _NEG / 2) & (m_new > _NEG / 2),
                        torch.exp(s - m_new), 0.0)
        corr = torch.where(m > _NEG / 2, torch.exp(m - m_new), 0.0)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _tf32_product(p, vc.transpose(-1, -2), terms)
        m = m_new
    return acc / l.clamp_min(1e-30)
