"""Token-choice MoE with sorted dispatch (port of ``repro.models.moe``:
``moe_capacity``, ``init_moe`` and ``moe_apply``).

The assignments are sorted by expert once a layer (a stable sort, as
``jnp.argsort``), bucketed into an (E, C, D) buffer with capacity
C = ``moe_capacity``, run through a batched per-expert GEMM, and combined
back weighted by the router probabilities.  The discrete parts -- top-k
experts, the stable order, each assignment's slot ``pos``, ``keep`` and
``dropped_frac`` -- are the reference's exactly on inputs without ties.

No step adds in an order that the device picks, so the card gives one
result for one input:

* the dispatch is a gather: slot ``c`` of expert ``e`` holds the token of
  sorted assignment ``starts[e] + c`` when ``c`` is below the expert's
  count, else zero.  The reference's ``buf.at[se, posc].add`` writes each
  kept slot once (a dropped assignment adds zero at ``C - 1``), so the
  buffers are equal;
* the combine (:func:`combine`) gathers each token's k contributions back
  by the inverse of the sort and adds them one by one in ascending expert
  id, from zero, in the compute dtype.  That is the order of XLA's
  ``out.at[stok].add(contrib)`` on the CPU, which walks the sorted
  assignments; ``index_add_`` on CUDA adds with atomics in no fixed order.

``moe_apply_a2a``'s ``shard_map`` all-to-all path (expert parallelism
across chips) is not ported: on one device the reference's
``moe_apply_a2a`` is ``moe_apply`` on the flat tokens, so the port's MoE
block always calls ``moe_apply`` and ``cfg.moe_impl`` has no effect.
"""
from __future__ import annotations

import torch

from repro_torch.core import threefry
from repro_torch.models.common import dense_init, dtype_of, matmul_cd, swiglu


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float, round_to: int = 128) -> int:
    """Slots per expert: ``n_tokens * top_k / n_experts`` times the
    capacity factor, plus one, rounded up to ``round_to``."""
    c = int(n_tokens * top_k / n_experts * capacity_factor) + 1
    return max(round_to, -(-c // round_to) * round_to)


def init_moe(key, cfg, *, device=None):
    """Router (D, E) in float32; expert stacks (E, D, F), (E, F, D) and
    the shared experts in the param dtype, drawn as the JAX ``init_moe``."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    ks = threefry.split(key, 6)
    p = {
        "router": dense_init(ks[0], (D, E), torch.float32, fan_in=D,
                             device=device),
        "w_gate": dense_init(ks[1], (E, D, F), dt, fan_in=D, device=device),
        "w_up": dense_init(ks[2], (E, D, F), dt, fan_in=D, device=device),
        "w_down": dense_init(ks[3], (E, F, D), dt, fan_in=F, device=device),
    }
    if cfg.n_shared_experts:
        Fs = F * cfg.n_shared_experts
        p["shared_gate"] = dense_init(ks[4], (D, Fs), dt, fan_in=D,
                                      device=device)
        p["shared_up"] = dense_init(ks[5], (D, Fs), dt, fan_in=D,
                                    device=device)
        p["shared_down"] = dense_init(threefry.fold_in(ks[4], 7), (Fs, D),
                                      dt, fan_in=Fs, device=device)
    return p


def plan(x, router, k: int, capacity: int):
    """The router and the sorted dispatch of ``moe_apply``, as a dict:

    ``logits``, ``probs`` (T, E) float32; ``top_p``, ``top_e`` (T, k) each
    token's top-k probabilities and experts; ``order`` (T * k,) the stable
    order of the flat assignments by expert; ``pos`` and ``keep`` (T * k,)
    each sorted assignment's slot in its expert and whether it fits the
    capacity; ``starts`` and ``counts`` (E,) where each expert's run begins
    in the sorted order and how long it is.  No host sync.
    """
    T = x.shape[0]
    E = router.shape[1]
    dev = x.device
    logits = x.float() @ router
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order].contiguous()
    experts = torch.arange(E, dtype=se.dtype, device=dev)
    starts = torch.searchsorted(se, experts)
    counts = torch.searchsorted(se, experts, right=True) - starts
    pos = torch.arange(T * k, device=dev) - starts[se]
    return {"logits": logits, "probs": probs, "top_p": top_p,
            "top_e": top_e, "order": order, "pos": pos,
            "keep": pos < capacity, "starts": starts, "counts": counts}


def dispatch(x, order, starts, counts, k: int, capacity: int, cd):
    """The (E, C, D) expert buffer in the compute dtype: slot ``c`` of
    expert ``e`` holds the token of sorted assignment ``starts[e] + c``
    when ``c < counts[e]``, else zero (a gather: no slot is written
    twice)."""
    slots = torch.arange(capacity, device=x.device)
    idx = (starts[:, None] + slots[None, :]).clamp_max(order.shape[0] - 1)
    filled = slots[None, :] < counts[:, None]                # (E, C)
    return x.to(cd)[order[idx] // k] * filled[..., None].to(cd)


def combine(out_e, top_e, top_p, pos_tk, cd):
    """Each token's output: the sum of its k experts' outputs, each times
    its router probability (zero where its slot is past the capacity),
    added one by one in ascending expert id from zero, in the compute
    dtype.

    ``out_e`` (E, C, D) expert outputs; ``top_e``, ``top_p``, ``pos_tk``
    (T, k) each assignment's expert, probability and slot, in the router's
    top-k order.
    """
    T, k = top_e.shape
    C = out_e.shape[1]
    order_k = torch.argsort(top_e, dim=1, stable=True)      # ascending id
    pos_s = pos_tk.gather(1, order_k)
    w_s = (top_p * (pos_tk < C)).gather(1, order_k).to(cd)  # (T, k)
    contrib = out_e[top_e.gather(1, order_k), pos_s.clamp(0, C - 1)] \
        * w_s[..., None]                                     # (T, k, D)
    out = torch.zeros((T, out_e.shape[2]), dtype=cd, device=out_e.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def moe_apply(p, x, cfg):
    """x: (T, D) flat tokens -> (out (T, D), aux dict of 0-d float32
    tensors: ``load_balance``, ``router_z``, ``dropped_frac``)."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    cd = dtype_of(cfg.compute_dtype)
    C = moe_capacity(T, E, k, cfg.capacity_factor)

    r = plan(x, p["router"], k, C)
    buf = dispatch(x, r["order"], r["starts"], r["counts"], k, C, cd)
    g = matmul_cd(buf, p["w_gate"].to(cd))
    u = matmul_cd(buf, p["w_up"].to(cd))
    out_e = matmul_cd(swiglu(g, u), p["w_down"].to(cd))

    # each assignment's slot, back in the router's top-k order
    pos_tk = torch.empty_like(r["pos"])
    pos_tk[r["order"]] = r["pos"]
    out = combine(out_e, r["top_e"], r["top_p"], pos_tk.view(T, k), cd)

    if cfg.n_shared_experts:
        xc = x.to(cd)
        sh = swiglu(matmul_cd(xc, p["shared_gate"].to(cd)),
                    matmul_cd(xc, p["shared_up"].to(cd)))
        out = out + matmul_cd(sh, p["shared_down"].to(cd))

    # aux: Switch load-balance (f_e * P_e) + z-loss
    me = r["probs"].mean(dim=0)
    fe = r["counts"].to(torch.float32) / (T * k)
    aux = {
        "load_balance": E * (fe * me).sum(),
        "router_z": (torch.logsumexp(r["logits"], dim=-1) ** 2).mean(),
        "dropped_frac": 1.0 - r["keep"].to(torch.float32).mean(),
    }
    return out, aux

