"""Mixture-of-Experts layer in PyTorch: top-k routing, capacity-based
scatter dispatch.

A port of the reference's ``models/moe.py`` with the same semantics:

- the router's top-k in f32, ties going to the lower expert index (as
  ``lax.top_k``: a stable descending sort);
- expert capacity ``ceil(T * K / E * capacity_factor)``, claimed in
  token-major order (a cumsum over the flattened ``[T * K]`` expert ids);
- tokens past an expert's capacity go to a trash slot and contribute 0;
- gates renormalised over the chosen k;
- the same Switch-style load-balancing aux loss.

The expert products are plain batched matrix products (``torch.bmm``),
as the reference leaves them to XLA outside any Pallas kernel.

``moe_apply`` is written over *local* arrays, as the reference's: on a
mesh (``launch/spmd.py::make_sharded_moe_fn``) a rank passes the expert
weights it owns and its first expert id (``expert_offset``, EP over the
model axis), or every expert with d_ff-sliced weights (expert tensor
parallelism), and the caller sums the partial outputs over the model
axis.  Capacity comes from the local token count ``T``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models.layers import dense_init


def moe_apply(
    lp: dict,                  # router [D, E]; w_gate/w_up [E_loc, D, F_loc]; w_down [E_loc, F_loc, D]
    x,                         # [T, D] token activations
    *,
    n_experts: int,
    top_k: int,
    act,                       # callable activation (on gate)
    expert_offset: int = 0,    # first expert id owned locally
    capacity_factor: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [T, D] local partial output, aux load-balance loss, an
    f32 scalar)."""
    T, D = x.shape
    E, K = n_experts, top_k
    E_loc = lp["w_gate"].shape[0]

    probs = torch.softmax((x @ lp["router"]).float(), dim=-1)           # [T, E]
    # lax.top_k order: descending, ties to the lower index
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :K]
    gates = probs.gather(1, order)                                      # [T, K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    C = max(1, int(math.ceil(T * K / E * capacity_factor)))

    flat_e = order.reshape(-1)                                          # [T*K]
    onehot = (flat_e[:, None] == torch.arange(E, device=x.device)[None]).to(torch.int32)
    my_pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]

    local_e = flat_e - expert_offset
    keep = (my_pos < C) & (local_e >= 0) & (local_e < E_loc)
    n_slots = E_loc * C
    slot = torch.where(keep, local_e * C + my_pos,
                       torch.full_like(my_pos, n_slots))                # overflow -> trash

    buf = torch.zeros((n_slots + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = x.repeat_interleave(K, dim=0)       # kept slots are distinct
    h = buf[:n_slots].reshape(E_loc, C, D)

    g = act(torch.bmm(h, lp["w_gate"])) * torch.bmm(h, lp["w_up"])
    y_exp = torch.bmm(g, lp["w_down"]).reshape(n_slots, D)
    y_exp = torch.cat([y_exp, y_exp.new_zeros((1, D))], dim=0)

    y_tok = y_exp[slot] * gates.reshape(-1, 1).to(y_exp.dtype)         # [T*K, D]
    y = y_tok.reshape(T, K, D).sum(dim=1)

    # Switch-style load-balancing aux loss (computed over the full router)
    frac_tokens = onehot.float().mean(dim=0) * (E / K)
    mean_probs = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens * mean_probs) / E
    return y, aux


def moe_init(generator, cfg, dtype, device, stack=()):
    """Router and expert weights with the reference's shapes and scales,
    drawn from ``generator`` in its order."""
    D, F, E, L = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers
    s = tuple(stack)

    def dense(shape, fan_in, scale=1.0):
        return dense_init(generator, s + shape, fan_in, dtype, device, scale)

    return {
        "router": dense((D, E), D),
        "w_gate": dense((E, D, F), D),
        "w_up": dense((E, D, F), D),
        "w_down": dense((E, F, D), F, 1.0 / math.sqrt(2 * L)),
    }
