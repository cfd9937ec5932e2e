"""RWKV6 language model in PyTorch (attention-free; recurrent state
instead of KV).

The counterpart of the reference's ``models/rwkv.py``, with its names,
layouts and parameter names.  Serving phases still exist: prefill = the
chunkwise-parallel WKV scan over the prompt (compute bound), decode = the
recurrent step (bandwidth bound: it reads the full state and every weight
per token), and ``mixed`` runs prefill chunks and decode rows in one call,
the Splitwiser step for the state-cache family.  The reference's engine
serves only paged caches, so this family is served at model level, as
the zamba2 hybrid is.

The state is the reference's stacked dict: ``x_tm``/``x_cm`` [L, B, D]
in the activations' dtype and ``S`` [L, B, H, K, K], f32 once a step has
run (``init_state`` gives zeros in the params' dtype, as the
reference's does).  The reference's ``lax.scan`` over layers is a Python
loop that stacks the new states; no step writes its input state.  The
WKV scan is plain PyTorch on every device: the reference's is jnp, not a
Pallas kernel.
``train_logits`` is differentiable; with ``remat`` each layer is
recomputed in the backward (``torch.utils.checkpoint``).

On a mesh (``forward``/``prefill``/``decode``/``mixed`` with a
``policy``; ``tp`` is accepted and unused, as in the reference: RWKV has
no heads to pad) each rank runs its shards (``models/ssm.py``), its data
shard's rows and a state of its heads (``init_state(..., tp=)``);
``embed`` is a vocab-parallel lookup and ``head`` gives vocab-parallel
logits gathered over ``model`` (``transformer.py``; ``train_logits``
keeps the rank's columns for the vocab-parallel loss, and gathers each
layer's FSDP'd weights in its remat region).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import ssm
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.sharding import gather_weights, layer_specs
from repro_torch.models.transformer import (embed_rows, layer_list, maybe_remat,
                                            pad_vocab, table_of, unembed)


def init_params(cfg, generator: torch.Generator, dtype=torch.float32,
                device=None, tp: int = 1):
    """Random parameters with the reference's shapes and init scales,
    drawn from ``generator`` (the numbers differ from JAX's; tests hand
    both packages the same weights through
    ``models.convert.params_from_jax``).  ``tp`` is unused: no heads to
    pad."""
    del tp
    device = resolve_device(device)
    Vp = pad_vocab(cfg.vocab_size)
    D = cfg.d_model
    zeros = lambda: torch.zeros((D,), dtype=dtype, device=device)
    return {
        "embed": dense_init(generator, (Vp, D), 1, dtype, device, 0.02),
        "ln0": zeros(),
        "blocks": ssm.rwkv6_init(generator, cfg, dtype, device, stack=(cfg.n_layers,)),
        "ln_f": zeros(),
        "head": dense_init(generator, (Vp, D), 1, dtype, device, 0.02),
    }


def init_state(cfg, batch, dtype=torch.float32, device=None, tp=1):
    """Zero states ``{x_tm, x_cm: [L, B, D], S: [L, B, H, K, K]}``
    (``H / tp`` heads with ``tp``: a model rank's)."""
    device = resolve_device(device)
    shapes = ssm.rwkv6_state_shapes(cfg, batch, tp)
    return {k: torch.zeros((cfg.n_layers,) + v, dtype=dtype, device=device)
            for k, v in shapes.items()}


def _hidden(params, cfg, tokens, state, *, chunk, policy, remat):
    """tokens [B, T]; state stacked [L, ...].  Returns (the final-normed
    hidden states [B, T, D], new_state).  ``remat``: each layer is a
    checkpoint region (training), which gathers the layer's FSDP'd
    weights (``policy.params``)."""
    x = rms_norm(embed_rows(table_of(params, policy, "embed"), tokens, policy),
                 params["ln0"], cfg.norm_eps)
    new = {k: [] for k in state}
    lps = layer_list(params["blocks"], cfg.n_layers)
    specs = layer_specs(policy)
    for l in range(cfg.n_layers):
        x, s2 = maybe_remat(lambda x, l=l: ssm.rwkv6_layer(      # l bound now: the
            gather_weights(lps[l], specs, policy), cfg, x,        # backward reruns it
            {k: t[l] for k, t in state.items()}, chunk=chunk, policy=policy), x, remat)
        for k, t in s2.items():
            new[k].append(t)
    return (rms_norm(x, params["ln_f"], cfg.norm_eps),
            {k: torch.stack(t) for k, t in new.items()})


def forward(params, cfg, tokens, state, *, chunk=32, policy=None):
    """tokens [B, T]; state stacked [L, ...]. Returns (logits, new_state):
    f32 logits [B, Vp] at the last token."""
    x, new = _hidden(params, cfg, tokens, state, chunk=chunk, policy=policy, remat=False)
    return unembed(params, cfg, x[:, -1], policy), new


def train_logits(params, cfg, batch, *, tp=1, policy=None, remat=False):
    """Full-sequence logits [B, T, Vp] from zero states (also the
    full-sequence oracle of the serving steps); the reference's (logits,
    aux loss) pair with aux 0.  On a mesh the rank's rows from a state of
    its heads (``init_state`` at the policy's tp; ``tp`` is unused, as in
    the reference) and its vocab columns [B, T, Vp / tp] (the
    vocab-parallel loss's input)."""
    del tp
    tokens = batch["tokens"]
    state = init_state(cfg, tokens.shape[0], params["embed"].dtype, tokens.device,
                       1 if policy is None else policy.tp)
    x, _ = _hidden(params, cfg, tokens, state, chunk=32, policy=policy, remat=remat)
    return (unembed(params, cfg, x, policy, gather=False),
            torch.zeros((), device=x.device))


def prefill(params, cfg, tokens, *, tp=1, policy=None, chunk=32, state=None):
    """tokens [B, T], from ``state`` (None: zeros, of the rank's heads on
    a mesh). Returns (last_logits [B, Vp], state)."""
    del tp
    if state is None:
        state = init_state(cfg, tokens.shape[0], params["embed"].dtype, tokens.device,
                           1 if policy is None else policy.tp)
    return forward(params, cfg, tokens, state, chunk=chunk, policy=policy)


def decode(params, cfg, tokens, state, *, tp=1, policy=None):
    """tokens [B] -> (logits [B, Vp], state). One recurrent step."""
    del tp
    return forward(params, cfg, tokens[:, None], state, chunk=1, policy=policy)


def mixed(params, cfg, mb, p_state, d_state, *, tp=1, policy=None):
    """Splitwiser step for the state-cache family: prefill chunks and
    decode tokens in one call.  The projection GEMMs are not merged
    across phases (the token shift and the scan separate the phases
    before the GEMMs), as in the reference.
    mb: p_tokens [P, C]; d_tokens [B].
    Returns (p_logits [P, Vp], d_logits [B, Vp], p_state, d_state).
    """
    del tp
    p_logits, p_state = forward(params, cfg, mb["p_tokens"], p_state,
                                chunk=min(32, mb["p_tokens"].shape[1]), policy=policy)
    d_logits, d_state = forward(params, cfg, mb["d_tokens"][:, None], d_state,
                                chunk=1, policy=policy)
    return p_logits, d_logits, p_state, d_state
