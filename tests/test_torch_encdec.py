"""The port's encoder-decoder (seamless-m4t) against the reference, on the
CPU, f32.

On ``seamless-m4t-medium.reduced()`` (2 + 2 layers, d_model 64, 4 q / 2
kv heads of 16) with the reference's weights: the encoder with and
without ragged valid lengths, the cross K/V, prefill (logits, self-KV,
cross-KV), decode over pages built with ``transformer.kv_to_pages`` with
a ragged ``enc_valid_len``, decode against the port's own full forward
(the counterpart of
``tests/test_serve_consistency.py::test_encdec_decode_matches_full``) and
greedy streams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_serving import encdec_greedy_stream, pool_from_prefill, tables
from torch_parity import both_models, reduced_cfg

from repro.models import encdec as JE
from repro_torch.models import encdec as PE

ARCH = "seamless-m4t-medium"
ATOL = 1e-4
# the reference's steps jitted, as its engine would run them (cfg is static)
j_encode = jax.jit(JE.encode, static_argnums=1)
j_prefill = jax.jit(JE.prefill, static_argnums=1)
j_decode = jax.jit(JE.decode, static_argnums=1)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def models():
    return both_models(reduced_cfg(ARCH), arch=ARCH)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = tuple(v.shape)
    return out


def _inputs(cfg, B, S, n_frames, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, n_frames, cfg.d_model)) * 0.3).astype(np.float32)
    return toks, frames


def test_params_match_reference_layout(models):
    jm, jp, pm, pp = models
    want = _flat(jp)
    assert "head" not in pp and _flat(pp) == want
    assert _flat(pm.init(torch.Generator().manual_seed(0), device="cpu")) == want


@pytest.mark.parametrize("valid", ["full", "ragged"])
def test_encode_matches_reference(models, valid):
    jm, jp, pm, pp = models
    _, frames = _inputs(jm.cfg, 3, 8, jm.cfg.encoder_seq, 1)
    evl = None if valid == "full" else np.array([16, 9, 1], np.int32)
    want = j_encode(jp, jm.cfg, jnp.asarray(frames),
                    enc_valid_len=None if evl is None else jnp.asarray(evl))
    got = PE.encode(pp, pm.cfg, torch.from_numpy(frames),
                    enc_valid_len=None if evl is None else torch.from_numpy(evl))
    _close(got, want)


def test_build_cross_kv_matches_reference(models):
    jm, jp, pm, pp = models
    _, frames = _inputs(jm.cfg, 2, 8, 12, 2)
    enc = np.array(j_encode(jp, jm.cfg, jnp.asarray(frames)))
    jk, jv = JE.build_cross_kv(jp, jm.cfg, jnp.asarray(enc))
    pk, pv = PE.build_cross_kv(pp, pm.cfg, torch.from_numpy(enc))
    assert tuple(pk.shape) == tuple(jk.shape) == (2, 2, 12, 2, 16)
    _close(pk, jk)
    _close(pv, jv)


def test_prefill_matches_reference(models):
    jm, jp, pm, pp = models
    toks, frames = _inputs(jm.cfg, 2, 8, 12, 3)
    jl, (jk, jv), (jxk, jxv) = j_prefill(jp, jm.cfg, jnp.asarray(frames), jnp.asarray(toks))
    pl, (pk, pv), (pxk, pxv) = PE.prefill(pp, pm.cfg, torch.from_numpy(frames),
                                          torch.from_numpy(toks))
    V = jm.cfg.vocab_size
    _close(pl[:, :V], jl[:, :V])
    for p, j in ((pk, jk), (pv, jv), (pxk, jxk), (pxv, jxv)):
        assert tuple(p.shape) == tuple(j.shape)
        _close(p, j)


def test_decode_matches_reference(models):
    """One decode step over identical pools (``kv_to_pages`` of the same
    prefill K/V plus free pages) with a ragged ``enc_valid_len``: logits
    within 1e-4 and the same K/V written to the same slots."""
    jm, jp, pm, pp = models
    cfg, ps = jm.cfg, 4
    toks, frames = _inputs(cfg, 2, 8, 12, 4)
    last, (k, v), (xk, xv) = j_prefill(jp, cfg, jnp.asarray(frames), jnp.asarray(toks))
    kpg, vpg, N0 = pool_from_prefill(torch.from_numpy(np.array(k)),
                                     torch.from_numpy(np.array(v)), ps, 3)
    bt = tables(2, 8, ps, N0, 1, width=4)
    lens, evl = np.full((2,), 8, np.int32), np.array([12, 5], np.int32)
    nxt = np.asarray(last.argmax(-1)).astype(np.int32)
    jl, (jkp, jvp) = j_decode(jp, cfg, jnp.asarray(nxt), jnp.asarray(kpg.numpy()),
                              jnp.asarray(vpg.numpy()), xk, xv, jnp.asarray(bt),
                              jnp.asarray(lens), enc_valid_len=jnp.asarray(evl))
    pl, (pkp, pvp) = PE.decode(pp, cfg, torch.from_numpy(nxt), kpg, vpg,
                               torch.from_numpy(np.array(xk)),
                               torch.from_numpy(np.array(xv)), torch.from_numpy(bt),
                               torch.from_numpy(lens), enc_valid_len=torch.from_numpy(evl))
    assert pkp is kpg and pvp is vpg                   # written in place
    _close(pl[:, :cfg.vocab_size], jl[:, :cfg.vocab_size])
    _close(pkp, jkp)
    _close(pvp, jvp)


def test_decode_matches_full_forward(models):
    _, _, pm, pp = models
    cfg, ps = pm.cfg, 4
    toks, frames = (torch.from_numpy(a) for a in _inputs(cfg, 2, 8, 12, 1))
    last, (k, v), (xk, xv) = PE.prefill(pp, cfg, frames, toks)
    kpg, vpg, N0 = pool_from_prefill(k, v, ps, 3)
    bt = torch.from_numpy(tables(2, 8, ps, N0, 1, width=4))
    nxt = last.argmax(-1)
    dl, _ = PE.decode(pp, cfg, nxt, kpg, vpg, xk, xv, bt, torch.full((2,), 8))
    fl, aux = PE.train_logits(pp, cfg, {"frames": frames,
                                        "tokens": torch.cat([toks, nxt[:, None]], 1)})
    assert float(aux) == 0.0
    assert float((dl - fl[:, -1]).abs().max()) < 2e-3


def test_greedy_tokens_match_reference(models):
    """8 greedy tokens, the cross keys of the second utterance masked past
    its 7 valid frames."""
    jm, jp, pm, pp = models
    cfg, ps, steps = jm.cfg, 4, 8
    toks, frames = _inputs(cfg, 2, 8, 12, 5)
    evl = np.array([12, 7], np.int32)
    last, (k, v), (xk, xv) = j_prefill(jp, cfg, jnp.asarray(frames), jnp.asarray(toks))
    new = -(-steps // ps)
    kpg, vpg, N0 = pool_from_prefill(torch.from_numpy(np.array(k)),
                                     torch.from_numpy(np.array(v)), ps, 2 * new + 1)
    kpg, vpg = jnp.asarray(kpg.numpy()), jnp.asarray(vpg.numpy())
    bt = jnp.asarray(tables(2, 8, ps, N0, new, width=8 // ps + new))
    want, nxt = [], last.argmax(-1).astype(jnp.int32)
    for i in range(steps):
        want.append(np.asarray(nxt))
        logits, (kpg, vpg) = j_decode(jp, cfg, nxt, kpg, vpg, xk, xv, bt,
                                      jnp.full((2,), 8 + i, jnp.int32),
                                      enc_valid_len=jnp.asarray(evl))
        nxt = logits.argmax(-1).astype(jnp.int32)
    got = encdec_greedy_stream(pp, pm.cfg, frames, toks, steps, ps, enc_valid_len=evl)
    np.testing.assert_array_equal(got, np.stack(want, 1))
