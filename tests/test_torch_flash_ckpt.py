"""The port's training attention and vocab-tiled loss against the
reference: ``flash_attention_ckpt`` (K2's forward with its log-normalizer,
the recompute backward as a ``torch.autograd.Function``) against the
reference's ``custom_vjp`` and against autograd through the plain
version; the chunked and vocab-tiled CE losses and their gradients; and
the guard that keeps kernels without a backward out of autograd.

The same numpy-seeded inputs go to both packages; JAX runs on the CPU
and the port with CPU tensors (the kernels' plain versions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _flash_ckpt_fwd
from repro.models.layers import flash_attention_ckpt as j_flash_ckpt
from repro.train import losses as JL
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import paged_attention as K1
from repro_torch.kernels import paged_attention_int8 as K3
from repro_torch.kernels import ssd_scan as K4
from repro_torch.models import layers as PL
from repro_torch.train import losses as PLoss

# B, T, Tk, H, KV, d, causal, window, softcap, first row's kv_len (None:
# Tk; the others Tk - 3), block_kv.  G = 2, a window, a softcap, both
# with G = 1 and Tk not a multiple of block_kv, non-causal with a ragged
# kv_len and G = 3 (the encoder's and cross-attention's shape, Tk > T),
# and one block wider than Tk.
CASES = [(2, 24, 24, 4, 2, 16, True, None, None, None, 8),
         (2, 24, 24, 4, 2, 16, True, 7, None, None, 8),
         (2, 24, 24, 4, 2, 16, True, None, 20.0, None, 8),
         (2, 21, 21, 4, 4, 16, True, 5, 30.0, 15, 8),
         (2, 16, 30, 6, 2, 16, False, None, None, 11, 8),
         (1, 12, 12, 2, 2, 8, True, None, None, None, 512)]


def _inputs(case, seed=0):
    B, T, Tk, H, KV, d, *_, first_len, _ = case
    rng = np.random.RandomState(seed)
    q = (rng.standard_normal((B, T, H, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, Tk, KV, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, Tk, KV, d)).astype(np.float32)
    g = rng.standard_normal((B, T, H, d)).astype(np.float32)
    lens = np.array([Tk if first_len is None else first_len] + [Tk - 3] * (B - 1), np.int32)
    return q, k, v, g, lens


def _positions(B, T):
    return jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))


def _jax_kw(case):
    *_, causal, window, cap, _, block = case
    return dict(scale=0.25, causal=causal, window=window, attn_softcap=cap, block_kv=block)


def _port_ckpt(case, q, k, v, lens):
    *_, causal, window, cap, _, block = case
    return PL.flash_attention_ckpt(q, k, v, lens, scale=0.25, causal=causal, window=window,
                                   attn_softcap=cap, block_kv=block)


@pytest.mark.parametrize("case", CASES)
def test_forward_and_lse_match_reference(case):
    q, k, v, _, lens = _inputs(case)
    B, T, Tk = case[0], case[1], case[2]
    kw = _jax_kw(case)
    win = kw["window"] if kw["window"] is not None else 2**30
    want_o, res = _flash_ckpt_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _positions(B, T), _positions(B, Tk),
        jnp.asarray(lens), jnp.asarray(win, jnp.int32), kw["scale"], kw["causal"],
        kw["attn_softcap"] or 0.0, kw["block_kv"])
    o, lse = K2.flash_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(lens),
                                    scale=0.25, causal=kw["causal"], window=kw["window"],
                                    softcap=kw["attn_softcap"])
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[-1]), rtol=1e-5, atol=1e-5)
    assert lse.shape == (B, case[4], case[3] // case[4], T)


@pytest.mark.parametrize("case", CASES)
def test_grads_match_jax_grad_of_reference(case):
    q, k, v, g, lens = _inputs(case)
    B, T, Tk = case[0], case[1], case[2]

    def f(q, k, v):
        o = j_flash_ckpt(q, k, v, _positions(B, T), _positions(B, Tk), jnp.asarray(lens),
                         **_jax_kw(case))
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(f, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (_port_ckpt(case, qt, kt, vt, torch.from_numpy(lens)) * torch.from_numpy(g)).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_autograd_through_plain(case):
    """The hand-written backward against torch autograd through the plain
    block loop (the counterpart of the reference's
    ``test_flash_ckpt_bwd_matches_autodiff``)."""
    q, k, v, g, lens = _inputs(case)
    B, T, Tk = case[0], case[1], case[2]
    *_, causal, window, cap, _, block = case
    grads = []
    for use_ckpt in (True, False):
        qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        if use_ckpt:
            o = _port_ckpt(case, qt, kt, vt, torch.from_numpy(lens))
        else:
            o = PL.flash_attention(
                qt, kt, vt, q_positions=torch.arange(T)[None].expand(B, T),
                kv_positions=torch.arange(Tk)[None].expand(B, Tk),
                kv_valid_len=torch.from_numpy(lens).long(), scale=0.25, causal=causal,
                window=window, attn_softcap=cap, block_kv=block)
        assert o.grad_fn is not None
        (o * torch.from_numpy(g)).sum().backward()
        grads.append((qt.grad, kt.grad, vt.grad))
    for a, b in zip(*grads, strict=True):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


# loss, softcap, v_real (None: the padded vocab of 768, all real)
LOSS_CASES = [("vtiled", None, None), ("vtiled", 30.0, None), ("vtiled", None, 750),
              ("vtiled", 30.0, 750), ("chunked", None, 750), ("chunked", 30.0, None)]


@pytest.mark.parametrize("impl,cap,v_real", LOSS_CASES)
def test_loss_and_grads_match_reference(impl, cap, v_real):
    B, T, D, Vp = 2, 12, 16, 768
    rng = np.random.RandomState(3)
    hidden = rng.standard_normal((B, T, D)).astype(np.float32)
    table = (rng.standard_normal((Vp, D)) * 0.3).astype(np.float32)
    labels = rng.randint(0, v_real or Vp, size=(B, T)).astype(np.int32)
    labels[0, :4] = -100
    kw = dict(softcap=cap, v_real=v_real)
    j_fn = JL.lm_loss_from_hidden_vtiled if impl == "vtiled" else JL.lm_loss_from_hidden
    p_fn = PLoss.lm_loss_from_hidden_vtiled if impl == "vtiled" else PLoss.lm_loss_from_hidden
    extra = dict(vtile=512) if impl == "vtiled" else dict(chunk=5)  # 512 halves to 256
    (want, n_want), want_g = jax.value_and_grad(
        lambda h, t: j_fn(h, jnp.asarray(labels), t, **kw, **extra), (0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(table))
    h, t = (torch.from_numpy(x).requires_grad_() for x in (hidden, table))
    loss, n = p_fn(h, torch.from_numpy(labels), t, **kw, **extra)
    loss.backward()
    assert float(n) == float(n_want) == B * T - 4
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for got, w in zip((h.grad, t.grad), want_g, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5)


def test_grad_guard_refuses_tensors_off_the_cpu():
    """The guard of the kernels without a backward: off the CPU (here a
    ``meta`` tensor stands for the card) an input that requires grad
    raises under grad mode; without grad mode, without requires_grad or
    on the CPU it passes.  The real launches are ``gpu`` tests."""
    x = torch.empty(2, 4, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no autograd backward"):
        build.refuse_grad("k", (None, x), "route")
    with torch.no_grad():
        build.refuse_grad("k", (x,), "route")
    build.refuse_grad("k", (x.detach(),), "route")
    build.refuse_grad("k", (torch.zeros(2, requires_grad=True),), "route")

    def meta(*shape, dtype=torch.float32, grad=False):
        return torch.zeros(*shape, dtype=dtype, device="meta", requires_grad=grad)

    i32 = torch.int32
    calls = {
        "flash_attention": lambda: ops.flash_attention(
            meta(1, 4, 2, 16, grad=True), meta(1, 4, 2, 16), meta(1, 4, 2, 16),
            meta(1, dtype=i32), scale=0.25),
        "paged_attention": lambda: K1.paged_attention(
            meta(1, 1, 2, 16, grad=True), meta(4, 4, 2, 16), meta(4, 4, 2, 16),
            meta(1, 2, dtype=i32), meta(1, dtype=i32), meta(1, dtype=i32), scale=0.25),
        "paged_attention_int8": lambda: K3.paged_attention_int8(
            meta(1, 1, 2, 16, grad=True), meta(4, 4, 2, 16, dtype=torch.int8),
            meta(4, 4, 2, 1), meta(4, 4, 2, 16, dtype=torch.int8), meta(4, 4, 2, 1),
            meta(1, 2, dtype=i32), meta(1, dtype=i32), meta(1, dtype=i32), scale=0.25),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has no autograd"):
            call()
    # K4 has a backward kernel, so it is not refused under grad: off the
    # CPU it takes cuda tensors only
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        K4.ssd_chunk_scan(meta(1, 8, 2, 4, grad=True), meta(1, 8, 2), meta(1, 8, 4),
                          meta(1, 8, 4), chunk=4)
