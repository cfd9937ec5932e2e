"""K4's backward on the CPU: the plain version of the backward kernel
(``ssd_chunk_scan_bwd_plain``, the recipe of ``csrc/ssd_scan_bwd.cu``)
against ``torch.autograd`` of the plain scan and against ``jax.vjp`` of
the reference's ``repro.models.ssm.mamba2_chunk_scan``; the autograd
binding ``SSDScanFn`` on CPU tensors; and one training gradient of the
families whose parity with the reference ``tests/test_torch_train.py``
does not hold — the zamba2 hybrid (its Mamba2 blocks' scans), rwkv6 and
the seamless-m4t encoder-decoder — against the reference's ``jax.grad``
on converted weights.  f32 throughout; inputs are made with numpy from a
seed.  The kernel itself runs on the card: ``tests/test_torch_kernels_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import family_batch
from torch_parity import reduced_models

from repro.configs import TrainConfig as JTrainConfig
from repro.models import ssm as JS
from repro.train import trainer as JT
from repro_torch.configs import TrainConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as K4
from repro_torch.train.trainer import make_loss_fn, value_and_grad

# each gradient within this share of its leaf's max |g|: f32 sums taken in
# another order over at most Q * P * N products
SCAN_REL = 1e-5
# a training gradient through a whole reduced model, both packages in f32
MODEL_REL = 1e-4

# B, T, H, P, N, chunk, h0, dh_final: T a multiple of the chunk, ragged,
# and below one chunk; h0 None (zeros) or given; dh_final None (zeros) or
# given; chunk 16 and 64
CASES = [(2, 64, 3, 8, 4, 16, False, False),
         (2, 37, 3, 8, 4, 16, True, True),
         (2, 10, 2, 4, 4, 16, True, False),
         (1, 130, 2, 8, 16, 64, False, True),
         (2, 128, 2, 8, 8, 64, True, True)]
NAMES = ("dx", "dla", "dB", "dC", "dh0")


def _inputs(case, seed=0):
    B, T, H, P, N, _, h0, dhf = case
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    x, Bc, Cc = r(B, T, H, P), r(B, T, N), r(B, T, N)
    la = (-np.abs(rng.standard_normal((B, T, H))) * 0.3).astype(np.float32)
    h = r(B, H, P, N) if h0 else None
    dy, dh = r(B, T, H, P), (r(B, H, P, N) if dhf else None)
    return x, la, Bc, Cc, h, dy, dh


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _assert_close(got, want, rel, names=NAMES):
    for name, a, b in zip(names, got, want):
        if b is None:
            assert a is None, name
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= rel * scale, (name, float(np.abs(a - b).max()), scale)


def _autograd(x, la, Bc, Cc, h, dy, dh, chunk, scan=K4.ssd_chunk_scan_plain):
    """torch.autograd's gradients of ``scan`` (h0's only when given)."""
    leaves = [t.clone().requires_grad_() for t in (x, la, Bc, Cc)]
    h = None if h is None else h.clone().requires_grad_()
    y, hf = scan(*leaves, h, chunk=chunk)
    outs, grads = [y], [dy]
    if dh is not None:
        outs, grads = outs + [hf], grads + [dh]
    g = torch.autograd.grad(outs, leaves + ([h] if h is not None else []), grads)
    return list(g) + ([None] if h is None else [])


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_matches_autograd_and_reference(case):
    """``ssd_chunk_scan_bwd_plain`` against autograd of the plain scan and
    against ``jax.vjp`` of the reference's scan (h0 given as zeros when
    None; its gradient then not compared)."""
    chunk = case[5]
    x, la, Bc, Cc, h, dy, dh = _inputs(case)
    got = K4.ssd_chunk_scan_bwd_plain(*map(_t, (x, la, Bc, Cc, h, dy, dh)), chunk=chunk)
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.float32
    assert (got[4] is None) == (h is None)
    _assert_close([None if g is None else g.numpy() for g in got],
                  [None if g is None else g.numpy()
                   for g in _autograd(*map(_t, (x, la, Bc, Cc, h, dy, dh)), chunk)],
                  SCAN_REL)
    B, T, H, P, N = x.shape + Bc.shape[-1:]
    h0 = np.zeros((B, H, P, N), np.float32) if h is None else h
    dh_final = np.zeros((B, H, P, N), np.float32) if dh is None else dh
    _, vjp = jax.vjp(lambda x, B_, C_, la, h0: JS.mamba2_chunk_scan(x, B_, C_, la, h0, chunk),
                     *map(jnp.asarray, (x, Bc, Cc, la, h0)))
    jx, jB, jC, jla, jh0 = vjp((jnp.asarray(dy), jnp.asarray(dh_final)))
    _assert_close([g.numpy() for g in got[:4]] + [None if h is None else got[4].numpy()],
                  [jx, jla, jB, jC, None if h is None else jh0], SCAN_REL)


def test_bwd_plain_empty_sequence():
    """T = 0: no step, so dh0 is dh_final and the other gradients are
    empty."""
    x, la, Bc, Cc, h, dy, dh = _inputs((2, 0, 2, 4, 4, 16, True, True))
    got = K4.ssd_chunk_scan_bwd_plain(*map(_t, (x, la, Bc, Cc, h, dy, dh)), chunk=16)
    assert [tuple(g.shape) for g in got[:4]] == [(2, 0, 2, 4), (2, 0, 2), (2, 0, 4), (2, 0, 4)]
    assert torch.equal(got[4], _t(dh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[4]])
def test_scan_fn_matches_autograd_on_cpu(case, dtype):
    """The autograd binding on CPU tensors (its forward and backward take
    the plain versions there): the gradients equal autograd of the plain
    scan in f32, an unused h_final gets no gradient input, and in bf16
    each gradient keeps its input's dtype."""
    chunk = case[5]
    x, la, Bc, Cc, h, dy, dh = map(_t, _inputs(case))
    if dtype == torch.float32:
        got = _autograd(x, la, Bc, Cc, h, dy, dh, chunk,
                        scan=lambda *a, chunk: K4.SSDScanFn.apply(*a, chunk))
        _assert_close([None if g is None else g.numpy() for g in got],
                      [None if g is None else g.numpy()
                       for g in _autograd(x, la, Bc, Cc, h, dy, dh, chunk)], SCAN_REL)
        return
    xs, bs, cs = (t.to(dtype).requires_grad_() for t in (x, Bc, Cc))
    lg = la.clone().requires_grad_()
    y, _ = K4.SSDScanFn.apply(xs, lg, bs, cs, h, chunk)
    y.backward(dy.to(dtype))
    assert (xs.grad.dtype, bs.grad.dtype, cs.grad.dtype, lg.grad.dtype) == (
        dtype, dtype, dtype, torch.float32)
    assert all(bool(torch.isfinite(g.float()).all()) for g in (xs.grad, bs.grad, cs.grad, lg.grad))


def _port_like_jax(tree):
    """The port's leaves in JAX's flattening order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_like_jax(tree[k])]
    return [tree.detach().numpy()]


def _batch(cfg, T):
    batch = {k: np.asarray(v) for k, v in family_batch(cfg, 2, T).items()}
    batch["labels"] = batch["tokens"]
    return batch


def _port_grads(pm, pp, batch, tmp_path):
    return value_and_grad(make_loss_fn(pm, TrainConfig(remat=True, ckpt_dir=str(tmp_path))), pp,
                          {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


@pytest.mark.parametrize("arch,T", [("zamba2-7b", 40), ("rwkv6-7b", 40),
                                    ("seamless-m4t-medium", 24)])
def test_train_grad_matches_reference(tmp_path, arch, T):
    """One training gradient of the reduced config on the reference's
    weights and batch: the loss within 1e-5 relative and every gradient
    leaf within ``MODEL_REL`` of its max |g|, against the reference's
    ``jax.grad`` of its loss.  The port runs with remat (ignored by the
    encoder-decoder, as in the reference).  zamba2's T = 40 stays inside
    one scan chunk: from about 56 steps in a chunk on, the reference's
    own gradient is NaN (its jnp scan exponentiates above the diagonal
    before masking, ``ROADMAP.md`` queue 3), which the next test covers
    on the port's side."""
    jm, jp, pm, pp = reduced_models(arch)
    batch = _batch(jm.cfg, T)
    jloss_fn = JT.make_loss_fn(jm, JTrainConfig(remat=False))
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: jloss_fn(p, b)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, pgrads = _port_grads(pm, pp, batch, tmp_path)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    got, want = _port_like_jax(pgrads), [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    assert len(got) == len(want) and all(np.isfinite(g).all() for g in want)
    _assert_close(got, want, MODEL_REL, names=[str(i) for i in range(len(got))])


def test_hybrid_train_grad_past_one_chunk(tmp_path, monkeypatch):
    """The reduced hybrid at T = 80 (two scan chunks, the last ragged; the
    decay sums past exp's f32 range above the diagonal): the gradient
    autograd takes through the plain scan is finite and equals the one
    through ``SSDScanFn``, whose backward is the kernel's recipe
    (``ssd_chunk_scan_bwd_plain``), leaf by leaf within ``MODEL_REL``."""
    _, _, pm, pp = reduced_models("zamba2-7b")
    batch = _batch(pm.cfg, 80)
    loss, grads = _port_grads(pm, pp, batch, tmp_path)
    calls = []

    def through_fn(x, la, Bc, Cc, h0=None, *, chunk=64):
        calls.append(chunk)
        return K4.SSDScanFn.apply(x, la, Bc, Cc, h0, chunk)

    monkeypatch.setattr(ops, "ssd_chunk_scan", through_fn)
    loss_fn, grads_fn = _port_grads(pm, pp, batch, tmp_path)
    assert calls == [64, 64]              # the one Mamba2 block, and remat's recompute
    assert float(loss_fn) == float(loss)
    got, want = _port_like_jax(grads_fn), _port_like_jax(grads)
    assert all(np.isfinite(g).all() for g in want)
    _assert_close(got, want, MODEL_REL, names=[str(i) for i in range(len(got))])
