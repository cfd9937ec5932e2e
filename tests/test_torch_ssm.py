"""The port's Mamba2 half of ``models/ssm.py`` and its SSD scan (K4's
plain version and wrapper) against the reference, on the CPU, f32.

The scan against the jnp oracle ``mamba2_chunk_scan`` (1e-5) and against
the Pallas kernel in interpret mode (1e-4, ``tests/test_ssd_kernel.py``'s
tolerance); the wrapper's CPU dispatch and argument contract; the conv,
the chunked block and the recurrent step against JAX on reduced zamba2
weights; and, port-side, one block over T tokens against T steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import reduced_cfg

from repro.kernels.ssd_scan import ssd_chunk_scan as pallas_ssd_chunk_scan
from repro.models import ssm as JS
from repro_torch.configs.base import ModelConfig as PortModelConfig
from repro_torch.kernels import ssd_scan as K4
from repro_torch.models import ssm as PS
from repro_torch.models.convert import params_from_jax

SCAN_ATOL = 1e-5        # plain scan vs the jnp oracle, f32
PALLAS_ATOL = 1e-4      # tests/test_ssd_kernel.py's tolerance
LAYER_ATOL = 1e-5

# B, H, T, P, N, chunk: tests/test_ssd_kernel.py's cases, then a ragged T
SSD_CASES = [(2, 3, 32, 16, 8, 8), (1, 2, 64, 32, 16, 16), (2, 1, 24, 8, 8, 8)]
RAGGED = (2, 3, 20, 16, 8, 8)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _scan_inputs(seed, B, H, T, P, N, h0):
    """Model-layout scan inputs as numpy f32: x [B,T,H,P], Bc/Cc [B,T,N],
    la [B,T,H] (<= 0), h0 [B,H,P,N] (zeros or random)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    x, Bc, Cc = f(B, T, H, P), f(B, T, N), f(B, T, N)
    la = (-np.abs(rng.standard_normal((B, T, H))) * 0.1).astype(np.float32)
    h = f(B, H, P, N) if h0 == "random" else np.zeros((B, H, P, N), np.float32)
    return x, Bc, Cc, la, h


@pytest.mark.parametrize("h0", ["zero", "random"])
@pytest.mark.parametrize("case", SSD_CASES + [RAGGED])
def test_plain_scan_matches_jax_oracle(case, h0):
    B, H, T, P, N, chunk = case
    x, Bc, Cc, la, h = _scan_inputs(0, B, H, T, P, N, h0)
    want_y, want_h = JS.mamba2_chunk_scan(*map(jnp.asarray, (x, Bc, Cc, la, h)),
                                          chunk=chunk)
    args = [torch.from_numpy(a) for a in (x, Bc, Cc, la, h)]
    y, hf = PS.mamba2_chunk_scan(*args, chunk=chunk)
    assert y.shape == (B, T, H, P) and hf.shape == (B, H, P, N) and hf.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(want_y), atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(_np(hf), _np(want_h), atol=SCAN_ATOL, rtol=0)
    # the model function reaches the plain version through the wrapper
    py, ph = K4.ssd_chunk_scan_plain(args[0], args[3], args[1], args[2], args[4], chunk=chunk)
    assert torch.equal(py, y) and torch.equal(ph, hf)


@pytest.mark.parametrize("case", SSD_CASES)
def test_scan_matches_pallas_kernel_in_interpret_mode(case):
    """The port fed the Pallas kernel's inputs (heads before time,
    transposed to the model's layout) against the kernel itself, h0 = 0."""
    B, H, T, P, N, chunk = case
    rng = np.random.RandomState(1)
    xdt = (rng.standard_normal((B, H, T, P)) * 0.5).astype(np.float32)
    Bc = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    Cc = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    la = (-np.abs(rng.standard_normal((B, H, T))) * 0.1).astype(np.float32)
    want_y, want_h = pallas_ssd_chunk_scan(*map(jnp.asarray, (xdt, la, Bc, Cc)),
                                           chunk=chunk, interpret=True)
    y, h = K4.ssd_chunk_scan(torch.from_numpy(xdt).transpose(1, 2),
                             torch.from_numpy(la).transpose(1, 2),
                             torch.from_numpy(Bc), torch.from_numpy(Cc), chunk=chunk)
    np.testing.assert_allclose(_np(y.transpose(1, 2)), _np(want_y), atol=PALLAS_ATOL, rtol=0)
    np.testing.assert_allclose(_np(h), _np(want_h), atol=PALLAS_ATOL, rtol=0)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    x, Bc, Cc, la, h = map(torch.from_numpy, _scan_inputs(2, *RAGGED[:5], "random"))
    n = K4.launches
    y, hf = K4.ssd_chunk_scan(x, la, Bc, Cc, h, chunk=8)
    assert K4.launches == n                     # no kernel launch for CPU tensors
    py, ph = K4.ssd_chunk_scan_plain(x, la, Bc, Cc, h, chunk=8)
    assert torch.equal(y, py) and torch.equal(hf, ph)
    y0, h0 = K4.ssd_chunk_scan(x, la, Bc, Cc, None, chunk=8)
    yz, hz = K4.ssd_chunk_scan(x, la, Bc, Cc, torch.zeros_like(h), chunk=8)
    assert torch.equal(y0, yz) and torch.equal(h0, hz)
    yb, hb = K4.ssd_chunk_scan(x.bfloat16(), la, Bc.bfloat16(), Cc.bfloat16(), h, chunk=8)
    assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32
    empty = K4.ssd_chunk_scan(x[:, :0], la[:, :0], Bc[:, :0], Cc[:, :0], h, chunk=8)
    assert empty[0].shape == (2, 0, 3, 16) and torch.equal(empty[1], h)


def _bad(kind):
    x, Bc, Cc, la, h = map(torch.from_numpy, _scan_inputs(3, 2, 3, 16, 8, 4, "zero"))
    return {"x 3-d": (x[0], la, Bc, Cc, None, 8),
            "la heads-first": (x, la.transpose(1, 2), Bc, Cc, None, 8),
            "Bc/Cc differ": (x, la, Bc, Cc[..., :2], None, 8),
            "Bc time": (x, la, Bc[:, :8], Cc[:, :8], None, 8),
            "h0 shape": (x, la, Bc, Cc, h[..., :2], 8),
            "chunk 0": (x, la, Bc, Cc, None, 0)}[kind]


@pytest.mark.parametrize("kind", ["x 3-d", "la heads-first", "Bc/Cc differ",
                                  "Bc time", "h0 shape", "chunk 0"])
def test_wrapper_rejects_bad_shapes(kind):
    x, la, Bc, Cc, h0, chunk = _bad(kind)
    with pytest.raises(ValueError):
        K4.ssd_chunk_scan(x, la, Bc, Cc, h0, chunk=chunk)


def test_wrapper_runs_only_on_cpu_or_cuda():
    x, Bc, Cc, la, _ = (torch.from_numpy(a).to("meta")
                        for a in _scan_inputs(3, 2, 3, 16, 8, 4, "zero"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        K4.ssd_chunk_scan(x, la, Bc, Cc, chunk=8)


# ----------------------------------------------------- layers vs JAX ---
@pytest.fixture(scope="module")
def mamba():
    """Reduced zamba2 config and one Mamba2 layer's weights, the JAX init
    (with nonzero conv biases, norms and D) handed to both packages."""
    cfg = reduced_cfg("zamba2-7b")
    jp = JS.mamba2_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.RandomState(4)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    for k in ("conv_b_x", "conv_b_B", "conv_b_C", "ln", "norm", "D_skip"):
        jp[k] = jp[k] + (rng.standard_normal(jp[k].shape) * 0.1).astype(np.float32)
    return cfg, PortModelConfig(**dataclasses.asdict(cfg)), jp, params_from_jax(jp, device="cpu")


def _states(cfg, B, seed):
    rng = np.random.RandomState(seed)
    conv_s, ssm_s = JS.mamba2_state_shapes(cfg, B)
    conv = {k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in conv_s.items()}
    return conv, (rng.standard_normal(ssm_s) * 0.1).astype(np.float32)


def _t(tree):
    return ({k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
            if isinstance(tree, dict) else torch.from_numpy(np.array(tree)))


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()} if isinstance(tree, dict) else jnp.asarray(tree)


def test_causal_conv_matches_jax(mamba):
    cfg, _, jp, pp = mamba
    rng = np.random.RandomState(5)
    xbc = (rng.standard_normal((2, 7, cfg.ssm_state)) * 0.5).astype(np.float32)
    conv, _ = _states(cfg, 2, 6)
    jy, js = JS._causal_conv(jnp.asarray(xbc), jnp.asarray(conv["B"]),
                             jp["conv_B"], jp["conv_b_B"])
    py, ps = PS._causal_conv(torch.from_numpy(xbc), _t(conv["B"]), pp["conv_B"],
                             pp["conv_b_B"])
    np.testing.assert_allclose(_np(py), _np(jy), atol=LAYER_ATOL, rtol=0)
    np.testing.assert_array_equal(_np(ps), _np(js))


@pytest.mark.parametrize("T,chunk", [(20, 8), (16, 64)])
def test_mamba2_block_matches_jax(mamba, T, chunk):
    cfg, pcfg, jp, pp = mamba
    x = (np.random.RandomState(7).standard_normal((2, T, cfg.d_model)) * 0.5).astype(np.float32)
    conv, sst = _states(cfg, 2, 8)
    jy, jc, js = JS.mamba2_block(_j(jp), cfg, jnp.asarray(x), _j(conv), jnp.asarray(sst),
                                 chunk=chunk)
    py, pc, ps = PS.mamba2_block(pp, pcfg, torch.from_numpy(x), _t(conv), _t(sst),
                                 chunk=chunk)
    np.testing.assert_allclose(_np(py), _np(jy), atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(_np(ps), _np(js), atol=LAYER_ATOL, rtol=0)
    for k in jc:
        np.testing.assert_allclose(_np(pc[k]), _np(jc[k]), atol=LAYER_ATOL, rtol=0)


def test_mamba2_decode_matches_jax(mamba):
    cfg, pcfg, jp, pp = mamba
    x = (np.random.RandomState(9).standard_normal((3, cfg.d_model)) * 0.5).astype(np.float32)
    conv, sst = _states(cfg, 3, 10)
    jy, jc, js = JS.mamba2_decode(_j(jp), cfg, jnp.asarray(x), _j(conv), jnp.asarray(sst))
    py, pc, ps = PS.mamba2_decode(pp, pcfg, torch.from_numpy(x), _t(conv), _t(sst))
    np.testing.assert_allclose(_np(py), _np(jy), atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(_np(ps), _np(js), atol=LAYER_ATOL, rtol=0)
    for k in jc:
        np.testing.assert_allclose(_np(pc[k]), _np(jc[k]), atol=LAYER_ATOL, rtol=0)


def test_mamba2_block_equals_successive_decode_steps(mamba):
    """Port-side: the chunked block over T tokens (ragged last chunk,
    nonzero starting states) equals T recurrent steps."""
    _, pcfg, _, pp = mamba
    T = 13
    x = torch.from_numpy((np.random.RandomState(11).standard_normal(
        (2, T, pcfg.d_model)) * 0.5).astype(np.float32))
    conv, sst = map(_t, _states(pcfg, 2, 12))
    y, c_blk, s_blk = PS.mamba2_block(pp, pcfg, x, conv, sst, chunk=4)
    ys = []
    for t in range(T):
        yt, conv, sst = PS.mamba2_decode(pp, pcfg, x[:, t], conv, sst)
        ys.append(yt)
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(sst), _np(s_blk), atol=1e-5, rtol=0)
    for k in conv:
        assert torch.equal(conv[k], c_blk[k])


def test_mamba2_init_matches_reference_layout(mamba):
    """Names and shapes of the port's own init equal the reference's; its
    deterministic entries (zeros, ones, the A/dt ladders) equal them too."""
    cfg, pcfg, _, _ = mamba
    want = JS.mamba2_init(jax.random.PRNGKey(0), cfg, jnp.float32, stack=(3,))
    got = PS.mamba2_init(torch.Generator().manual_seed(0), pcfg, torch.float32, "cpu",
                         stack=(3,))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in ("ln", "conv_b_x", "conv_b_B", "conv_b_C", "A_log", "D_skip", "dt_bias", "norm"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=1e-6, rtol=0)
