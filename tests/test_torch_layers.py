"""The port's layer primitives and the plain versions of its attention
kernels against the reference package, on the CPU, at f32.

The reference's Pallas kernels run the way tests/test_kernels.py runs
them: through ``repro.kernels.ops`` in interpret mode.  Inputs come from
one numpy seed and are handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import ops as pops
from repro_torch.kernels import paged_attention as K1
from repro_torch.models import layers as PL

ATOL = 1e-5


def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("fn", ["rms_norm", "head_rms_norm"])
def test_norms_match_reference(fn):
    rng = np.random.RandomState(0)
    x, w = _rand(rng, 3, 5, 64, scale=2.0), _rand(rng, 64)
    _close(getattr(PL, fn)(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           getattr(JL, fn)(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.RandomState(1)
    x = _rand(rng, 2, 7, 4, 16, scale=1.0)
    pos = rng.randint(0, 4096, size=(2, 7)).astype(np.int32)
    _close(PL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_mlp"])
def test_mlp_matches_reference(act):
    rng = np.random.RandomState(2)
    D, F = 32, 48
    names = ("w_in", "w_out") if act == "gelu_mlp" else ("w_gate", "w_up", "w_down")
    shapes = {"w_in": (D, F), "w_out": (F, D), "w_gate": (D, F), "w_up": (D, F),
              "w_down": (F, D)}
    p = {n: _rand(rng, *shapes[n], scale=0.2) for n in names}
    x = _rand(rng, 5, D)
    _close(PL.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), act),
           JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act))


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_mlp"])
def test_mlp_init_matches_reference_layout(act):
    """Names and shapes of the reference's mlp_init, init scale 1/sqrt(fan_in)
    (the output matrix times n_layers_scale)."""
    want = JL.mlp_init(jax.random.PRNGKey(0), 64, 256, act, jnp.float32, 0.5, stack=(3,))
    got = PL.mlp_init(torch.Generator().manual_seed(0), 64, 256, act, torch.float32,
                      "cpu", 0.5, stack=(3,))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k, w in got.items():
        fan_in, scale = (256, 0.5) if k in ("w_out", "w_down") else (64, 1.0)
        assert abs(float(w.std()) * fan_in ** 0.5 / scale - 1.0) < 0.05


@pytest.mark.parametrize("window,cap,block", [(None, None, 8), (5, None, 16),
                                              (None, 20.0, 512), (6, 30.0, 8)])
def test_flash_attention_matches_reference(window, cap, block):
    rng = np.random.RandomState(3)
    B, Tq, Tk, H, KV, d = 2, 12, 20, 4, 2, 16
    q, k, v = _rand(rng, B, Tq, H, d), _rand(rng, B, Tk, KV, d), _rand(rng, B, Tk, KV, d)
    qpos = np.stack([np.arange(Tq) + 8, np.arange(Tq) + 3]).astype(np.int32)
    kvpos = np.broadcast_to(np.arange(Tk, dtype=np.int32), (B, Tk)).copy()
    lens = np.array([Tk, 14], np.int32)
    kw = dict(scale=0.25, causal=True, window=window, attn_softcap=cap, block_kv=block)
    port = PL.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              q_positions=torch.from_numpy(qpos),
                              kv_positions=torch.from_numpy(kvpos),
                              kv_valid_len=torch.from_numpy(lens), **kw)
    ref = JL.flash_attention(*map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qpos),
                             kv_positions=jnp.asarray(kvpos),
                             kv_valid_len=jnp.asarray(lens), **kw)
    _close(port, ref)


def _paged_inputs(seed, B, Tq, H, KV, d, ps, N, Pmax):
    rng = np.random.RandomState(seed)
    q = _rand(rng, B, Tq, H, d)
    kpg, vpg = _rand(rng, N, ps, KV, d), _rand(rng, N, ps, KV, d)
    bt = rng.permutation(N - 1)[: B * Pmax].reshape(B, Pmax).astype(np.int32)
    q_pos = rng.randint(0, Pmax * ps - Tq, size=B).astype(np.int32)
    return q, kpg, vpg, bt, q_pos + Tq, q_pos


def test_paged_attention_ref_matches_reference():
    q, kpg, vpg, bt, lens, q_pos = _paged_inputs(4, 3, 4, 4, 2, 32, 8, 16, 4)
    qpos = q_pos[:, None] + np.arange(4, dtype=np.int32)[None]
    kw = dict(scale=0.2, window=None, attn_softcap=None)
    port = PL.paged_attention_ref(*map(torch.from_numpy, (q, kpg, vpg, bt, lens, qpos)), **kw)
    ref = JL.paged_attention_ref(*map(jnp.asarray, (q, kpg, vpg, bt, lens, qpos)), **kw)
    _close(port, ref)


# B, Tq, H, KV, d, ps, N, Pmax — a subset of tests/test_kernels.py::PAGED_CASES
PAGED_CASES = [
    (3, 1, 4, 2, 64, 8, 16, 4),        # decode GQA
    (2, 1, 8, 8, 128, 16, 32, 3),      # decode MHA, 128-dim
    (2, 8, 4, 4, 64, 8, 16, 4),        # chunked prefill
    (1, 16, 6, 2, 32, 4, 32, 8),       # chunk, d=32
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_matches_pallas(case):
    args = _paged_inputs(0, *case)
    port = K1.paged_attention(*map(torch.from_numpy, args), scale=0.2)
    ref = jops.paged_attention(*map(jnp.asarray, args), scale=0.2, interpret=True)
    _close(port, ref)


@pytest.mark.parametrize("softcap,window", [(20.0, None), (None, 7), (30.0, 5)])
def test_paged_plain_softcap_window_matches_pallas(softcap, window):
    args = _paged_inputs(3, 2, 4, 4, 2, 64, 8, 16, 4)
    port = pops.paged_attention(*map(torch.from_numpy, args), scale=0.2,
                                softcap=softcap, window=window)
    ref = jops.paged_attention(*map(jnp.asarray, args), scale=0.2, softcap=softcap,
                               window=window, interpret=True)
    _close(port, ref)


# B, T, Tk, H, KV, d, bq, bk — tests/test_kernels.py::FLASH_CASES
FLASH_CASES = [
    (2, 32, 32, 4, 2, 64, 8, 8),
    (1, 64, 64, 8, 8, 128, 16, 16),
    (2, 16, 16, 6, 2, 32, 16, 8),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas(case):
    B, T, Tk, H, KV, d, bq, bk = case
    rng = np.random.RandomState(0)
    q, k, v = _rand(rng, B, T, H, d), _rand(rng, B, Tk, KV, d), _rand(rng, B, Tk, KV, d)
    lens = np.asarray([Tk] + [Tk - 5] * (B - 1), np.int32)
    port = K2.flash_attention(*map(torch.from_numpy, (q, k, v, lens)), scale=0.2)
    ref = jops.flash_attention(*map(jnp.asarray, (q, k, v, lens)), scale=0.2,
                               block_q=bq, block_k=bk, interpret=True)
    _close(port, ref)


def test_flash_plain_window_softcap_matches_pallas():
    rng = np.random.RandomState(7)
    B, T, H, KV, d = 1, 32, 4, 4, 64
    q, k, v = _rand(rng, B, T, H, d), _rand(rng, B, T, KV, d), _rand(rng, B, T, KV, d)
    lens = np.asarray([T], np.int32)
    port = pops.flash_attention(*map(torch.from_numpy, (q, k, v, lens)), scale=0.2,
                                window=8, softcap=25.0)
    ref = jops.flash_attention(*map(jnp.asarray, (q, k, v, lens)), scale=0.2, window=8,
                               softcap=25.0, block_q=8, block_k=8, interpret=True)
    _close(port, ref)


def test_paged_empty_and_inactive_rows_are_finite_zero():
    """kv_len = 0 rows (empty streams) give zeros, not NaN, and a
    zero-row batch (the decode half of a prefill-only step) is empty."""
    args = [torch.from_numpy(a) for a in _paged_inputs(5, 2, 4, 4, 2, 16, 4, 12, 3)]
    args[4] = torch.tensor([0, 5], dtype=torch.int32)
    args[5] = torch.tensor([0, 1], dtype=torch.int32)
    out = K1.paged_attention(*args, scale=0.3)
    assert torch.isfinite(out).all() and bool((out[0] == 0).all())
    empty = [a[:0] for a in args[:1]] + args[1:3] + [a[:0] for a in args[3:]]
    assert K1.paged_attention(*empty, scale=0.3).shape == (0, 4, 4, 16)


def test_wrappers_check_arguments_and_count_only_launches():
    q, kpg, vpg, bt, lens, q_pos = map(torch.from_numpy,
                                       _paged_inputs(6, 2, 1, 4, 2, 16, 4, 12, 3))
    before = (K1.launches, K2.launches)
    K1.paged_attention(q, kpg, vpg, bt, lens, q_pos, scale=0.3)   # CPU: plain
    with pytest.raises(ValueError, match="block_table"):
        K1.paged_attention(q, kpg, vpg, bt[:1], lens, q_pos, scale=0.3)
    with pytest.raises(ValueError, match="dtypes"):
        K1.paged_attention(q.double(), kpg, vpg, bt, lens, q_pos, scale=0.3)
    with pytest.raises(ValueError, match="integer"):
        K2.flash_attention(q, kpg[:2, :, :, :], vpg[:2], lens.float(), scale=0.3)
    assert (K1.launches, K2.launches) == before
