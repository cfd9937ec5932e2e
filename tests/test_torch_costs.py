"""The port's cost model (``repro_torch.launch.costs``) and roofline
against the reference's on the CPU.

Unit cases, one per category of the reference's jaxpr walk (dot, conv,
gather, scatter, reduce, transcendental, and a kernel region fed by a
gather), give the same FLOPs and bytes in both packages.  Six rows of
``benchmarks/phase_intensity.py`` (the paper's Figs. 2-4 on full-size
opt-125m) give FLOPs within 1% of the reference's; bytes are printed side
by side but not compared (the port counts what its own code moves, e.g.
a gather feeding flash attention through views once).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.common.hw import TPU_V5E
from repro.configs import get_config as jax_get_config
from repro.launch.costs import traced_costs as jax_traced_costs
from repro.models import transformer as JT
from repro.models.registry import CACHE_KIND, FAMILY_MODULE, Model
from repro_torch.common.hw import H100_SXM, TPU_V5E as PORT_TPU_V5E
from repro_torch.configs import get_config
from repro_torch.launch.costs import fake_mode, kernel_region, traced_costs
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model

PAGE = 16         # phase_intensity's page size


def test_hw_spec_copies_the_reference_and_adds_the_h100():
    assert PORT_TPU_V5E.__dict__ == {**TPU_V5E.__dict__, "peak_flops_f32": None,
                                     "peak_flops_tf32": None}
    assert H100_SXM.peak_flops_bf16 == 989e12 and H100_SXM.hbm_bw == 3.35e12
    assert H100_SXM.peak_flops_f32 == 67e12 and H100_SXM.hbm_bytes == 80 * 10**9
    assert H100_SXM.peak_flops_tf32 == 494.7e12
    assert 290 < H100_SXM.peak_flops_bf16 / H100_SXM.hbm_bw < 300


def test_costs_exact_on_matmul_and_loop():
    """The counterpart of test_jaxpr_costs_exact_on_matmul_and_scan: a
    Python loop needs no trip multiplier, every iteration dispatches."""
    c = traced_costs(lambda a, b: a @ b, torch.zeros(8, 32), torch.zeros(32, 16))
    assert c["flops"] == 2 * 8 * 32 * 16
    assert c["bytes"] == (8 * 32 + 32 * 16 + 8 * 16) * 4

    def g(a, b):
        for _ in range(10):
            a = a @ b
        return a
    c2 = traced_costs(g, torch.zeros(8, 32), torch.zeros(32, 32))
    assert c2["flops"] == 10 * 2 * 8 * 32 * 32


@kernel_region
def _toy_region(h, xs):
    for x in xs:
        h = h + torch.exp(x).sum(0)
    return h


def _jax_toy(table, idx, h0):
    xs = table[idx].reshape(5, 4, 16)

    def toy_vmem_body(h, x):
        return h + jnp.exp(x).sum(0), None
    return jax.lax.scan(toy_vmem_body, h0, xs)[0]


# (port fn, reference fn, argument shapes and dtypes)
_F32, _I32 = np.float32, np.int32
UNIT_CASES = {
    "dot": (lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
            lambda a, b: jnp.einsum("bmk,bkn->bmn", a, b),
            [((3, 8, 32), _F32), ((3, 32, 16), _F32)]),
    "conv": (lambda x, w: F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0)),
             lambda x, w: jax.lax.conv_general_dilated(
                 x, w, (1,), "VALID", dimension_numbers=("NWC", "WIO", "NWC")),
             [((2, 10, 4), _F32), ((3, 4, 6), _F32)]),
    "gather": (lambda t, i: t[i] * 2.0, lambda t, i: t[i] * 2.0,
               [((64, 16), _F32), ((10,), _I32)]),
    "scatter": (lambda p, i, u: p.clone().index_put_((i,), u),
                lambda p, i, u: p.at[i].set(u),
                [((64, 16), _F32), ((10,), _I32), ((10, 16), _F32)]),
    "reduce": (lambda x: x.sum(-1) + x.amax(-1), lambda x: x.sum(-1) + x.max(-1),
               [((6, 40), _F32)]),
    "transcendental": (lambda x: torch.exp(x) + torch.tanh(x) * torch.rsqrt(x),
                       lambda x: jnp.exp(x) + jnp.tanh(x) * jax.lax.rsqrt(x),
                       [((6, 40), _F32)]),
    "region fed by a gather": (lambda t, i, h: _toy_region(h, t[i].reshape(5, 4, 16)),
                               _jax_toy,
                               [((64, 16), _F32), ((20,), _I32), ((16,), _F32)]),
}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_unit_case_matches_reference(case):
    port_fn, jax_fn, specs = UNIT_CASES[case]
    rng = np.random.RandomState(0)
    arrs = [rng.randint(0, 64, size=s).astype(d) if d is _I32 else rng.randn(*s).astype(d)
            for s, d in specs]
    want = jax_traced_costs(jax_fn, *[jnp.asarray(a) for a in arrs])
    got = traced_costs(port_fn, *[torch.from_numpy(a) for a in arrs])
    assert want["flops"] > 0 or want["bytes"] > 0
    assert (got["flops"], got["bytes"]) == (want["flops"], want["bytes"]), (got, want)


def test_region_interior_bytes_and_peak():
    """Inside a region only FLOPs count; its intermediates are not live."""
    x = torch.zeros(4, 8, 64)
    c = traced_costs(lambda h, xs: _toy_region(h, xs), torch.zeros(64), x)
    assert c["bytes"] == (64 + 4 * 8 * 64 + 64) * 4
    assert c["flops"] == 4 * (4 * 8 * 64 + 8 * 64)
    assert c["peak_bytes"] == (64 + 4 * 8 * 64 + 64) * 4


def test_peak_live_bytes_counts_views_once_and_frees():
    def f(a):
        b = a * 2.0                 # new: 4 KiB
        v = b.reshape(-1).t()       # views: nothing
        del b
        return v + 1.0              # new: 4 KiB, b still alive through v
    c = traced_costs(f, torch.zeros(32, 32))
    assert c["peak_bytes"] == 3 * 32 * 32 * 4


# ------------------------------------------- phase_intensity on opt-125m --
@functools.lru_cache(maxsize=None)
def _port_setup():
    model = get_model("opt-125m")
    mode = fake_mode()
    with mode:
        params = model.init(torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    return model.cfg, mode, params


@functools.lru_cache(maxsize=None)
def _jax_setup():
    cfg = jax_get_config("opt-125m")
    model = Model("opt-125m", cfg, FAMILY_MODULE[cfg.family], CACHE_KIND[cfg.family])
    return cfg, jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.bfloat16))


# (kind, batch, tokens or context, pages in the pool): phase_intensity's rows
ROWS = {"prefill s=128": ("prefill", 1, 128, 0),
        "prefill s=2048": ("prefill", 1, 2048, 0),
        "decode ctx=128": ("decode", 1, 128, 128 // PAGE + 4),
        "decode ctx=2048": ("decode", 1, 2048, 2048 // PAGE + 4),
        "decode B=1": ("decode", 1, 512, (512 // PAGE + 2) * 40 + 4),
        "decode B=40": ("decode", 40, 512, (512 // PAGE + 2) * 40 + 4)}


@functools.lru_cache(maxsize=None)
def port_row(name):
    kind, b, n, n_pages = ROWS[name]
    cfg, mode, params = _port_setup()
    with mode:
        if kind == "prefill":
            args = (torch.zeros(b, n, dtype=torch.int32),)
        else:
            pool = (cfg.n_layers, n_pages, PAGE, cfg.n_kv_heads, cfg.head_dim)
            args = (torch.zeros(b, dtype=torch.int32), torch.zeros(pool, dtype=torch.bfloat16),
                    torch.zeros(pool, dtype=torch.bfloat16),
                    torch.zeros(b, n // PAGE + 1, dtype=torch.int32),
                    torch.zeros(b, dtype=torch.int32))
    if kind == "prefill":
        return traced_costs(lambda p, t: T.prefill(p, cfg, t)[0], params, *args)
    return traced_costs(lambda p, *a: T.decode(p, cfg, *a)[0], params, *args)


def jax_row(name):
    kind, b, n, n_pages = ROWS[name]
    cfg, params = _jax_setup()
    S = jax.ShapeDtypeStruct
    if kind == "prefill":
        return jax_traced_costs(lambda p, t: JT.prefill(p, cfg, t)[0], params,
                                S((b, n), jnp.int32))
    pool = S((cfg.n_layers, n_pages, PAGE, cfg.n_kv_heads, cfg.head_dim), jnp.bfloat16)
    return jax_traced_costs(lambda p, *a: JT.decode(p, cfg, *a)[0], params,
                            S((b,), jnp.int32), pool, pool,
                            S((b, n // PAGE + 1), jnp.int32), S((b,), jnp.int32))


@pytest.mark.parametrize("name", list(ROWS))
def test_phase_intensity_row_flops_match_reference(name):
    got, want = port_row(name), jax_row(name)
    print(f"{name}: flops {got['flops']:.4e} vs {want['flops']:.4e}; "
          f"bytes {got['bytes']:.4e} vs {want['bytes']:.4e} (port vs reference)")
    assert got["flops"] == pytest.approx(want["flops"], rel=0.01)
    assert got["bytes"] > 0 and got["peak_bytes"] > 0


def test_phase_intensity_physics_on_the_h100():
    """Prefill's intensity rises with its length and lies above the
    H100's ridge at 2048 tokens; decode at B = 1 stays below 10 FLOP/B."""
    ridge = H100_SXM.peak_flops_bf16 / H100_SXM.hbm_bw
    ai = {name: port_row(name)["flops"] / port_row(name)["bytes"]
          for name in ("prefill s=128", "prefill s=2048", "decode B=1")}
    assert ai["prefill s=128"] < ai["prefill s=2048"]
    assert ai["prefill s=2048"] > ridge
    assert ai["decode B=1"] < 10


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "mixed_32k"])
def test_model_flops_estimate_matches_reference(arch, shape):
    from repro.launch.roofline import model_flops_estimate as jax_estimate
    from repro_torch.launch.roofline import model_flops_estimate
    assert model_flops_estimate(get_config(arch), shape) == jax_estimate(
        jax_get_config(arch), shape)
