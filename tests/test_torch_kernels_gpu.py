"""The port's CUDA kernels against their plain PyTorch versions, and the
engine on the card against the engine on the CPU.

Every test here needs a CUDA device and skips itself without one.  This
file imports neither JAX nor the reference package, so it also runs on a
machine without them:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ServeConfig, get_config
from repro_torch.core.engine import Engine, Request
from repro_torch.core.sampler import SamplingParams
from repro_torch.kernels import flash_attention as K2
from repro_torch.kernels import paged_attention as K1
from repro_torch.kernels import paged_attention_int8 as K3
from repro_torch.kernels.kv_int8 import SCALE_FLOOR, q8_kv
from repro_torch.models.registry import get_model

pytestmark = pytest.mark.gpu
TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # f32: FMA order; bf16: output rounding

# B, C, H, KV, d, ps, N, Pmax — tests/test_kernels.py's paged cases
PAGED_CASES = [(3, 1, 4, 2, 64, 8, 16, 4), (2, 1, 8, 8, 128, 16, 32, 3),
               (2, 8, 4, 4, 64, 8, 16, 4), (1, 16, 6, 2, 32, 4, 32, 8),
               (2, 4, 4, 4, 112, 8, 16, 4)]
# B, T, Tk, H, KV, d
FLASH_CASES = [(2, 32, 32, 4, 2, 64), (1, 64, 64, 8, 8, 128), (2, 16, 16, 6, 2, 32),
               (2, 37, 37, 16, 8, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape):
    return torch.from_numpy((rng.standard_normal(shape) * 0.5).astype(np.float32))


def _paged(seed, B, C, H, KV, d, ps, N, Pmax, dtype):
    rng = np.random.RandomState(seed)
    q, kpg, vpg = (_rand(rng, B, C, H, d), _rand(rng, N, ps, KV, d),
                   _rand(rng, N, ps, KV, d))
    bt = torch.from_numpy(rng.permutation(N - 1)[: B * Pmax].reshape(B, Pmax))
    q_pos = torch.from_numpy(rng.randint(0, Pmax * ps - C, size=B))
    args = [q, kpg, vpg, bt, q_pos + C, q_pos]
    return ([a.to("cuda", dtype) for a in args[:3]]
            + [a.to("cuda", torch.int32) for a in args[3:]])


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain(cuda, case, dtype):
    args = _paged(0, *case, getattr(torch, dtype))
    n = K1.launches
    out = K1.paged_attention(*args, scale=0.2)
    torch.cuda.synchronize()
    assert K1.launches == n + 1
    assert _err(out, K1.paged_attention_plain(*args, scale=0.2)) <= TOL[dtype]


@pytest.mark.parametrize("softcap,window", [(20.0, None), (None, 7), (30.0, 5)])
def test_paged_kernel_softcap_window(cuda, softcap, window):
    args = _paged(3, 2, 4, 4, 2, 64, 8, 16, 4, torch.float32)
    kw = dict(scale=0.2, softcap=softcap, window=window)
    assert _err(K1.paged_attention(*args, **kw),
                K1.paged_attention_plain(*args, **kw)) <= TOL["float32"]


def test_paged_kernel_empty_rows_and_stale_table(cuda):
    """kv_len = 0 gives zeros; table entries past ceil(kv_len/ps) are
    never read (here: ids far outside the pool)."""
    args = _paged(5, 3, 4, 4, 2, 16, 4, 12, 3, torch.float32)
    args[4] = torch.tensor([0, 5, 9], dtype=torch.int32, device="cuda")
    args[5] = torch.tensor([0, 1, 5], dtype=torch.int32, device="cuda")
    want = K1.paged_attention_plain(*args, scale=0.3)
    args[3][1, 2] = 10**6                       # slot 2 lies past ceil(5/4) = 2
    out = K1.paged_attention(*args, scale=0.3)
    assert bool((out[0] == 0).all()) and _err(out, want) <= TOL["float32"]
    empty = [args[0][:0]] + args[1:3] + [a[:0] for a in args[3:]]
    assert K1.paged_attention(*empty, scale=0.3).shape == (0, 4, 4, 16)


def _paged_int8(seed, B, C, H, KV, d, ps, N, Pmax, dtype):
    """K3's inputs: K1's, with the pages as int8 codes and f32 scales."""
    q, kpg, vpg, bt, lens, q_pos = _paged(seed, B, C, H, KV, d, ps, N, Pmax, torch.float32)
    (kq, ks), (vq, vs) = q8_kv(kpg), q8_kv(vpg)
    return [q.to(dtype), kq, ks, vq, vs, bt, lens, q_pos]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_int8_kernel_matches_plain(cuda, case, dtype):
    args = _paged_int8(0, *case, getattr(torch, dtype))
    n = K3.launches
    out = K3.paged_attention_int8(*args, scale=0.2)
    torch.cuda.synchronize()
    assert K3.launches == n + 1                 # a CUDA tensor launches, never plain
    assert _err(out, K3.paged_attention_int8_plain(*args, scale=0.2)) <= TOL[dtype]


@pytest.mark.parametrize("softcap,window", [(20.0, None), (None, 7), (30.0, 5)])
def test_paged_int8_kernel_softcap_window(cuda, softcap, window):
    args = _paged_int8(3, 2, 4, 4, 2, 64, 8, 16, 4, torch.float32)
    kw = dict(scale=0.2, softcap=softcap, window=window)
    assert _err(K3.paged_attention_int8(*args, **kw),
                K3.paged_attention_int8_plain(*args, **kw)) <= TOL["float32"]


def test_paged_int8_kernel_empty_rows_zero_pages_and_stale_table(cuda):
    """kv_len = 0 gives zeros; all-zero pages with floored scales
    dequantize to 0; table entries past ceil(kv_len/ps) are never read."""
    args = _paged_int8(5, 3, 4, 4, 2, 16, 4, 12, 3, torch.float32)
    args[6] = torch.tensor([0, 5, 9], dtype=torch.int32, device="cuda")
    args[7] = torch.tensor([0, 1, 5], dtype=torch.int32, device="cuda")
    zero = args[5][2, 0].long()
    for codes, scales in ((args[1], args[2]), (args[3], args[4])):
        codes[zero], scales[zero] = 0, SCALE_FLOOR
    want = K3.paged_attention_int8_plain(*args, scale=0.3)
    args[5][1, 2] = 10**6                       # slot 2 lies past ceil(5/4) = 2
    out = K3.paged_attention_int8(*args, scale=0.3)
    assert torch.isfinite(out).all() and bool((out[0] == 0).all())
    assert _err(out, want) <= TOL["float32"]
    empty = [args[0][:0]] + args[1:5] + [a[:0] for a in args[5:]]
    assert K3.paged_attention_int8(*empty, scale=0.3).shape == (0, 4, 4, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, T, Tk, H, KV, d = case
    rng = np.random.RandomState(0)
    dt = getattr(torch, dtype)
    q, k, v = (x.to("cuda", dt) for x in (_rand(rng, B, T, H, d), _rand(rng, B, Tk, KV, d),
                                          _rand(rng, B, Tk, KV, d)))
    lens = torch.tensor([Tk] + [Tk - 5] * (B - 1), dtype=torch.int32, device="cuda")
    for kw in (dict(), dict(window=8, softcap=25.0), dict(causal=False)):
        n = K2.launches
        out = K2.flash_attention(q, k, v, lens, scale=0.2, **kw)
        assert K2.launches == n + 1
        assert _err(out, K2.flash_attention_plain(q, k, v, lens, scale=0.2, **kw)) <= TOL[dtype]


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("mode", ["sequential", "splitwiser", "splitwiser_mps", "chunked"])
def test_engine_on_card_matches_cpu(cuda, mode, kv_dtype):
    """Greedy streams on the card (kernels) equal those on the CPU (plain
    versions), f32, reduced qwen3-0.6b, with fp and with int8 pages (the
    latter under the step sanitizer)."""
    model = get_model("qwen3-0.6b", get_config("qwen3-0.6b").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    serve = ServeConfig(mode=mode, max_batch=4, page_size=4, n_pages=128,
                        max_pages_per_seq=16, prefill_chunk=4, n_streams=2,
                        kv_dtype=kv_dtype,
                        sanitize_level="step" if kv_dtype == "int8" else "off",
                        dispatch_sentinel=False)
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(2, 256, size=rng.randint(5, 20))]
               for _ in range(6)]
    streams = {}
    for dev in ("cuda", "cpu"):
        reqs = [Request(rid=i, prompt=p, sampling=SamplingParams(max_new_tokens=6))
                for i, p in enumerate(prompts)]
        Engine(model, params, serve, device=dev).run(reqs)
        streams[dev] = [r.out_tokens for r in reqs]
    assert streams["cuda"] == streams["cpu"]
