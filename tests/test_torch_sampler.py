"""The port's sampler: greedy equals the reference's argmax; sampled rows
are deterministic per (seed, rid, pos) and independent of the batch.

Sampled token *values* are not compared with the reference: JAX draws
from threefry, which PyTorch cannot reproduce.  JAX and the reference are
imported inside the one test that compares with them, so the ``gpu``
case loads on a machine without them:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_sampler.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sampler import greedy_tokens, sample_tokens


def _logits(seed, B=4, V=50):
    return np.random.RandomState(seed).standard_normal((B, V)).astype(np.float32)


def _sample(logits, temp, top_k, top_p, seed, rid, pos, device="cpu"):
    B = logits.shape[0]

    def col(x, dt):
        return torch.tensor(np.broadcast_to(np.asarray(x), (B,)).copy(), dtype=dt)

    return sample_tokens(torch.from_numpy(logits).to(device), col(temp, torch.float32),
                         col(top_k, torch.int32), col(top_p, torch.float32),
                         col(seed, torch.int64), col(rid, torch.int64),
                         col(pos, torch.int64)).cpu().numpy()


def test_greedy_equals_reference_argmax_including_ties():
    import jax.numpy as jnp
    from repro.core.sampler import greedy_tokens as j_greedy
    lg = _logits(0, B=6)
    lg[1, [3, 17, 40]] = 9.0                    # a three-way tie: first wins
    lg[2, :] = 0.0                              # all equal: index 0
    got = greedy_tokens(torch.from_numpy(lg)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_greedy(jnp.asarray(lg))))
    assert got[1] == 3 and got[2] == 0
    # temperature 0 rows of the full sampler take the same argmax
    np.testing.assert_array_equal(_sample(lg, 0.0, 0, 1.0, 0, 0, 0), got)


def test_sampled_rows_are_deterministic_and_batch_independent():
    lg = _logits(1, B=4)
    rid, pos = np.arange(4) + 10, np.asarray([0, 3, 3, 7])
    full = _sample(lg, 0.9, 0, 1.0, 5, rid, pos)
    np.testing.assert_array_equal(full, _sample(lg, 0.9, 0, 1.0, 5, rid, pos))
    for i in range(4):                           # alone, or in another batch
        alone = _sample(lg[i:i + 1], 0.9, 0, 1.0, 5, rid[i:i + 1], pos[i:i + 1])
        assert alone[0] == full[i]
    mixed = _sample(lg[::-1].copy(), 0.9, 0, 1.0, 5, rid[::-1], pos[::-1])
    np.testing.assert_array_equal(mixed[::-1], full)
    # the stream key is (seed, rid, pos): changing any part changes draws
    draws = {tuple(_sample(np.tile(lg[:1], (64, 1)), 5.0, 0, 1.0, s, np.arange(64), 0))
             for s in (0, 1)}
    assert len(draws) == 2


def test_top_k_and_top_p_restrict_the_support():
    lg = np.tile(_logits(2, B=1), (256, 1))
    rid = np.arange(256)
    top3 = set(np.argsort(-lg[0])[:3])
    assert set(_sample(lg, 2.0, 3, 1.0, 0, rid, 0)) <= top3
    # a nucleus that only the top token fills
    peaked = lg.copy()
    peaked[:, 7] = 50.0
    assert set(_sample(peaked, 1.0, 0, 0.5, 0, rid, 0)) == {7}


def test_sampled_streams_are_mode_independent():
    """The engine samples row i from (seed, rid, len(out_tokens)), so a
    sampled request's stream does not depend on the serving mode."""
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.core.engine import Engine, Request
    from repro_torch.core.sampler import SamplingParams
    from repro_torch.models.registry import get_model
    model = get_model("qwen3-0.6b", get_config("qwen3-0.6b").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(4)
    prompts = [[int(t) for t in rng.randint(2, 256, size=n)] for n in (7, 12, 5)]
    streams = []
    for mode in ("sequential", "splitwiser_mps", "chunked"):
        serve = ServeConfig(mode=mode, max_batch=2, page_size=4, n_pages=64,
                            max_pages_per_seq=8, prefill_chunk=4, n_streams=2, chunk_tokens=8,
                            sanitize_level="off", dispatch_sentinel=False)
        reqs = [Request(rid=i, prompt=p, sampling=SamplingParams(
                    max_new_tokens=6, temperature=1.0 if i != 1 else 0.0,
                    top_k=20 * (i == 2), seed=9))
                for i, p in enumerate(prompts)]
        Engine(model, params, serve, device="cpu").run(reqs)
        streams.append([r.out_tokens for r in reqs])
    assert streams[0] == streams[1] == streams[2]


def _untied_logits(seed, B, V):
    """Logits [B, V] on a grid of 1/16 with distinct values per row: no
    two candidates of a row tie, and the scaled and masked values are
    computed exactly on either device."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(V) for _ in range(B)]).astype(np.float32) / 16.0


@pytest.mark.gpu
def test_sample_tokens_on_cuda_logits():
    """On the card: greedy rows are the argmax, a row's token does not
    depend on the batch around it, and the tokens equal the same call on
    the CPU copy of the logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, V = 12, 4096
    lg = _untied_logits(5, B, V)
    rid, pos = np.arange(B) + 3, np.arange(B) % 5
    temp = np.where(np.arange(B) % 3 == 0, 0.0, 1.0).astype(np.float32)
    top_k = np.where(np.arange(B) % 3 == 1, 40, 0)
    top_p = np.where(np.arange(B) % 3 == 2, 0.9, 1.0).astype(np.float32)
    on_card = _sample(lg, temp, top_k, top_p, 11, rid, pos, device="cuda")
    greedy = np.arange(B) % 3 == 0
    np.testing.assert_array_equal(on_card[greedy], lg[greedy].argmax(-1))
    np.testing.assert_array_equal(on_card, _sample(lg, temp, top_k, top_p, 11, rid, pos))
    for i in range(B):                           # alone, or reversed in the batch
        assert _sample(lg[i:i + 1], temp[i:i + 1], top_k[i:i + 1], top_p[i:i + 1], 11,
                       rid[i:i + 1], pos[i:i + 1], device="cuda")[0] == on_card[i]
    rev = _sample(lg[::-1].copy(), temp[::-1], top_k[::-1], top_p[::-1], 11, rid[::-1],
                  pos[::-1], device="cuda")
    np.testing.assert_array_equal(rev[::-1], on_card)
