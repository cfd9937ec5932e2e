"""The port's sampler: greedy equals the reference's argmax; sampled rows
are deterministic per (seed, rid, pos) and independent of the batch.

Sampled token *values* are not compared with the reference: JAX draws
from threefry, which PyTorch cannot reproduce.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.sampler import greedy_tokens as j_greedy
from repro_torch.core.sampler import greedy_tokens, sample_tokens


def _logits(seed, B=4, V=50):
    return np.random.RandomState(seed).standard_normal((B, V)).astype(np.float32)


def _sample(logits, temp, top_k, top_p, seed, rid, pos):
    B = logits.shape[0]

    def col(x, dt):
        return torch.tensor(np.broadcast_to(np.asarray(x), (B,)).copy(), dtype=dt)

    return sample_tokens(torch.from_numpy(logits), col(temp, torch.float32),
                         col(top_k, torch.int32), col(top_p, torch.float32),
                         col(seed, torch.int64), col(rid, torch.int64),
                         col(pos, torch.int64)).numpy()


def test_greedy_equals_reference_argmax_including_ties():
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
