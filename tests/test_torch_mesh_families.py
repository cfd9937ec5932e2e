"""The port's sharded serving steps of the four families beyond the
transformer's dense and MoE ones (the zamba2 hybrid, rwkv6, seamless-m4t's
encoder-decoder, internvl2's patch prefix) against the reference's own
sharded steps, on the CPU.

- Whole steps (``mesh_family_ranks.py``'s scenario): prefill, 4 greedy
  decode steps from the reference's prefilled pools, states and cross K/V
  (fed the port's own tokens), internvl2's mixed steps and rwkv6's
  ``rwkv.mixed``, through ``launch/steps.py``'s sharded cells on gloo
  ranks spawned on the CPU at meshes 2 x 2 and 1 x 4, against the
  reference's steps on a forced 4-device mesh of the same shape (one
  subprocess, ``spmd_family_reference.py``): the 1 x 4 mesh pads reduced
  zamba2's, seamless's and internvl2's 2 KV heads to 4 and gives each rank
  one of reduced zamba2's 4 SSM heads.  Logits within 1e-4, greedy tokens
  equal, pages (but the trash pages), conv and SSM states, RWKV states,
  prefill K/V and cross K/V within 1e-5 a shard.
- Unit cases on a 1 x 2 mesh, each held to the reference's one-device
  function: the sharded gated norm (``models/sharding.py::rms_norm``), one
  Mamba2 block and a recurrent step from its states, and the vocab-parallel
  embedding of encdec's and rwkv6's tables; a Mamba2 shard that would
  split a head raises ``ValueError``; a decode batch that does not divide
  over data > 1 builds replicated over data (seamless-m4t's raises
  ``ValueError``, as the reference's step does).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mesh_family_ranks as F
import mesh_ranks as M
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

from repro_torch.configs import get_config
from repro_torch.models import ssm

HERE = Path(__file__).resolve().parent
LOGIT_TOL, CACHE_TOL, UNIT_TOL = 1e-4, 1e-5, 1e-5
KINDS = {"hybrid": ("prefill", "decode"), "ssm": ("prefill", "decode", "mixed"),
         "encdec": ("prefill", "decode"), "vlm": ("prefill", "decode", "mixed")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded steps (one subprocess), then the port's
    ranks: one world of 4 (every family at meshes 2 x 2 and 1 x 4), one of
    2 (the unit cases)."""
    tmp = tmp_path_factory.mktemp("families")
    case_path = tmp / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(HERE / "spmd_family_reference.py"),
                          str(case_path)], env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    M.run_ranks(tmp, 4, M.run_all, *[(F.rank_main, (str(case_path), str(tmp), fam, F.MESHES))
                                     for fam in F.ARCHS])
    M.run_ranks(tmp, 2, F.unit_main, str(case_path), str(tmp))
    return tmp, np.load(case_path)


@pytest.mark.parametrize("fam,kind", [(f, k) for f in F.ARCHS for k in KINDS[f]])
@pytest.mark.parametrize("shape", F.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_family_sharded_steps_match_reference(runs, shape, fam, kind):
    out_dir, case = runs
    r = F.compare(out_dir, case, fam, shape, kind)
    assert r["ranks"] == shape[0] * shape[1] and r["compared"] > 0, r
    assert r["logit_gap"] <= LOGIT_TOL, r
    assert r["tokens_equal"], r
    assert r["cache_gap"] <= CACHE_TOL, r


@pytest.mark.parametrize("fam", list(F.ARCHS))
def test_replicated_decode_batch_raises_over_data(runs, fam):
    """A decode batch that does not divide over 2 data shards (long_500k's
    one sequence) is the reference's replicated batch: its cell builds,
    replicated over data with its caches (parity with the reference's
    steps: ``test_torch_mesh_train_families.py``), but for seamless-m4t,
    whose reference step shards its batch over data and so raises, as the
    port does (``ValueError``, naming no ROADMAP item)."""
    out_dir, _ = runs
    for r in range(4):
        got = str(np.load(out_dir / f"{fam}-2x2-rank{r}.npz")["replicated_batch"])
        if fam == "encdec":
            assert got.startswith("ValueError") and "shards its batch" in got, got
            assert "item" not in got, got
        else:
            assert "replicated over data" in got and "B=1" in got, got


def _unit(out_dir, name):
    return [np.load(out_dir / f"unit-rank{r}.npz")[name] for r in range(2)]


def test_sharded_gated_norm_matches_reference(runs):
    """RMS norm over a dim split over 2 model ranks: each rank's columns of
    the reference's norm over the whole dim."""
    out_dir, case = runs
    want = case["unit/want_norm"]
    d = want.shape[-1] // 2
    for m, got in enumerate(_unit(out_dir, "norm")):
        assert np.abs(got - want[..., m * d:(m + 1) * d]).max() <= UNIT_TOL


def test_mamba2_block_on_two_ranks_matches_reference(runs):
    """One Mamba2 block (3 chunks of 8) and a recurrent step from its
    states on a 1 x 2 mesh: 2 of reduced zamba2's 4 heads a rank; y whole
    on each rank, conv x state and SSM state the rank's channels and heads."""
    out_dir, case = runs
    for m in range(2):
        o = np.load(out_dir / f"unit-rank{m}.npz")
        coords, sizes = {"model": m}, {"model": 2}
        for name, spec in (("y", ()), ("y1", ()), ("h", (None, "model")),
                           ("h1", (None, "model")), ("conv_x", (None, None, "model")),
                           ("conv_B", ()), ("conv1_x", (None, None, "model")),
                           ("conv1_C", ())):
            want = F.cut(case[f"unit/want_mamba_{name}"], spec, coords, sizes)
            assert o[f"mamba_{name}"].shape == want.shape, name
            assert np.abs(o[f"mamba_{name}"] - want).max() <= UNIT_TOL, name


@pytest.mark.parametrize("fam", ["encdec", "ssm"])
def test_vocab_parallel_embedding_matches_reference(runs, fam):
    """The rank's vocab rows masked and summed over 2 model ranks equal the
    reference's lookup (ids 0 and vocab - 1 included; no scale for either
    family's config)."""
    out_dir, case = runs
    arch = F.ARCHS[fam][0]
    assert not get_config(arch).emb_scale_by_sqrt_dim
    for got in _unit(out_dir, f"embed_{fam}"):
        assert np.abs(got - case[f"unit/want_embed_{fam}"]).max() == 0.0


def test_mamba2_shard_that_splits_a_head_raises():
    """2 heads of 64 channels over 4 model ranks: each rank's 32 channels
    would be half a head."""
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), ssm_heads=2)

    class Rank1Of4:             # rank 1 of a 1 x 4 mesh, no process group needed
        tp = 4

        @staticmethod
        def index(axis):
            return 1

    lp = {"wx": torch.zeros(cfg.d_model, 2 * cfg.d_model // 4)}
    x = torch.zeros(1, 3, cfg.d_model)
    with pytest.raises(ValueError, match="whole heads"):
        ssm.mamba2_block(lp, cfg, x, None, None, policy=Rank1Of4())
    with pytest.raises(ValueError, match="whole heads"):
        ssm.mamba2_decode(lp, cfg, x[:, 0], None, None, policy=Rank1Of4())
    with pytest.raises(ValueError, match="whole heads"):
        ssm.mamba2_state_shapes(cfg, 2, tp=4)
    assert ssm.mamba2_heads(cfg, 2, 1) == (1, 1)
