"""The port's sharded training of the zamba2 hybrid, rwkv6 and
seamless-m4t, gradient accumulation on a mesh, the decode ``2d`` scheme
and the replicated decode batch (``repro_torch/launch/steps.py``'s
``train_mesh``/``build_train``/``build_decode``, ``train/trainer.py``,
``train/losses.py::lm_loss`` vocab-parallel, ``launch/spmd.py``'s
``flat_f`` MoE and row-gathering attention) against the reference's own
jitted sharded steps, on the CPU.

- Training (``mesh_train_family_ranks.TRAIN_CASES``), two steps each of
  B x T = 4 x 16 from the reference's initial params (their all-zero
  leaves made random): reduced zamba2 (2 layer-units: a Mamba2 unit and
  the shared block) in ``tp`` at 2 x 2 and 1 x 4 (one
  SSM head a rank, 2 KV heads padded to 4) and in ``fsdp`` at 2 x 2;
  rwkv6 and seamless-m4t in ``tp`` at 2 x 2; qwen3 and olmoe (capacity
  factor 1) in ``tp`` at 2 x 2 with ``microbatch=2``.  Loss and gnorm
  within 1e-5 relative, each gradient leaf within 1e-4 of its max |g|,
  params after each step within 1e-4 (``test_torch_mesh_train.py``'s
  bounds).
- Decode (``DECODE_CASES``) on a 2 x 2 mesh against the reference's
  ``build_decode`` cell itself: olmoe's ``2d`` scheme (the batch
  replicated over data, pages data-sharded, expert d_ff over both axes)
  and a batch of one row replicated over data with its caches for qwen3,
  internvl2, zamba2 and rwkv6; logits within 1e-4, greedy tokens equal,
  each rank's caches within 1e-5.  seamless-m4t's one row is refused by
  both packages (a ``ValueError`` on the port, naming no ROADMAP item).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mesh_ranks as M
import mesh_train_family_ranks as TF
import mesh_train_ranks as R
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

HERE = Path(__file__).resolve().parent
TOL, LOGIT_TOL, CACHE_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (four subprocesses side by side, each a quarter of its
    XLA compiles: ``spmd_train_family_reference.PARTS``), then one world of 4 gloo ranks: the training cases and the
    decode cases."""
    tmp = tmp_path_factory.mktemp("mesh_train_families")
    case_path = tmp / "reference.npz"
    # LLVM's optimization level changes only how fast XLA compiles, not
    # what the programs compute
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=4 --xla_backend_optimization_level=0"))
    parts = {p: tmp / f"reference-{p}.npz" for p in ("zamba2-2x2", "zamba2-1x4", "encdec",
                                                      "others")}
    procs = {p: subprocess.Popen([sys.executable, str(HERE / "spmd_train_family_reference.py"),
                                  str(path), p], env=env, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)
             for p, path in parts.items()}
    for p, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-4000:]
    merged = {}
    for path in parts.values():
        with np.load(path) as part:
            merged.update({k: part[k] for k in part.files})
    np.savez(case_path, **merged)
    M.run_ranks(tmp, 4, M.run_all,
                (R.train_main, (str(case_path), str(tmp), list(TF.TRAIN_CASES),
                                TF.TRAIN_CASES)),
                (TF.decode_main, (str(case_path), str(tmp))))
    return tmp, np.load(case_path)


@pytest.mark.parametrize("name", list(TF.TRAIN_CASES))
def test_family_sharded_train_matches_reference(runs, name):
    out_dir, ref = runs
    r = TF.compare_train(out_dir, ref, name)
    assert r["ranks"] == 4, r
    assert r["loss"] <= TOL and r["grad_loss"] <= TOL, r
    assert r["gnorm"] <= TOL and r["lr"] <= TOL, r
    assert r["grad"] <= 1e-4, r
    assert r["params1"] <= 1e-4 and r["params2"] <= 1e-4, r


@pytest.mark.parametrize("name", [n for n, c in TF.DECODE_CASES.items()
                                  if "seamless" not in c["arch"]])
def test_decode_2d_and_replicated_batch_match_reference(runs, name):
    out_dir, ref = runs
    r = TF.compare_decode(out_dir, ref, name)
    assert r["ranks"] == 4 and r["compared"] > 0, r
    assert r["logit_gap"] <= LOGIT_TOL, r
    assert r["tokens_equal"], r
    assert r["cache_gap"] <= CACHE_TOL, r
    note = str(np.load(out_dir / f"dec-{name}-rank0.npz")["note"])
    assert "replicated over data" in note, note


def test_seamless_replicated_batch_refused_as_reference(runs):
    """One row over 2 data shards: the reference's encoder-decoder step
    cannot shard it and the port refuses it with a ``ValueError``."""
    out_dir, ref = runs
    assert "dec/seamless-b1/error" in ref.files
    for r in range(4):
        err = str(np.load(out_dir / f"dec-seamless-b1-rank{r}.npz")["error"])
        assert "shards its batch" in err and "item" not in err, err
