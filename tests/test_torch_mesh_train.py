"""The port's sharded train step and grok-1-314b's FSDP'd serving
(``repro_torch/launch/steps.py::build_train``/``train_mesh``,
``models/sharding.py``'s collectives with gradients, ``launch/spmd.py``'s
``fsdp_gather``, the vocab-parallel losses, the mesh-aware optimizer)
against the reference, on the CPU.

- Whole train steps (``mesh_train_ranks.CASES``): reduced qwen3-0.6b
  (vocab 200, so the padded vocab columns fall on the last model rank)
  in the ``tp`` scheme at 2 x 2 and at 1 x 4 with the vocab-tiled loss,
  the ``fsdp`` scheme at 2 x 2, and ``tp`` at 2 x 2 with int8 moments
  whose 256-blocks span a shard boundary; reduced olmoe-1b-7b (capacity
  factor 1: experts drop tokens) in ``tp`` at 2 x 2, where
  ``fsdp_gather`` runs, and in ``fsdp`` at 2 x 2; reduced internvl2-2b in
  ``tp`` at 2 x 2.  The reference runs its own jitted sharded step
  (``spmd_train_reference.py``, one subprocess on a forced 4-device
  mesh), the port's gloo ranks the same step on the converted params
  (``mesh_train_ranks.py``): loss (each data shard's, as the reference's
  devices hold it) and gnorm within 1e-5 relative, each gradient leaf
  within 1e-4 of its max |g|, params after each of two steps within 1e-4
  (the bounds of ``test_torch_train.py::test_train_step_matches_reference``).
  With int8 moments the second step moves a param whose ``nu`` code
  is 0 by ``mu`` over about |g| (up to hundreds of lr), which magnifies
  g's rounding past 1e-4, and a code flipped at a rounding boundary
  moves its param too (ROADMAP queue 3, "Expected"): there the first
  step's params are held to 1e-4, its moments' scales to 1e-5 of each
  leaf's max scale and codes to one apart (at most 1 in 1,000 off), and
  the second step's params to 1e-4 but for at most 1 in 1,000 (the
  bound ``test_torch_train.py::test_checkpoints_cross_packages`` gives
  int8 moments), each of which has a flipped code or a ``nu`` code of 0
  and, in the latter case, is within a tenth of the reference's own move.
- A ``Trainer`` on the 2 x 2 mesh that crashes and resumes lands bitwise
  on the uninterrupted run.
- grok-1-314b's serving cells FSDP its weights over data as the
  reference's do: each rank's weight shapes under fake tensors are
  ``local_shape`` of the reference's placements at 2 x 2, and a reduced
  grok's prefill and decode with FSDP'd weights match the reference's
  sharded steps at ``test_torch_mesh.py``'s bounds.
- ``train_logits`` on the 2 x 2 mesh (its logits gathered with a
  gradient) against the one-card port's, values and gradients.
- ``build_cell(arch, "train_4k", mesh)`` for the transformer family, and
  for the zamba2 hybrid, rwkv6 and seamless-m4t each rank's param and
  moment shapes against the reference's ``build_train`` placements (their
  sharded steps' parity: ``test_torch_mesh_train_families.py``);
  ``adamw.opt_specs`` at the production profile against the reference's
  ``_opt_specs``; the rows a rank takes of microbatches on a mesh.
- ``relayout_attention_params`` leaf for leaf against the reference's,
  and the tp = 1 function of ``train_logits`` at tp = 8 after it
  (the reference's ``tests/test_train.py::test_elastic_relayout_preserves_function``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks as M
import mesh_train_ranks as R
from torch_parity import one_torch_thread, port_model, reduced_cfg  # noqa: F401

from repro.launch.shardings import param_pspecs as jax_param_pspecs
from repro.launch.steps import _opt_specs as jax_opt_specs
from repro.launch.steps import get_model as jax_get_model
from repro_torch.launch.costs import fake_mode
from repro_torch.launch.shardings import local_shape, param_pspecs, shard_params
from repro_torch.models.registry import get_model
from repro_torch.models.sharding import Policy

HERE = Path(__file__).resolve().parent
TOL, LOGIT_TOL, PAGE_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (one subprocess), then one world of 4 gloo ranks: every
    case, grok's steps and cells, the crash/resume ``Trainer``."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    case_path = tmp / "reference.npz"
    # LLVM's optimization level changes only how fast XLA compiles the
    # reference's eight programs (half the CPU time), not what they compute
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=4 --xla_backend_optimization_level=0"))
    out = subprocess.run([sys.executable, str(HERE / "spmd_train_reference.py"),
                          str(case_path)], env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    M.run_ranks(tmp, 4, M.run_all,
                (R.train_main, (str(case_path), str(tmp), list(R.CASES))),
                (R.grok_main, (str(case_path), str(tmp))),
                (R.cells_main, (str(tmp),)),
                (R.logits_main, (str(tmp),)),
                (R.trainer_main, (str(tmp), (2, 2))))
    return tmp, np.load(case_path)


def _compare(runs, name):
    out_dir, ref = runs
    r = R.compare(out_dir, ref, name)
    assert r["ranks"] == 4, r
    return r


@pytest.mark.parametrize("name", list(R.CASES))
def test_sharded_train_metrics_match_reference(runs, name):
    r = _compare(runs, name)
    assert r["loss"] <= TOL and r["grad_loss"] <= TOL, r
    assert r["gnorm"] <= TOL and r["lr"] <= TOL, r


@pytest.mark.parametrize("name", list(R.CASES))
def test_sharded_train_grads_match_reference(runs, name):
    r = _compare(runs, name)
    assert r["grad"] <= 1e-4, r


@pytest.mark.parametrize("name", list(R.CASES))
def test_sharded_train_params_match_reference(runs, name):
    r = _compare(runs, name)
    assert r["params1"] <= 1e-4, r
    if R.CASES[name]["int8"]:
        # past 1e-4 after step 2 only where a moment's code flipped at a
        # rounding boundary after step 1, or where nu's code was 0: step 2
        # then moves the param by mu / |g| (up to hundreds of lr), which
        # magnifies g's rounding; there within a tenth of that move
        assert r["over_1e4"] <= r["n_params"] // 1000, r
        assert r["over_unexplained"] == 0, r
        assert r["zero_nu_rel"] <= 0.1, r
    else:
        assert r["params2"] <= 1e-4, r


def test_int8_moments_scales_span_shard_boundaries(runs):
    """The int8 case's moments after one step: codes the reference's but
    for flips by one (at most 1 in 1,000), every block's scale within
    1e-5 of the leaf's max scale from the reference's global block scale,
    and scale leaves of blocks that a shard boundary cuts (held whole on
    each rank)."""
    out_dir, _ = runs
    name = "qwen3-tp-2x2-int8"
    r = _compare(runs, name)
    assert r["n_codes"] > 0 and r["bad_codes"] == 0, r
    assert r["flips"] <= r["n_codes"] // 1000, r
    assert r["scale"] <= TOL, r
    o = np.load(out_dir / f"{name}-rank0.npz")
    cut = {k for k, v in json.loads(str(o["scale_specs"])).items() if v[-1] is None
           and json.loads(str(o["specs"]))[k][-1] is not None}
    assert {"blocks/mlp/w_gate", "blocks/wo", "embed"} <= cut, cut


def test_microbatch_on_a_mesh_raises():
    """Gradient accumulation on a mesh takes the reference's rows: batch
    shard d of n holds rows d·m/n to (d+1)·m/n - 1 of each microbatch of
    m (its parity with the reference's step:
    ``test_torch_mesh_train_families.py``); a microbatch that does not
    divide over the batch shards raises ``ValueError``."""
    from repro_torch.configs import TrainConfig
    from repro_torch.train.trainer import make_grad_fn, rank_rows

    class Rank:                 # data shard 1 of 2 (tp scheme), no process group
        rules = {"batch": "data", "heads": "model"}
        coords, sizes = {"data": 1, "model": 0}, {"data": 2, "model": 2}
        size, index = Policy.size, Policy.index
        batch_axis = property(lambda self: "data")
        tp_axis = property(lambda self: "model")

    assert rank_rows(Rank(), 8, 4) == [2, 3, 6, 7]
    assert rank_rows(Rank(), 8) == [4, 5, 6, 7]
    assert rank_rows(None, 3, 2) == [0, 1, 2]
    make_grad_fn(get_model("qwen3-0.6b"), TrainConfig(microbatch=2), policy=Rank())
    with pytest.raises(ValueError, match="does not divide"):
        make_grad_fn(get_model("qwen3-0.6b"), TrainConfig(microbatch=3), policy=Rank())
    with pytest.raises(ValueError, match="does not divide"):
        rank_rows(Rank(), 8, 3)


def test_mesh_trainer_crash_resume_bitwise(runs):
    """``Trainer`` on the 2 x 2 mesh (int8 moments, per-rank checkpoints
    under ``ckpt_dir/rank<r>``) crashing after step 6 and resuming from
    the step-4 checkpoint ends bitwise where the uninterrupted run does."""
    out_dir, _ = runs
    for r in range(4):
        o = np.load(out_dir / f"trainer-rank{r}.npz")
        assert int(o["start"]) == 4
        assert list(o["ckpt_dirs"]) == [f"rank{i}" for i in range(4)]
        keys = [k for k in o.files if k.startswith("ref/")]
        assert keys and all(np.array_equal(o[k], o["resumed/" + k[4:]]) for k in keys)


def test_train_logits_on_a_mesh_matches_one_card(runs):
    """``train_logits`` at 2 x 2 (``tp``: the logits gathered over the
    vocab's ranks, ``gather_from``, every weight FSDP'd over data): each
    rank's logits and, for a fixed linear function of them, its gradient
    shards summed over data, against the one-card port's, within 1e-5 of
    max (the logits) and 1e-5 of each leaf's max |g|."""
    out_dir, _ = runs
    for r in range(4):
        o = np.load(out_dir / f"logits-rank{r}.npz")
        want = o["want"][..., :200]
        assert np.abs(o["logits"][..., :200] - want).max() <= TOL * np.abs(want).max()
        keys = [k[6:] for k in o.files if k.startswith("grads/")]
        assert len(keys) > 5
        for k in keys:
            g, w = o["grads/" + k], o["want/" + k]
            assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-30), k


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_grok_fsdp_serving_matches_reference(runs, kind):
    out_dir, ref = runs
    r = M.compare(out_dir, ref, R.GROK, (2, 2), f"{R.GROK}/2x2", kind)
    assert r["ranks"] == 4
    assert r["logit_gap"] <= LOGIT_TOL, r
    assert r["tokens_equal"], r
    assert r["page_gap"] <= PAGE_TOL, r


class _Rank:
    """Rank (d, m) of a 2 x 2 mesh for ``local_shape``."""
    sizes = {"data": 2, "model": 2}
    size, index = Policy.size, Policy.index

    def __init__(self, d, m):
        self.coords = {"data": d, "model": m}


def _ref_local_shapes(arch, rank, cfg=None):
    """{path: this rank's shape} under the reference's serving placements of
    ``arch`` at 2 x 2 (FSDP over data, as its ``SERVE_FSDP`` archs)."""
    model = jax_get_model(arch)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.bfloat16, tp=2))
    specs = jax_param_pspecs(shapes, model.cfg, tp=2, fsdp_size=2, fsdp="data")
    flat_s = dict(M.flat(jax.tree.map(lambda s: np.array(s.shape), shapes), ""))
    flat_p = {}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat_p[f"{prefix}{k}"] = tuple(v) + (None,) * (len(flat_s[f"{prefix}{k}"])
                                                               - len(tuple(v)))
    walk(jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    return {k: local_shape(tuple(flat_s[k]), flat_p[k], rank) for k in flat_s}


def test_grok_cells_place_weights_as_reference(runs):
    """Each rank's weight shapes in grok-1-314b's sharded prefill, decode
    and mixed cells at 2 x 2 (fake tensors) are ``local_shape`` of the
    reference's FSDP'd placements: every big weight a quarter."""
    out_dir, _ = runs
    for r in range(4):
        want = _ref_local_shapes(R.GROK, _Rank(r // 2, r % 2))
        o = np.load(out_dir / f"cells-rank{r}.npz")
        for name in ("prefill", "decode", "mixed"):
            got = {k[len(name) + 1:]: tuple(o[k]) for k in o.files if k.startswith(name + "/")}
            assert got == want, name
        assert want["blocks/moe/w_gate"][2] == 6144 // 2 and want["embed"][1] == 6144 // 2


def _ref_train_shapes(arch, rank):
    """({path: this rank's param shape}, {path: its first moment's shape})
    under the reference's ``build_train`` placements of ``arch`` at 2 x 2
    (scheme ``tp``: ``param_pspecs(fsdp_size=2, fsdp="data")``, the
    moments by its ``_opt_specs``)."""
    from repro.configs import TrainConfig as JTrainConfig
    from repro.train.trainer import init_state as jax_init_state
    model = jax_get_model(arch)
    st = jax.eval_shape(lambda: jax_init_state(model, jax.random.PRNGKey(0), JTrainConfig(),
                                               jnp.bfloat16, tp=2))
    p_specs = jax_param_pspecs(st["params"], model.cfg, tp=2, fsdp_size=2, fsdp="data")
    o_specs = jax_opt_specs(st["opt"], p_specs, ("data",), 2)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)      # noqa: E731

    def local(shapes, specs):
        flat_s = dict(M.flat(jax.tree.map(lambda s: np.array(s.shape), shapes), ""))
        flat_p = dict(M.flat(jax.tree.map(lambda s: np.array(tuple(s), dtype=object),
                                          specs, is_leaf=is_spec), ""))
        return {k: local_shape(tuple(v), tuple(flat_p[k]) + (None,) * (len(v) - len(flat_p[k])),
                               rank) for k, v in flat_s.items()}
    return local(st["params"], p_specs), local(st["opt"]["mu"], o_specs["mu"])


def test_build_cell_train_on_a_mesh(runs):
    """``build_cell(arch, "train_4k", mesh)`` gives the transformer family's
    rank its shards (tp scheme at 2 x 2: heads over model, D over data)
    and its data shard's rows; for zamba2-7b, rwkv6-7b and
    seamless-m4t-medium (full size, fake tensors) each rank's param and
    first-moment shapes are ``local_shape`` of the reference's
    ``build_train`` placements, and its rows half the batch."""
    out_dir, _ = runs
    o = np.load(out_dir / "cells-rank0.npz")
    assert tuple(o["train/qwen3-0.6b/blocks/wq"]) == (28, 1024 // 2, 16 // 2, 128)
    assert tuple(o["train/qwen3-0.6b/embed"]) == (152_064 // 2, 1024 // 2)
    assert tuple(o["train/qwen3-0.6b/tokens"]) == (128, 4096)
    assert tuple(o["train/olmoe-1b-7b/blocks/moe/w_gate"]) == (16, 64 // 2, 2048 // 2, 1024)
    assert tuple(o["train/internvl2-2b/tokens"]) == (128, 4096 - 256)
    for r in (0, 3):
        o = np.load(out_dir / f"cells-rank{r}.npz")
        for arch in R.FAMILY_TRAIN_ARCHS:
            want_p, want_mu = _ref_train_shapes(arch, _Rank(r // 2, r % 2))
            pre = f"train/{arch}/"
            got_p = {k[len(pre):]: tuple(o[k]) for k in o.files
                     if k.startswith(pre) and not k.startswith((pre + "mu/", pre + "batch/"))}
            got_mu = {k[len(pre) + 3:]: tuple(o[k]) for k in o.files if k.startswith(pre + "mu/")}
            assert got_p == want_p, arch
            assert got_mu == want_mu, arch
            assert tuple(o[pre + "batch/tokens"]) == (128, 4096), arch
    o = np.load(out_dir / "cells-rank0.npz")
    assert tuple(o["train/seamless-m4t-medium/batch/frames"]) == (128, 1024, 1024)
    assert tuple(o["train/zamba2-7b/mamba/wx"]) == (68, 3584 // 2, 7168 // 2)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "grok-1-314b"])
def test_opt_specs_match_reference(arch):
    """At the production profile (tp = 16, FSDP over 16 data ranks, int8
    moments) the port's moment placements are the reference's
    ``_opt_specs``, leaf for leaf (codes, scales, f32 moments)."""
    from repro.configs import TrainConfig as JTrainConfig
    from repro.train.trainer import init_state as jax_init_state
    from repro_torch.optim import Q8, adamw_init
    from repro_torch.optim.adamw import opt_specs
    model = jax_get_model(arch)
    st = jax.eval_shape(lambda: jax_init_state(model, jax.random.PRNGKey(0),
                                               JTrainConfig(int8_moments=True), tp=16))
    p_specs = jax_param_pspecs(st["params"], model.cfg, tp=16, fsdp_size=16, fsdp="data")
    want = jax_opt_specs(st["opt"], p_specs, ("data",), 16)

    class Rank:
        coords, sizes = {"data": 3, "model": 5}, {"data": 16, "model": 16}
        size, index = Policy.size, Policy.index
    with fake_mode():
        pm = get_model(arch)
        full = pm.init(torch.Generator().manual_seed(0), torch.bfloat16, "cpu", tp=16)
        specs = param_pspecs(full, pm.cfg, tp=16, fsdp_size=16, fsdp="data")
        local = shard_params(full, specs, Rank())
        got = opt_specs(adamw_init(local, True, specs, Rank()), specs, Rank())

    def pad(spec, nd):
        return tuple(spec) + (None,) * (nd - len(tuple(spec)))

    def check(g, w, s):
        if isinstance(w, dict):
            for k in w:
                check(g[k], w[k], s[k])
        elif hasattr(w, "scale"):
            assert isinstance(g, Q8)
            assert g.q == pad(w.q, len(s.q.shape)) and g.scale == pad(w.scale, len(s.scale.shape))
        else:
            assert g == pad(w, len(s.shape))
    for mom in ("mu", "nu"):
        check(got[mom], want[mom], st["opt"][mom])
    assert got["count"] == ()


def test_relayout_attention_params_matches_reference():
    """tp 1 -> 8 and back on reduced gemma2-2b's params: the reference's
    relayout, leaf for leaf."""
    from repro.ckpt.checkpoint import relayout_attention_params as jax_relayout
    from repro_torch.ckpt.checkpoint import relayout_attention_params
    from repro_torch.models.convert import params_from_jax
    cfg = reduced_cfg("gemma2-2b")
    jm = jax_get_model("gemma2-2b")
    jp = jm.module.init_params(cfg, jax.random.PRNGKey(0), tp=1)
    for frm, to, src in ((1, 8, jp), (8, 2, None)):
        src = src if src is not None else jax_relayout(jp, cfg, 1, 8)
        want = jax.tree.map(np.asarray, jax_relayout(src, cfg, frm, to))
        got = relayout_attention_params(params_from_jax(jax.tree.map(np.asarray, src),
                                                        device="cpu"), cfg, frm, to)
        flat_w, flat_g = M.flat(want, ""), M.flat(got, "")
        assert flat_w.keys() == flat_g.keys()
        for k in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[k]), flat_w[k], err_msg=k)


def test_elastic_relayout_preserves_function():
    """The reference's ``test_elastic_relayout_preserves_function`` on the
    port: ``train_logits`` at tp = 1 and after the tp = 8 relayout (padded
    heads inert) within 1e-4."""
    from repro_torch.ckpt.checkpoint import relayout_attention_params
    from repro_torch.models import transformer as PT
    cfg = reduced_cfg("gemma2-2b")
    model = port_model(cfg, "gemma2-2b")
    p1 = model.init(torch.Generator().manual_seed(0), device="cpu", tp=1)
    rs = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 12)))}
    with torch.no_grad():
        l1, _ = PT.train_logits(p1, cfg, batch, tp=1)
        p8 = relayout_attention_params(p1, cfg, tp_from=1, tp_to=8)
        assert p8["blocks"]["wq"].shape[2] == 8 > p1["blocks"]["wq"].shape[2]
        l8, _ = PT.train_logits(p8, cfg, batch, tp=8)
    np.testing.assert_allclose(l1.numpy(), l8.numpy(), atol=1e-4)
