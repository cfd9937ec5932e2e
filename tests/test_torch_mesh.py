"""The port's mesh path (``repro_torch/launch/{mesh,shardings}.py``,
``repro_torch/models/sharding.py``) against the reference, on the CPU.

- Placements: ``param_pspecs`` equals the reference's leaf for leaf for
  every assigned arch, at the production profile (tp = 16, FSDP over 16
  data ranks) and at tp = 2, on the reference's parameter shapes
  (``jax.eval_shape``, no devices); every placed dim divides, and every
  family's ``init_params(tp=16)`` has the reference's shapes.
- Entry points: ``make_mesh`` needs a card unless asked for the CPU, and
  its backend is explicit.
- Whole steps, reduced qwen3 (vocab 200): prefill, 4 greedy decode steps,
  2 mixed steps with fp and with int8 pages (``mesh_ranks.py``'s
  scenario) on gloo ranks spawned on the CPU at meshes 2 x 2, 1 x 2 and
  2 x 1, against the reference's own sharded steps on a forced 4-device
  2 x 2 mesh (the dense steps do not depend on how the batch is split),
  and at 1 x 4 (tp = 4 pads the 2 KV heads to 4) against the reference's
  1 x 4: logits within 1e-4, greedy tokens equal, pages and prefill K/V
  within 1e-5 a shard (int8 pages: equal codes, a code off by one at a
  rounding boundary counted, scales within 1e-5).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import mesh_ranks as M
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

from repro.configs.registry import ASSIGNED
from repro.launch.shardings import param_pspecs as jax_param_pspecs
from repro.launch.steps import get_model as jax_get_model
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.costs import fake_mode
from repro_torch.launch.shardings import param_pspecs, shard_params
from repro_torch.models.registry import get_model
from repro_torch.models.sharding import Policy, make_rules

HERE = Path(__file__).resolve().parent
ARCH = "qwen3-0.6b"
LOGIT_TOL, PAGE_TOL = 1e-4, 1e-5


def _shapes(arch, tp):
    model = jax_get_model(arch)
    return model.cfg, jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                        jnp.bfloat16, tp=tp))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("profile", ["tp16-fsdp16", "tp2"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_pspecs_match_reference(arch, profile):
    tp, kw = (16, dict(fsdp_size=16, fsdp="data")) if profile == "tp16-fsdp16" else (2, {})
    cfg, shapes = _shapes(arch, tp)
    want = dict(_leaves(jax.tree.map(
        tuple, jax_param_pspecs(shapes, cfg, tp=tp, **kw),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    got = dict(_leaves(param_pspecs(shapes, cfg, tp=tp, **kw)))
    assert got.keys() == want.keys()
    leaf_shapes = dict(_leaves(shapes))
    n_placed = 0
    for path, spec in got.items():
        nd = len(leaf_shapes[path].shape)
        assert spec == tuple(want[path]) + (None,) * (nd - len(want[path])), path
        for dim, ax in enumerate(spec):
            if ax is not None:
                n_placed += 1
                assert leaf_shapes[path].shape[dim] % (tp if ax == "model" else 16) == 0
    assert n_placed > 0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_init_params_padded_shapes_match_reference(arch):
    """The port's ``init_params(tp=16)`` has the reference's padded
    shapes, and ``shard_params`` cuts them into the sixteenth a rank its
    placements say."""
    _, shapes = _shapes(arch, 16)
    with fake_mode():
        params = get_model(arch).init(torch.Generator().manual_seed(0), torch.bfloat16,
                                      "cpu", tp=16)
        got = {p: tuple(t.shape) for p, t in _leaves(params)}
        assert got == {p: tuple(s.shape) for p, s in _leaves(shapes)}

        class Rank3:          # rank 3 of a 1 x 16 mesh, no process group needed
            coords, sizes = {"data": 0, "model": 3}, {"data": 1, "model": 16}
            size, index = Policy.size, Policy.index
        specs = param_pspecs(params, get_model(arch).cfg, tp=16)
        local = dict(_leaves(shard_params(params, specs, Rank3())))
    for path, spec in _leaves(specs):
        want = tuple(n // 16 if ax == "model" else n for n, ax in zip(got[path], spec))
        assert tuple(local[path].shape) == want, path


def test_make_mesh_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match='device_type="cpu"'):
        mesh_mod.make_mesh((1, 1))
    with pytest.raises(ValueError, match="NCCL runs on cuda only"):
        mesh_mod.resolve_backend("cpu", "nccl")
    assert mesh_mod.resolve_backend("cpu") == ("cpu", "gloo")
    assert mesh_mod.make_production_mesh() == ((16, 16), ("data", "model"))
    assert mesh_mod.make_production_mesh(multi_pod=True) == ((2, 16, 16),
                                                             ("pod", "data", "model"))


def test_make_mesh_over_one_gloo_rank(tmp_path):
    """A 1 x 1 mesh over a one-rank gloo group: the backend resolves to
    gloo, a mismatched one or a wrong rank count raises, and the policy
    reads the rank's place; the collectives are identities in value."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            mesh_mod.make_mesh((2, 2), device_type="cpu")
        mesh = mesh_mod.make_test_mesh(device_type="cpu")
        assert mesh_mod.data_axes(mesh) == ("data",) and mesh_mod.model_axis_size(mesh) == 1
        policy = Policy(make_rules(), mesh)
        assert (policy.tp, policy.index("data"), policy.index("model")) == (1, 0, 0)
        assert policy.spec("batch", None, "heads") == ("data", None, "model")
        from repro_torch.models import sharding
        x = torch.arange(6.0).reshape(2, 3)
        before = sharding.counts["all_reduce"]
        assert torch.equal(sharding.all_reduce(x.clone(), policy), x)
        assert torch.equal(sharding.all_gather(x, policy, dim=-1), x)
        assert sharding.counts["all_reduce"] == before + 1
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_mod.make_mesh((1, 1), device_type="cpu")


# ---------------------------------------------------------- whole steps ---
MESHES = {"2x2": ((2, 2), "2x2"), "1x2": ((1, 2), "2x2"), "2x1": ((2, 1), "2x2"),
          "1x4": ((1, 4), "1x4")}
CELL_MESHES = [(1, 2), (2, 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded steps (one subprocess), then the port's
    ranks: one world of 4 (meshes 2 x 2 and 1 x 4), one of 2 (1 x 2, 2 x 1)."""
    tmp = tmp_path_factory.mktemp("mesh")
    case_path = tmp / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(HERE / "spmd_reference.py"), str(case_path),
                          "qwen3"], env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    worlds = {}
    for name, (shape, ref) in MESHES.items():
        worlds.setdefault(shape[0] * shape[1], []).append((shape, f"{ARCH}/{ref}"))
    for world, world_runs in worlds.items():
        calls = [(M.rank_main, (str(case_path), str(tmp), ARCH, world_runs))]
        if world == 2:
            calls += [(M.cell_shapes_main, (str(tmp), shape)) for shape in CELL_MESHES]
        M.run_ranks(tmp, world, M.run_all, *calls)
    return tmp, np.load(case_path)


@pytest.mark.parametrize("kind", M.KINDS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_qwen3_sharded_steps_match_reference(runs, mesh, kind):
    out_dir, case = runs
    shape, ref = MESHES[mesh]
    r = M.compare(out_dir, case, ARCH, shape, f"{ARCH}/{ref}", kind)
    assert r["ranks"] == shape[0] * shape[1]
    assert r["logit_gap"] <= LOGIT_TOL, r
    assert r["tokens_equal"], r
    assert r["page_gap"] <= PAGE_TOL, r
    assert r["bad_codes"] == 0, r


@pytest.mark.parametrize("shape", CELL_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_cells_give_each_rank_its_shards(runs, shape):
    """``build_prefill``/``build_decode``/``build_mixed(kv8)`` of
    qwen3-0.6b with a mesh: each rank's weights, rows and local pools
    ``[L, N/n_data, 64, KV_p/tp, hd]``; N holds a trash page a data shard;
    the mixed step's streams rounded to the data shards."""
    from repro_torch.launch import steps
    out_dir, _ = runs
    nd, tp = shape
    cfg = get_model(ARCH).cfg
    pool, _ = steps._page_pool_shapes(cfg, 128, 32768, tp=tp, n_data=nd)
    assert pool[1] % nd == 0 and pool[1] == -(-(128 * 513 + nd) // nd) * nd
    mixed, _ = steps._page_pool_shapes(cfg, 128, 32768, extra_seqs=16, tp=tp, n_data=nd)
    for r in range(nd * tp):
        z = np.load(out_dir / f"cells-{nd}x{tp}-rank{r}.npz")
        for name in ("prefill", "decode", "mixed"):
            assert tuple(z[f"{name}/wq"]) == (28, 1024, 16 // tp, 128)
            assert tuple(z[f"{name}/embed"]) == (152_064 // tp, 1024)     # Vp
        assert tuple(z["prefill/tokens"]) == (32 // nd, 32768)
        assert tuple(z["decode/tokens"]) == (128 // nd,)
        assert tuple(z["decode/kpg"]) == (28, pool[1] // nd, 64, 8 // tp, 128)
        assert tuple(z["mixed/codes"]) == (28, mixed[1] // nd, 64, 8 // tp, 128)
        assert tuple(z["mixed/p_tokens"]) == (16 // nd, 2048)
        assert tuple(z["mixed/d_tokens"]) == (128 // nd,)
