"""The port's mesh hooks (``repro_torch/launch/spmd.py``) and the MoE
model on a mesh against the reference, on the CPU.

- Islands: the port's decode and chunk bodies (page writes through the
  pool-local table, then K1 on fp pages or K3 on int8 pages) and its MoE
  body (expert-parallel, capacity overflowing) on one gloo rank equal the
  reference's ``make_sharded_*`` on a 1 x 1 mesh (Auto axes); with
  ``expert_offset``, ``moe_apply`` equals the reference's on the same
  slice of experts; expert tensor parallelism (3 experts over 2 model
  ranks) equals the reference's one-device MoE.
- Whole steps, reduced olmoe at a capacity factor of 1 (experts overflow,
  checked): ``mesh_ranks.py``'s scenario on gloo ranks at meshes 2 x 2,
  1 x 2 and 2 x 1 against the reference's own sharded steps on a forced
  4-device mesh: 2 x 2 for the data-sharded meshes' prefill and decode
  (each data shard's capacity from its own rows, as there), 1 x 2 for the
  1 x 2 mesh, and for the data-sharded meshes' mixed steps the
  reference's 1 x 2 step on each data shard's rows (its 2 x 2 mixed step
  groups the concatenated [prefill; decode] tokens in contiguous blocks
  across shards; ``spmd.py`` says why the port does not).  Logits within
  1e-4, greedy tokens and so the drops equal, pages within 1e-5 a shard.
- Every scheme builds on a 1 x 1 mesh (every family's sharded training,
  the decode ``2d`` scheme, whose ``flat_f`` MoE equals ``moe_apply``
  there); the other four families' sharded serving cells build.
"""
import dataclasses
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
from jax.sharding import AxisType

import mesh_ranks as M
from torch_parity import one_torch_thread, reduced_cfg  # noqa: F401  (autouse fixture)

from repro.launch import spmd as jax_spmd
from repro.models import moe as JM
from repro.models.layers import act_fn as jax_act_fn
from repro_torch.configs import get_config
from repro_torch.launch import spmd, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.models.layers import act_fn
from repro_torch.models.sharding import Policy, make_rules

HERE = Path(__file__).resolve().parent
ARCH = "olmoe-1b-7b"
LOGIT_TOL, PAGE_TOL, ISLAND_TOL = 1e-4, 1e-5, 1e-5


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """(the reference's 1 x 1 mesh, the port's over one gloo rank)."""
    jm = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rdv = tmp_path_factory.mktemp("rdv") / "rdv"
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=0, world_size=1)
    yield jm, make_mesh((1, 1), device_type="cpu")
    dist.destroy_process_group()


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _pools(rs, N, ps, KV, hd, int8):
    """Random (k, v) pools of one layer; int8: code/scale dicts (numpy)."""
    def one():
        if int8:
            return {"q": rs.randint(-127, 128, (N, ps, KV, hd)).astype(np.int8),
                    "s": (rs.rand(N, ps, KV, 1) / 64 + 1e-3).astype(np.float32)}
        return rs.randn(N, ps, KV, hd).astype(np.float32)
    return one(), one()


def _t(tree):
    return ({k: torch.from_numpy(v.copy()) for k, v in tree.items()}
            if isinstance(tree, dict) else torch.from_numpy(tree.copy()))


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else jnp.asarray(tree)


def _pool_gap(a, b):
    if isinstance(a, dict):
        return max(float(np.abs(_np(a[k]).astype(np.float64) - _np(b[k])).max())
                   for k in a)
    return float(np.abs(_np(a) - _np(b)).max())


@pytest.mark.parametrize("pages", ["fp", "int8"])
def test_decode_island_matches_reference(meshes, pages):
    """One layer's decode write + attend on global page ids (2N above the
    pool-local ones), an inactive row writing the trash page."""
    jm, mesh = meshes
    i8 = pages == "int8"
    rs = np.random.RandomState(1)
    N, ps, KV, G, hd, B, W = 12, 4, 2, 2, 16, 3, 3
    kpg, vpg = _pools(rs, N, ps, KV, hd, i8)
    q = rs.randn(B, 1, KV * G, hd).astype(np.float32)
    k_new, v_new = (rs.randn(B, KV, hd).astype(np.float32) for _ in range(2))
    bt = (np.arange(B * W).reshape(B, W) + 2 * N).astype(np.int32)
    lens, active = np.array([5, 0, 9], np.int32), np.array([True, True, False])
    kw = dict(scale=0.25, window=None, attn_softcap=None)
    o_ref, kp_ref, vp_ref = jax_spmd.make_sharded_decode_attn(jm, kv_int8=i8)(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), _j(kpg), _j(vpg),
        jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(active), **kw)

    hook = spmd.make_sharded_decode_attn(mesh, kv_int8=i8)
    kp, vp = _t(kpg), _t(vpg)
    stacked = {n: t[None] for n, t in kp.items()} if i8 else kp[None]
    bt_loc = hook.local_table(torch.from_numpy(bt), stacked)
    dest = PT.token_dest(bt_loc, torch.from_numpy(lens), torch.from_numpy(active), ps, N - 1)
    PT._write(kp, vp, torch.from_numpy(k_new), torch.from_numpy(v_new), dest)
    o = hook(torch.from_numpy(q), kp, vp, bt_loc, torch.from_numpy(lens) + 1,
             torch.from_numpy(lens), scale=0.25)
    assert np.abs(_np(o) - np.asarray(o_ref)).max() <= ISLAND_TOL
    assert _pool_gap(kp, kp_ref) <= ISLAND_TOL and _pool_gap(vp, vp_ref) <= ISLAND_TOL


@pytest.mark.parametrize("pages", ["fp", "int8"])
def test_chunk_island_matches_reference(meshes, pages):
    """One layer's chunk write + attend over history, the second stream's
    chunk padded (its tail to the trash page)."""
    jm, mesh = meshes
    i8 = pages == "int8"
    rs = np.random.RandomState(2)
    N, ps, KV, G, hd, P, C, W = 12, 4, 2, 2, 16, 2, 4, 4
    kpg, vpg = _pools(rs, N, ps, KV, hd, i8)
    q = rs.randn(P, C, KV * G, hd).astype(np.float32)
    k_new, v_new = (rs.randn(P, C, KV, hd).astype(np.float32) for _ in range(2))
    bt = (np.arange(P * W).reshape(P, W) + N).astype(np.int32)
    start, lens = np.array([4, 6], np.int32), np.array([4, 3], np.int32)
    kw = dict(scale=0.25, window=None, attn_softcap=None)
    o_ref, kp_ref, vp_ref = jax_spmd.make_sharded_chunk_attn(jm, kv_int8=i8)(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), _j(kpg), _j(vpg),
        jnp.asarray(bt), jnp.asarray(start), jnp.asarray(lens), **kw)

    hook = spmd.make_sharded_chunk_attn(mesh, kv_int8=i8)
    kp, vp = _t(kpg), _t(vpg)
    stacked = {n: t[None] for n, t in kp.items()} if i8 else kp[None]
    bt_loc = hook.local_table(torch.from_numpy(bt), stacked)
    st, ln = torch.from_numpy(start), torch.from_numpy(lens)
    dest = PT.chunk_dest(bt_loc, st, ln, C, ps, N - 1)
    PT._write(kp, vp, torch.from_numpy(k_new).reshape(P * C, KV, hd),
              torch.from_numpy(v_new).reshape(P * C, KV, hd), dest)
    o = hook(torch.from_numpy(q), kp, vp, bt_loc, st + ln, st, scale=0.25)
    valid = np.arange(C)[None] < lens[:, None]           # padded query rows are garbage
    assert np.abs(_np(o) - np.asarray(o_ref))[valid].max() <= ISLAND_TOL
    keep = slice(0, N - 1)                               # all but the trash page
    trim = (lambda p: {k: v[keep] for k, v in p.items()}) if i8 else (lambda p: p[keep])
    assert _pool_gap(trim(kp), trim(kp_ref)) <= ISLAND_TOL
    assert _pool_gap(trim(vp), trim(vp_ref)) <= ISLAND_TOL


def _moe_inputs(cfg, T, seed):
    rs = np.random.RandomState(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    lp = {"router": (rs.randn(D, E) / np.sqrt(D)).astype(np.float32),
          "w_gate": (rs.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
          "w_up": (rs.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
          "w_down": (rs.randn(E, F, D) / np.sqrt(F)).astype(np.float32)}
    return lp, rs.randn(T, D).astype(np.float32)


def _capacity_drops(cfg, lp, x):
    counter = [0]
    M.counting_drops(lambda lp_, x_: None, cfg, counter)(_t(lp), torch.from_numpy(x))
    return counter[0]


def test_moe_island_matches_reference(meshes):
    """Expert-parallel dispatch on one rank (every expert, offset 0) at a
    capacity factor of 1: y and aux equal the reference's island."""
    jm, mesh = meshes
    cfg = reduced_cfg(ARCH, moe_capacity_factor=1.0)
    lp, x = _moe_inputs(cfg, 12, 3)
    assert _capacity_drops(cfg, lp, x) > 0
    y_ref, aux_ref = jax_spmd.make_sharded_moe_fn(jm, cfg, tp=1)(_j(lp), jnp.asarray(x))
    pcfg = dataclasses.replace(get_config(ARCH).reduced(), moe_capacity_factor=1.0)
    y, aux = spmd.make_sharded_moe_fn(mesh, pcfg, tp=1)(_t(lp), torch.from_numpy(x))
    assert np.abs(_np(y) - np.asarray(y_ref)).max() <= ISLAND_TOL
    assert abs(float(aux) - float(aux_ref)) <= ISLAND_TOL


@pytest.mark.parametrize("offset", [0, 2])
def test_moe_apply_expert_offset_matches_reference(offset):
    """A rank's 2 of 4 experts (``expert_offset``), capacity overflowing."""
    cfg = reduced_cfg(ARCH, moe_capacity_factor=1.0)
    lp, x = _moe_inputs(cfg, 10, 4)
    loc = dict(lp, **{k: lp[k][offset:offset + 2] for k in ("w_gate", "w_up", "w_down")})
    y_ref, aux_ref = JM.moe_apply(_j(loc), jnp.asarray(x), n_experts=4, top_k=2,
                                  act=jax_act_fn("silu"), expert_offset=offset,
                                  capacity_factor=1.0)
    y, aux = PM.moe_apply(_t(loc), torch.from_numpy(x), n_experts=4, top_k=2,
                          act=act_fn("silu"), expert_offset=offset, capacity_factor=1.0)
    assert np.abs(_np(y) - np.asarray(y_ref)).max() <= ISLAND_TOL
    assert abs(float(aux) - float(aux_ref)) <= ISLAND_TOL


def test_schemes_not_ported_raise(meshes):
    """Every scheme of the reference's cells builds on the 1 x 1 mesh (the
    sharded training of every family, ROADMAP items 16 and 16b; the decode
    ``2d`` scheme and its ``flat_f`` MoE, item 17, whose parity with the
    reference's steps is ``test_torch_mesh_train_families.py``'s); an
    unknown decode scheme raises ``ValueError``, and so do the hooks'
    misuses below."""
    _, mesh = meshes
    cfg = get_config(ARCH).reduced()
    flat = spmd.make_sharded_moe_fn(mesh, cfg, tp=1, flat_f=True)
    lp = PM.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.randn(5, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y, aux = flat(lp, x)
    want = PM.moe_apply(lp, x, n_experts=cfg.n_experts, top_k=cfg.top_k,
                        act=act_fn("silu" if cfg.mlp_act == "silu" else "gelu"),
                        capacity_factor=cfg.moe_capacity_factor)
    assert torch.equal(y, want[0]) and torch.equal(aux, want[1])
    for arch in ("qwen3-0.6b", "zamba2-7b", "rwkv6-7b", "seamless-m4t-medium"):
        for scheme in ("tp", "fsdp"):
            cell = steps.build_train(arch, mesh, scheme)
            assert cell["note"].endswith(f"scheme={scheme} mesh (1, 1)"), cell["note"]
    assert "scheme=2d" in steps.build_decode("olmoe-1b-7b", scheme="2d", mesh=mesh)["note"]
    with pytest.raises(ValueError, match="scheme"):
        steps.build_decode("qwen3-0.6b", scheme="3d", mesh=mesh)
    # the other four families' cells build on the 1 x 1 mesh (ROADMAP item 15)
    for arch in ("zamba2-7b", "rwkv6-7b", "seamless-m4t-medium", "internvl2-2b"):
        cells = [steps.build_prefill(arch, mesh=mesh), steps.build_decode(arch, mesh=mesh)]
        if arch == "internvl2-2b":
            cells.append(steps.build_mixed(arch, mesh=mesh))
        for cell in cells:
            assert cell["note"].endswith("mesh (1, 1)"), cell["note"]
    hook = spmd.make_sharded_decode_attn(mesh, kv_int8=True)
    with pytest.raises(TypeError, match="kv_int8=True"):
        hook(torch.zeros(1, 1, 2, 16), torch.zeros(4, 4, 1, 16), torch.zeros(4, 4, 1, 16),
             torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
             torch.zeros(1, dtype=torch.int32), scale=1.0)
    with pytest.raises(ValueError, match="needs moe_fn"):
        PT._ffn(cfg, {"moe": {}}, torch.zeros(2, cfg.d_model), Policy(make_rules(), mesh))


# ---------------------------------------------------------- whole steps ---
# mesh -> (shape, reference run of prefill/decode, of the mixed steps)
MESHES = {"2x2": ((2, 2), "2x2", "2x2-shards"), "1x2": ((1, 2), "1x2", "1x2"),
          "2x1": ((2, 1), "2x2", "2x2-shards")}
EXPERT_TP = (1, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded steps (one subprocess), then the port's
    ranks: one world of 4 (2 x 2), one of 2 (1 x 2, 2 x 1, and expert TP)."""
    tmp = tmp_path_factory.mktemp("spmd")
    case_path = tmp / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(HERE / "spmd_reference.py"), str(case_path),
                          "olmoe"], env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    cfg = reduced_cfg(ARCH, n_experts=3, moe_capacity_factor=1.0)
    lp, x = _moe_inputs(cfg, 12, 5)
    np.savez(tmp / "expert_tp.npz", x=x, n_experts=3, capacity_factor=1.0, **lp)
    worlds = {}
    for shape, ref, _ in MESHES.values():
        worlds.setdefault(shape[0] * shape[1], []).append((shape, f"{ARCH}/{ref}"))
    for world, world_runs in worlds.items():
        calls = [(M.rank_main, (str(case_path), str(tmp), ARCH, world_runs))]
        if world == 2:
            calls.append((M.expert_tp_main, (str(tmp / "expert_tp.npz"), str(tmp), EXPERT_TP)))
        M.run_ranks(tmp, world, M.run_all, *calls)
    return tmp, np.load(case_path)


@pytest.mark.parametrize("kind", M.KINDS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_olmoe_sharded_steps_match_reference(runs, mesh, kind):
    out_dir, case = runs
    shape, ref, mixed_ref = MESHES[mesh]
    r = M.compare(out_dir, case, ARCH, shape, f"{ARCH}/{ref}", kind, f"{ARCH}/{mixed_ref}")
    assert r["ranks"] == shape[0] * shape[1]
    assert r["logit_gap"] <= LOGIT_TOL, r
    assert r["tokens_equal"], r
    assert r["page_gap"] <= PAGE_TOL, r
    assert r["bad_codes"] == 0, r


@pytest.mark.parametrize("mesh", list(MESHES))
def test_olmoe_steps_drop_tokens(runs, mesh):
    """The comparison covers capacity drops: every step kind overflows
    experts on every rank (each data shard's capacity from its tokens)."""
    out_dir, _ = runs
    nd, tp = MESHES[mesh][0]
    for r in range(nd * tp):
        z = np.load(out_dir / f"{ARCH}-{nd}x{tp}-rank{r}.npz")
        assert min(int(z[f"drops_{k}"]) for k in ("prefill", "decode", "mixed")) > 0


def test_expert_tensor_parallel_matches_reference(runs):
    """3 experts over 2 model ranks (d_ff sliced, every expert a rank):
    the reduced partial outputs equal the reference's one-device MoE."""
    out_dir, _ = runs
    z = np.load(out_dir / "expert_tp.npz")
    lp = {k: jnp.asarray(z[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    y_ref, aux_ref = JM.moe_apply(lp, jnp.asarray(z["x"]), n_experts=3, top_k=2,
                                  act=jax_act_fn("silu"), capacity_factor=1.0)
    for r in range(2):
        o = np.load(out_dir / f"expert-tp-rank{r}.npz")
        assert tuple(o["w_gate_shape"]) == (3, 64, 64)          # d_ff 128 over 2 ranks
        assert np.abs(o["y"] - np.asarray(y_ref)).max() <= ISLAND_TOL
        assert abs(float(o["aux"]) - float(aux_ref)) <= ISLAND_TOL
