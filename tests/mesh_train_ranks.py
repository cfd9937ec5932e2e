"""JAX-free helpers of ``tests/test_torch_mesh_train.py``: the sharded
train step's cases, the port's gloo ranks that run them on the CPU, and
the comparison with the reference's outputs (``spmd_train_reference.py``).

A case is a reduced config (overrides), a ``("data", "model")`` mesh, the
reference's ``build_train`` scheme (``tp`` or ``fsdp``), the loss and
int8 moments on or off; every case takes two steps of B x T = 4 x 16 at
``TCFG`` (lr 1e-3 from the first step, the clip at 0.5 on the path).
``int8`` runs d_ff = 768: ``w_gate``/``w_up``'s last axis then splits as
384 a rank over `model`, so the second 256-block of each row spans the
shard boundary (and D = 64, the last axis of ``wo``, ``w_down`` and the
tables, one block, splits over `data`).  ``grok`` is a reduced
grok-1-314b's FSDP'd serving steps (``mesh_ranks.py``'s prefill and
decode).
"""
from __future__ import annotations

import json
import os

import numpy as np

import mesh_ranks as M

TCFG = dict(global_batch=4, seq_len=16, total_steps=4, warmup_steps=0, lr=1e-3,
            grad_clip=0.5, remat=True)
B, T = 4, 16
QWEN = ("qwen3-0.6b", dict(vocab_size=200))
CASES = {
    "qwen3-tp-2x2": dict(arch=QWEN[0], over=QWEN[1], shape=(2, 2), scheme="tp",
                         loss="chunked", int8=False),
    "qwen3-tp-1x4-vtiled": dict(arch=QWEN[0], over=QWEN[1], shape=(1, 4), scheme="tp",
                                loss="vtiled", int8=False),
    "qwen3-fsdp-2x2": dict(arch=QWEN[0], over=QWEN[1], shape=(2, 2), scheme="fsdp",
                           loss="chunked", int8=False),
    "qwen3-tp-2x2-int8": dict(arch=QWEN[0], over=dict(QWEN[1], d_ff=768), shape=(2, 2),
                              scheme="tp", loss="chunked", int8=True),
    "olmoe-tp-2x2": dict(arch="olmoe-1b-7b", over=dict(moe_capacity_factor=1.0),
                         shape=(2, 2), scheme="tp", loss="chunked", int8=False),
    "olmoe-fsdp-2x2": dict(arch="olmoe-1b-7b", over=dict(moe_capacity_factor=1.0),
                           shape=(2, 2), scheme="fsdp", loss="chunked", int8=False),
    "internvl2-tp-2x2": dict(arch="internvl2-2b", over={}, shape=(2, 2), scheme="tp",
                             loss="chunked", int8=False),
}
GROK, GROK_OVER = "grok-1-314b", dict(vocab_size=200)
FAMILY_TRAIN_ARCHS = ("zamba2-7b", "rwkv6-7b", "seamless-m4t-medium")


def batches(cfg):
    """The cases' two seeded batches (labels = tokens; patches for vlm,
    frames for encdec)."""
    rs = np.random.RandomState(1)
    out = []
    for _ in range(2):
        b = {"tokens": rs.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)}
        b["labels"] = b["tokens"]
        if cfg.family == "vlm":
            b["patches"] = (rs.standard_normal((B, cfg.n_vision_patches, cfg.d_vision))
                            * 0.3).astype(np.float32)
        if cfg.family == "encdec":
            b["frames"] = (rs.standard_normal((B, cfg.encoder_seq, cfg.d_model))
                           * 0.3).astype(np.float32)
        out.append(b)
    return out


def _cfg(arch, over):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ------------------------------------------------------------- the port ---
def train_main(case_path, out_dir, names, cases=None):
    """One rank: each case of ``names`` (in ``cases``, default ``CASES``) on
    its mesh (every name's mesh the world's size): the gradients of the
    first batch, two train steps from the reference's initial params, and
    the placements, to ``out_dir/<name>-rank<r>.npz``.  A case's
    ``micro`` (default 0) is its ``TrainConfig.microbatch``: the rank
    then takes its rows of each microbatch (``trainer.take_rows``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import shard_params
    from repro_torch.configs import TrainConfig
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import get_model
    from repro_torch.optim import Q8, adamw, adamw_init
    from repro_torch.train.trainer import make_grad_fn, make_train_step, take_rows

    ref = np.load(case_path)
    meshes = {}
    for name in names:
        case = (cases or CASES)[name]
        cfg = _cfg(case["arch"], case["over"])
        model = get_model(case["arch"], cfg)
        shape = case["shape"]
        mesh = meshes.setdefault(shape, make_mesh(shape, device_type="cpu"))
        tp, policy, moe_fn = steps.train_mesh(model, mesh, case["scheme"])
        tcfg = TrainConfig(**TCFG, loss_impl=case["loss"], int8_moments=case["int8"],
                           microbatch=case.get("micro", 0), ckpt_dir=out_dir)
        params = shard_params(params_from_jax(M.unflat(ref, f"{name}/params0/"), device="cpu"),
                              policy.params, policy)
        state = {"params": params,
                 "opt": adamw_init(params, case["int8"], policy.params, policy)}
        def rows(b):
            return {k: v.clone() for k, v in take_rows(
                {k: torch.from_numpy(v) for k, v in b.items()}, policy, tcfg.microbatch).items()}

        bs = [rows(M.unflat(ref, f"{name}/batch{j}/")) for j in range(2)]
        kw = dict(tp=tp, policy=policy, moe_fn=moe_fn)
        out = {}
        loss, grads = make_grad_fn(model, tcfg, **kw)(state["params"], bs[0])
        out["grad_loss"] = loss.numpy()
        out.update({f"grads/{k}": v.numpy() for k, v in _leaves(grads)})
        step = make_train_step(model, tcfg, **kw)
        for j, b in enumerate(bs):
            state, m = step(state, b)
            out.update({f"{k}{j}": v.numpy() for k, v in m.items()})
            out.update({f"params{j + 1}/{k}": v.numpy() for k, v in _leaves(state["params"])})
            if case["int8"] and j == 0:
                for mom in ("mu", "nu"):
                    for k, v in _leaves(state["opt"][mom]):
                        if isinstance(v, Q8):
                            out[f"{mom}1/{k}/q"], out[f"{mom}1/{k}/scale"] = (
                                v.q.numpy(), v.scale.numpy())
        opt_specs = adamw.opt_specs(state["opt"], policy.params, policy)
        scale_specs = {k: list(v.scale) for k, v in _leaves(opt_specs["mu"])
                       if isinstance(v, Q8)}
        out["specs"] = np.array(json.dumps({k: list(v) for k, v in _leaves(policy.params)}))
        out["scale_specs"] = np.array(json.dumps(scale_specs))
        out["coords"] = np.array(json.dumps(policy.coords))
        out["sizes"] = np.array(json.dumps(policy.sizes))
        np.savez(os.path.join(out_dir, f"{name}-rank{dist.get_rank()}.npz"), **out)


def trainer_main(out_dir, shape):
    """One rank: ``Trainer`` on reduced qwen3 at ``shape`` (tp scheme),
    ten steps uninterrupted, and ten that crash after step 6 and resume
    from the step-4 checkpoint; both final params and the resumed start
    step to ``out_dir/trainer-rank<r>.npz``."""
    import dataclasses

    import pytest
    import torch.distributed as dist
    from repro_torch.configs import TrainConfig
    from repro_torch.data import make_train_data_fn
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.train.trainer import Trainer

    model = get_model(QWEN[0], _cfg(*QWEN))
    mesh = make_mesh(shape, device_type="cpu")
    tp, policy, _ = steps.train_mesh(model, mesh, "tp")
    tcfg = TrainConfig(global_batch=4, seq_len=16, total_steps=10, ckpt_every=4,
                       remat=False, int8_moments=True,
                       ckpt_dir=os.path.join(out_dir, "trainer-ckpt"))
    data_fn = make_train_data_fn(model.cfg, tcfg)
    kw = dict(device="cpu", tp=tp, policy=policy)
    ref = Trainer(model, dataclasses.replace(tcfg, ckpt_dir=os.path.join(
        out_dir, "trainer-ref")), data_fn, **kw)
    ref.run()
    t1 = Trainer(model, tcfg, data_fn, **kw)
    with pytest.raises(RuntimeError, match="simulated failure at step 6"):
        t1.run(crash_at=6)
    t2 = Trainer(model, tcfg, data_fn, **kw)
    start = t2.start_step
    t2.run()
    out = {f"ref/{k}": v.numpy() for k, v in _leaves(ref.state["params"])}
    out.update({f"resumed/{k}": v.numpy() for k, v in _leaves(t2.state["params"])})
    out["start"] = np.array(start)
    out["ckpt_dirs"] = np.array(sorted(os.listdir(tcfg.ckpt_dir)))
    np.savez(os.path.join(out_dir, f"trainer-rank{dist.get_rank()}.npz"), **out)


def grok_main(case_path, out_dir):
    """One rank of the 2 x 2 mesh: reduced grok-1-314b's prefill and 4
    greedy decode steps through ``launch/steps.py``'s serving policy (its
    weights FSDP'd over data, gathered a layer at a time) on the
    reference's weights, to ``out_dir/grok-1-314b-2x2-rank<r>.npz`` in
    ``mesh_ranks.compare``'s keys; and this rank's weight shapes."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import shard_params
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import get_model

    ref = np.load(case_path)
    cfg = _cfg(GROK, GROK_OVER)
    mesh = make_mesh((2, 2), device_type="cpu")
    shard = steps._Shard(get_model(GROK, cfg), mesh)
    policy, kw = shard.policy, shard.kw
    d, m = policy.index("data"), policy.index("model")
    params = shard_params(params_from_jax(M.unflat(ref, f"{GROK}/params2/"), device="cpu"),
                          policy.params, policy)
    prompts, _ = M.inputs(cfg.vocab_size)
    t = torch.from_numpy

    def rows(a):
        k = a.shape[0] // 2
        return t(np.ascontiguousarray(a[d * k:(d + 1) * k]))

    def local(pool):
        n, h = pool.shape[1] // 2, pool.shape[3] // 2
        return t(np.ascontiguousarray(pool[:, d * n:(d + 1) * n, :, m * h:(m + 1) * h]))

    key = f"{GROK}/2x2"
    out = {}
    with torch.inference_mode():
        logits, (k, v) = T.prefill(params, cfg, rows(prompts), **kw)
        out.update(prefill_logits=logits, prefill_k=k, prefill_v=v)
        kp, vp = local(ref[f"{key}/prefill_kpool"]), local(ref[f"{key}/prefill_vpool"])
        attn = shard.decode_attn()
        tok, lens = logits[:, :cfg.vocab_size].argmax(-1), rows(np.full(M.B, M.S, np.int32))
        bt = rows(M.seq_table())
        dec, toks = [], []
        for _ in range(M.DECODE_STEPS):
            lg, _ = T.decode(params, cfg, tok.to(torch.int32), kp, vp, bt, lens, attn_fn=attn,
                             **kw)
            tok, lens = lg[:, :cfg.vocab_size].argmax(-1), lens + 1
            dec.append(lg)
            toks.append(tok)
        out.update(decode_logits=torch.stack(dec), decode_tokens=torch.stack(toks),
                   decode_kpool=kp, decode_vpool=vp)
    out = {k_: v_.numpy() for k_, v_ in out.items()}
    out.update({f"shape/{k_}": np.array(v_.shape) for k_, v_ in _leaves(params)})
    np.savez(os.path.join(out_dir, f"{GROK}-2x2-rank{dist.get_rank()}.npz"),
             data=d, model=m, **out)


def cells_main(out_dir):
    """One rank of the 2 x 2 mesh: ``launch/steps.py``'s sharded prefill,
    decode and mixed cells of grok-1-314b under fake tensors (this rank's
    weight shapes), and ``build_cell(arch, "train_4k", mesh)`` for the
    transformer family's archs (its param and batch shapes) and the other
    families' (their param, first-moment and batch shapes)."""
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), device_type="cpu")
    out = {}
    for name, build in (("prefill", steps.build_prefill), ("decode", steps.build_decode),
                        ("mixed", steps.build_mixed)):
        params = build(GROK, mesh=mesh)["args"][0]
        out.update({f"{name}/{k}": np.array(v.shape) for k, v in _leaves(params)})
    for arch in ("qwen3-0.6b", "olmoe-1b-7b", "internvl2-2b"):
        cell, why = steps.build_cell(arch, "train_4k", mesh)
        state, batch = cell["args"]
        out.update({f"train/{arch}/{k}": np.array(v.shape)
                    for k, v in _leaves(state["params"])})
        out[f"train/{arch}/tokens"] = np.array(batch["tokens"].shape)
    for arch in FAMILY_TRAIN_ARCHS:
        cell, why = steps.build_cell(arch, "train_4k", mesh)
        state, batch = cell["args"]
        out.update({f"train/{arch}/{k}": np.array(v.shape)
                    for k, v in _leaves(state["params"])})
        out.update({f"train/{arch}/mu/{k}": np.array(v.shape)
                    for k, v in _leaves(state["opt"]["mu"])})
        out.update({f"train/{arch}/batch/{k}": np.array(v.shape) for k, v in batch.items()})
    np.savez(os.path.join(out_dir, f"cells-rank{dist.get_rank()}.npz"), **out)


def logits_main(out_dir):
    """One rank of the 2 x 2 mesh (``tp`` scheme): ``train_logits`` of reduced
    qwen3 on this rank's rows, and the gradients of a fixed linear function
    of its real columns, summed over data (``sync_grads``); the one-card
    port's on the full params and batch beside them, sliced to this
    rank's rows and shards, to ``out_dir/logits-rank<r>.npz``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import shard_params
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    from repro_torch.models.sharding import sync_grads
    from repro_torch.train.trainer import value_and_grad

    cfg = _cfg(*QWEN)
    model = get_model(QWEN[0], cfg)
    tp, policy, _ = steps.train_mesh(model, make_mesh((2, 2), device_type="cpu"), "tp")
    full = model.init(torch.Generator().manual_seed(0), torch.float32, "cpu", tp=tp)
    local = shard_params(full, policy.params, policy)
    rs = np.random.RandomState(2)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, 8)))
    w = torch.from_numpy(rs.standard_normal((B, 8, cfg.vocab_size)).astype(np.float32))
    d = policy.index("data")
    rows = slice(d * B // 2, (d + 1) * B // 2)

    def fn(pol, r):
        def loss(params, batch):
            logits, _ = T.train_logits(params, cfg, batch, tp=tp, policy=pol)
            return (logits[..., :cfg.vocab_size] * w[r]).sum(), logits
        return loss

    with torch.no_grad():
        logits = T.train_logits(local, cfg, {"tokens": tokens[rows]}, tp=tp, policy=policy)[0]
        want = T.train_logits(full, cfg, {"tokens": tokens}, tp=tp)[0][rows]
    _, grads = value_and_grad(fn(policy, rows), local, {"tokens": tokens[rows]})
    grads = sync_grads(grads, policy)
    _, g1 = value_and_grad(fn(None, slice(None)), full, {"tokens": tokens})
    g1 = shard_params(g1, policy.params, policy)
    out = {"logits": logits.numpy(), "want": want.numpy()}
    out.update({f"grads/{k}": v.numpy() for k, v in _leaves(grads)})
    out.update({f"want/{k}": v.numpy() for k, v in _leaves(g1)})
    np.savez(os.path.join(out_dir, f"logits-rank{dist.get_rank()}.npz"), **out)


# ------------------------------------------------------------- compare ---
def local_block(a, spec, coords, sizes):
    """This rank's block of the global array ``a`` under placement ``spec``
    (axis names or lists of them, row-major over a list)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = [ax] if isinstance(ax, str) else list(ax)
        n, i = 1, 0
        for x in axes:
            n, i = n * sizes[x], i * sizes[x] + coords[x]
        k = a.shape[dim] // n
        a = np.take(a, np.arange(i * k, (i + 1) * k), axis=dim)
    return a


def compare(out_dir, ref, name, cases=None):
    """Each rank's outputs of case ``name`` against the reference's: per
    metric the largest relative gap, per gradient leaf its gap over the
    leaf's max |g|, the params' largest gap after each step and the
    count of param elements over 1e-4 after two, and with int8 moments
    the codes off by one and by more and the scales' largest gap over the
    leaf's max scale after the first step.  Of the param elements over
    1e-4 after two whose moments' codes after the first were all the
    reference's: the count of those whose ``nu`` code was not 0
    (``over_unexplained``), and the largest gap of the others over the
    reference's own move at step 2 (``zero_nu_rel``): where ``nu`` decodes
    to 0, step 2 divides ``mu`` by about |g|, which magnifies g's
    rounding."""
    case = (cases or CASES)[name]
    world = case["shape"][0] * case["shape"][1]
    res = dict(ranks=0, loss=0.0, grad_loss=0.0, gnorm=0.0, lr=0.0, grad=0.0,
               grad_leaf="", params1=0.0, params2=0.0, over_1e4=0, n_params=0,
               flips=0, bad_codes=0, n_codes=0, scale=0.0, over_unexplained=0,
               zero_nu_rel=0.0)

    def rel(a, b):
        return float(abs(float(a) - float(b)) / abs(float(b)))

    for r in range(world):
        o = np.load(os.path.join(out_dir, f"{name}-rank{r}.npz"))
        specs, coords, sizes = (json.loads(str(o[k])) for k in ("specs", "coords", "sizes"))
        scale_specs = json.loads(str(o["scale_specs"]))
        d = coords["data"] if case["scheme"] == "tp" else None
        res["ranks"] += 1
        for j in range(2):
            want = ref[f"{name}/loss{j}"]
            res["loss"] = max(res["loss"], rel(o[f"loss{j}"],
                                               want[d] if d is not None else want[0]))
            res["gnorm"] = max(res["gnorm"], rel(o[f"gnorm{j}"], ref[f"{name}/gnorm{j}"]))
            res["lr"] = max(res["lr"], rel(o[f"lr{j}"], ref[f"{name}/lr{j}"]))
        want = ref[f"{name}/loss0"]
        res["grad_loss"] = max(res["grad_loss"],
                               rel(o["grad_loss"], want[d] if d is not None else want[0]))
        for path, spec in specs.items():
            g = ref[f"{name}/grads/{path}"]
            gap = float(np.abs(o[f"grads/{path}"] - local_block(g, spec, coords, sizes)).max()
                        / max(float(np.abs(g).max()), 1e-30))
            if gap >= res["grad"]:
                res["grad"], res["grad_leaf"] = gap, path
            for j in (1, 2):
                diff = np.abs(o[f"params{j}/{path}"] - local_block(
                    ref[f"{name}/params{j}/{path}"], spec, coords, sizes))
                res[f"params{j}"] = max(res[f"params{j}"], float(diff.max()))
            res["over_1e4"] += int((diff > 1e-4).sum())
            res["n_params"] += diff.size
            if not case["int8"]:
                continue
            flipped = np.zeros(diff.shape, dtype=bool)
            zero_nu = np.zeros(diff.shape, dtype=bool)
            for mom in ("mu", "nu"):
                if f"{name}/{mom}1/{path}/q" not in ref:
                    continue
                codes = (o[f"{mom}1/{path}/q"].astype(np.int32) - local_block(
                    ref[f"{name}/{mom}1/{path}/q"], spec, coords, sizes).astype(np.int32))
                flipped |= codes != 0
                if mom == "nu":
                    zero_nu = local_block(ref[f"{name}/nu1/{path}/q"], spec, coords,
                                          sizes) == 0
                res["flips"] += int((np.abs(codes) == 1).sum())
                res["bad_codes"] += int((np.abs(codes) > 1).sum())
                res["n_codes"] += codes.size
                s_ref = local_block(ref[f"{name}/{mom}1/{path}/scale"], scale_specs[path],
                                    coords, sizes)
                s_got = o[f"{mom}1/{path}/scale"]
                res["scale"] = max(res["scale"], float(
                    np.abs(s_got - s_ref).max() / max(float(np.abs(s_ref).max()), 1e-30)))
            over = (diff > 1e-4) & ~flipped
            res["over_unexplained"] += int((over & ~zero_nu).sum())
            if (over & zero_nu).any():
                step2 = np.abs(local_block(ref[f"{name}/params2/{path}"], spec, coords, sizes)
                               - local_block(ref[f"{name}/params1/{path}"], spec, coords,
                                             sizes))
                m = over & zero_nu
                res["zero_nu_rel"] = max(res["zero_nu_rel"],
                                         float((diff[m] / step2[m]).max()))
    return res
