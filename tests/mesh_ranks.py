"""JAX-free helpers of the mesh tests (tests/test_torch_mesh.py,
tests/test_torch_spmd.py): the scenario both packages run, and the port's
ranks, spawned on the CPU over gloo.

The scenario, on a ``("data", "model")`` mesh, reduced configs, f32:
  prefill   B=4 prompts of S=8 tokens;
  decode    4 greedy steps, from the reference's prefilled pools, fed the
            port's own greedy tokens;
  mixed     2 steps, 2 prompt streams in chunks of C=4 (the second stream
            7 tokens long: a padded row) beside the 4 decode rows (one
            inactive in step 2), from the reference's pools after its
            decode steps, fp pages and int8 pages (the reference's pools
            quantized);
over one global pool of N = 2 * N_LOC pages of PS=4 tokens: data shard d
of 2 holds rows 2d, 2d+1 and stream d on its block of N_LOC pages, whose
last is its trash page.  With one data shard the pool is one block (its
last page the trash page) and the same global page ids hold.

``spmd_reference.py`` (JAX) runs it through the reference's sharded
steps and writes an ``.npz``; ``run_ranks`` spawns the port's ranks,
each running it on its shards (``rank_main``) and writing its outputs.
Run by the tests; nothing here imports JAX or the reference.
"""
from __future__ import annotations

import os

import numpy as np

PS, B, S, DECODE_STEPS, PMAX = 4, 4, 8, 4, 4
P_STREAMS, C, P_PAGES = 2, 4, 2
STREAM_LENS = (8, 7)
N_LOC = (B // 2) * PMAX + (P_STREAMS // 2) * P_PAGES + 1
N = 2 * N_LOC
SEED = 0


def seq_table():
    """[B, PMAX] global page ids: row i on data shard i // 2's block."""
    return np.stack([(i // 2) * N_LOC + (i % 2) * PMAX + np.arange(PMAX)
                     for i in range(B)]).astype(np.int32)


def stream_table():
    """[P_STREAMS, P_PAGES]: stream k on data shard k's block."""
    return np.stack([k * N_LOC + (B // 2) * PMAX + np.arange(P_PAGES)
                     for k in range(P_STREAMS)]).astype(np.int32)


def inputs(vocab):
    """The scenario's seeded token inputs."""
    rs = np.random.RandomState(SEED)
    prompts = rs.randint(1, vocab, (B, S)).astype(np.int32)
    streams = rs.randint(1, vocab, (P_STREAMS, C * 2)).astype(np.int32)
    for k, n in enumerate(STREAM_LENS):
        streams[k, n:] = 0
    return prompts, streams


def mixed_batch(step, streams, d_tokens):
    """Mixed step ``step`` (0 or 1) of the scenario as numpy."""
    lens = np.array([min(C, n - step * C) for n in STREAM_LENS], np.int32)
    return dict(
        p_tokens=streams[:, step * C:(step + 1) * C], p_table=stream_table(),
        p_start=np.full(P_STREAMS, step * C, np.int32), p_lens=lens,
        d_tokens=np.asarray(d_tokens, np.int32), d_table=seq_table(),
        d_lens=np.full(B, S + DECODE_STEPS + step, np.int32),
        d_active=np.array([True, True, True, step == 0]))


def write_prefill(pool, kv, table):
    """Write prefill K or V [L, B, S, KV_p, hd] into pool [L, N, PS, KV_p,
    hd] (numpy) through ``table``."""
    for i in range(kv.shape[1]):
        for t in range(kv.shape[2]):
            pool[:, table[i, t // PS], t % PS] = kv[:, i, t]
    return pool


def trash_pages(n_data):
    """Global ids of the pool's trash pages with n_data data shards."""
    return [d * (N // n_data) + N // n_data - 1 for d in range(n_data)]


def flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflat(arrays, prefix):
    tree = {}
    for key in arrays.files if hasattr(arrays, "files") else arrays:
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.array(arrays[key])
    return tree


# ------------------------------------------------------------- the port ---
def run_ranks(tmp_path, world, fn, *args):
    """Spawn ``world`` gloo ranks on the CPU, each calling ``fn(*args)``
    after joining a file rendezvous under ``tmp_path``.  A rank's
    exception fails the spawn (``ProcessRaisedException``)."""
    import torch.multiprocessing as mp
    init = f"file://{tmp_path / f'rdv-{world}-{os.getpid()}'}"
    mp.spawn(_rank_entry, args=(world, init, fn, args), nprocs=world, join=True)


def _rank_entry(rank, world, init, fn, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def _port_cfg(case, arch):
    import dataclasses
    import json
    from repro_torch.configs import get_config
    over = json.loads(str(case[f"{arch}/cfg"]))
    return dataclasses.replace(get_config(arch).reduced(), **over)


def counting_drops(moe_fn, cfg, counter):
    """``moe_fn`` that first adds to ``counter[0]`` the (token, expert)
    choices its capacity drops (``models/moe.py``'s rule over the local
    tokens)."""
    import math

    import torch

    def fn(lp, x2d):
        probs = torch.softmax((x2d @ lp["router"]).float(), dim=-1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
        flat_e = order[:, :cfg.top_k].reshape(-1)
        cap = max(1, math.ceil(x2d.shape[0] * cfg.top_k / cfg.n_experts
                               * cfg.moe_capacity_factor))
        onehot = torch.nn.functional.one_hot(flat_e, cfg.n_experts)
        pos = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None])
        counter[0] += int((pos >= cap).sum())
        return moe_fn(lp, x2d)

    return fn


def rank_main(case_path, out_dir, arch, runs):
    """One rank: the scenario on each mesh of ``runs``, ``((n_data, tp),
    key)`` pairs over one world, on the reference's weights (at the
    mesh's ``tp``) and, from its run ``key``, its prefilled pools, its
    pools and tokens after decode; the outputs to
    ``out_dir/<arch>-<n_data>x<tp>-rank<r>.npz``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import param_pspecs, shard_params
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.sharding import Policy, make_rules

    case = np.load(case_path)
    cfg = _port_cfg(case, arch)
    prompts, streams = inputs(cfg.vocab_size)
    t = torch.from_numpy
    for shape, ref in runs:
        nd, tp = shape
        mesh = make_mesh(shape, device_type="cpu")
        policy = Policy(make_rules(), mesh)
        d, m = policy.index("data"), policy.index("model")
        full = params_from_jax(unflat(case, f"{arch}/params{tp}/"), device="cpu")
        params = shard_params(full, param_pspecs(full, cfg, tp=tp), policy)
        drops = [0]
        moe_fn = (counting_drops(spmd.make_sharded_moe_fn(mesh, cfg, tp=tp), cfg, drops)
                  if cfg.is_moe else None)
        kw = dict(tp=tp, policy=policy, moe_fn=moe_fn)

        def rows(a):
            a = t(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
            k = a.shape[0] // nd
            return a[d * k:(d + 1) * k].clone()

        def local(pool):
            """This rank's block of pages and heads of a global pool."""
            n, h = pool.shape[1] // nd, pool.shape[3] // tp
            return t(np.ascontiguousarray(pool[:, d * n:(d + 1) * n, :, m * h:(m + 1) * h]))

        out = {}
        with torch.inference_mode():
            logits, (k, v) = T.prefill(params, cfg, rows(prompts), **kw)
            out.update(prefill_logits=logits, prefill_k=k, prefill_v=v,
                       drops_prefill=torch.tensor(drops[0]))

            kp, vp = local(case[f"{ref}/prefill_kpool"]), local(case[f"{ref}/prefill_vpool"])
            attn = spmd.make_sharded_decode_attn(mesh)
            tok, lens = logits[:, :cfg.vocab_size].argmax(-1), rows(np.full(B, S, np.int32))
            bt = rows(seq_table())
            dec, toks = [], []
            for _ in range(DECODE_STEPS):
                lg, _ = T.decode(params, cfg, tok.to(torch.int32), kp, vp, bt, lens,
                                 attn_fn=attn, **kw)
                tok, lens = lg[:, :cfg.vocab_size].argmax(-1), lens + 1
                dec.append(lg)
                toks.append(tok)
            out.update(decode_logits=torch.stack(dec), decode_tokens=torch.stack(toks),
                       decode_kpool=kp, decode_vpool=vp,
                       drops_decode=torch.tensor(drops[0] - int(out["drops_prefill"])))

            for pages in ("fp", "int8"):
                int8 = pages == "int8"
                src = f"{ref}/decode_{'q' if int8 else ''}"
                if int8:
                    kp = {"q": local(case[src + "kpool"]), "s": local(case[src + "kscale"])}
                    vp = {"q": local(case[src + "vpool"]), "s": local(case[src + "vscale"])}
                else:
                    kp, vp = local(case[src + "kpool"]), local(case[src + "vpool"])
                attn = {"decode": spmd.make_sharded_decode_attn(mesh, kv_int8=int8),
                        "chunk": spmd.make_sharded_chunk_attn(mesh, kv_int8=int8)}
                d_tok = case[f"{ref}/decode_tokens"][-1]
                for step in range(2):
                    mb = {k_: rows(v_) for k_, v_ in mixed_batch(step, streams, d_tok).items()}
                    if step:
                        mb["d_tokens"] = d_next.to(torch.int32)
                    pl, dl, _ = T.mixed(params, cfg, mb, kp, vp, attn_fn=attn, **kw)
                    d_next = dl[:, :cfg.vocab_size].argmax(-1)
                    out.update({f"mixed_{pages}{step}_p": pl, f"mixed_{pages}{step}_d": dl})
                if int8:
                    out.update({f"mixed_{pages}_kpool": kp["q"], f"mixed_{pages}_kscale": kp["s"],
                                f"mixed_{pages}_vpool": vp["q"], f"mixed_{pages}_vscale": vp["s"]})
                else:
                    out.update({f"mixed_{pages}_kpool": kp, f"mixed_{pages}_vpool": vp})
        out["drops_mixed"] = torch.tensor(drops[0] - int(out["drops_prefill"])
                                          - int(out["drops_decode"]))
        np.savez(os.path.join(out_dir, f"{arch}-{nd}x{tp}-rank{dist.get_rank()}.npz"),
                 data=d, model=m, **{k_: v_.numpy() for k_, v_ in out.items()})


# ------------------------------------------------------------- compare ---
KINDS = ("prefill", "decode", "mixed_fp", "mixed_int8")


def compare(out_dir, case, arch, shape, ref, kind, mixed_ref=None):
    """The port's ranks on ``shape`` (outputs in ``out_dir``) against the
    reference run ``ref`` (``mixed_ref`` for the mixed steps) on step
    ``kind``: per rank, the largest logit gap, its rows' greedy tokens
    equal, the largest gap of its pages (all but the trash pages) and K/V,
    and for int8 pages the codes off by one and by more."""
    nd, tp = shape
    res = dict(logit_gap=0.0, page_gap=0.0, tokens_equal=True, flips=0, bad_codes=0,
               ranks=0)
    mixed_ref = mixed_ref or ref
    for r in range(nd * tp):
        o = np.load(os.path.join(out_dir, f"{arch}-{nd}x{tp}-rank{r}.npz"))
        d, m = int(o["data"]), int(o["model"])
        res["ranks"] += 1

        def rows(a, axis=0):
            k = a.shape[axis] // nd
            return np.take(a, np.arange(d * k, (d + 1) * k), axis=axis)

        def pages(a):
            n, h = a.shape[1] // nd, a.shape[3] // tp
            keep = [i for i in range(n) if i != n - 1]      # the shard's trash page
            return a[:, d * n:(d + 1) * n][:, keep, :, m * h:(m + 1) * h]

        def local_pages(a):
            return a[:, [i for i in range(a.shape[1]) if i != a.shape[1] - 1]]

        def gap(a, b):
            return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))

        def logits(a, b, axis=0):
            res["logit_gap"] = max(res["logit_gap"], gap(a, rows(b, axis)))

        def pool(a, b):
            res["page_gap"] = max(res["page_gap"], gap(local_pages(a), pages(b)))

        if kind == "prefill":
            logits(o["prefill_logits"], case[f"{ref}/prefill_logits"])
            h = case[f"{ref}/prefill_k"].shape[3] // tp
            for n in ("k", "v"):
                want = rows(case[f"{ref}/prefill_{n}"], 1)[:, :, :, m * h:(m + 1) * h]
                res["page_gap"] = max(res["page_gap"], gap(o[f"prefill_{n}"], want))
            res["tokens_equal"] &= bool(np.array_equal(
                o["prefill_logits"].argmax(-1), rows(case[f"{ref}/prefill_logits"]).argmax(-1)))
        elif kind == "decode":
            logits(o["decode_logits"], case[f"{ref}/decode_logits"], 1)
            res["tokens_equal"] &= bool(np.array_equal(
                o["decode_tokens"], rows(case[f"{ref}/decode_tokens"], 1)))
            for n in ("k", "v"):
                pool(o[f"decode_{n}pool"], case[f"{ref}/decode_{n}pool"])
        else:
            p = kind.split("_")[1]
            for step in range(2):
                logits(o[f"mixed_{p}{step}_p"], case[f"{mixed_ref}/mixed_{p}{step}_p"])
                logits(o[f"mixed_{p}{step}_d"], case[f"{mixed_ref}/mixed_{p}{step}_d"])
                res["tokens_equal"] &= bool(np.array_equal(
                    o[f"mixed_{p}{step}_d"].argmax(-1),
                    rows(case[f"{mixed_ref}/mixed_{p}{step}_d"]).argmax(-1)))
            for n in ("k", "v"):
                if p == "fp":
                    pool(o[f"mixed_fp_{n}pool"], case[f"{mixed_ref}/mixed_fp_{n}pool"])
                    continue
                diff = np.abs(local_pages(o[f"mixed_int8_{n}pool"]).astype(np.int32)
                              - pages(case[f"{mixed_ref}/mixed_int8_{n}pool"]).astype(np.int32))
                res["flips"] += int((diff == 1).sum())
                res["bad_codes"] += int((diff > 1).sum())
                pool(o[f"mixed_int8_{n}scale"], case[f"{mixed_ref}/mixed_int8_{n}scale"])
    return res


def run_all(*calls):
    """Rank function running each ``(fn, args)`` of ``calls`` in turn."""
    for fn, args in calls:
        fn(*args)


def expert_tp_main(in_path, out_dir, shape):
    """Expert tensor parallelism (E % tp != 0: every expert, d_ff sliced
    over `model`): ``make_sharded_moe_fn`` on ``in_path``'s router, expert
    weights and tokens, its output to ``out_dir``."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import param_pspecs, shard_params
    from repro_torch.models.sharding import Policy, make_rules

    z = np.load(in_path)
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              n_experts=int(z["n_experts"]),
                              moe_capacity_factor=float(z["capacity_factor"]))
    mesh = make_mesh(shape, device_type="cpu")
    tree = {"blocks": {"moe": {k: torch.from_numpy(z[k])[None]
                               for k in ("router", "w_gate", "w_up", "w_down")}}}
    tp = shape[1]
    local = shard_params(tree, param_pspecs(tree, cfg, tp=tp), Policy(make_rules(), mesh))
    lp = {k: v[0] for k, v in local["blocks"]["moe"].items()}
    with torch.inference_mode():
        y, aux = spmd.make_sharded_moe_fn(mesh, cfg, tp=tp)(lp, torch.from_numpy(z["x"]))
    np.savez(os.path.join(out_dir, f"expert-tp-rank{dist.get_rank()}.npz"), y=y.numpy(),
             aux=aux.numpy(), w_gate_shape=np.array(lp["w_gate"].shape))


def cell_shapes_main(out_dir, shape):
    """``launch/steps.py``'s sharded prefill, decode and kv8 mixed cells
    of qwen3-0.6b on ``shape``: this rank's (fake) argument shapes."""
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, device_type="cpu")
    cells = {"prefill": steps.build_prefill("qwen3-0.6b", mesh=mesh),
             "decode": steps.build_decode("qwen3-0.6b", mesh=mesh),
             "mixed": steps.build_mixed("qwen3-0.6b", scheme="kv8", mesh=mesh)}
    out = {}
    for name, cell in cells.items():
        params, *rest = cell["args"]
        out[f"{name}/wq"] = np.array(params["blocks"]["wq"].shape)
        out[f"{name}/embed"] = np.array(params["embed"].shape)
        if name == "prefill":
            out["prefill/tokens"] = np.array(rest[0].shape)
        elif name == "decode":
            out["decode/kpg"] = np.array(rest[1].shape)
            out["decode/tokens"] = np.array(rest[0].shape)
        else:
            mb, kpg = rest[0], rest[1]
            out["mixed/codes"] = np.array(kpg["q"].shape)
            out["mixed/p_tokens"] = np.array(mb["p_tokens"].shape)
            out["mixed/d_tokens"] = np.array(mb["d_tokens"].shape)
    tag = f"{shape[0]}x{shape[1]}"
    np.savez(os.path.join(out_dir, f"cells-{tag}-rank{dist.get_rank()}.npz"), **out)
