"""JAX-free helpers of tests/test_torch_mesh_families.py: the scenario of
the four families on a mesh (the zamba2 hybrid, rwkv6, seamless-m4t's
encoder-decoder and internvl2's patch prefix), the port's ranks and the
comparison with the reference's sharded steps.

The scenario, on a ``("data", "model")`` mesh, reduced configs (vocab
200, so the padded vocab columns fall on the last model rank; the hybrid
at 5 layer-units: 2 shared-attention invocations over pool layers 0 and
1, 3 Mamba2 units), f32:
  prefill   B=4 prompts of S=8 tokens (seamless after 16 frames of
            ``frames``; internvl2 behind 8 patches of ``patches``);
  decode    4 greedy steps from the reference's prefilled pools, states
            and cross K/V, fed the port's own greedy tokens;
  mixed     internvl2: 2 mixed steps (2 prompt streams in chunks of C=4,
            the second 7 tokens long, beside the 4 decode rows, one
            inactive in step 2) from the reference's pools after decode;
            rwkv6: 2 ``rwkv.mixed`` steps at model level (the streams from
            zero states, the decode rows from the reference's states
            after decode);
over one global pool of N = 2 * N_LOC pages of PS=4 tokens: data shard d
of 2 holds rows 2d, 2d+1 and stream d on its block of N_LOC pages, whose
last is its trash page.

``spmd_family_reference.py`` (JAX) runs it through the reference's
sharded steps; ``rank_main`` runs it on the port's gloo ranks through
``launch/steps.py``'s sharded cells, ``unit_main`` the unit cases.
"""
from __future__ import annotations

import os

import numpy as np

import mesh_ranks as M

PS, B, S, DECODE_STEPS, PMAX = 4, 4, 8, 4, 6
P_STREAMS, C, P_PAGES = 2, 4, 2
N_LOC = (B // 2) * PMAX + (P_STREAMS // 2) * P_PAGES + 1
N = 2 * N_LOC
MESHES = ((2, 2), (1, 4))
VOCAB = 200
# family -> (arch, config overrides of its reduced config)
ARCHS = {"hybrid": ("zamba2-7b", dict(vocab_size=VOCAB, n_layers=5)),
         "ssm": ("rwkv6-7b", dict(vocab_size=VOCAB)),
         "encdec": ("seamless-m4t-medium", dict(vocab_size=VOCAB)),
         "vlm": ("internvl2-2b", dict(vocab_size=VOCAB))}

# placements of the outputs (one entry a leading dim, later dims whole):
# rows over data, KV heads, channels and SSM heads over model
ROWS, ROWS1 = ("data",), (None, "data")
KV = (None, "data", None, "model", None)
PAGES = (None, "data", None, "model", None)
CONV = {"x": (None, "data", None, "model"), "B": (None, "data", None, None),
        "C": (None, "data", None, None)}
SSM = (None, "data", "model", None, None)
RWKV = {"x_tm": (None, "data", None), "x_cm": (None, "data", None),
        "S": (None, "data", "model", None)}


def seq_table():
    """[B, PMAX] global page ids: row i on data shard i // 2's block."""
    return np.stack([(i // 2) * N_LOC + (i % 2) * PMAX + np.arange(PMAX)
                     for i in range(B)]).astype(np.int32)


def stream_table():
    """[P_STREAMS, P_PAGES]: stream k on data shard k's block."""
    return np.stack([k * N_LOC + (B // 2) * PMAX + np.arange(P_PAGES)
                     for k in range(P_STREAMS)]).astype(np.int32)


def inputs(cfg):
    """The scenario's seeded inputs: prompts [B, S], streams [P, 2C],
    frames [B, S_enc, D] (encdec) and patches [B, Np, d_vision] (vlm)."""
    prompts, streams = M.inputs(cfg.vocab_size)
    rs = np.random.RandomState(M.SEED + 1)
    frames = patches = None
    if cfg.family == "encdec":
        frames = (rs.randn(B, cfg.encoder_seq, cfg.d_model) * 0.3).astype(np.float32)
    if cfg.family == "vlm":
        patches = rs.randn(B, cfg.n_vision_patches, cfg.d_vision).astype(np.float32)
    return prompts, streams, frames, patches


def context(cfg):
    """Positions a prompt fills: the patch prefix, then its tokens."""
    return S + (cfg.n_vision_patches if cfg.family == "vlm" else 0)


def mixed_batch(step, streams, d_tokens, ctx):
    """Mixed step ``step`` (0 or 1) as numpy, decode rows ``ctx`` +
    DECODE_STEPS + step deep."""
    lens = np.array([min(C, n - step * C) for n in M.STREAM_LENS], np.int32)
    return dict(
        p_tokens=streams[:, step * C:(step + 1) * C], p_table=stream_table(),
        p_start=np.full(P_STREAMS, step * C, np.int32), p_lens=lens,
        d_tokens=np.asarray(d_tokens, np.int32), d_table=seq_table(),
        d_lens=np.full(B, ctx + DECODE_STEPS + step, np.int32),
        d_active=np.array([True, True, True, step == 0]))


def rwkv_mixed_batch(step, streams, d_tokens):
    return dict(p_tokens=streams[:, step * C:(step + 1) * C],
                d_tokens=np.asarray(d_tokens, np.int32))


def cut(a, spec, coords, sizes):
    """This rank's block of the global numpy ``a`` under ``spec``."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        k = a.shape[dim] // sizes[ax]
        a = np.take(a, np.arange(coords[ax] * k, (coords[ax] + 1) * k), axis=dim)
    return a


def pool_of(cfg, kv, table, n_layers):
    """A global pool [L, N, PS, KV_p, hd] holding prefill K or V [L, B,
    ctx, KV_p, hd] through ``table``."""
    pool = np.zeros((n_layers, N, PS) + kv.shape[3:], np.float32)
    return M.write_prefill(pool, kv, table)


# ------------------------------------------------------------- the port ---
def _cfg(case, fam):
    import dataclasses
    import json
    from repro_torch.configs import get_config
    arch, _ = ARCHS[fam]
    over = json.loads(str(case[f"{fam}/cfg"]))
    return arch, dataclasses.replace(get_config(arch).reduced(), **over)


def rank_main(case_path, out_dir, fam, shapes):
    """One rank: family ``fam``'s scenario on each mesh of ``shapes`` over
    one world, through ``launch/steps.py``'s sharded cells on the
    reference's weights (at the mesh's ``tp``), from the reference run's
    prefilled caches; outputs to ``out_dir/<fam>-<n_data>x<tp>-rank<r>.npz``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import spmd, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import param_pspecs, shard_params
    from repro_torch.models import rwkv
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.sharding import Policy, make_rules

    case = np.load(case_path)
    arch, cfg = _cfg(case, fam)
    prompts, streams, frames, patches = inputs(cfg)
    t = torch.from_numpy
    for shape in shapes:
        nd, tp = shape
        ref = f"{fam}/{nd}x{tp}"
        mesh = make_mesh(shape, device_type="cpu")
        policy = Policy(make_rules(), mesh)
        coords, sizes = dict(policy.coords), dict(policy.sizes)
        full = params_from_jax(M.unflat(case, f"{fam}/params{tp}/"), device="cpu")
        params = shard_params(full, param_pspecs(full, cfg, tp=tp), policy)
        cells = dict(prefill=steps.build_prefill(arch, mesh=mesh, cfg=cfg)["fn"],
                     decode=steps.build_decode(arch, mesh=mesh, cfg=cfg)["fn"])
        if fam == "vlm":
            cells["mixed"] = steps.build_mixed(arch, mesh=mesh, cfg=cfg)["fn"]

        def mine(a, spec):
            return t(np.ascontiguousarray(cut(np.asarray(a), spec, coords, sizes)))

        def ref_cache(name, spec):
            return mine(case[f"{ref}/{name}"], spec)

        rows = ROWS
        lens = mine(np.full(B, context(cfg), np.int32), rows)
        bt = mine(seq_table(), rows)
        out = {}
        if nd > 1:              # long_500k's one sequence cannot split over data
            try:
                note = steps.build_decode(arch, "long_500k", mesh=mesh, cfg=cfg)["note"]
                out["replicated_batch"] = np.array(note)
            except ValueError as e:
                out["replicated_batch"] = np.array(f"ValueError: {e}")
        with torch.inference_mode():
            # prefill
            tok_rows = mine(prompts, rows)
            if fam == "hybrid":
                logits, (k, v), (conv, ssm) = cells["prefill"](params, tok_rows)
                out.update(prefill_k=k, prefill_v=v, prefill_ssm=ssm,
                           **{f"prefill_conv_{n}": c for n, c in conv.items()})
            elif fam == "ssm":
                logits, state = cells["prefill"](params, tok_rows)
                out.update({f"prefill_state_{n}": s_ for n, s_ in state.items()})
            elif fam == "encdec":
                logits, (k, v), (xk, xv) = cells["prefill"](params, mine(frames, rows), tok_rows)
                out.update(prefill_k=k, prefill_v=v, prefill_xk=xk, prefill_xv=xv)
            else:
                logits, (k, v) = cells["prefill"](params, tok_rows, mine(patches, rows))
                out.update(prefill_k=k, prefill_v=v)
            out["prefill_logits"] = logits

            # decode, from the reference's prefilled caches
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            if fam == "hybrid":
                conv = {n: ref_cache(f"prefill_conv_{n}", CONV[n]) for n in CONV}
                ssm = ref_cache("prefill_ssm", SSM)
            if fam == "ssm":
                state = {n: ref_cache(f"prefill_state_{n}", RWKV[n]) for n in RWKV}
            else:
                kp, vp = ref_cache("prefill_kpool", PAGES), ref_cache("prefill_vpool", PAGES)
            if fam == "encdec":
                xk, xv = ref_cache("prefill_xk", KV), ref_cache("prefill_xv", KV)
            dec, toks = [], []
            for step in range(DECODE_STEPS):
                if fam == "hybrid":
                    lg, _, _ = cells["decode"](params, tok, conv, ssm, kp, vp, bt, lens + step)
                elif fam == "ssm":
                    lg, state = cells["decode"](params, tok, state)
                elif fam == "encdec":
                    lg, _ = cells["decode"](params, tok, kp, vp, xk, xv, bt, lens + step)
                else:
                    lg, _ = cells["decode"](params, tok, kp, vp, bt, lens + step)
                tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
                dec.append(lg)
                toks.append(tok)
            out.update(decode_logits=torch.stack(dec), decode_tokens=torch.stack(toks))
            if fam == "hybrid":
                out.update(decode_ssm=ssm, **{f"decode_conv_{n}": c for n, c in conv.items()})
            if fam == "ssm":
                out.update({f"decode_state_{n}": s_ for n, s_ in state.items()})
            else:
                out.update(decode_kpool=kp, decode_vpool=vp)

            # mixed steps
            d_tok = case[f"{ref}/decode_tokens"][-1]
            if fam == "vlm":
                kp, vp = ref_cache("decode_kpool", PAGES), ref_cache("decode_vpool", PAGES)
                for step in range(2):
                    mb = {k_: mine(v_, rows) for k_, v_ in
                          mixed_batch(step, streams, d_tok, context(cfg)).items()}
                    if step:
                        mb["d_tokens"] = d_next
                    pl, dl, _ = cells["mixed"](params, mb, kp, vp)
                    d_next = dl[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
                    out.update({f"mixed{step}_p": pl, f"mixed{step}_d": dl})
                out.update(mixed_kpool=kp, mixed_vpool=vp)
            if fam == "ssm":
                p_state = rwkv.init_state(cfg, P_STREAMS // nd, torch.float32, "cpu", tp)
                d_state = {n: ref_cache(f"decode_state_{n}", RWKV[n]) for n in RWKV}
                for step in range(2):
                    mb = {k_: mine(v_, rows) for k_, v_ in
                          rwkv_mixed_batch(step, streams, d_tok).items()}
                    if step:
                        mb["d_tokens"] = d_next
                    pl, dl, p_state, d_state = rwkv.mixed(params, cfg, mb, p_state, d_state,
                                                          tp=tp, policy=policy)
                    d_next = dl[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
                    out.update({f"mixed{step}_p": pl, f"mixed{step}_d": dl})
                out.update({f"mixed_p_state_{n}": s_ for n, s_ in p_state.items()})
                out.update({f"mixed_d_state_{n}": s_ for n, s_ in d_state.items()})
        np.savez(os.path.join(out_dir, f"{fam}-{nd}x{tp}-rank{dist.get_rank()}.npz"),
                 data=coords["data"], model=coords["model"],
                 **{k_: v_ if isinstance(v_, np.ndarray) else v_.numpy()
                    for k_, v_ in out.items()})


def unit_main(case_path, out_dir):
    """The unit cases on a 1 x 2 mesh (their inputs ``unit/...`` of
    ``case_path``): the
    sharded gated norm, one Mamba2 block and a recurrent step from its
    states, and the vocab-parallel embedding of encdec and rwkv6's tables;
    outputs to ``out_dir/unit-rank<r>.npz``."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import param_pspecs, shard_params
    from repro_torch.models import sharding, ssm
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import Policy, make_rules

    case = np.load(case_path)
    z = {k[len("unit/"):]: case[k] for k in case.files if k.startswith("unit/")}
    t = torch.from_numpy
    mesh = make_mesh((1, 2), device_type="cpu")
    policy = Policy(make_rules(), mesh)
    m = policy.index("model")
    out = {}
    with torch.inference_mode():
        d = z["norm_x"].shape[-1] // 2
        out["norm"] = sharding.rms_norm(t(z["norm_x"][..., m * d:(m + 1) * d]),
                                        t(z["norm_w"][m * d:(m + 1) * d]), 1e-6, policy)

        cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), **ARCHS["hybrid"][1])
        full = {"mamba": {k[len("mamba/"):]: t(v) for k, v in z.items() if k.startswith("mamba/")}}
        lp = shard_params(full, param_pspecs(full, cfg, tp=2), policy)["mamba"]
        x = t(z["mamba_x"])
        cs, _ = ssm.mamba2_state_shapes(cfg, x.shape[0], tp=2)
        conv0 = {k: torch.zeros(v) for k, v in cs.items()}
        y, conv, h = ssm.mamba2_block(lp, cfg, x, conv0, None, chunk=8, policy=policy)
        y1, conv1, h1 = ssm.mamba2_decode(lp, cfg, x[:, -1], conv, h, policy)
        out.update(mamba_y=y, mamba_h=h, mamba_y1=y1, mamba_h1=h1,
                   **{f"mamba_conv_{k}": v for k, v in conv.items()},
                   **{f"mamba_conv1_{k}": v for k, v in conv1.items()})

        for fam in ("encdec", "ssm"):
            table = t(z[f"embed_{fam}"])
            n = table.shape[0] // 2
            out[f"embed_{fam}"] = T.embed_rows(table[m * n:(m + 1) * n], t(z["embed_tokens"]),
                                               policy)
    np.savez(os.path.join(out_dir, f"unit-rank{dist.get_rank()}.npz"), model=m,
             **{k: v.numpy() for k, v in out.items()})


# ------------------------------------------------------------- compare ---
def outputs(fam, kind):
    """(name, placement) of the outputs of step ``kind`` a rank holds."""
    if kind == "prefill":
        names = [("prefill_logits", ROWS)]
        names += {"hybrid": [("prefill_k", KV), ("prefill_v", KV), ("prefill_ssm", SSM)]
                  + [(f"prefill_conv_{n}", CONV[n]) for n in CONV],
                  "ssm": [(f"prefill_state_{n}", RWKV[n]) for n in RWKV],
                  "encdec": [("prefill_k", KV), ("prefill_v", KV), ("prefill_xk", KV),
                             ("prefill_xv", KV)],
                  "vlm": [("prefill_k", KV), ("prefill_v", KV)]}[fam]
        return names
    if kind == "decode":
        names = [("decode_logits", ROWS1)]
        if fam == "hybrid":
            names += [("decode_ssm", SSM)] + [(f"decode_conv_{n}", CONV[n]) for n in CONV]
        if fam == "ssm":
            return names + [(f"decode_state_{n}", RWKV[n]) for n in RWKV]
        return names + [("decode_kpool", PAGES), ("decode_vpool", PAGES)]
    names = [(f"mixed{s}_{p}", ROWS) for s in range(2) for p in "pd"]
    if fam == "vlm":
        return names + [("mixed_kpool", PAGES), ("mixed_vpool", PAGES)]
    return names + [(f"mixed_{w}_state_{n}", RWKV[n]) for w in "pd" for n in RWKV]


def compare(out_dir, case, fam, shape, kind):
    """The port's ranks on ``shape`` against the reference run of the same
    mesh on step ``kind``: per rank the largest logit gap, the largest gap
    of its caches (pools without the trash pages) and its greedy tokens."""
    nd, tp = shape
    ref = f"{fam}/{nd}x{tp}"
    res = dict(logit_gap=0.0, cache_gap=0.0, tokens_equal=True, ranks=0, compared=0)
    for r in range(nd * tp):
        o = np.load(os.path.join(out_dir, f"{fam}-{nd}x{tp}-rank{r}.npz"))
        coords, sizes = {"data": int(o["data"]), "model": int(o["model"])}, \
            {"data": nd, "model": tp}
        res["ranks"] += 1
        for name, spec in outputs(fam, kind):
            got, want = o[name], cut(case[f"{ref}/{name}"], spec, coords, sizes)
            if spec is PAGES:           # all but the shard's trash page
                got, want = got[:, :-1], want[:, :-1]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            gap = float(np.abs(got.astype(np.float64) - want).max())
            key = "logit_gap" if "logits" in name or name.startswith("mixed") and \
                name[-2:] in ("_p", "_d") else "cache_gap"
            res[key] = max(res[key], gap)
            res["compared"] += 1
            if key == "logit_gap":
                res["tokens_equal"] &= bool(np.array_equal(
                    got[..., :VOCAB].argmax(-1), want[..., :VOCAB].argmax(-1)))
        if kind == "decode":
            res["tokens_equal"] &= bool(np.array_equal(
                o["decode_tokens"], cut(case[f"{ref}/decode_tokens"], ROWS1, coords, sizes)))
    return res
