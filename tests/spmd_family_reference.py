"""``mesh_family_ranks.py``'s scenario through the reference's own
sharded steps, on forced host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/spmd_family_reference.py OUT.npz

For each family of ``mesh_family_ranks.ARCHS`` (the zamba2 hybrid,
rwkv6, seamless-m4t's encoder-decoder, internvl2) and each mesh of
``MESHES`` (2 x 2 and 1 x 4, whose tp = 4 pads reduced zamba2's,
seamless's and internvl2's 2 KV heads to 4 and gives each rank one of
reduced zamba2's 4 SSM heads): ``jax.make_mesh`` over the first devices
with Auto axes, params from the family's ``init_params(..., tp)`` (its
all-zero leaves drawn small and random, ``nonzero``) placed
by ``launch/shardings.py::param_pspecs``, caches placed as
``launch/steps.py``'s decode cells place them, and the family's
``prefill``/``decode`` (``hybrid``/``encdec`` with
``launch/spmd.py::make_sharded_decode_attn``), internvl2's
``transformer.mixed`` and rwkv6's ``rwkv.mixed``, jitted with ``tp`` and
a ``Policy``.  Writes, per run ``<family>/<n_data>x<tp>``, the outputs
``mesh_family_ranks.outputs`` names, the prefilled pools and tokens, and
``<family>/params<tp>/...`` and ``<family>/cfg``; plus the unit cases'
inputs and want values (``unit/...``).
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import mesh_family_ranks as F  # noqa: E402
import mesh_ranks as M  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import spmd  # noqa: E402
from repro.launch.shardings import param_pspecs  # noqa: E402
from repro.models import encdec, hybrid, rwkv  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.models.registry import FAMILY_MODULE  # noqa: E402
from repro.models.sharding import Policy, make_rules  # noqa: E402


def mesh_of(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def put(mesh, a, spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))


def place(mesh, params, cfg, tp):
    specs = param_pspecs(jax.eval_shape(lambda: params), cfg, tp=tp)
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                        params, specs, is_leaf=lambda x: isinstance(x, P))


def nonzero(params):
    """``params`` with every all-zero leaf (norm scales, biases, the
    hybrid's LoRA ``*b`` and rwkv6's ``u``) drawn small and random, so each
    sharded piece moves the outputs."""
    rs = np.random.RandomState(7)
    return jax.tree.map(lambda a: a + jnp.asarray(rs.randn(*a.shape) * 0.1, a.dtype)
                        if not np.asarray(a).any() else a, params)


def argmax(logits, cfg):
    return np.asarray(logits)[:, :cfg.vocab_size].argmax(-1).astype(np.int32)


def run(fam, cfg, shape, out):
    key = f"{fam}/{shape[0]}x{shape[1]}"
    tp = shape[1]
    mesh = mesh_of(shape)
    policy = Policy(make_rules(("data",), "model"), mesh)
    kw = dict(tp=tp, policy=policy)
    attn = spmd.make_sharded_decode_attn(mesh)
    params = nonzero(FAMILY_MODULE[cfg.family].init_params(cfg, jax.random.PRNGKey(0), tp=tp))
    out.update(M.flat(jax.tree.map(np.asarray, params), f"{fam}/params{tp}/"))
    params = place(mesh, params, cfg, tp)
    prompts, streams, frames, patches = F.inputs(cfg)
    rows = lambda a: put(mesh, a, F.ROWS)                 # noqa: E731
    st = {}

    # prefill
    if fam == "hybrid":
        logits, (k, v), (conv, ssm) = jax.jit(
            lambda p, t: hybrid.prefill(p, cfg, t, **kw))(params, rows(prompts))
        st.update(prefill_ssm=ssm, **{f"prefill_conv_{n}": c for n, c in conv.items()})
    elif fam == "ssm":
        logits, state = jax.jit(lambda p, t: rwkv.prefill(p, cfg, t, chunk=64, **kw))(
            params, rows(prompts))
        st.update({f"prefill_state_{n}": s for n, s in state.items()})
    elif fam == "encdec":
        logits, (k, v), (xk, xv) = jax.jit(
            lambda p, f, t: encdec.prefill(p, cfg, f, t, **kw))(params, rows(frames),
                                                                 rows(prompts))
        st.update(prefill_xk=xk, prefill_xv=xv)
    else:
        logits, (k, v) = jax.jit(lambda p, t, x: T.prefill(p, cfg, t, patches=x, **kw))(
            params, rows(prompts), rows(patches))
    st["prefill_logits"] = logits
    if fam != "ssm":
        st.update(prefill_k=k, prefill_v=v)
        L = np.asarray(k).shape[0]
        st["prefill_kpool"] = F.pool_of(cfg, np.asarray(k), F.seq_table(), L)
        st["prefill_vpool"] = F.pool_of(cfg, np.asarray(v), F.seq_table(), L)

    # decode: 4 greedy steps from the prefilled caches
    tok = argmax(logits, cfg)
    lens = np.full(F.B, F.context(cfg), np.int32)
    bt = put(mesh, F.seq_table(), F.ROWS)
    if fam == "ssm":
        state = {n: put(mesh, s, F.RWKV[n]) for n, s in state.items()}
        step = jax.jit(lambda p, t, s: rwkv.decode(p, cfg, t, s, **kw))
    else:
        kp, vp = (put(mesh, st[f"prefill_{n}pool"], F.PAGES) for n in "kv")
    if fam == "hybrid":
        conv = {n: put(mesh, c, F.CONV[n]) for n, c in conv.items()}
        ssm = put(mesh, ssm, F.SSM)
        step = jax.jit(lambda p, t, c, s, kp, vp, bt, l: hybrid.decode(
            p, cfg, t, c, s, kp, vp, bt, l, attn_fn=attn, **kw))
    if fam == "encdec":
        xk, xv = put(mesh, xk, F.KV), put(mesh, xv, F.KV)
        step = jax.jit(lambda p, t, kp, vp, xk, xv, bt, l: encdec.decode(
            p, cfg, t, kp, vp, xk, xv, bt, l, attn_fn=attn, **kw))
    if fam == "vlm":
        step = jax.jit(lambda p, t, kp, vp, bt, l: T.decode(
            p, cfg, t, kp, vp, bt, l, attn_fn=attn, **kw))
    dec, toks = [], []
    for i in range(F.DECODE_STEPS):
        t, ln = rows(tok), rows(lens + i)
        if fam == "hybrid":
            lg, (conv, ssm), (kp, vp) = step(params, t, conv, ssm, kp, vp, bt, ln)
        elif fam == "ssm":
            lg, state = step(params, t, state)
        elif fam == "encdec":
            lg, (kp, vp) = step(params, t, kp, vp, xk, xv, bt, ln)
        else:
            lg, (kp, vp) = step(params, t, kp, vp, bt, ln)
        tok = argmax(lg, cfg)
        dec.append(np.asarray(lg))
        toks.append(tok)
    st.update(decode_logits=np.stack(dec), decode_tokens=np.stack(toks))
    if fam == "hybrid":
        st.update(decode_ssm=ssm, **{f"decode_conv_{n}": c for n, c in conv.items()})
    if fam == "ssm":
        st.update({f"decode_state_{n}": s for n, s in state.items()})
    else:
        st.update(decode_kpool=kp, decode_vpool=vp)

    # mixed steps
    if fam == "vlm":
        mixed = jax.jit(lambda p, mb, kp, vp: T.mixed(
            p, cfg, mb, kp, vp, attn_fn={"decode": attn,
                                         "chunk": spmd.make_sharded_chunk_attn(mesh)}, **kw))
        d_tok = tok
        for i in range(2):
            mb = {k_: rows(v_) for k_, v_ in
                  F.mixed_batch(i, streams, d_tok, F.context(cfg)).items()}
            pl, dl, (kp, vp), _ = mixed(params, mb, kp, vp)
            d_tok = argmax(dl, cfg)
            st.update({f"mixed{i}_p": pl, f"mixed{i}_d": dl})
        st.update(mixed_kpool=kp, mixed_vpool=vp)
    if fam == "ssm":
        mixed = jax.jit(lambda p, mb, ps, ds: rwkv.mixed(p, cfg, mb, ps, ds, **kw))
        p_state = {n: put(mesh, s, F.RWKV[n]) for n, s in
                   rwkv.init_state(cfg, F.P_STREAMS, jnp.float32).items()}
        d_state, d_tok = state, tok
        for i in range(2):
            mb = {k_: rows(v_) for k_, v_ in F.rwkv_mixed_batch(i, streams, d_tok).items()}
            pl, dl, p_state, d_state = mixed(params, mb, p_state, d_state)
            d_tok = argmax(dl, cfg)
            st.update({f"mixed{i}_p": pl, f"mixed{i}_d": dl})
        st.update({f"mixed_p_state_{n}": s for n, s in p_state.items()})
        st.update({f"mixed_d_state_{n}": s for n, s in d_state.items()})
    out.update({f"{key}/{k_}": np.asarray(v_) for k_, v_ in st.items()})


def units(out):
    """The unit cases' inputs and the reference's one-device values."""
    from repro.models import ssm
    from repro.models.layers import rms_norm
    rs = np.random.RandomState(3)
    x = rs.randn(3, 5, 128).astype(np.float32)
    w = (rs.randn(128) * 0.1).astype(np.float32)
    out.update({"unit/norm_x": x, "unit/norm_w": w,
                "unit/want_norm": np.asarray(rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))})

    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), **F.ARCHS["hybrid"][1])
    lp = ssm.mamba2_init(jax.random.PRNGKey(5), cfg, jnp.float32)
    lp = dict(lp, norm=jnp.asarray(rs.randn(*lp["norm"].shape) * 0.1, jnp.float32),
              D_skip=jnp.asarray(rs.rand(*lp["D_skip"].shape) + 0.5, jnp.float32))
    x = jnp.asarray(rs.randn(2, 24, cfg.d_model), jnp.float32)
    cs, ss = ssm.mamba2_state_shapes(cfg, 2)
    conv0 = {k: jnp.zeros(v) for k, v in cs.items()}
    y, conv, h = ssm.mamba2_block(lp, cfg, x, conv0, jnp.zeros(ss), chunk=8)
    y1, conv1, h1 = ssm.mamba2_decode(lp, cfg, x[:, -1], conv, h)
    out.update({f"unit/mamba/{k}": np.asarray(v) for k, v in lp.items()})
    out.update({"unit/mamba_x": np.asarray(x), "unit/want_mamba_y": np.asarray(y),
                "unit/want_mamba_h": np.asarray(h), "unit/want_mamba_y1": np.asarray(y1),
                "unit/want_mamba_h1": np.asarray(h1)})
    out.update({f"unit/want_mamba_conv_{k}": np.asarray(v) for k, v in conv.items()})
    out.update({f"unit/want_mamba_conv1_{k}": np.asarray(v) for k, v in conv1.items()})

    tokens = rs.randint(0, F.VOCAB, (3, 7)).astype(np.int32)
    tokens[0, :2] = (0, F.VOCAB - 1)
    out["unit/embed_tokens"] = tokens
    for fam in ("encdec", "ssm"):
        table = out[f"{fam}/params1/embed"]
        out[f"unit/embed_{fam}"] = table
        # the reference's lookups: encdec's decoder and rwkv's forward take
        # rows of the table, with no scale
        out[f"unit/want_embed_{fam}"] = np.asarray(jnp.take(jnp.asarray(table),
                                                            jnp.asarray(tokens), axis=0))


def main():
    path = sys.argv[1]
    out = {}
    for fam, (arch, over) in F.ARCHS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        out[f"{fam}/cfg"] = np.array(json.dumps(over))
        params = FAMILY_MODULE[cfg.family].init_params(cfg, jax.random.PRNGKey(0), tp=1)
        out.update(M.flat(jax.tree.map(np.asarray, params), f"{fam}/params1/"))
        for shape in F.MESHES:
            run(fam, cfg, shape, out)
    units(out)
    np.savez(path, **out)


if __name__ == "__main__":
    main()
