"""The mesh tests' scenario (``mesh_ranks.py``) through the reference's
own sharded steps, on forced host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/spmd_reference.py OUT.npz ARCH [ARCH ...]

``ARCH`` is ``qwen3`` (reduced qwen3-0.6b, vocab 200 so the padded
vocab columns fall on the last model rank; meshes 2 x 2 and 1 x 4, whose
tp = 4 pads its 2 KV heads to 4) or ``olmoe`` (reduced olmoe-1b-7b at a
capacity factor of 1, so experts overflow and drop tokens; meshes 2 x 2
and 1 x 2, and the mixed step on a 1 x 2 mesh on each data shard's rows
from the 2 x 2 run's decode states, ``<arch>/2x2-shards``).  Every mesh
is ``jax.make_mesh`` over the first devices with Auto axes; params are
placed by ``launch/shardings.py::param_pspecs``, pools over (data,
model); the steps are ``models/transformer.py``'s ``prefill``,
``decode`` and ``mixed`` with ``launch/spmd.py``'s islands, jitted.
Writes, per run ``<arch>/<n_data>x<tp>``, the steps' logits, greedy
tokens, prefill K/V and pools (``mesh_ranks.rank_main`` reads the same
keys), and ``<arch>/params<tp>/...`` and ``<arch>/cfg``.
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

import mesh_ranks as M  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.kernels.kv_int8 import q8_kv  # noqa: E402
from repro.launch import spmd  # noqa: E402
from repro.launch.shardings import param_pspecs  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.models.sharding import Policy, make_rules  # noqa: E402

ARCHS = {
    "qwen3": ("qwen3-0.6b", dict(vocab_size=200), [(2, 2), (1, 4)]),
    "olmoe": ("olmoe-1b-7b", dict(moe_capacity_factor=1.0), [(2, 2), (1, 2)]),
}


def mesh_of(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def steps(cfg, mesh, tp):
    """The jitted sharded steps on ``mesh``."""
    policy = Policy(make_rules(("data",), "model"), mesh)
    moe_fn = spmd.make_sharded_moe_fn(mesh, cfg, tp=tp) if cfg.is_moe else None
    kw = dict(tp=tp, policy=policy, moe_fn=moe_fn)
    dec = spmd.make_sharded_decode_attn(mesh)
    mixed = {i8: {"decode": spmd.make_sharded_decode_attn(mesh, kv_int8=i8),
                  "chunk": spmd.make_sharded_chunk_attn(mesh, kv_int8=i8)}
             for i8 in (False, True)}
    return dict(
        prefill=jax.jit(lambda p, t: T.prefill(p, cfg, t, **kw)),
        decode=jax.jit(lambda p, t, kp, vp, bt, l: T.decode(
            p, cfg, t, kp, vp, bt, l, attn_fn=dec, **kw)),
        mixed={i8: jax.jit(lambda p, mb, kp, vp, i8=i8: T.mixed(
            p, cfg, mb, kp, vp, attn_fn=mixed[i8], **kw)) for i8 in (False, True)})


def place(mesh, params, cfg, tp):
    specs = param_pspecs(jax.eval_shape(lambda: params), cfg, tp=tp)
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                        params, specs, is_leaf=lambda x: isinstance(x, P))


def pools(mesh, *arrays):
    sh = NamedSharding(mesh, P(None, "data", None, "model", None))
    return [jax.device_put(jnp.asarray(a), sh) for a in arrays]


def argmax(logits, cfg):
    return np.asarray(logits)[:, :cfg.vocab_size].argmax(-1).astype(np.int32)


def run_mixed(fns, params, cfg, mesh, out, key, state, rows_d=None, n_shards=1):
    """The two mixed steps, fp and int8, from ``state`` (post-decode pools
    and tokens); with ``rows_d`` only data shard ``rows_d``'s rows of
    ``n_shards``."""
    _, streams = M.inputs(cfg.vocab_size)

    def rows(a):
        if rows_d is None:
            return a
        k = a.shape[0] // n_shards
        return a[rows_d * k:(rows_d + 1) * k]

    for i8 in (False, True):
        name = "int8" if i8 else "fp"
        if i8:
            kq, ks = q8_kv(jnp.asarray(state["decode_kpool"]))
            vq, vs = q8_kv(jnp.asarray(state["decode_vpool"]))
            kp = dict(zip("qs", pools(mesh, kq, ks)))
            vp = dict(zip("qs", pools(mesh, vq, vs)))
        else:
            kp, vp = pools(mesh, state["decode_kpool"], state["decode_vpool"])
        d_tok = rows(state["decode_tokens"][-1])
        for step in range(2):
            mb = {k: jnp.asarray(rows(v)) for k, v in
                  M.mixed_batch(step, streams, np.zeros(M.B, np.int32)).items()}
            mb["d_tokens"] = jnp.asarray(d_tok)
            pl, dl, (kp, vp), _ = fns["mixed"][i8](params, mb, kp, vp)
            d_tok = argmax(dl, cfg)
            out[f"{key}/mixed_{name}{step}_p"] = np.asarray(pl)
            out[f"{key}/mixed_{name}{step}_d"] = np.asarray(dl)
        if i8:
            for n, pool in (("k", kp), ("v", vp)):
                out[f"{key}/mixed_{name}_{n}pool"] = np.asarray(pool["q"])
                out[f"{key}/mixed_{name}_{n}scale"] = np.asarray(pool["s"])
        else:
            out[f"{key}/mixed_{name}_kpool"] = np.asarray(kp)
            out[f"{key}/mixed_{name}_vpool"] = np.asarray(vp)


def run(arch, cfg, tp, shape, out):
    key = f"{arch}/{shape[0]}x{shape[1]}"
    mesh = mesh_of(shape)
    params = T.init_params(cfg, jax.random.PRNGKey(0), tp=tp)
    out.update(M.flat(jax.tree.map(np.asarray, params), f"{arch}/params{tp}/"))
    params = place(mesh, params, cfg, tp)
    fns = steps(cfg, mesh, tp)
    prompts, _ = M.inputs(cfg.vocab_size)

    logits, (k, v) = fns["prefill"](params, jnp.asarray(prompts))
    k, v = np.asarray(k), np.asarray(v)
    shape_pool = (cfg.n_layers, M.N, M.PS) + k.shape[3:]
    kpool = M.write_prefill(np.zeros(shape_pool, np.float32), k, M.seq_table())
    vpool = M.write_prefill(np.zeros(shape_pool, np.float32), v, M.seq_table())
    st = dict(prefill_logits=np.asarray(logits), prefill_k=k, prefill_v=v,
              prefill_kpool=kpool, prefill_vpool=vpool)

    kp, vp = pools(mesh, kpool, vpool)
    tok, lens = argmax(logits, cfg), np.full(M.B, M.S, np.int32)
    dec, toks = [], []
    for _ in range(M.DECODE_STEPS):
        lg, (kp, vp) = fns["decode"](params, jnp.asarray(tok), kp, vp,
                                     jnp.asarray(M.seq_table()), jnp.asarray(lens))
        tok, lens = argmax(lg, cfg), lens + 1
        dec.append(np.asarray(lg))
        toks.append(tok)
    st.update(decode_logits=np.stack(dec), decode_tokens=np.stack(toks),
              decode_kpool=np.asarray(kp), decode_vpool=np.asarray(vp))
    for n in ("k", "v"):
        q, s = q8_kv(jnp.asarray(st[f"decode_{n}pool"]))
        st[f"decode_q{n}pool"], st[f"decode_q{n}scale"] = np.asarray(q), np.asarray(s)
    out.update({f"{key}/{k_}": v_ for k_, v_ in st.items()})
    if not (cfg.is_moe and shape[0] > 1):
        run_mixed(fns, params, cfg, mesh, out, key, st)
        return
    # data-sharded MoE: the mixed step on each data shard's rows alone
    mesh1 = mesh_of((1, shape[1]))
    p1, fns1 = place(mesh1, T.init_params(cfg, jax.random.PRNGKey(0), tp=tp), cfg, tp), \
        steps(cfg, mesh1, tp)
    shards = [{} for _ in range(shape[0])]
    for d in range(shape[0]):
        run_mixed(fns1, p1, cfg, mesh1, shards[d], "s", st, rows_d=d, n_shards=shape[0])
    n = M.N // shape[0]
    for name in shards[0]:
        parts = [sh[name] for sh in shards]
        if "pool" in name or "scale" in name:      # each shard's block of pages
            val = np.concatenate([p[:, d * n:(d + 1) * n] for d, p in enumerate(parts)], 1)
        else:
            val = np.concatenate(parts)
        out[f"{key}-shards/{name[2:]}"] = val


def main():
    path, archs = sys.argv[1], sys.argv[2:]
    out = {}
    for a in archs:
        arch, over, meshes = ARCHS[a]
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        out[f"{arch}/cfg"] = np.array(json.dumps(over))
        params = T.init_params(cfg, jax.random.PRNGKey(0), tp=1)    # for tp = 1 meshes
        out.update(M.flat(jax.tree.map(np.asarray, params), f"{arch}/params1/"))
        for shape in meshes:
            run(arch, cfg, shape[1], shape, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main()
