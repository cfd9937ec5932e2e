"""The sharded train step's cases (``mesh_train_ranks.CASES``) and
grok-1-314b's FSDP'd serving steps through the reference's own jitted
steps, on forced host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/spmd_train_reference.py OUT.npz

Each training case builds its step as the reference's
``launch/steps.py::build_train`` does (scheme ``tp``: ``make_rules(...,
fsdp=True)``, params placed by ``param_pspecs(fsdp_size=n_data,
fsdp="data")``, the MoE through ``make_sharded_moe_fn(fsdp_gather=True)``;
scheme ``fsdp``: tp = 1, batch and FSDP over (data, model), heads, ff,
vocab and experts whole, ``moe_fn=None``; moments placed by its
``_opt_specs``), on a reduced config at B x T = 4 x 16, and writes, under
``<case>/``: the initial params, the two batches, the gradients of the
first batch (``jax.value_and_grad`` of the sharded loss), each step's
loss on every data shard (a device's value: ``<case>/loss<i>``
``[n_data]``), gnorm and lr, the params after each step, and with int8
moments the moments after the first step.  ``grok/`` holds a reduced
grok-1-314b's prefill and decode (``mesh_ranks.py``'s scenario) at 2 x 2
with its weights FSDP'd over data, as the reference's serving cells
place them.
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
import mesh_train_ranks as R  # noqa: E402
from repro.configs import TrainConfig, get_config  # noqa: E402
from repro.launch import spmd  # noqa: E402
from repro.launch.shardings import param_pspecs  # noqa: E402
from repro.launch.steps import _opt_specs  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.models.registry import CACHE_KIND, FAMILY_MODULE, Model  # noqa: E402
from repro.models.sharding import Policy, make_rules  # noqa: E402
from repro.optim.adamw import Q8  # noqa: E402
from repro.train.trainer import init_state, make_loss_fn, make_train_step  # noqa: E402


def mesh_of(shape):
    n = shape[0] * shape[1]
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def is_spec(x):
    return isinstance(x, P)


def train_setup(model, mesh, scheme, tcfg):
    """(step, loss_fn, params' specs, moments' specs, batch spec, tp) as
    ``build_train`` makes them."""
    cfg = model.cfg
    n_data, tp = mesh.shape["data"], mesh.shape["model"]
    shapes = jax.eval_shape(lambda: init_state(model, jax.random.PRNGKey(0), tcfg,
                                               tp=1 if scheme == "fsdp" else tp))
    if scheme == "fsdp":
        tp, flat = 1, ("data", "model")
        rules = dict(make_rules(flat, "model", fsdp=True))
        for k in ("batch", "tokens", "pages", "fsdp"):
            rules[k] = flat
        for k in ("heads", "kv_heads", "ff", "vocab", "experts"):
            rules[k] = None
        policy, moe_fn = Policy(rules, mesh), None
        p_specs = param_pspecs(shapes["params"], cfg, tp=1, fsdp_size=n_data * mesh.shape["model"],
                               fsdp=flat)
        bspec = P(flat, None)
    else:
        policy = Policy(make_rules(("data",), "model", fsdp=True), mesh)
        moe_fn = (spmd.make_sharded_moe_fn(mesh, cfg, tp=tp, data=("data",), fsdp_gather=True)
                  if cfg.is_moe else None)
        p_specs = param_pspecs(shapes["params"], cfg, tp=tp, fsdp_size=n_data, fsdp="data")
        bspec = P("data", None)
    o_specs = _opt_specs(shapes["opt"], p_specs, ("data",), tp)
    kw = dict(tp=tp, policy=policy, moe_fn=moe_fn)
    return (make_train_step(model, tcfg, **kw), make_loss_fn(model, tcfg, **kw),
            p_specs, o_specs, bspec, tp)


def by_data(arr, mesh):
    """A scalar's value on each data shard's devices (model rank 0)."""
    devs = list(mesh.devices[:, 0])
    vals = {devs.index(s.device): float(np.asarray(s.data)) for s in arr.addressable_shards
            if s.device in devs}
    return np.array([vals[d] for d in range(len(devs))], np.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def run_case(name, out, cases=None, prepare=None):
    """Case ``name`` of ``cases`` (default ``mesh_train_ranks.CASES``);
    ``prepare`` maps the initial params before anything runs."""
    case = (cases or R.CASES)[name]
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["over"])
    model = Model(case["arch"], cfg, FAMILY_MODULE[cfg.family], CACHE_KIND[cfg.family])
    mesh = mesh_of(case["shape"])
    tcfg = TrainConfig(**R.TCFG, loss_impl=case["loss"], int8_moments=case["int8"],
                       microbatch=case.get("micro", 0))
    step, loss_fn, p_specs, o_specs, bspec, tp = train_setup(model, mesh, case["scheme"], tcfg)
    state = init_state(model, jax.random.PRNGKey(0), tcfg, tp=tp)
    if prepare is not None:
        state = dict(state, params=prepare(state["params"]))
    out.update(M.flat(np_tree(state["params"]), f"{name}/params0/"))
    batches = R.batches(cfg)
    for i, b in enumerate(batches):
        out.update({f"{name}/batch{i}/{k}": v for k, v in b.items()})

    def place(tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                            tree, specs, is_leaf=is_spec)

    state = {"params": place(state["params"], p_specs), "opt": place(state["opt"], o_specs)}

    def batch_on_mesh(b):
        return {k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, P(*bspec, *([None] * (v.ndim - 2))))) for k, v in b.items()}

    def grads_of(params, b):
        """The step's gradients: with microbatches the reference's own
        accumulation (``make_train_step``'s ``compute_grads``)."""
        m = tcfg.microbatch
        if not m or m >= R.B:
            return jax.grad(lambda p: loss_fn(p, b)[0])(params)
        mb = jax.tree.map(lambda x: x.reshape((R.B // m, m) + x.shape[1:]), b)

        def body(acc, micro):
            g = jax.grad(lambda p: loss_fn(p, micro)[0])(params)
            return jax.tree.map(jnp.add, acc, g), None
        zero = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        g, _ = jax.lax.scan(body, zero, mb)
        return jax.tree.map(lambda x: x / (R.B // m), g)

    # one program a case: the step, and the gradients of its batch
    jstep = jax.jit(lambda s, b: step(s, b) + (grads_of(s["params"], b),))
    for i, b in enumerate(batches):
        state, m, grads = jstep(state, batch_on_mesh(b))
        if i == 0:
            out.update(M.flat(np_tree(grads), f"{name}/grads/"))
        out[f"{name}/loss{i}"] = by_data(m["loss"], mesh)
        out[f"{name}/gnorm{i}"] = np.float32(m["gnorm"])
        out[f"{name}/lr{i}"] = np.float32(m["lr"])
        out.update(M.flat(np_tree(state["params"]), f"{name}/params{i + 1}/"))
        if case["int8"] and i == 0:
            for mom in ("mu", "nu"):
                flat = jax.tree.map(lambda q: {"q": np.asarray(q.q), "scale": np.asarray(q.scale)}
                                    if isinstance(q, Q8) else {"f32": np.asarray(q)},
                                    state["opt"][mom], is_leaf=lambda x: isinstance(x, Q8))
                out.update(M.flat(flat, f"{name}/{mom}1/"))


def run_grok(out):
    """Reduced grok-1-314b's prefill and 4 greedy decode steps at 2 x 2,
    weights FSDP'd over data (the reference's ``SERVE_FSDP``)."""
    cfg = dataclasses.replace(get_config("grok-1-314b").reduced(), **R.GROK_OVER)
    mesh, tp = mesh_of((2, 2)), 2
    params = T.init_params(cfg, jax.random.PRNGKey(0), tp=tp)
    out.update(M.flat(np_tree(params), f"{R.GROK}/params{tp}/"))
    specs = param_pspecs(jax.eval_shape(lambda: params), cfg, tp=tp, fsdp_size=2, fsdp="data")
    params = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                          params, specs, is_leaf=is_spec)
    policy = Policy(make_rules(("data",), "model"), mesh)
    kw = dict(tp=tp, policy=policy, moe_fn=spmd.make_sharded_moe_fn(mesh, cfg, tp=tp))
    dec = spmd.make_sharded_decode_attn(mesh)
    prefill = jax.jit(lambda p, t: T.prefill(p, cfg, t, **kw))
    decode = jax.jit(lambda p, t, kp, vp, bt, l: T.decode(p, cfg, t, kp, vp, bt, l,
                                                           attn_fn=dec, **kw))
    prompts, _ = M.inputs(cfg.vocab_size)
    logits, (k, v) = prefill(params, jnp.asarray(prompts))
    k, v = np.asarray(k), np.asarray(v)
    shape_pool = (cfg.n_layers, M.N, M.PS) + k.shape[3:]
    kpool = M.write_prefill(np.zeros(shape_pool, np.float32), k, M.seq_table())
    vpool = M.write_prefill(np.zeros(shape_pool, np.float32), v, M.seq_table())
    key = f"{R.GROK}/2x2"
    out.update({f"{key}/prefill_logits": np.asarray(logits), f"{key}/prefill_k": k,
                f"{key}/prefill_v": v, f"{key}/prefill_kpool": kpool,
                f"{key}/prefill_vpool": vpool})
    sh = NamedSharding(mesh, P(None, "data", None, "model", None))
    kp, vp = (jax.device_put(jnp.asarray(a), sh) for a in (kpool, vpool))
    tok = np.asarray(logits)[:, :cfg.vocab_size].argmax(-1).astype(np.int32)
    lens = np.full(M.B, M.S, np.int32)
    dec_logits, toks = [], []
    for _ in range(M.DECODE_STEPS):
        lg, (kp, vp) = decode(params, jnp.asarray(tok), kp, vp, jnp.asarray(M.seq_table()),
                              jnp.asarray(lens))
        tok = np.asarray(lg)[:, :cfg.vocab_size].argmax(-1).astype(np.int32)
        lens = lens + 1
        dec_logits.append(np.asarray(lg))
        toks.append(tok)
    out.update({f"{key}/decode_logits": np.stack(dec_logits),
                f"{key}/decode_tokens": np.stack(toks),
                f"{key}/decode_kpool": np.asarray(kp), f"{key}/decode_vpool": np.asarray(vp)})
    out[f"{R.GROK}/cfg"] = np.array(json.dumps(R.GROK_OVER))


def main():
    path = sys.argv[1]
    out = {}
    for name in R.CASES:
        run_case(name, out)
    run_grok(out)
    np.savez(path, **out)


if __name__ == "__main__":
    main()
