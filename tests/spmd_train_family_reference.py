"""``mesh_train_family_ranks.py``'s cases through the reference's own
jitted sharded steps, on forced host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/spmd_train_family_reference.py OUT.npz [PART]

Training cases (``TRAIN_CASES``): ``spmd_train_reference.run_case``, the
reference's ``build_train`` step of each scheme, with every all-zero
initial leaf drawn small and random (``spmd_family_reference.nonzero``)
and, for a microbatched case, the gradients of the reference's own
accumulation.  Decode cases (``DECODE_CASES``): the reference's
``launch/steps.py::build_decode`` itself on a 2 x 2 mesh, its config and
shape replaced by the case's (its ``get_config`` and a ``SHAPES`` entry),
jitted with the cell's ``in_shardings`` on f32 params of the family's
``init_params(..., tp=2)`` (made nonzero), random pools and states of
the cell's shapes, and ``DECODE_STEPS`` steps fed its own greedy tokens;
writes under ``dec/<name>/`` the params, the inputs, the tokens fed, each
step's logits and the caches after the last step, or, where the cell does
not build or lower (seamless-m4t's one row over two data shards), its
error.
"""
import dataclasses
import os
import sys

import jax
import numpy as np
from jax.sharding import NamedSharding

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import mesh_ranks as M  # noqa: E402
import mesh_train_family_ranks as TF  # noqa: E402
import spmd_train_reference as TR  # noqa: E402
from spmd_family_reference import nonzero  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import steps  # noqa: E402
from repro.models.registry import FAMILY_MODULE  # noqa: E402


def run_decode(name, out):
    case = TF.DECODE_CASES[name]
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["over"])
    key, B = f"dec/{name}", case["batch"]
    steps.get_config = lambda arch: cfg
    steps.SHAPES[TF.DECODE_SHAPE_NAME] = dict(kind="decode", seq=TF.DECODE_SEQ, batch=B)
    mesh = TR.mesh_of(TF.DECODE_SHAPE)
    tp = TF.DECODE_SHAPE[1]
    try:
        cell = steps.build_decode(case["arch"], mesh, TF.DECODE_SHAPE_NAME, case["scheme"])
        shard = jax.tree.map(lambda s: NamedSharding(mesh, s), cell["in_shardings"],
                             is_leaf=TR.is_spec)
        fn = jax.jit(cell["fn"], in_shardings=shard)
        fn.lower(*cell["args"])
    except Exception as e:              # the reference refuses the cell
        out[f"{key}/error"] = np.array(f"{type(e).__name__}: {e}")
        return
    params = nonzero(FAMILY_MODULE[cfg.family].init_params(cfg, jax.random.PRNGKey(0), tp=tp))
    out.update(M.flat(jax.tree.map(np.asarray, params), f"{key}/params/"))
    rs = np.random.RandomState(11)
    sds = cell["args"][1:]
    names = TF.CACHES[cfg.family if cfg.family in TF.CACHES else "dense"]
    if cfg.family == "ssm":
        caches = {f"state/{k}": rs.randn(*v.shape).astype(np.float32) * 0.5
                  for k, v in sds[1].items()}
        args = lambda tok: (params, tok, {k: caches[f"state/{k}"] for k in sds[1]})  # noqa
    else:
        flat = ([(f"conv/{k}", v) for k, v in sds[1].items()] + [("ssm", sds[2])]
                if cfg.family == "hybrid" else [])
        kp, vp, bt = sds[-4], sds[-3], sds[-2]
        flat += [("kpool", kp), ("vpool", vp)]
        caches = {n: rs.randn(*v.shape).astype(np.float32) * 0.5 for n, v in flat}
        pages_sharded = cell["in_shardings"][-4][1] is not None
        table = TF.decode_table(B, bt.shape[1], kp.shape[1], 2 if pages_sharded else 1)
        lens = TF.decode_lens(B)
        out.update({f"{key}/in/bt": table, f"{key}/in/lens": lens})

        def args(tok, i):
            lead = (({k: caches[f"conv/{k}"] for k in ("x", "B", "C")}, caches["ssm"])
                    if cfg.family == "hybrid" else ())
            return (params, tok) + lead + (caches["kpool"], caches["vpool"], table, lens + i)
    assert sorted(caches) == sorted(names), (sorted(caches), names)
    out.update({f"{key}/in/{n}": v for n, v in caches.items()})
    tok = rs.randint(1, cfg.vocab_size, (B,)).astype(np.int32)
    toks, logits = [], []
    for i in range(TF.DECODE_STEPS):
        toks.append(tok)
        if cfg.family == "ssm":
            lg, state = fn(*args(tok))
            caches = {f"state/{k}": np.asarray(v) for k, v in state.items()}
        elif cfg.family == "hybrid":
            lg, (conv, ssm), (kp_, vp_) = fn(*args(tok, i))
            caches = dict({f"conv/{k}": np.asarray(v) for k, v in conv.items()},
                          ssm=np.asarray(ssm), kpool=np.asarray(kp_), vpool=np.asarray(vp_))
        else:
            lg, (kp_, vp_) = fn(*args(tok, i))
            caches = dict(kpool=np.asarray(kp_), vpool=np.asarray(vp_))
        logits.append(np.asarray(lg))
        tok = np.asarray(lg)[:, :cfg.vocab_size].argmax(-1).astype(np.int32)
    out.update({f"{key}/tokens": np.stack(toks), f"{key}/logits": np.stack(logits)})
    out.update({f"{key}/out/{n}": v for n, v in caches.items()})


# four parts of about equal XLA compile time, that a caller can run side
# by side (decode: every decode case)
PARTS = {"zamba2-2x2": ("zamba2-tp-2x2",),
         "zamba2-1x4": ("zamba2-tp-1x4", "qwen3-tp-2x2-micro"),
         "encdec": ("seamless-tp-2x2", "decode"),
         "others": ("zamba2-fsdp-2x2", "rwkv6-tp-2x2", "olmoe-tp-2x2-micro")}


def main():
    """``OUT.npz [PART]``: every case, or those of ``PARTS[PART]``."""
    path = sys.argv[1]
    names = (PARTS[sys.argv[2]] if len(sys.argv) > 2
             else tuple(TF.TRAIN_CASES) + ("decode",))
    out = {}
    for name in TF.TRAIN_CASES:
        if name in names:
            TR.run_case(name, out, TF.TRAIN_CASES, prepare=nonzero)
    for name in TF.DECODE_CASES if "decode" in names else ():
        run_decode(name, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main()
