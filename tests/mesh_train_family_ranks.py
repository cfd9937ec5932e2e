"""JAX-free helpers of ``tests/test_torch_mesh_train_families.py``: the
sharded train step of the zamba2 hybrid, rwkv6 and seamless-m4t, gradient
accumulation on a mesh, the decode ``2d`` scheme and the replicated decode
batch; the port's gloo ranks that run them and the comparison with the
reference's outputs (``spmd_train_family_reference.py``).

Training cases (``TRAIN_CASES``) are ``mesh_train_ranks.CASES``' kind: a
reduced config, a mesh, the reference's ``build_train`` scheme, two steps
of B x T = 4 x 16 at ``mesh_train_ranks.TCFG``; here every all-zero
initial leaf (norm scales, the hybrid's LoRA ``*b``, rwkv6's ``u``) is
drawn small and random first (``spmd_family_reference.nonzero``), so that
each sharded piece moves the loss from the first step.  ``micro`` is the
microbatch: B = 4 in microbatches of 2 rows, one row of each a data shard.

Decode cases (``DECODE_CASES``) run ``DECODE_STEPS`` steps of the
reference's ``build_decode`` cell on a 2 x 2 mesh at ``DECODE_SEQ``
tokens of context (pages of 64), from random pools and states, fed the
reference's greedy tokens: olmoe-1b-7b's ``2d`` scheme at B = 4, and a
batch of one row (replicated over data with its caches) for qwen3,
internvl2, zamba2 and rwkv6; seamless-m4t's one row is refused by both
packages (its reference step shards the batch over data).
"""
from __future__ import annotations

import os

import numpy as np

import mesh_family_ranks as F
import mesh_train_ranks as R

VOCAB = 200
TRAIN_CASES = {
    "zamba2-tp-2x2": dict(arch="zamba2-7b", over=dict(vocab_size=VOCAB, n_layers=2),
                          shape=(2, 2), scheme="tp", loss="chunked", int8=False),
    "zamba2-tp-1x4": dict(arch="zamba2-7b", over=dict(vocab_size=VOCAB, n_layers=2),
                          shape=(1, 4), scheme="tp", loss="chunked", int8=False),
    "zamba2-fsdp-2x2": dict(arch="zamba2-7b", over=dict(vocab_size=VOCAB, n_layers=2),
                            shape=(2, 2), scheme="fsdp", loss="chunked", int8=False),
    "rwkv6-tp-2x2": dict(arch="rwkv6-7b", over=dict(vocab_size=VOCAB), shape=(2, 2),
                         scheme="tp", loss="chunked", int8=False),
    "seamless-tp-2x2": dict(arch="seamless-m4t-medium", over=dict(vocab_size=VOCAB),
                            shape=(2, 2), scheme="tp", loss="chunked", int8=False),
    "qwen3-tp-2x2-micro": dict(arch="qwen3-0.6b", over=dict(vocab_size=VOCAB), shape=(2, 2),
                               scheme="tp", loss="chunked", int8=False, micro=2),
    "olmoe-tp-2x2-micro": dict(arch="olmoe-1b-7b", over=dict(moe_capacity_factor=1.0),
                               shape=(2, 2), scheme="tp", loss="chunked", int8=False, micro=2),
}

DECODE_SHAPE, DECODE_STEPS, DECODE_SEQ, DECODE_SHAPE_NAME = (2, 2), 3, 100, "decode_cut"
DECODE_CASES = {
    "olmoe-2d": dict(arch="olmoe-1b-7b", over=dict(vocab_size=VOCAB), scheme="2d", batch=4),
    "qwen3-b1": dict(arch="qwen3-0.6b", over=dict(vocab_size=VOCAB), scheme="baseline",
                     batch=1),
    "internvl2-b1": dict(arch="internvl2-2b", over=dict(vocab_size=VOCAB), scheme="baseline",
                         batch=1),
    "zamba2-b1": dict(arch="zamba2-7b", over=dict(vocab_size=VOCAB, n_layers=5),
                      scheme="baseline", batch=1),
    "rwkv6-b1": dict(arch="rwkv6-7b", over=dict(vocab_size=VOCAB), scheme="baseline",
                     batch=1),
    "seamless-b1": dict(arch="seamless-m4t-medium", over=dict(vocab_size=VOCAB),
                        scheme="baseline", batch=1),
}
# the caches a decode cell takes after its params and tokens, by family
CACHES = {"dense": ("kpool", "vpool"), "moe": ("kpool", "vpool"), "vlm": ("kpool", "vpool"),
          "hybrid": ("conv/x", "conv/B", "conv/C", "ssm", "kpool", "vpool"),
          "ssm": ("state/x_tm", "state/x_cm", "state/S")}


def decode_lens(batch):
    """Each row's context before the first step (its next position)."""
    return (DECODE_SEQ - 1 - 7 * np.arange(batch)).astype(np.int32)


def decode_table(batch, pmax, n_pages, n_data):
    """[batch, pmax] global page ids: with ``n_data`` > 1 (data-sharded
    pages) row i on data shard i // (batch / n_data)'s block of the pool,
    else rows one after another."""
    per, n_loc = batch // n_data, n_pages // n_data
    return np.stack([(i // per) * n_loc + (i % per) * pmax + np.arange(pmax)
                     for i in range(batch)]).astype(np.int32)


def _cache_spec(name, sharded):
    from repro_torch.launch.steps import CACHE_SPECS
    spec = {"kpool": CACHE_SPECS["pages"], "vpool": CACHE_SPECS["pages"],
            "ssm": CACHE_SPECS["ssm"]}.get(name)
    if spec is None:
        kind, key = name.split("/")
        spec = CACHE_SPECS["rwkv" if kind == "state" else kind][key]
    return spec if sharded else tuple(None if a == "data" else a for a in spec)


# ------------------------------------------------------------- the port ---
def decode_main(case_path, out_dir):
    """One rank of the 2 x 2 mesh: each decode case through the port's
    ``launch/steps.py::build_decode`` cell (its shape cut to
    ``DECODE_SEQ`` and the case's batch) on the reference's weights and
    caches, fed the reference's tokens; outputs to
    ``out_dir/dec-<name>-rank<r>.npz``, and seamless-m4t's refusal."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import get_model

    import mesh_ranks as M

    ref = np.load(case_path)
    mesh = make_mesh(DECODE_SHAPE, device_type="cpu")
    t = torch.from_numpy
    for name, case in DECODE_CASES.items():
        cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["over"])
        B = case["batch"]
        steps.SHAPES[DECODE_SHAPE_NAME] = dict(kind="decode", seq=DECODE_SEQ, batch=B)
        out = {}
        if cfg.family == "encdec":
            try:
                steps.build_decode(case["arch"], DECODE_SHAPE_NAME, mesh=mesh, cfg=cfg,
                                   scheme=case["scheme"])
                out["error"] = np.array("")
            except ValueError as e:
                out["error"] = np.array(str(e))
            np.savez(os.path.join(out_dir, f"dec-{name}-rank{dist.get_rank()}.npz"), **out)
            continue
        key = f"dec/{name}"
        cell = steps.build_decode(case["arch"], DECODE_SHAPE_NAME, mesh=mesh, cfg=cfg,
                                  scheme=case["scheme"])
        shard = steps._Shard(get_model(case["arch"], cfg), mesh, batch=B, scheme=case["scheme"])
        policy = shard.policy
        coords, sizes = dict(policy.coords), dict(policy.sizes)
        params = shard.slice(params_from_jax(M.unflat(ref, f"{key}/params/"), device="cpu"))
        caches = {n: t(np.ascontiguousarray(F.cut(ref[f"{key}/in/{n}"],
                                                  _cache_spec(n, shard.caches_sharded),
                                                  coords, sizes)))
                  for n in CACHES[cfg.family]}
        rows = lambda a: shard.rows(t(np.ascontiguousarray(a)))    # noqa: E731
        if cfg.family != "ssm":
            bt, lens = rows(ref[f"{key}/in/bt"]), rows(ref[f"{key}/in/lens"])
        logits = []
        with torch.inference_mode():
            for i in range(DECODE_STEPS):
                tok = rows(ref[f"{key}/tokens"][i])
                if cfg.family == "ssm":
                    state = {k: caches[f"state/{k}"] for k in ("x_tm", "x_cm", "S")}
                    lg, state = cell["fn"](params, tok, state)
                    caches.update({f"state/{k}": v for k, v in state.items()})
                elif cfg.family == "hybrid":
                    conv = {k: caches[f"conv/{k}"] for k in ("x", "B", "C")}
                    lg, _, _ = cell["fn"](params, tok, conv, caches["ssm"], caches["kpool"],
                                          caches["vpool"], bt, lens + i)
                else:
                    lg, _ = cell["fn"](params, tok, caches["kpool"], caches["vpool"], bt,
                                       lens + i)
                logits.append(lg)
        out = {"logits": torch.stack(logits).numpy(), "note": np.array(cell["note"]),
               **{f"out/{n}": v.numpy() for n, v in caches.items()}}
        np.savez(os.path.join(out_dir, f"dec-{name}-rank{dist.get_rank()}.npz"),
                 coords=np.array([coords["data"], coords["model"]]),
                 sharded=np.array(shard.caches_sharded), **out)


# ------------------------------------------------------------- compare ---
def compare_train(out_dir, ref, name):
    return R.compare(out_dir, ref, name, TRAIN_CASES)


def compare_decode(out_dir, ref, name):
    """Every rank's decode outputs of case ``name`` against the
    reference's: the largest logit gap over the steps (every row, the
    batch being whole on each rank), the greedy tokens, and the largest
    gap of the rank's block of each cache after the steps."""
    case = DECODE_CASES[name]
    key = f"dec/{name}"
    res = dict(ranks=0, logit_gap=0.0, tokens_equal=True, cache_gap=0.0, compared=0)
    for r in range(DECODE_SHAPE[0] * DECODE_SHAPE[1]):
        o = np.load(os.path.join(out_dir, f"dec-{name}-rank{r}.npz"))
        d, m = (int(x) for x in o["coords"])
        coords, sizes = {"data": d, "model": m}, {"data": 2, "model": 2}
        res["ranks"] += 1
        want = ref[f"{key}/logits"]
        res["logit_gap"] = max(res["logit_gap"], float(np.abs(o["logits"] - want).max()))
        res["tokens_equal"] &= bool(np.array_equal(o["logits"][..., :VOCAB].argmax(-1),
                                                   want[..., :VOCAB].argmax(-1)))
        family = "ssm" if "rwkv" in case["arch"] else (
            "hybrid" if "zamba" in case["arch"] else "dense")
        for n in CACHES[family]:
            w = F.cut(ref[f"{key}/out/{n}"], _cache_spec(n, bool(o["sharded"])), coords, sizes)
            assert o[f"out/{n}"].shape == w.shape, (n, o[f"out/{n}"].shape, w.shape)
            res["cache_gap"] = max(res["cache_gap"],
                                   float(np.abs(o[f"out/{n}"] - w).max()))
            res["compared"] += 1
    return res
