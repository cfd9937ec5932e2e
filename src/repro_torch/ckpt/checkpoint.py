"""Checkpointing with async save, atomic commit and auto-resume, in the
reference's on-disk format (``src/repro/ckpt/checkpoint.py``), so a
checkpoint written by either package loads in the other.

Format: ``step_<n>/arrays.npz``, one array per leaf keyed by its
``/``-joined path (dict keys, list indices, and ``q``/``scale`` for the
fields of an int8 moment, :class:`repro_torch.optim.Q8`), plus
``step_<n>/manifest.json``.  A save is written to a ``.tmp_step_*``
directory and renamed into place, so readers never see a torn
checkpoint.  numpy has no bfloat16: bf16 leaves are stored widened to
f32 and listed in the manifest under ``bfloat16``, and ``load`` narrows
them back.

``relayout_attention_params`` re-lays a transformer checkpoint's padded
GQA heads (``wq``/``wo``) from one tensor-parallel degree's layout to
another's, as the reference's does (elastic resharding).  On a mesh each
rank's ``Trainer`` writes its own shards under ``ckpt_dir/rank<r>`` in
this format (``train/trainer.py``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import Q8


def _flatten(tree, prefix=""):
    """{path: tensor} of a nested dict/list/:class:`Q8` tree."""
    if isinstance(tree, Q8):
        tree = tree._asdict()
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def host_snapshot(state):
    """{path: numpy array} of ``state``, copied to the host now (bf16
    widened to f32), and the paths that were bf16."""
    arrays, bf16 = {}, []
    for key, t in _flatten(state).items():
        t = t.detach()
        if t.dtype == torch.bfloat16:
            bf16.append(key)
            t = t.float()
        arrays[key] = t.to("cpu", copy=True).numpy()
    return arrays, bf16


def save(ckpt_dir: str, step: int, state) -> str:
    """Write ``state`` (a tree of tensors) as checkpoint ``step``; returns
    its directory."""
    return _write(ckpt_dir, step, *host_snapshot(state))


def _write(ckpt_dir: str, step: int, arrays: dict, bf16: list) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "keys": sorted(arrays), "time": time.time()}
    if bf16:
        manifest["bfloat16"] = sorted(bf16)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)            # atomic commit
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def load(ckpt_dir: str, step: int, device=None):
    """Checkpoint ``step`` as a nested dict of tensors on ``device``
    (default cuda): ``{"0": a, "1": b}`` nodes become lists, and the
    ``{"q", "scale"}`` nodes of a training state's moments
    (``opt/mu``, ``opt/nu``) become :class:`Q8`."""
    device = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        bf16 = set(json.load(f).get("bfloat16", ()))
    root: dict = {}
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as data:
        for key in data.files:
            t = torch.from_numpy(data[key]).to(device)
            if key in bf16:
                t = t.to(torch.bfloat16)
            node = root
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    tree = _intify(root)
    opt = tree.get("opt") if isinstance(tree, dict) else None
    if isinstance(opt, dict):
        for k in ("mu", "nu"):
            if k in opt:
                opt[k] = _restore_q8(opt[k])
    return tree


def _intify(node):
    """Convert {'0': a, '1': b} dicts (from lists/tuples) back to lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _intify(v) for k, v in node.items()}
    if node and all(re.fullmatch(r"\d+", k) for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def _restore_q8(node):
    if isinstance(node, dict):
        if set(node) == {"q", "scale"} and not isinstance(node["q"], dict):
            return Q8(node["q"], node["scale"])
        return {k: _restore_q8(v) for k, v in node.items()}
    return node


class AsyncCheckpointer:
    """Snapshot on the host, write in a background thread (training never
    blocks on disk); one save in flight at a time, atomic commit."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None
        self.snapshot_s = 0.0       # host time of the last snapshot

    def save(self, step: int, state):
        self.wait()
        t0 = time.perf_counter()
        arrays, bf16 = host_snapshot(state)            # snapshot now
        self.snapshot_s = time.perf_counter() - t0

        def write():
            try:
                self.last_path = _write(self.ckpt_dir, step, arrays, bf16)
            except Exception as e:              # re-raised by wait()
                self._error = e

        self._error = None
        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self):
        """Block until the save in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._error is not None:
                raise RuntimeError(f"checkpoint write failed: {self._error}") from self._error


# --------------------------------------------------------------- elastic ---
def relayout_attention_params(params, cfg, tp_from: int, tp_to: int):
    """Re-layout padded GQA tensors (wq/wo) between TP degrees.

    Real q heads are extracted with the source layout's q_map and
    re-scattered with the target layout's (padded slots zero). All other
    tensors are layout-independent and returned as they are. Works on the
    transformer family's param tree (full tensors, not a rank's shards)."""
    from repro_torch.models.transformer import gqa_layout
    H, KV = cfg.n_heads, cfg.n_kv_heads
    qm_from = torch.as_tensor(gqa_layout(H, KV, tp_from)[2], dtype=torch.long)
    Hp_to, _, qm_to, _, _ = gqa_layout(H, KV, tp_to)
    qm_to = torch.as_tensor(qm_to, dtype=torch.long)

    def relayout(blocks):
        wq, wo = blocks["wq"], blocks["wo"]               # [L, D, H_p, hd], [L, H_p, hd, D]
        src = torch.zeros(H, dtype=torch.long)
        real = qm_from >= 0
        src[qm_from[real]] = torch.nonzero(real)[:, 0]      # real head -> source slot
        src, pick, keep = (t.to(wq.device) for t in (src, qm_to.clamp(min=0), qm_to >= 0))
        out = dict(blocks)
        out["wq"] = torch.where(keep[None, None, :, None], wq[:, :, src][:, :, pick], 0)
        out["wo"] = torch.where(keep[None, :, None, None], wo[:, src][:, pick], 0)
        return out

    out = dict(params)
    out["blocks"] = relayout(params["blocks"])
    return out
