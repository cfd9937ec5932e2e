"""Deterministic synthetic data pipeline (PyTorch port: a copy of the
reference package's ``data/synthetic.py``; ``make_train_data_fn`` hands
out torch tensors).

Training: a seeded, step-indexed token stream with local n-gram structure
(so the LM loss genuinely decreases — pure-uniform tokens would not train).
Determinism in `step` is what makes checkpoint/restart bitwise reproducible
and is the straggler-/failure-safe property real pipelines need (any host
can recompute any step's shard without coordination).

Serving: synthetic radiology-report-shaped prompts standing in for the
paper's MIMIC-III CT/MR reports (30k de-identified notes; we generate
matched-length synthetic text instead — no clinical data in the repo).
"""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np


# ------------------------------------------------------------- training ----
def _rng_for(seed: int, step: int) -> np.random.Generator:
    mix = int.from_bytes(
        hashlib.blake2s(f"{seed}:{step}".encode(), digest_size=8).digest(), "little")
    return np.random.default_rng(mix)


def lm_batch(step: int, *, batch: int, seq: int, vocab: int, seed: int = 0,
             order: int = 3):
    """Markov-ish synthetic tokens [batch, seq+1] -> (tokens, labels)."""
    rng = _rng_for(seed, step)
    # deterministic per-seed transition structure: next = f(prev) + noise
    a = (seed * 2654435761 + 97) % vocab
    toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
    for t in range(1, seq + 1):
        follow = (toks[:, t - 1] * 31 + a) % vocab
        use = rng.random(batch) < 0.85
        toks[:, t] = np.where(use, follow, toks[:, t])
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def make_train_data_fn(cfg, tcfg, extra: str = ""):
    """step -> batch dict for the arch's family (adds frames/patches stubs)."""
    import torch

    def fn(step: int):
        b = lm_batch(step, batch=tcfg.global_batch, seq=tcfg.seq_len,
                     vocab=cfg.vocab_size, seed=tcfg.seed)
        out = {k: torch.as_tensor(v) for k, v in b.items()}
        if cfg.family == "encdec":
            rng = _rng_for(tcfg.seed + 1, step)
            out["frames"] = torch.as_tensor(
                rng.standard_normal((tcfg.global_batch, cfg.encoder_seq,
                                     cfg.d_model), dtype=np.float32) * 0.3)
        if cfg.family == "vlm":
            rng = _rng_for(tcfg.seed + 2, step)
            out["patches"] = torch.as_tensor(
                rng.standard_normal((tcfg.global_batch, cfg.n_vision_patches,
                                     cfg.d_vision), dtype=np.float32) * 0.3)
        return out

    return fn


# -------------------------------------------------------------- serving ----
_SECTIONS = ["EXAMINATION", "INDICATION", "TECHNIQUE", "COMPARISON",
             "FINDINGS", "IMPRESSION"]
_FINDINGS = [
    "no acute intracranial abnormality", "mild mucosal thickening",
    "stable postsurgical changes", "no evidence of pulmonary embolism",
    "scattered calcified granulomas", "unremarkable soft tissues",
    "no focal consolidation", "trace pleural effusion",
    "degenerative changes of the spine", "patent major vessels",
]


def synthetic_reports(n: int, seed: int = 0) -> List[str]:
    """Synthetic CT/MR report text shaped like the paper's MIMIC-III data."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        parts = []
        for s in _SECTIONS:
            k = int(rng.integers(1, 4))
            body = "; ".join(rng.choice(_FINDINGS, size=k))
            parts.append(f"{s}: {body}.")
        out.append(f"Report {i}. " + " ".join(parts))
    return out


def report_tokens(n: int, length: int, vocab: int, seed: int = 0):
    """Tokenized prompts: hash-tokenizer over synthetic reports, padded or
    cycled to exactly `length` tokens (the paper controls input-token count
    explicitly — §III-A1)."""
    texts = synthetic_reports(n, seed)
    out = []
    for t in texts:
        words = t.split()
        ids = [(int.from_bytes(hashlib.blake2s(w.encode(), digest_size=4)
                               .digest(), "little") % (vocab - 2)) + 2
               for w in words]
        while len(ids) < length:
            ids = ids + ids
        out.append(ids[:length])
    return out


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    return np.cumsum(gaps)
