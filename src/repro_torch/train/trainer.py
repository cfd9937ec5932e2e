"""Training step + fault-tolerant Trainer loop, counterparts of the
reference's ``train/trainer.py``.

``make_train_step`` builds the step for any registered arch:
  - transformer family -> chunked (or vocab-tiled) CE from hidden (no
    [B, T, V] logits);
  - other families     -> full-logit CE;
  - gradient accumulation over microbatches, in f32;
  - global-norm clipping, warmup-cosine LR, AdamW (optionally int8 moments);
  - MoE router aux-loss added with cfg.router_aux_coef.

It runs eagerly: gradients come from ``torch.autograd.grad`` over the
parameter leaves, attention's through K2's recompute backward
(``ops.flash_attention_ckpt``).  ``Trainer`` adds checkpoint/restart
fault tolerance: async snapshots every ``ckpt_every`` steps,
resume-from-latest, and deterministic data order, so a killed-and-resumed
run is bitwise identical to an uninterrupted one as long as every op of
the step is deterministic (on the card: ``torch.use_deterministic_algorithms``).

**On a mesh** (``tp``, ``policy`` and ``moe_fn`` as the reference's, from
``launch/steps.py::train_mesh``; every family) the step is the rank's:
its shards of the state (``policy.params`` places them), its rows of
the batch (``take_rows``; with ``microbatch``, its rows of each
microbatch, as the reference's sharded step holds them), its heads and
vocab rows, the FSDP'd weights gathered a layer at a time (the models'
``sharding.gather_weights``), the loss the global mean (the other
families' full-logit loss vocab-parallel, ``losses.lm_loss``), the
gradients summed over the batch axes (``sharding.sync_grads``), the
clip's norm and the int8 moments' scales global (``optim/adamw.py``).  Every rank
reports the loss of its own data shard's MoE aux loss, as the
reference's devices hold it (its metric is data shard 0's), while the
gradient is that of the mean over the data shards (ROADMAP queue 3,
"Expected").  A ``Trainer`` on a mesh writes each rank's shards under
``ckpt_dir/rank<r>`` in the one-card format and resumes every rank from
the latest step that all of them committed.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.ckpt.checkpoint import AsyncCheckpointer, latest_step, load
from repro_torch.common.tree import tree_leaves, tree_map, tree_zip_map
from repro_torch.configs.base import TrainConfig
from repro_torch.device import resolve_device
from repro_torch.launch.shardings import shard_params
from repro_torch.models import transformer as T
from repro_torch.models.sharding import grad_mean, sync_grads
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, warmup_cosine
from repro_torch.train.losses import (IGNORE, lm_loss, lm_loss_from_hidden,
                                      lm_loss_from_hidden_vtiled)


def make_loss_fn(model, tcfg: TrainConfig, *, tp=1, policy=None, moe_fn=None):
    """loss_fn(params, batch) -> (loss, n_tokens).  On a mesh: this rank's
    loss (the global mean, plus its data shard's MoE aux term), whose
    gradient is the rank's share of the global one."""
    cfg = model.cfg

    def loss_fn(params, batch):
        if cfg.family in ("dense", "moe", "vlm"):
            hidden, aux = T.train_hidden(params, cfg, batch, tp=tp, policy=policy,
                                         moe_fn=moe_fn, remat=tcfg.remat)
            table = T.table_of(params, policy)
            labels = batch["labels"]
            if cfg.family == "vlm":   # hidden includes the vision prefix
                npfx = hidden.shape[1] - labels.shape[1]
                labels = F.pad(labels, (npfx, 0), value=IGNORE)
            impl = (lm_loss_from_hidden_vtiled if tcfg.loss_impl == "vtiled"
                    else lm_loss_from_hidden)
            loss, n = impl(hidden, labels, table, softcap=cfg.final_logit_softcap,
                           v_real=cfg.vocab_size, policy=policy)
        else:
            logits, aux = model.module.train_logits(params, cfg, batch, tp=tp, policy=policy,
                                                    remat=tcfg.remat)
            loss, n = lm_loss(logits, batch["labels"], v_real=cfg.vocab_size, policy=policy)
        if cfg.is_moe:
            aux = grad_mean(aux, policy, None if policy is None else policy.batch_axis)
            loss = loss + cfg.router_aux_coef * aux / cfg.n_layers
        return loss, n

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, grads): grads a tree like ``params`` (zeros for a leaf the
    loss does not reach); on a mesh the rank's, not yet summed over the
    batch axes (``sync_grads``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = loss_fn(live, batch)
    leaves = tree_leaves(live)
    grads = iter([torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))])
    return loss.detach(), tree_map(lambda _: next(grads), params)


def rank_rows(policy, n_rows: int, microbatch: int = 0):
    """The global row indices of a batch of ``n_rows`` that this rank holds
    (all of them without a policy).  The reference's gradient accumulation
    reshapes the global batch into microbatches of ``microbatch`` rows, and
    its sharded step gives batch shard d of n (n the size of the batch
    axes) the contiguous rows ``d·m/n`` to ``(d+1)·m/n - 1`` of each
    microbatch; without microbatches (or one of the whole batch) that is
    shard d's block of ``n_rows / n`` rows.  Raises ``ValueError`` where
    the microbatch does not divide the batch or the shards."""
    if policy is None:
        return list(range(n_rows))
    axis = policy.batch_axis
    n, d = policy.size(axis), policy.index(axis)
    m = microbatch if microbatch and microbatch < n_rows else n_rows
    if n_rows % m or m % n:
        raise ValueError(f"a batch of {n_rows} rows in microbatches of {m} does not "
                         f"divide over {n} batch shards")
    k = m // n
    return [i * m + d * k + j for i in range(n_rows // m) for j in range(k)]


def take_rows(batch, policy, microbatch: int = 0):
    """This rank's rows (``rank_rows``) of every tensor of a global batch;
    the batch as it is without a policy."""
    if policy is None:
        return batch
    idx = torch.as_tensor(rank_rows(policy, next(iter(batch.values())).shape[0], microbatch))
    return {k: v[idx.to(v.device)] for k, v in batch.items()}


def make_grad_fn(model, tcfg: TrainConfig, *, tp=1, policy=None, moe_fn=None):
    """grad_fn(params, batch) -> (loss, grads): the train step's gradients
    (microbatches accumulated in f32); on a mesh the rank's gradient
    shards, summed over the batch axes.  With ``tcfg.microbatch`` on a
    mesh ``batch`` is this rank's rows as ``rank_rows`` orders them: each
    microbatch's ``microbatch / n`` of them in turn, whose loss is the
    global mean over the batch axes (``ValueError`` where they do not
    divide over the n batch shards)."""
    n_shards = 1 if policy is None else policy.size(policy.batch_axis)
    if tcfg.microbatch and tcfg.microbatch % n_shards:
        raise ValueError(f"microbatch={tcfg.microbatch} does not divide over "
                         f"{n_shards} batch shards")
    loss_fn = make_loss_fn(model, tcfg, tp=tp, policy=policy, moe_fn=moe_fn)

    def grads_of(params, batch):
        loss, grads = compute_grads(params, batch)
        return loss, sync_grads(grads, policy)

    def compute_grads(params, batch):
        B = batch["tokens"].shape[0]                  # this rank's rows
        if tcfg.microbatch and tcfg.microbatch < B * n_shards:
            m = tcfg.microbatch // n_shards
            n_micro = B // m
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            ltot = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(n_micro):
                micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                l, g = value_and_grad(loss_fn, params, micro)
                acc = tree_zip_map(torch.add, acc, g)
                ltot = ltot + l
            return ltot / n_micro, tree_map(lambda a: a / n_micro, acc)
        return value_and_grad(loss_fn, params, batch)

    return grads_of


def make_train_step(model, tcfg: TrainConfig, *, tp=1, policy=None, moe_fn=None):
    """train_step(state, batch) -> (new_state, {"loss", "gnorm", "lr"}):
    a pure function of its inputs (the state is not modified).  On a mesh
    ``state`` is the rank's shards and ``batch`` its rows."""
    grad_fn = make_grad_fn(model, tcfg, tp=tp, policy=policy, moe_fn=moe_fn)

    def train_step(state, batch):
        loss, grads = grad_fn(state["params"], batch)
        new_state, gnorm, lr = apply_grads(tcfg, state, grads, policy)
        return new_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step


def apply_grads(tcfg: TrainConfig, state, grads, policy=None):
    """The optimizer's half of a train step: global-norm clipping, the
    warmup-cosine lr, AdamW (on a mesh over the rank's shards, placed by
    ``policy.params``).  Returns (new_state, gnorm, lr); ``state`` is not
    modified."""
    params, opt = state["params"], state["opt"]
    specs = None if policy is None else policy.params
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip, specs, policy)
    lr = warmup_cosine(opt["count"], base_lr=tcfg.lr,
                       warmup_steps=tcfg.warmup_steps,
                       total_steps=tcfg.total_steps)
    new_params, new_opt = adamw_update(
        grads, opt, params, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
        weight_decay=tcfg.weight_decay, specs=specs, policy=policy)
    return {"params": new_params, "opt": new_opt}, gnorm, lr


def init_state(model, generator: torch.Generator, tcfg: TrainConfig,
               dtype=torch.float32, device=None, tp=1, policy=None):
    """{"params": model.init(generator, dtype, device, tp=tp), "opt": AdamW
    state}; on a mesh the rank's shards of that draw (``policy.params``
    places them) and their moments."""
    params = model.init(generator, dtype, resolve_device(device), tp=tp)
    specs = None if policy is None else policy.params
    params = shard_params(params, specs, policy)
    return {"params": params, "opt": adamw_init(params, tcfg.int8_moments, specs, policy)}


@dataclass
class Trainer:
    """Fault-tolerant training loop (checkpoint / restart / resume).

    Starts from the latest checkpoint in ``tcfg.ckpt_dir`` if there is
    one, else from ``init_state`` with a generator on ``device`` seeded
    with ``tcfg.seed``.  ``data_fn(step)`` must be deterministic; its
    batches are moved to ``device``.  On a mesh (``tp``, ``policy``,
    ``moe_fn``; every rank runs a ``Trainer``) each rank keeps its shards,
    takes its rows of each batch, and checkpoints under
    ``ckpt_dir/rank<r>``; all ranks resume from the latest step every one
    of them has committed."""
    model: object
    tcfg: TrainConfig
    data_fn: Callable[[int], dict]      # step -> batch (deterministic!)
    log_every: int = 10
    device: Optional[object] = None
    tp: int = 1
    policy: Optional[object] = None
    moe_fn: Optional[Callable] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._step_fn = make_train_step(self.model, self.tcfg, tp=self.tp,
                                        policy=self.policy, moe_fn=self.moe_fn)
        ckpt_dir = self.tcfg.ckpt_dir
        if self.policy is not None:
            import torch.distributed as dist
            ckpt_dir = os.path.join(ckpt_dir, f"rank{dist.get_rank()}")
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        start = self._agreed(latest_step(ckpt_dir))
        if start is not None:
            self.state = load(ckpt_dir, start, self.device)
            self.start_step = start
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
            self.state = init_state(self.model, gen, self.tcfg, device=self.device,
                                    tp=self.tp, policy=self.policy)
            self.start_step = 0
        self.history = []       # (step, loss) every log_every steps and at the end
        # (step, {"loss", "gnorm", "lr", "step_s"}) at the same steps; step_s
        # is the host wall of the step up to its metrics on the host
        self.metrics = []

    def _agreed(self, step):
        """The latest checkpoint step every rank holds (``step`` alone on
        one card): the minimum over the world, None where a rank has none."""
        if self.policy is None:
            return step
        import torch.distributed as dist
        t = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                         device="cuda" if dist.get_backend() == "nccl" else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return None if int(t) < 0 else int(t)

    def _rows(self, batch):
        """This rank's rows of a global batch (all of it on one card), in
        ``rank_rows``'s order for the microbatches."""
        return take_rows(batch, self.policy, self.tcfg.microbatch)

    def run(self, n_steps: Optional[int] = None, crash_at: Optional[int] = None):
        """Run to tcfg.total_steps (or n_steps more). crash_at simulates a
        node failure after that global step commits (for FT tests)."""
        end = self.tcfg.total_steps if n_steps is None else self.start_step + n_steps
        step = self.start_step
        while step < end:
            t0 = time.perf_counter()
            batch = {k: v.to(self.device) for k, v in self._rows(self.data_fn(step)).items()}
            self.state, m = self._step_fn(self.state, batch)
            step += 1
            if step % self.log_every == 0 or step == end:
                vals = {k: float(v) for k, v in m.items()}
                vals["step_s"] = time.perf_counter() - t0
                self.history.append((step, vals["loss"]))
                self.metrics.append((step, vals))
            if step % self.tcfg.ckpt_every == 0 or step == end:
                self.ckpt.save(step, self.state)
            if crash_at is not None and step >= crash_at:
                self.ckpt.wait()
                raise RuntimeError(f"simulated failure at step {step}")
        self.ckpt.wait()
        self.start_step = step
        return self.history
