"""The mesh path's attention and MoE hooks: the counterparts of the
reference's ``shard_map`` islands.

The reference runs two ops in ``shard_map`` islands because GSPMD
cannot partition them well: paged attention with its page writes (a
data-dependent scatter/gather) and MoE dispatch (a data-dependent
scatter, formulated as expert-local compute + ONE psum over `model`).
In the port's local-shard idiom (``models/sharding.py``) every op runs
on per-rank local arrays, so the islands become hooks over the rank's
own shards:

1. ``make_sharded_decode_attn`` / ``make_sharded_chunk_attn``: the
   ``attn_fn`` of ``models/transformer.py``'s ``decode`` and ``mixed``.
   They attend over the rank's local pool, K1 on fp pools and K3 on int8
   ``{"q", "s"}`` pools (``kernels/kv_int8.py``), on ``H_p/tp`` query and
   ``KV_p/tp`` KV heads (G unchanged).  Locality invariant, as the
   reference's: a sequence's pages live on its data shard, and block
   tables hold global page ids that ``local_table`` maps to pool-local
   ones with ``% N_local`` (the last local page is the shard's trash
   page); the model's page writes use that same table.
2. ``make_sharded_moe_fn``: expert-parallel (EP, ``E % tp == 0``: each
   rank owns ``E/tp`` experts, ``expert_offset`` its first) or expert
   tensor-parallel (d_ff sliced) dispatch over the rank's tokens, then
   one ``all_reduce`` of ``y`` over `model`.  Capacity comes from the
   local token count: the rank's data shard's tokens.  Every model rank
   routes the same tokens over the full router, so the reference's mean
   of ``aux`` over `model` is the local value and needs no collective
   (``sharding.grad_mean`` divides its gradient by tp, as the mean's
   would be).  Where the experts are FSDP'd over `data` (the training
   cells, and grok-1-314b's serving cells: the reference's
   ``fsdp_gather=True``), the model gathers them with the rest of their
   layer by their placements (``sharding.gather_weights``, inside the
   layer's remat region), so their gradients leave through a
   reduce-scatter and the hook sees whole D dims either way.  In
   training the hook is Megatron's region:
   ``copy_to`` of the tokens and the router, ``reduce_from`` of ``y``.
   The aux loss is each data shard's own, as the reference's: its
   ``shard_map`` declares ``aux`` replicated over `data`
   (``out_specs=P()``, ``check_rep=False``) while each data shard
   computes its own, so the loss the reference reports holds data shard
   0's aux and its gradient is that of the mean over the data shards
   (``train/trainer.py::make_loss_fn`` does the same; ROADMAP queue 3,
   "Expected").
3. ``make_gathered_moe_fn``: the training ``fsdp`` scheme's MoE, which
   the reference leaves to GSPMD (its ``moe_fn`` is None there): every
   rank's tokens gathered over the batch axes, routed with the global
   capacity, and the rank's rows of the output kept.

In the mixed step the reference splits the concatenated ``[prefill;
decode]`` token array into contiguous blocks over data, so at data > 1
its MoE capacity groups straddle data shards' rows; the port's groups
are each shard's own streams and decode rows (its engine pins a stream
to a shard), the one-card step on that shard's rows.  The two agree
wherever no expert overflows.

The decode ``2d`` scheme (``launch/steps.py::build_decode``) keeps the
batch replicated over data: its MoE is ``make_sharded_moe_fn(flat_f=
True)`` (expert d_ff over every axis, one ``[T, D]`` all_reduce over
all of them) and its attention ``make_sharded_decode_attn(
rows_over="data")`` (each rank writes and attends its data shard's rows
on its data-sharded pool, then gathers the output over data).  A decode
batch that does not divide over data > 1 is replicated with its pool
(the reference's ``shard_batch=False``): every data rank computes the
whole step on its `model` shards.
"""
from __future__ import annotations

from repro_torch.kernels import ops
from repro_torch.models.layers import act_fn
from repro_torch.models.moe import moe_apply
from repro_torch.models import sharding
from repro_torch.models.sharding import Policy, copy_to, grad_mean, make_rules, reduce_from


def _policy(mesh, data, model):
    if model not in mesh.mesh_dim_names or not set(data) <= set(mesh.mesh_dim_names):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} lack {data} or {model!r}")
    return Policy(make_rules(tuple(data), model), mesh)


class ShardedPagedAttention:
    """``ops.paged_attention``'s signature over one layer of the rank's
    local pool (K1 for fp pages, K3 for int8), given pool-local tables.

    With ``rows_over`` (the decode ``2d`` scheme: the batch replicated
    over that axis, the pages sharded over it) the model hands the hook
    its shard's rows alone (``row_slice``: of the new K/V it writes, the
    queries, lengths and positions; ``local_table`` keeps that shard's
    rows of the table), and the hook gathers the attention output over
    ``rows_over`` in rank order: every rank's output holds the whole
    batch again."""

    def __init__(self, kv_int8: bool, policy=None, rows_over=None):
        self.kv_int8, self.policy, self.rows_over = kv_int8, policy, rows_over

    def row_slice(self, n):
        """This rank's rows of a batch of ``n`` (all of them unless the
        batch is replicated over sharded pages)."""
        if self.rows_over is None:
            return slice(None)
        k, d = self.policy.size(self.rows_over), self.policy.index(self.rows_over)
        if n % k:
            raise ValueError(f"{n} rows do not divide over {k} data shards")
        return slice(d * (n // k), (d + 1) * (n // k))

    def local_table(self, block_table, pages):
        """Global page ids (of this rank's rows) -> ids in the rank's pool
        of N_local pages."""
        codes = pages["q"] if isinstance(pages, dict) else pages
        return block_table[self.row_slice(block_table.shape[0])] % codes.shape[1]

    def __call__(self, q, kpg, vpg, block_table, kv_lens, q_pos, *, scale,
                 window=None, softcap=None):
        if isinstance(kpg, dict) != self.kv_int8:
            raise TypeError(f"hook built with kv_int8={self.kv_int8} got "
                            f"{'int8' if isinstance(kpg, dict) else 'fp'} pages")
        kw = dict(scale=scale, window=window, softcap=softcap)
        if self.kv_int8:
            o = ops.paged_attention_int8(q, kpg["q"], kpg["s"], vpg["q"], vpg["s"],
                                         block_table, kv_lens, q_pos, **kw)
        else:
            o = ops.paged_attention(q, kpg, vpg, block_table, kv_lens, q_pos, **kw)
        return (o if self.rows_over is None
                else sharding.all_gather(o, self.policy, self.rows_over, 0))


def make_sharded_decode_attn(mesh, *, data=("data",), model="model", rows_over=None,
                             kv_int8=False):
    """The decode step's ``attn_fn`` on the rank's local pool.

    ``rows_over="data"`` is the decode ``2d`` scheme's: the model's batch
    replicated over data, the pages data-sharded, so the hook takes its
    data shard's rows and gathers their output over data
    (``ShardedPagedAttention``).  A batch replicated over data with its
    pool (the reference's ``shard_batch=False``, its single-sequence
    long-context layout) needs nothing of the hook: every data rank
    attends the whole batch on its `model` heads over its whole pool."""
    policy = _policy(mesh, data, model)
    if rows_over is not None and policy.size(rows_over) > 1:
        return ShardedPagedAttention(kv_int8, policy, rows_over)
    return ShardedPagedAttention(kv_int8)


def make_sharded_chunk_attn(mesh, *, data=("data",), model="model",
                            kv_int8=False):
    """The mixed step's chunk ``attn_fn``: chunked-prefill attention over
    the rank's local pool (streams shard over data)."""
    _policy(mesh, data, model)
    return ShardedPagedAttention(kv_int8)


def make_sharded_moe_fn(mesh, cfg, *, tp: int, data=("data",), model="model",
                        flat_f=False):
    """EP/expert-TP MoE: local dispatch + expert GEMMs + one all_reduce.
    ``lp`` holds the rank's expert slices (``launch/shardings.py``), their
    FSDP'd dims already gathered by the model (the reference's
    ``fsdp_gather``).

    ``flat_f`` is the decode ``2d`` scheme's (``launch/shardings.py::
    flat_f_pspecs``): every expert's d_ff sliced over every mesh axis, the
    tokens replicated (every rank routes them all over the full router,
    capacity from them all), and the partial outputs summed by one
    ``all_reduce`` of ``[T, D]`` over all the axes.  Its ``aux`` is the
    reference's ``pmean`` over them: every rank computes the same value."""
    policy = _policy(mesh, data, model)
    if policy.size(model) != tp:
        raise ValueError(f"tp={tp} but the mesh's {model!r} axis has "
                         f"{policy.size(model)} ranks")
    E = cfg.n_experts
    gate_act = act_fn("silu" if cfg.mlp_act == "silu" else "gelu")
    if flat_f:
        axes = tuple(data) + (model,)

        def flat_fn(lp, x2d):
            y, aux = moe_apply(lp, x2d, n_experts=E, top_k=cfg.top_k, act=gate_act,
                               capacity_factor=cfg.moe_capacity_factor)
            return sharding.all_reduce(y, policy, axes), aux

        return flat_fn
    ep = E % tp == 0
    offset = policy.index(model) * (E // tp) if ep else 0

    def fn(lp, x2d):
        lp = dict(lp, router=copy_to(lp["router"], policy, model))
        y, aux = moe_apply(lp, copy_to(x2d, policy, model), n_experts=E, top_k=cfg.top_k,
                           act=gate_act, expert_offset=offset,
                           capacity_factor=cfg.moe_capacity_factor)
        return reduce_from(y, policy, model), grad_mean(aux, policy, model)

    return fn


def make_gathered_moe_fn(policy, cfg):
    """The training ``fsdp`` scheme's MoE (tp = 1, every weight whole after
    the layer's gathers): the tokens of every rank of the batch axes
    gathered in rank order (the global batch's order), routed over the
    global capacity as the reference's one ``moe_apply`` on the global
    batch, this rank's rows of ``y`` kept.  The gather's backward sums the
    ranks' token gradients; ``aux`` is the global batch's, on every rank."""
    axis = policy.batch_axis
    gate_act = act_fn("silu" if cfg.mlp_act == "silu" else "gelu")

    def fn(lp, x2d):
        y, aux = moe_apply(lp, sharding.fsdp_gather(x2d, policy, axis, 0),
                           n_experts=cfg.n_experts,
                           top_k=cfg.top_k, act=gate_act,
                           capacity_factor=cfg.moe_capacity_factor)
        k = x2d.shape[0]
        return y[policy.index(axis) * k:][:k], aux

    return fn
