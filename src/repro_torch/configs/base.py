"""Model/serving/training configuration dataclasses (PyTorch port).

A copy of the reference package's ``configs/base.py`` that imports only
this package.

One frozen `ModelConfig` covers all assigned architecture families
(dense / moe / hybrid / ssm / enc-dec / vlm); per-arch files in this
package instantiate it with the exact published numbers.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention features ---
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False        # qwen3
    attn_logit_softcap: Optional[float] = None   # gemma2 (50.0)
    final_logit_softcap: Optional[float] = None  # gemma2 (30.0)
    sliding_window: Optional[int] = None         # gemma2 local layers (4096)
    local_global_pattern: Optional[Tuple[str, ...]] = None  # e.g. ("local","global")
    attn_scale_override: Optional[float] = None  # gemma2 query scaling

    # --- mlp ---
    mlp_act: str = "silu"            # silu(SwiGLU) | gelu(GeGLU) | gelu_mlp (2-mat)
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # MoE layer frequency (1 = all layers)
    router_aux_coef: float = 0.01
    # expert capacity factor; reduced() sets no-drop (E/k) so prefill/decode
    # paths are exactly equivalent in tests (capacity dropping is a real,
    # documented property of capacity-based MoE at small batch)
    moe_capacity_factor: float = 1.25

    # --- SSM (mamba2 / rwkv6) ---
    ssm_state: int = 0               # mamba2 state size per head
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    rwkv_head_dim: int = 64
    shared_attn_every: int = 0       # zamba2: a shared attn block every k mamba blocks
    shared_attn_lora_rank: int = 0   # zamba2 per-use LoRA on the shared block

    # --- enc-dec (seamless) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0             # frontend frames per utterance (stub)

    # --- vlm (internvl2) ---
    n_vision_patches: int = 0        # stub frontend: precomputed patch embeds
    d_vision: int = 0

    # --- norms / misc ---
    norm_eps: float = 1e-6
    post_attn_norm: bool = False     # gemma2 uses pre+post norms
    emb_scale_by_sqrt_dim: bool = False  # gemma2

    # shapes supported (used by launch/dryrun cell enumeration)
    supports_decode: bool = True
    supports_long_context: bool = False  # sub-quadratic archs only

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        def shrink(v, lo, cap):
            return max(lo, min(v, cap))
        kw = dict(
            n_layers=shrink(self.n_layers, 2, 2),
            d_model=64,
            n_heads=shrink(self.n_heads, 0, 4) if self.n_heads else 0,
            n_kv_heads=shrink(self.n_kv_heads, 0, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=min(self.vocab_size, 256),
            head_dim=16 if self.n_heads else 0,
        )
        if self.n_experts:
            kw["n_experts"] = min(self.n_experts, 4)
            kw["top_k"] = min(self.top_k, 2)
            kw["moe_capacity_factor"] = float(kw["n_experts"]) / kw["top_k"]
        if self.ssm_state:
            kw["ssm_state"] = min(self.ssm_state, 16)
            kw["ssm_heads"] = min(self.ssm_heads or 4, 4)
        if self.family == "ssm":  # rwkv6
            kw["rwkv_head_dim"] = 16
        if self.n_encoder_layers:
            kw["n_encoder_layers"] = 2
            kw["encoder_seq"] = 16
        if self.n_vision_patches:
            kw["n_vision_patches"] = 8
            kw["d_vision"] = 32
        if self.sliding_window:
            kw["sliding_window"] = 8
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
            kw["shared_attn_lora_rank"] = min(self.shared_attn_lora_rank, 4) or 4
        if self.local_global_pattern:
            kw["local_global_pattern"] = self.local_global_pattern
        return dataclasses.replace(self, name=self.name + "-reduced", **kw)


# Engine execution modes (see core/engine.py for what each arm means);
# "mp2" from the paper is not an engine mode — benchmarks build it from two
# "sequential" replicas (benchmarks/splitwiser_vllm.py).
SERVE_MODES = ("sequential", "splitwiser", "splitwiser_mps", "chunked")


@dataclass(frozen=True)
class TenantTier:
    """Per-tenant SLO tier (``ServeConfig.tenants``).

    Requests name a tenant via ``SLOParams.tenant`` (core/slo.py); the
    matching tier supplies default TTFT/TBT deadlines (per-request
    values override), an in-flight token quota the ``deadline``
    admission policy enforces (a tenant's burst queues behind its quota
    instead of starving other tenants), and a weight the chunked-mode
    planner's carve order scales urgency by (higher weight = served
    earlier at equal slack).  Targets are engine-clock seconds (virtual
    seconds under the counting-clock harnesses).
    """
    name: str
    ttft_target: Optional[float] = None
    tbt_target: Optional[float] = None
    quota_tokens: Optional[int] = None   # max in-flight prompt+budget tokens
    weight: float = 1.0                  # planner carve-order weight

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise ValueError(
                f"tier name must be a non-empty string, got {self.name!r}")
        for knob in ("ttft_target", "tbt_target"):
            value = getattr(self, knob)
            if value is not None and (
                    not isinstance(value, (int, float))
                    or isinstance(value, bool) or value <= 0):
                raise ValueError(
                    f"tier {self.name!r}: {knob} must be a positive number "
                    f"or None, got {value!r}")
        if self.quota_tokens is not None and (
                not isinstance(self.quota_tokens, int)
                or isinstance(self.quota_tokens, bool)
                or self.quota_tokens <= 0):
            raise ValueError(
                f"tier {self.name!r}: quota_tokens must be a positive int "
                f"or None, got {self.quota_tokens!r}")
        if not isinstance(self.weight, (int, float)) \
                or isinstance(self.weight, bool) or self.weight <= 0:
            raise ValueError(
                f"tier {self.name!r}: weight must be a positive number, "
                f"got {self.weight!r}")


@dataclass(frozen=True)
class ServeConfig:
    """Serving-engine (Splitwiser) configuration.

    Sampling knobs live on each request (``SamplingParams`` in
    ``core/sampler.py``), not here: one engine serves heterogeneous
    workloads.
    """
    mode: str = "splitwiser"     # one of SERVE_MODES
    max_batch: int = 64          # max concurrent decode sequences
    token_budget: int = 256      # token slots per mixed step (prefill chunk + decode)
    page_size: int = 16          # tokens per KV page
    n_pages: int = 1024          # global page pool size
    max_pages_per_seq: int = 64
    max_seq_len: int = 1024
    prefill_chunk: int = 128     # chunked-prefill chunk size in mixed mode
    n_streams: int = 2           # parallel prompt-processing streams (paper's #processes)
    chunk_tokens: int = 256      # mode="chunked": per-round packed-token
                                 # budget (core/planner.py) — decode tokens
                                 # claim their share first, prefill chunks
                                 # fill the rest; must be >= page_size
    # --- scheduler: pluggable policies (core/policies.py) ---
    watermark: float = 0.01      # fraction of the page pool kept free at admission
    decode_reserve: float = 0.5  # fraction of remaining max_new_tokens reserved
                                 # as decode headroom when admitting a request
    admission_policy: str = "fcfs"  # fcfs: arrival order (seed behaviour)
                                    # cache_aware: co-schedule resident
                                    #   prefixes, hold twins of in-flight
                                    #   prefills one round so they hit
    admission_age_weight: float = 0.5  # cache_aware aging: resident-prefix
                                    # page advantage one waited round
                                    # offsets, so a cold-prefix request
                                    # cannot starve behind a hot-template
                                    # stream (0 = pure hit-first order)
    eviction_policy: Optional[str] = None  # reclaimable prefix-page strip
                                    # order: lru | fifo | cost (recompute-
                                    # FLOPs model); None inherits
                                    # prefix_cache_policy
    preempt_policy: str = "latest"  # latest: evict latest-arrival + recompute
                                    # cache_aware: prefer victims whose
                                    #   committed KV survives eviction
                                    #   (resume = remap), tie-break latest
                                    # none:   seed behaviour (OutOfPages crash)
    # scheduler-event trace ring size (EngineMetrics.sched_events); oldest
    # events beyond the cap are dropped and counted.  Kept in sync with
    # metrics.DEFAULT_SCHED_EVENTS_CAP (configs stay import-free of core
    # at module load)
    sched_events_cap: int = 16384
    # --- KV page dtype (kernels/kv_int8.py) ---
    # fp:   pages in the model param dtype (seed behaviour)
    # int8: pages as int8 codes + f32 per-(token, head) scale sidecar,
    #       quantized at commit and dequantized inside the attention
    #       kernel; page bytes shrink so the byte-denominated pool holds
    #       ~2x (fp16) to 3.2x (fp32) the pages at equal pool bytes
    kv_dtype: str = "fp"
    # Device-byte budget for the KV page pool.  None sizes the pool as
    # ``n_pages`` *fp-width* pages (so flipping kv_dtype="int8" alone
    # holds pool bytes constant and grows the page count); set explicitly
    # to pin the budget in bytes regardless of n_pages.
    kv_pool_bytes: Optional[int] = None
    # --- shared-prefix KV cache (core/prefix_cache.py) ---
    enable_prefix_cache: bool = False   # refcounted copy-on-write page sharing
    prefix_cache_policy: str = "lru"    # legacy alias for eviction_policy
                                        # (lru | fifo | cost)
    prefix_cache_granularity: str = "token"  # token: partial-page (mid-page
                                        # divergence) reuse via COW of the
                                        # tail page; page: full pages only
                                        # (PR-3 behaviour)
    # --- runtime sanitizer (analysis/invariants.py) ---
    # off:    never check (zero overhead; production default)
    # finish: full cross-module validation after any step finishing a request
    # step:   validate after every engine step (CI runs tier-1 under this)
    # call:   step, plus call-site hooks on every mutating allocator/cache
    #         entry point (violations attributed to the exact call)
    # Defaults from $REPRO_SANITIZE so CI flips whole suites via the
    # environment without touching individual tests.
    sanitize_level: str = field(
        default_factory=lambda: os.environ.get("REPRO_SANITIZE", "off"))
    # --- jit-dispatch sentinel (analysis/dispatch.py) ---
    # Counts XLA compiles per jitted step callable, raises on recompile
    # storms in the step loop, and lets harnesses assert a zero
    # post-warmup recompile budget.  Defaults from $REPRO_DISPATCH_SENTINEL
    # so CI arms whole suites via the environment.
    dispatch_sentinel: bool = field(
        default_factory=lambda: os.environ.get(
            "REPRO_DISPATCH_SENTINEL", "") not in ("", "0", "false", "off"))
    # --- multi-tenant SLO tiers (core/slo.py, core/policies.py) ---
    # Tuple of TenantTier: per-tenant default TTFT/TBT deadlines,
    # in-flight token quotas (enforced by admission_policy="deadline"),
    # and planner carve-order weights.  Empty = single implicit
    # "default" tenant with no deadlines (seed behaviour).
    tenants: Tuple[TenantTier, ...] = ()
    # deadline-admission completion predictor: engine-clock seconds of
    # predicted delay charged per page the admission would allocate
    # (slack = deadline - now - slo_page_cost * admission_pages).  0
    # ranks by raw deadline (pure EDF).
    slo_page_cost: float = 0.0

    def __post_init__(self):
        if self.mode not in SERVE_MODES:
            raise ValueError(
                f"unknown serve mode {self.mode!r}; supported modes: "
                f"{', '.join(SERVE_MODES)}")
        # imported here to keep configs free of core deps at module load
        from repro_torch.core.policies import (ADMISSION_POLICIES,
                                         EVICTION_POLICIES, PREEMPT_POLICIES)
        if self.admission_policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission_policy {self.admission_policy!r}; "
                f"supported: {', '.join(sorted(ADMISSION_POLICIES))}")
        for knob, value in (("eviction_policy", self.eviction_policy),
                            ("prefix_cache_policy", self.prefix_cache_policy)):
            if value is not None and value not in EVICTION_POLICIES:
                raise ValueError(
                    f"unknown {knob} {value!r}; "
                    f"supported: {', '.join(sorted(EVICTION_POLICIES))}")
        if self.preempt_policy not in PREEMPT_POLICIES and \
                self.preempt_policy != "none":
            raise ValueError(
                f"unknown preempt_policy {self.preempt_policy!r}; supported: "
                f"{', '.join(sorted(PREEMPT_POLICIES))}, none")
        if self.kv_dtype not in ("fp", "int8"):
            raise ValueError(
                f"unknown kv_dtype {self.kv_dtype!r}; supported: fp, int8")
        if self.kv_pool_bytes is not None and (
                not isinstance(self.kv_pool_bytes, int)
                or isinstance(self.kv_pool_bytes, bool)
                or self.kv_pool_bytes <= 0):
            raise ValueError(
                f"kv_pool_bytes must be a positive int or None, got "
                f"{self.kv_pool_bytes!r}")
        if self.prefix_cache_granularity not in ("page", "token"):
            raise ValueError(
                f"unknown prefix_cache_granularity "
                f"{self.prefix_cache_granularity!r}; supported: page, token")
        if self.admission_age_weight < 0:
            raise ValueError(
                f"admission_age_weight must be >= 0, got "
                f"{self.admission_age_weight}")
        if self.sched_events_cap <= 0:
            raise ValueError(
                f"sched_events_cap must be positive, got {self.sched_events_cap}")
        for knob in ("max_batch", "token_budget", "page_size", "n_pages",
                     "max_pages_per_seq", "max_seq_len", "prefill_chunk",
                     "n_streams", "chunk_tokens"):
            value = getattr(self, knob)
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value <= 0:
                raise ValueError(
                    f"{knob} must be a positive int, got {value!r}")
        if self.chunk_tokens < self.page_size:
            raise ValueError(
                f"chunk_tokens ({self.chunk_tokens}) must be >= page_size "
                f"({self.page_size}): a chunked round must be able to "
                "commit at least one full KV page")
        if self.n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page n_pages-1 is the reserved "
                f"trash page), got {self.n_pages}")
        if not 0.0 <= self.watermark < 1.0:
            raise ValueError(
                f"watermark must be in [0, 1), got {self.watermark}")
        if self.decode_reserve < 0:
            raise ValueError(
                f"decode_reserve must be >= 0, got {self.decode_reserve}")
        for knob in ("enable_prefix_cache", "dispatch_sentinel"):
            value = getattr(self, knob)
            if not isinstance(value, bool):
                raise ValueError(f"{knob} must be a bool, got {value!r}")
        if not isinstance(self.tenants, tuple) or any(
                not isinstance(t, TenantTier) for t in self.tenants):
            raise ValueError(
                f"tenants must be a tuple of TenantTier, got {self.tenants!r}")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant tier names: {names}")
        if not isinstance(self.slo_page_cost, (int, float)) \
                or isinstance(self.slo_page_cost, bool) \
                or self.slo_page_cost < 0:
            raise ValueError(
                f"slo_page_cost must be a number >= 0, got "
                f"{self.slo_page_cost!r}")
        from repro_torch.analysis.invariants import SANITIZE_LEVELS
        if self.sanitize_level not in SANITIZE_LEVELS:
            raise ValueError(
                f"unknown sanitize_level {self.sanitize_level!r}; "
                f"supported: {', '.join(SANITIZE_LEVELS)}")

    @property
    def resolved_eviction_policy(self) -> str:
        """The effective reclaimable-page strip order: ``eviction_policy``
        when set, else the legacy ``prefix_cache_policy`` knob."""
        return self.eviction_policy or self.prefix_cache_policy


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    warmup_steps: int = 10
    total_steps: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatch: int = 0          # 0 = no grad accumulation
    remat: bool = True
    int8_moments: bool = False   # quantized optimizer state (beyond-paper)
    loss_impl: str = "chunked"   # chunked | vtiled (fused vocab-tiled CE)
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    seed: int = 0
