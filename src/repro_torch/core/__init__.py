# The Splitwiser serving engine (scheduler + paged KV + mixed batching +
# metrics) behind a vLLM-shaped request/response API, in PyTorch.
from repro_torch.core.kv_cache import OutOfPages, PageAllocator
from repro_torch.core.metrics import EngineMetrics, RequestMetrics
from repro_torch.core.outputs import RequestOutput, TokenEvent
from repro_torch.core.planner import ChunkPlan, ChunkPlanner
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.sampler import SamplingParams, sample_tokens
from repro_torch.core.scheduler import Scheduler

__all__ = [
    "ChunkPlan", "ChunkPlanner", "EngineMetrics", "OutOfPages",
    "PageAllocator", "PrefixCache", "RequestMetrics", "RequestOutput",
    "SamplingParams", "Scheduler", "TokenEvent", "sample_tokens",
]
