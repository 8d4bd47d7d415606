"""Serving: paged KV cache, sampling, the continuous-batching engine
(counterpart of :mod:`apex_tpu.serving`)."""

from apex_tpu_torch.serving.engine import (
    EngineConfig,
    EngineStalledError,
    InferenceEngine,
    Request,
    RequestResult,
)
from apex_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    CacheOutOfBlocks,
    KVCache,
    blocks_needed,
    device_block_table,
    paged_write,
    write_coords,
    write_kv,
)
from apex_tpu_torch.serving.sampling import (
    SamplingParams,
    sample_tokens,
    sample_tokens_per_lane,
    token_generator,
)

__all__ = [
    "BlockAllocator",
    "CacheOutOfBlocks",
    "EngineConfig",
    "EngineStalledError",
    "InferenceEngine",
    "KVCache",
    "Request",
    "RequestResult",
    "SamplingParams",
    "blocks_needed",
    "device_block_table",
    "paged_write",
    "sample_tokens",
    "sample_tokens_per_lane",
    "token_generator",
    "write_coords",
    "write_kv",
]
