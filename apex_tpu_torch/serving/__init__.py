"""Serving: paged KV cache with the prefix-cache allocator, sampling,
speculative drafters, the continuous-batching engine (counterpart of
:mod:`apex_tpu.serving`)."""

from apex_tpu_torch.serving.drafter import (
    Drafter,
    GPTDrafter,
    NgramDrafter,
)
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
    copy_block,
    default_kv_dtype,
    defragment,
    device_block_table,
    gather_blocks,
    hash_block_tokens,
    paged_write,
    seq_block_hashes,
    write_coords,
    write_kv,
)
from apex_tpu_torch.serving.sampling import (
    SamplingParams,
    sample_tokens,
    sample_tokens_per_lane,
    spec_uniforms,
    spec_verify_tokens,
    token_generator,
)

__all__ = [
    "BlockAllocator",
    "CacheOutOfBlocks",
    "Drafter",
    "EngineConfig",
    "EngineStalledError",
    "GPTDrafter",
    "InferenceEngine",
    "KVCache",
    "NgramDrafter",
    "Request",
    "RequestResult",
    "SamplingParams",
    "blocks_needed",
    "copy_block",
    "default_kv_dtype",
    "defragment",
    "device_block_table",
    "gather_blocks",
    "hash_block_tokens",
    "paged_write",
    "sample_tokens",
    "sample_tokens_per_lane",
    "seq_block_hashes",
    "spec_uniforms",
    "spec_verify_tokens",
    "token_generator",
    "write_coords",
    "write_kv",
]
