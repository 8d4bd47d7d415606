"""Megatron-style tensor parallelism over ``torch.distributed``
(counterpart of :mod:`apex_tpu.transformer.tensor_parallel`)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (  # noqa: F401
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (  # noqa: F401
    copy_to_tensor_model_parallel_region,
    gather_along_first_dim,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_along_first_dim,
    scatter_to_tensor_model_parallel_region,
    sequence_parallel_enter,
    sequence_parallel_exit,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (  # noqa: F401
    RNGStatesTracker,
    checkpoint,
    get_cuda_rng_tracker,
    get_rng_state_tracker,
    model_parallel_cuda_manual_seed,
    model_parallel_key,
    model_parallel_rng_seed,
    model_parallel_seed,
)
from apex_tpu_torch.transformer.tensor_parallel.main_grad import (  # noqa: F401,E402
    accumulate_main_grads,
    init_main_grads,
    reset_main_grads,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (  # noqa: F401,E402
    VocabUtility,
    divide,
    ensure_divisibility,
    split_tensor_along_last_dim,
)
