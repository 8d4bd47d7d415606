"""Shared parallelism test helpers (counterpart of
:mod:`apex_tpu.transformer.testing`)."""

from apex_tpu_torch.transformer.testing.commons import (  # noqa: F401
    IdentityLayer,
    ToyParallelMLP,
    initialize_distributed,
    model_parallel_harness,
    print_separator,
    set_random_seed,
)
