"""MLP (counterpart of :mod:`apex_tpu.mlp`)."""

from apex_tpu_torch.mlp.mlp import MLP, load_jax_params

__all__ = ["MLP", "load_jax_params"]
