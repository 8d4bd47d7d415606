"""O1 cast tables (counterpart of :mod:`apex_tpu.amp.lists`).

Each entry is ``(module_path, attr)``, resolved when :mod:`autocast`
installs its wrappers, and is the torch counterpart of an entry of the
JAX package's tables: the whitelist runs in the low-precision compute
dtype (the matmul class), the blacklist in fp32 (transcendentals,
reductions and losses that lose precision).

The JAX package's ``jax.nn.standardize`` (``(x - mean) / sqrt(var +
eps)`` in one call) has no single torch counterpart, so it has no row
here; a model normalizing by hand runs that formula's pieces, of which
``torch.rsqrt`` is blacklisted.
"""

# The matmul class, cast to the compute dtype. jnp.matmul / jnp.dot /
# lax.dot_general / lax.dot map onto the torch matmul family, jnp.outer
# onto outer and its alias ger, the lax convolutions onto F.conv*d and
# F.conv_transpose*d.
WHITELIST = [
    ("torch", "matmul"),
    ("torch", "mm"),
    ("torch", "bmm"),
    ("torch", "mv"),
    ("torch", "addmm"),
    ("torch", "baddbmm"),
    ("torch", "addbmm"),
    ("torch", "addmv"),
    ("torch", "dot"),
    ("torch", "vdot"),
    ("torch", "inner"),
    ("torch", "outer"),
    ("torch", "ger"),
    ("torch", "tensordot"),
    ("torch", "einsum"),
    ("torch", "linalg.multi_dot"),
    ("torch.nn.functional", "linear"),
    ("torch.nn.functional", "conv1d"),
    ("torch.nn.functional", "conv2d"),
    ("torch.nn.functional", "conv3d"),
    ("torch.nn.functional", "conv_transpose1d"),
    ("torch.nn.functional", "conv_transpose2d"),
    ("torch.nn.functional", "conv_transpose3d"),
    # jnp.matmul(..., preferred_element_type=float32), FusedDense's
    # product: the inputs are cast, the output stays fp32
    ("apex_tpu_torch.fused_dense.fused_dense", "matmul_fp32_out"),
]

# Forced to fp32 (jnp.power -> pow, arccos/arcsin -> acos/asin,
# jax.scipy.special.logsumexp -> logsumexp, lax.rsqrt / lax.erf_inv ->
# rsqrt / erfinv, the optax losses -> the two F losses).
BLACKLIST = [
    ("torch", "exp"),
    ("torch", "exp2"),
    ("torch", "expm1"),
    ("torch", "log"),
    ("torch", "log1p"),
    ("torch", "log2"),
    ("torch", "log10"),
    ("torch", "logaddexp"),
    ("torch", "logaddexp2"),
    ("torch", "pow"),
    ("torch", "float_power"),
    ("torch", "reciprocal"),
    ("torch", "cosh"),
    ("torch", "sinh"),
    ("torch", "tan"),
    ("torch", "acos"),
    ("torch", "asin"),
    ("torch", "cumsum"),
    ("torch", "cumprod"),
    ("torch", "prod"),
    ("torch", "linalg.norm"),
    ("torch", "logsumexp"),
    ("torch", "rsqrt"),
    ("torch", "erfinv"),
    ("torch.nn.functional", "softmax"),
    ("torch.nn.functional", "log_softmax"),
    ("torch.nn.functional", "softplus"),
    ("torch.nn.functional", "cross_entropy"),
    ("torch.nn.functional", "binary_cross_entropy_with_logits"),
]

# Binary ops whose mixed-dtype result apex promotes to the widest type.
# torch's binary ops already promote so, as jax.numpy's do: nothing is
# installed for them; the table documents the parity.
PROMOTE = [
    ("torch", "add"),
    ("torch", "sub"),
    ("torch", "mul"),
    ("torch", "div"),
    ("torch", "eq"),
    ("torch", "gt"),
    ("torch", "lt"),
    ("torch", "minimum"),
    ("torch", "maximum"),
]
