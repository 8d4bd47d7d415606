"""O1's casts around listed functions (counterpart of
:mod:`apex_tpu.amp.autocast`).

:class:`autocast` replaces the functions of :mod:`apex_tpu_torch.amp.lists`
on their modules (``torch.matmul``, ``torch.nn.functional.linear``, ...)
for the extent of a ``with`` block: a whitelisted call gets its floating
tensor arguments cast to the compute dtype, a blacklisted one to fp32.
Callers reach the wrappers through the module attribute, as
``nn.Linear.forward`` reaches ``F.linear``. Operators (``x @ w``) and
``Tensor`` methods are not patched, as in the JAX package, where ``@`` is
bound before patching.

This is the reference apex's O1 design, and not ``torch.autocast``:
torch's own cast lists differ between its CPU and CUDA backends and from
the JAX package's tables, so the CPU parity tests would hold a cast set
other than the one the card runs. Explicit tables give the same casts on
both devices.

The wrappers are installed when the outermost context is entered and
removed when it exits, after an exception too. They consult a stack of
active contexts at call time, so the innermost wins and
``autocast(enabled=False)`` inside an enabled region restores full
precision for its extent. Patching module attributes is process-global,
as apex's is: use one autocast region at a time.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

import torch

from apex_tpu_torch.amp import lists

# active contexts, innermost last; the wrappers read the top at call time
_STACK = []
# (holder, name, original) of every installed wrapper
_INSTALLED = []


def _resolve(module_path: str, attr: str):
    holder = importlib.import_module(module_path)
    parts = attr.split(".")
    for p in parts[:-1]:
        holder = getattr(holder, p)
    return holder, parts[-1]


def _cast_args(args, kwargs, dtype):
    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        # only plain containers: named tuples pass through untouched
        if type(x) in (tuple, list):
            return type(x)(cast(v) for v in x)
        return x

    return tuple(cast(a) for a in args), {k: cast(v)
                                          for k, v in kwargs.items()}


def _active():
    """The innermost context, enabled or not, or None outside any."""
    return _STACK[-1] if _STACK else None


def _wrap(orig, kind):
    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        ctx = _active()
        if ctx is None or not ctx.enabled:
            return orig(*args, **kwargs)
        dtype = torch.float32 if kind == "fp32" else ctx.compute_dtype
        args, kwargs = _cast_args(args, kwargs, dtype)
        return orig(*args, **kwargs)

    wrapper.__wrapped_by_amp__ = True
    return wrapper


def _install():
    if _INSTALLED:
        return
    for table, kind in ((lists.WHITELIST, "lo"), (lists.BLACKLIST, "fp32")):
        for module_path, attr in table:
            try:
                holder, name = _resolve(module_path, attr)
                orig = getattr(holder, name)
            except (ImportError, AttributeError):
                continue  # absent in this torch: skipped, as apex does
            setattr(holder, name, _wrap(orig, kind))
            _INSTALLED.append((holder, name, orig))


def _uninstall():
    for holder, name, orig in reversed(_INSTALLED):
        setattr(holder, name, orig)
    _INSTALLED.clear()


class autocast(contextlib.ContextDecorator):
    """Casts of the listed functions for the extent of a ``with`` block.

    Args:
      compute_dtype: the whitelist's dtype, bfloat16 by default (the
        reference casts to fp16 on CUDA; pass ``torch.float16`` for it).
      enabled: False restores full precision for the block's extent.
    """

    def __init__(self, compute_dtype=torch.bfloat16, enabled: bool = True):
        self.compute_dtype = compute_dtype
        self.enabled = enabled

    def __enter__(self):
        _install()
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        if self in _STACK:
            while _STACK[-1] is not self:
                _STACK.pop()
            _STACK.pop()
        if not _STACK:
            _uninstall()
        return False


def half_function(fn):
    """``fn`` always runs on inputs cast to the compute dtype: the active
    context's, else bfloat16 (``apex.amp.half_function``)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        ctx = _active()
        dtype = ctx.compute_dtype if ctx is not None else torch.bfloat16
        args, kwargs = _cast_args(args, kwargs, dtype)
        return fn(*args, **kwargs)

    return wrapped


def float_function(fn):
    """``fn`` always runs on fp32 inputs (``apex.amp.float_function``)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        args, kwargs = _cast_args(args, kwargs, torch.float32)
        return fn(*args, **kwargs)

    return wrapped


def promote_function(fn):
    """``apex.amp.promote_function``: torch's binary ops already promote
    to the widest type, so ``fn`` is returned unchanged."""
    return fn
