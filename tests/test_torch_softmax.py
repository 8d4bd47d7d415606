"""Port parity for the fused scale-mask softmax (kernels B6, B7, B8 through
their plain versions on the CPU) and FusedScaleMaskSoftmax, against
apex_tpu on the same numpy inputs. The JAX side runs its Pallas kernels
in interpret mode, as its own tests do on the CPU.

Every route of the JAX wrapper is taken: no mask, a pre-folded boolean
mask, a fill tile (boolean mask with scale <= 0) through the 2-D and the
4-D route, an additive mask at full size (2-D route, B6) and broadcast
(B, 1, 1, Sk) (B7), causal with and without padding, a fully masked row,
and bf16. Tolerances: fp32 1e-5, bf16 2e-2 (one bf16 ulp of values up
to 2, the outputs' rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.ops.softmax as jsm
from apex_tpu.transformer import enums as jenums
from apex_tpu.transformer.functional import (
    AttnMaskType as JaxAttnMaskType,
    FusedScaleMaskSoftmax as JaxFusedSoftmax,
)
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.transformer import enums as tenums
from apex_tpu_torch.transformer.functional import (
    AttnMaskType,
    FusedScaleMaskSoftmax,
)
from torch_parity import assert_close

X_SHAPE = (2, 3, 8, 100)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bool_mask(shape, seed, p=0.3):
    return np.random.RandomState(seed).rand(*shape) < p


def _add_mask(shape, seed):
    return np.where(np.random.RandomState(seed).rand(*shape) < 0.3, -1e4,
                    0.1 * _rand(shape, seed + 1)).astype(np.float32)


# (name, which function, x shape, mask: None | ("bool"|"add", shape),
#  scale, causal)
CASES = [
    ("no mask", "softmax", X_SHAPE, None, 0.5, False),
    ("bool pre-folded", "masked", X_SHAPE, ("bool", (2, 1, 8, 100)), 2.0,
     False),
    ("bool fill 4-D (B7)", "masked", X_SHAPE, ("bool", (2, 1, 1, 100)),
     -0.5, False),
    ("bool fill 2-D (B6)", "masked", X_SHAPE, ("bool", (8, 100)), 0.0,
     False),
    ("additive 2-D (B6)", "masked", X_SHAPE, ("add", (8, 100)), 1.0, False),
    ("additive 4-D (B7)", "masked", X_SHAPE, ("add", (2, 1, 1, 100)), 1.0,
     False),
    ("causal", "causal", (2, 2, 16, 16), None, 1.0, False),
    ("causal + padding, scale < 0", "masked", (2, 2, 16, 16),
     ("bool", (2, 1, 1, 16)), -0.7, True),
    ("3-D input", "masked", (4, 8, 33), ("add", (4, 1, 33)), 1.5, False),
]


def _masks(spec, full_row):
    if spec is None:
        return None
    kind, shape = spec
    m = _bool_mask(shape, 7) if kind == "bool" else _add_mask(shape, 7)
    if full_row:
        m[(0,) * (len(shape) - 1)] = True
    return m


def _jax_fn(which, scale, causal):
    if which == "softmax":
        return lambda x, m: jsm.scaled_softmax(x, scale)
    if which == "causal":
        return lambda x, m: jsm.scaled_upper_triang_masked_softmax(x, scale)
    return lambda x, m: jsm.scaled_masked_softmax(x, m, scale, causal)


def _torch_fn(which, scale, causal):
    if which == "softmax":
        return lambda x, m: tsm.scaled_softmax(x, scale)
    if which == "causal":
        return lambda x, m: tsm.scaled_upper_triang_masked_softmax(x, scale)
    return lambda x, m: tsm.scaled_masked_softmax(x, m, scale, causal)


# the boolean-mask routes again, with every key of one row masked
FULL_ROW = [(c[0] + ", a fully masked row",) + c[1:] + (True,)
            for c in CASES if c[3] is not None and c[3][0] == "bool"
            and not c[5]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,which,shape,mspec,scale,causal,full_row",
    [c + (False,) for c in CASES] + FULL_ROW,
    ids=[c[0] for c in CASES] + [c[0] for c in FULL_ROW])
def test_softmax_routes_match_jax(name, which, shape, mspec, scale, causal,
                                  full_row, dtype):
    """Forward, dx and the additive mask's cotangent (summed back over
    its broadcast axes) against apex_tpu.ops.softmax; with ``full_row`` the
    mask hides every key of one row, which must come out uniform."""
    tol = 1e-5 if dtype == "float32" else 2e-2
    x_np = _rand(shape, 1)
    g_np = _rand(shape, 2)
    m_np = _masks(mspec, full_row)
    additive = mspec is not None and mspec[0] == "add"

    def jax_side(x, m, g):
        y, vjp = jax.vjp(_jax_fn(which, scale, causal), x, m)
        dx, dm = vjp(g)
        return y, dx, dm if additive else None

    jy, jdx, jdm = jax.jit(jax_side)(
        jnp.asarray(x_np).astype(dtype),
        None if m_np is None else jnp.asarray(m_np),
        jnp.asarray(g_np).astype(dtype))

    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x_np).to(tdt).requires_grad_(True)
    tm = None if m_np is None else torch.from_numpy(m_np)
    if additive:
        tm.requires_grad_(True)
    ty = _torch_fn(which, scale, causal)(tx, tm)
    ty.backward(torch.from_numpy(g_np).to(tdt))

    assert ty.dtype == tdt and ty.shape == shape
    assert torch.isfinite(ty.float()).all()
    assert_close(ty, np.asarray(jy, np.float32), atol=tol, rtol=tol)
    assert_close(tx.grad, np.asarray(jdx, np.float32), atol=tol, rtol=tol)
    if additive:
        assert tm.grad.shape == tm.shape
        assert_close(tm.grad, np.asarray(jdm), atol=tol, rtol=tol)
    if full_row:
        # every key of row (0, 0, .., 0) is masked: uniform, not NaN
        row = ty[(0,) * (len(shape) - 1)].float()
        assert_close(row, torch.full_like(row, 1.0 / shape[-1]), atol=tol,
                     rtol=0)


@pytest.mark.parametrize("dtype,scale,causal", [
    (torch.float32, 1.0, False), (torch.float32, 0.125, False),
    (torch.float32, 3.0, True), (torch.bfloat16, 1.0, False),
    (torch.bfloat16, 0.125, False), (torch.bfloat16, 3.0, True),
    (torch.float16, 1.0, False), (torch.float16, 3.0, True)])
def test_in_kernel_mask_equals_the_pre_fold_bit_for_bit(dtype, scale,
                                                        causal):
    """A boolean key mask with scale > 0 reaches the kernel's plain
    version as it is (``"fold"``). Its y and dx must equal, bit for bit,
    those of the route it replaces: ``where(mask, FILL / scale, x)`` by
    hand, the unmasked softmax, and that ``where``'s backward. Sample 0's
    keys are all masked, and a (B, 1, 1, Sk) and a (B, 1, Sq, Sk) mask are
    both read. (fp16 at scale 0.125 takes the fill route: its fill does not
    fit fp16.)"""
    shape = (2, 3, 8, 40)
    x = torch.from_numpy(_rand(shape, 21)).to(dtype)
    g = torch.from_numpy(_rand(shape, 22)).to(dtype)
    for mshape in ((2, 1, 1, 40), (2, 1, 8, 40)):
        mask = torch.from_numpy(_bool_mask(mshape, 23))
        mask[0] = True
        xa = x.clone().requires_grad_(True)
        ya = tsm.scaled_masked_softmax(xa, mask, scale, causal)
        ya.backward(g)
        xb = x.clone().requires_grad_(True)
        yb = tsm._FusedSoftmax.apply(torch.where(mask, -30000.0 / scale, xb),
                                     None, scale, causal, None)
        yb.backward(g)
        assert torch.equal(ya, yb) and torch.equal(xa.grad, xb.grad)
        assert (xa.grad[mask.expand(shape)] == 0).all()


def test_plain_versions_are_the_kernels_arithmetic():
    """softmax_fwd_plain with each mask mode against apex_tpu's reference,
    and softmax_bwd_plain against the JAX backward formula; a version that
    applies the scale after the mask fails the scale <= 0 case."""
    x = _rand((3, 5, 40), 3)
    m = _bool_mask((3, 5, 40), 4)
    for scale in (1.3, -0.6):
        ref = np.asarray(jsm.softmax_reference(jnp.asarray(x),
                                               jnp.asarray(m), scale))
        got = tsm.softmax_fwd_plain(torch.from_numpy(x),
                                    torch.from_numpy(m).float(), scale,
                                    mask_mode="fill")
        assert_close(got, ref, atol=1e-6, rtol=1e-5)
        wrong = torch.softmax(torch.where(torch.from_numpy(m), -30000.0,
                                          torch.from_numpy(x)) * scale, -1)
        assert torch.allclose(wrong, got, atol=1e-5) == (scale > 0)
    y = np.array(jsm.softmax_reference(jnp.asarray(x), scale=0.8))
    g = _rand(y.shape, 5)
    dot = (g * y).sum(-1, keepdims=True)
    assert_close(tsm.softmax_bwd_plain(torch.from_numpy(g),
                                       torch.from_numpy(y), 0.8),
                 0.8 * y * (g - dot), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("mask_type,with_mask,fusion", [
    ("padding", True, True), ("causal", False, True), ("causal", True, True),
    ("padding", True, False)])
def test_fused_scale_mask_softmax_dispatch_matches_jax(mask_type, with_mask,
                                                       fusion):
    """The module's dispatch (fused kernels or the composed fallback, with
    a mask_func on the fallback) against its JAX counterpart, bf16 in."""
    x_np = _rand((2, 2, 16, 16), 11)
    m_np = _bool_mask((2, 1, 1, 16), 12) if with_mask else None
    kw = dict(attn_mask_type=getattr(JaxAttnMaskType, mask_type),
              scaled_masked_softmax_fusion=fusion, scale=0.5,
              mask_func=None if fusion else (
                  lambda s, m: jnp.where(m, -10000.0, s)))
    jy = JaxFusedSoftmax(**kw)(jnp.asarray(x_np).astype(jnp.bfloat16),
                               None if m_np is None else jnp.asarray(m_np))
    kw.update(attn_mask_type=getattr(AttnMaskType, mask_type),
              mask_func=None if fusion else (
                  lambda s, m: torch.where(m, -10000.0, s)))
    ty = FusedScaleMaskSoftmax(**kw)(
        torch.from_numpy(x_np).bfloat16(),
        None if m_np is None else torch.from_numpy(m_np))
    assert ty.dtype == torch.bfloat16
    assert_close(ty, np.asarray(jy, np.float32), atol=2e-2, rtol=2e-2)


def test_constructor_checks_and_enums():
    with pytest.raises(RuntimeError, match="both fp16 and bf16"):
        FusedScaleMaskSoftmax(input_in_fp16=True, input_in_bf16=True)
    with pytest.raises(RuntimeError, match="fp32 when scaled"):
        FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=2.0)
    with pytest.raises(ValueError, match="square"):
        tsm.scaled_upper_triang_masked_softmax(torch.zeros(2, 4, 5))
    assert tenums.AttnMaskType is AttnMaskType
    for name in ("AttnMaskType", "ModelType", "LayerType", "AttnType"):
        assert ({m.name: m.value for m in getattr(tenums, name)}
                == {m.name: m.value for m in getattr(jenums, name)})
