"""Port parity: apex_tpu_torch.ops.multi_tensor and multi_tensor_applier
against apex_tpu.ops.multi_tensor on the same numpy lists: every op, with
and without a set ``noop_flag``, with a non-finite input where the op
detects one; ``stochastic_round`` bit for bit given the JAX package's own
noise bits (the clamp at the bf16 maximum and the non-finite cases
included) and its statistics with torch's generator. fp32 math within
1e-6 relative (+1e-7): the same elementwise formulas, rounded at the same
places up to FMA contraction and reduction order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor_apply import multi_tensor_applier as japply
from apex_tpu.ops import multi_tensor as jmt
from apex_tpu_torch.multi_tensor_apply import (
    MultiTensorApply,
    multi_tensor_applier,
)
from apex_tpu_torch.ops import multi_tensor as mt
from torch_parity import assert_close, to_torch

SHAPES = ((7, 5), (5,), (3, 4, 2))
TOL = dict(atol=1e-7, rtol=1e-6)


def _lists(n, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]
            for _ in range(n)]


def _t(lst, dtype=torch.float32):
    """Torch copies (the ops update in place; from_numpy shares memory)."""
    return [to_torch(a).to(dtype, copy=True) for a in lst]


def _j(lst, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in lst]


def _step_i32(args, i):
    """``args`` with the step count at ``i`` as an int32 array: the JAX
    optimizers' traced count, whose bias corrections are fp32 (as the
    port's are), where a Python int would give float64 ones."""
    return args[:i] + (jnp.int32(args[i]),) + args[i + 1:]


def _close_lists(ours, theirs, **tol):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert str(a.dtype) == f"torch.{np.dtype(b.dtype).name}"
        assert_close(a, np.asarray(b, np.float32), **(tol or TOL))


def test_applier_forwards_chunk_size_and_args():
    seen = []
    app = MultiTensorApply(1024)
    assert app(lambda c, f, lists, a, k=0: seen.append((c, f, a, k)) or 7,
               None, [[]], 3, k=4) == 7
    assert seen == [(1024, None, 3, 4)]
    assert multi_tensor_applier.chunk_size == 2048 * 32


@pytest.mark.parametrize("noop", [None, False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_scale_matches_jax(noop, out_dtype):
    (src,) = _lists(1, 0)
    tdt, jdt = getattr(torch, out_dtype), getattr(jnp, out_dtype)
    dst = [torch.zeros(s, dtype=tdt) for s in SHAPES]
    outs, flag = multi_tensor_applier(mt.multi_tensor_scale, noop,
                                      [_t(src), dst], 0.125)
    jouts, jflag = japply(jmt.multi_tensor_scale,
                          None if noop is None else jnp.asarray(noop),
                          [_j(src), [jnp.zeros(s, jdt) for s in SHAPES]],
                          0.125)
    assert outs is dst
    _close_lists(outs, jouts)
    assert bool(flag) == bool(jflag) == bool(noop)


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_scale_flags_non_finite(bad):
    (src,) = _lists(1, 1)
    src[2][1, 2, 0] = bad
    ours, flag = mt.multi_tensor_scale(0, None, [_t(src)], 2.0)
    theirs, jflag = jmt.multi_tensor_scale(0, None, [_j(src)], 2.0)
    assert bool(flag) and bool(jflag)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a finite input that the scale takes past fp32's range is found too
    big = [np.full((3,), 3e38, np.float32)]
    assert bool(mt.multi_tensor_scale(0, None, [_t(big)], 4.0)[1])
    assert bool(jmt.multi_tensor_scale(0, None, [_j(big)], 4.0)[1])


@pytest.mark.parametrize("noop", [None, True])
def test_axpby_matches_jax(noop):
    x, y, out = _lists(3, 2)
    y[0][0, 0] = float("inf")
    ours, flag = mt.multi_tensor_axpby(0, noop, [_t(x), _t(y), _t(out)],
                                       2.0, -0.5)
    theirs, jflag = jmt.multi_tensor_axpby(
        0, None if noop is None else jnp.asarray(noop),
        [_j(x), _j(y), _j(out)], 2.0, -0.5)
    assert bool(flag) and bool(jflag)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("per_tensor", [False, True])
def test_l2norm_matches_jax(per_tensor):
    (x,) = _lists(1, 3, scale=3.0)
    norm, per = mt.multi_tensor_l2norm(0, None, [_t(x, torch.bfloat16)],
                                       per_tensor)
    jnorm, jper = jmt.multi_tensor_l2norm(0, None, [_j(x, jnp.bfloat16)],
                                          per_tensor)
    assert norm.dtype == torch.float32
    assert_close(norm, np.asarray(jnorm), **TOL)
    assert (per is None) == (jper is None)
    if per_tensor:
        assert_close(per, np.asarray(jper), **TOL)
    x[1][2] = float("nan")
    assert torch.isnan(mt.multi_tensor_l2norm(0, None, [_t(x)])[0])


@pytest.mark.parametrize("noop", [None, False, True])
def test_l2norm_scale_matches_jax(noop):
    (x,) = _lists(1, 4)
    outs, norm, per, flag = mt.multi_tensor_l2norm_scale(
        0, noop, [_t(x)], 0.5, True)
    jouts, jnorm, jper, jflag = jmt.multi_tensor_l2norm_scale(
        0, None if noop is None else jnp.asarray(noop), [_j(x)], 0.5, True)
    _close_lists(outs, jouts)
    assert_close(norm, np.asarray(jnorm), **TOL)
    assert_close(per, np.asarray(jper), **TOL)
    assert bool(flag) == bool(jflag)


def test_parallel_lists_must_match():
    x, y = _lists(2, 5)
    for op, args in ((mt.multi_tensor_axpby, (1.0, 1.0)),
                     (mt.multi_tensor_scale, (1.0,))):
        with pytest.raises(ValueError, match="mismatched lengths"):
            op(0, None, [_t(x), _t(y)[:2]], *args)
    with pytest.raises(ValueError, match="mismatched lengths"):
        mt.multi_tensor_adam(0, None, [_t(x), _t(y), _t(x)[:1], _t(y)],
                             1e-3, 0.9, 0.999, 1e-8, 1, 1, True, 0.0)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("noop", [None, True])
def test_adam_matches_jax(mode, master, noop):
    g, p, m, v = _lists(4, 6)
    v = [np.abs(a) for a in v]
    lists = [g, p, m, v] + ([p] if master else [])
    args = (1e-2, 0.9, 0.95, 1e-8, 3, mode, True, 0.1)
    ours = mt.multi_tensor_adam(0, noop, [_t(x) for x in lists], *args)
    theirs = jmt.multi_tensor_adam(
        0, None if noop is None else jnp.asarray(noop),
        [_j(x) for x in lists], *_step_i32(args, 4))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        _close_lists(a, b)
    if noop:
        for a, b in zip(ours, lists[1:]):
            _close_lists(a, _j(b), atol=0, rtol=0)


def test_adam_bf16_moments_and_params_round_to_nearest():
    """bf16 params and moments without a generator: the moments rounded to
    nearest, bit for bit the JAX op's ``astype``."""
    g, p, m, v = _lists(4, 7)
    v = [np.abs(a) for a in v]
    bf = torch.bfloat16
    ours = mt.multi_tensor_adam(
        0, None, [_t(g), _t(p, bf), _t(m, bf), _t(v, bf), _t(p)],
        1e-3, 0.9, 0.999, 1e-8, 2, 1, True, 0.01)
    theirs = jmt.multi_tensor_adam(
        0, None, [_j(g), _j(p, jnp.bfloat16), _j(m, jnp.bfloat16),
                  _j(v, jnp.bfloat16), _j(p)],
        1e-3, 0.9, 0.999, 1e-8, jnp.int32(2), 1, True, 0.01)
    for lst_o, lst_t in zip(ours[1:3], theirs[1:3]):
        for a, b in zip(lst_o, lst_t):
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(),
                np.asarray(b).view(np.int16))
    _close_lists(ours[3], theirs[3])


@pytest.mark.parametrize("op", ["adam", "lamb_stage1"])
def test_16bit_moments_in_runs_match_one_run(op, monkeypatch):
    """16-bit moments are stepped in runs of at most ``_ROUND_CHUNK``
    elements: runs that cut the list (20 elements a run: three runs here)
    give bit for bit what one run over the whole list gives, rounded to
    nearest."""
    g, p, m, v = _lists(4, 13)
    v = [np.abs(a) for a in v]
    bf = torch.bfloat16

    def run():
        lists = [_t(g), _t(p), _t(m, bf), _t(v, bf)]
        if op == "adam":
            out = mt.multi_tensor_adam(0, None, lists, 1e-3, 0.9, 0.999,
                                       1e-8, 2, 1, True, 0.01)
            return out[0] + out[1] + out[2]
        norm = torch.tensor(3.0)
        u, m_out, v_out = mt.multi_tensor_lamb_stage1(
            0, None, lists, 0.9, 0.999, 1e-6, 2, True, 0.01, True, norm, 1.0)
        return u + m_out + v_out

    one = run()
    monkeypatch.setattr(mt, "_ROUND_CHUNK", 20)
    assert len(mt._runs([_t(g)], [_t(m, bf)])) == 3
    for a, b in zip(run(), one):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("noop", [None, True])
def test_adagrad_matches_jax(mode, master, noop):
    g, p, h = _lists(3, 8)
    h = [np.abs(a) for a in h]
    lists = [g, p, h] + ([p] if master else [])
    ours = mt.multi_tensor_adagrad(0, noop, [_t(x) for x in lists], 1e-2,
                                   1e-10, mode, 0.1)
    theirs = jmt.multi_tensor_adagrad(
        0, None if noop is None else jnp.asarray(noop),
        [_j(x) for x in lists], 1e-2, 1e-10, mode, 0.1)
    for a, b in zip(ours, theirs):
        _close_lists(a, b)


@pytest.mark.parametrize("momentum,nesterov,dampening", [
    (0.0, False, 0.0), (0.9, False, 0.1), (0.9, True, 0.0)])
@pytest.mark.parametrize("first_run", [True, False])
@pytest.mark.parametrize("wd_after", [False, True])
def test_sgd_matches_jax(momentum, nesterov, dampening, first_run, wd_after):
    g, p, mom = _lists(3, 9)
    args = (0.01, momentum, dampening, 0.1, nesterov, first_run, wd_after,
            0.5)
    ours = mt.multi_tensor_sgd(0, None, [_t(g), _t(p), _t(mom)], *args)
    theirs = jmt.multi_tensor_sgd(0, None, [_j(g), _j(p), _j(mom)], *args)
    for a, b in zip(ours, theirs):
        _close_lists(a, b)


def test_sgd_master_noop_and_traced_first_run():
    g, p, mom = _lists(3, 10)
    lists = [g, p, mom, p]
    args = (0.0, 0.9, 0.0, 0.1, True)
    for noop in (None, True):
        for first in (True, False):
            ours = mt.multi_tensor_sgd(
                0, noop, [_t(x) for x in lists], *args,
                torch.tensor(first), False)
            theirs = jmt.multi_tensor_sgd(
                0, None if noop is None else jnp.asarray(noop),
                [_j(x) for x in lists], *args, jnp.asarray(first), False)
            for a, b in zip(ours, theirs):
                _close_lists(a, b)


def test_lamb_pieces_match_jax():
    g, p, m, v = _lists(4, 11, scale=4.0)
    v = [np.abs(a) for a in v]
    norm, _ = mt.multi_tensor_l2norm(0, None, [_t(g)])
    jnorm, _ = jmt.multi_tensor_l2norm(0, None, [_j(g)])
    sc = mt.lamb_scalars(0.9, 0.999, 4, True, True, norm, 1.0, 0.5)
    jsc = jmt.lamb_scalars(0.9, 0.999, jnp.int32(4), True, True, jnorm, 1.0,
                           0.5)
    for a, b in zip(sc, jsc):
        assert_close(torch.as_tensor(a), np.asarray(b), **TOL)
    u = mt.lamb_update_direction(_t(m), _t(v), _t(p), 0.3, 0.2, 1e-6, 0.01)
    ju = [jmt.lamb_update_direction(a, b, c, 0.3, 0.2, 1e-6, 0.01)
          for a, b, c in zip(_j(m), _j(v), _j(p))]
    _close_lists(u, ju)
    w = torch.tensor([0.0, 1.0, 2.0, 3.0])
    un = torch.tensor([1.0, 0.0, 4.0, 1.5])
    np.testing.assert_array_equal(
        mt.lamb_trust_ratio(w, un).numpy(),
        np.asarray(jmt.lamb_trust_ratio(jnp.asarray(w.numpy()),
                                        jnp.asarray(un.numpy()))))


@pytest.mark.parametrize("wd,nvlamb", [(0.0, False), (0.01, False),
                                       (0.0, True)])
@pytest.mark.parametrize("master", [False, True])
def test_lamb_stages_match_jax(wd, nvlamb, master):
    g, p, m, v = _lists(4, 12, scale=3.0)
    v = [np.abs(a) for a in v]
    norm = mt.multi_tensor_l2norm(0, None, [_t(g)])[0]
    jnorm = jmt.multi_tensor_l2norm(0, None, [_j(g)])[0]
    args = (0.9, 0.999, 1e-6, 2, True, wd, True)
    u, m2, v2 = mt.multi_tensor_lamb_stage1(
        0, None, [_t(g), _t(p), _t(m), _t(v)], *args, norm, 1.0, 0.25)
    ju, jm2, jv2 = jmt.multi_tensor_lamb_stage1(
        0, None, [_j(g), _j(p), _j(m), _j(v)], *_step_i32(args, 3), jnorm,
        1.0, 0.25)
    for a, b in ((u, ju), (m2, jm2), (v2, jv2)):
        _close_lists(a, b)
    lists = [_t(p), u] + ([_t(p)] if master else [])
    jlists = [_j(p), ju] + ([_j(p)] if master else [])
    ours = mt.multi_tensor_lamb_stage2(0, None, lists, 1e-2, wd, nvlamb)
    theirs = jmt.multi_tensor_lamb_stage2(0, None, jlists, 1e-2, wd, nvlamb)
    if master:
        for a, b in zip(ours, theirs):
            _close_lists(a, b)
    else:
        _close_lists(ours, theirs)


@pytest.mark.parametrize("init_zero", [False, True])
@pytest.mark.parametrize("step", [1, 3])
@pytest.mark.parametrize("master", [False, True])
def test_novograd_matches_jax(init_zero, step, master):
    g, p, m = _lists(3, 13)
    v = np.abs(np.random.RandomState(14).randn(len(SHAPES))).astype(
        np.float32)
    tl = [_t(g), _t(p), _t(m), to_torch(v).clone()] + (
        [_t(p)] if master else [])
    jl = [_j(g), _j(p), _j(m), jnp.asarray(v)] + ([_j(p)] if master else [])
    args = (1e-2, 0.95, 0.98, 1e-8, step, True, 0.01, True, 2, init_zero)
    ours = mt.multi_tensor_novograd(0, None, tl, *args)
    theirs = jmt.multi_tensor_novograd(0, None, jl, *_step_i32(args, 4))
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        if i == 2:
            assert_close(a, np.asarray(b), **TOL)
        else:
            _close_lists(a, b)


def _jax_bits(seed, shape):
    return np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      jnp.uint16))


def test_stochastic_round_bf16_bit_for_bit_with_jax_noise():
    """The same noise bits give the same bf16 bits: ordinary values, the
    clamp at the bf16 maximum (a carry into the exponent), fp32 values past
    bf16's range, and the non-finite cases passed through."""
    rng = np.random.RandomState(15)
    bf16_max = float(jnp.finfo(jnp.bfloat16).max)
    special = np.array([bf16_max, -bf16_max, np.nextafter(
        np.float32(bf16_max), np.float32(np.inf)), 3.4e38, -3.4e38,
        np.inf, -np.inf, np.nan, 0.0, -0.0, 2.0 ** -126, -2.0 ** -126],
        np.float32)
    x = np.concatenate([rng.randn(500).astype(np.float32)
                        * 10.0 ** rng.randint(-6, 6, 500), special])
    x = x.astype(np.float32)
    bits = _jax_bits(16, x.shape)
    # the JAX function with a key whose bits are `bits`
    theirs = np.asarray(jmt.stochastic_round(jnp.asarray(x), jnp.bfloat16,
                                             jax.random.PRNGKey(16)))
    ours = mt.stochastic_round_with(to_torch(x), torch.bfloat16,
                                    to_torch(bits.astype(np.int32)))
    o = ours.view(torch.int16).numpy()
    t = theirs.view(np.int16)
    nan = np.isnan(x)
    np.testing.assert_array_equal(o[~nan], t[~nan])
    assert torch.isnan(ours[torch.from_numpy(nan)]).all()
    # the carries at the maximum were clamped, never rounded to inf
    assert torch.isfinite(ours[torch.from_numpy(np.isfinite(x))]).all()
    # all-ones noise rounds every positive non-bf16 value up
    up = mt.stochastic_round_with(to_torch(np.float32([1.0 + 2 ** -10])),
                                  torch.bfloat16, torch.tensor([65535]))
    assert up.item() == 1.0 + 2 ** -7
    # subnormal inputs: XLA's CPU flushes them to zero, torch keeps them
    # (within a subnormal of 0 either way)
    tiny = mt.stochastic_round_with(to_torch(np.float32([1e-40, -1e-40])),
                                    torch.bfloat16, torch.tensor([0, 0]))
    assert tiny.float().abs().max().item() < 2.0 ** -126


@pytest.mark.parametrize("dtype", ["int8", "int32"])
def test_stochastic_round_integers_with_jax_noise(dtype):
    rng = np.random.RandomState(17)
    x = np.concatenate([rng.randn(400).astype(np.float32) * 60.0,
                        np.float32([300.0, -300.0, np.inf, -np.inf,
                                    np.nan])])
    key = jax.random.PRNGKey(18)
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    theirs = np.asarray(jmt.stochastic_round(jnp.asarray(x),
                                             getattr(jnp, dtype), key))
    ours = mt.stochastic_round_with(to_torch(x), getattr(torch, dtype),
                                    to_torch(u.copy()))
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_stochastic_round_statistics_and_fp32():
    """With torch's generator: unbiased (the mean of many roundings of a
    value between two bf16 neighbours is the value), each draw one of the
    two neighbours; fp32 targets a plain cast."""
    x = torch.full((200_000,), 1.0 + 2 ** -9)   # a quarter of a bf16 ulp
    gen = torch.Generator().manual_seed(19)
    r = mt.stochastic_round(x, torch.bfloat16, gen).float()
    assert set(r.unique().tolist()) == {1.0, 1.0 + 2 ** -7}
    frac_up = (r > 1.0).float().mean().item()
    assert abs(frac_up - 0.25) < 0.005
    y = torch.randn(10)
    assert torch.equal(mt.stochastic_round(y, torch.float32, gen), y)
    with pytest.raises(NotImplementedError, match="bf16/f32/integer"):
        mt.stochastic_round(y, torch.float16, gen)


def test_all_finite():
    assert bool(mt.all_finite([]))
    a, b = torch.randn(4), torch.randn(3).bfloat16()
    assert bool(mt.all_finite([a, b]))
    b[1] = float("nan")
    assert not bool(mt.all_finite([a, b]))


def _op_calls(g, p, m, v):
    """Each optimizer op of both packages on one set of lists: (name,
    port call, JAX call), the JAX step counts as int32."""
    v = [np.abs(a) for a in v]
    vec = np.abs(np.random.RandomState(20).randn(len(SHAPES))).astype(
        np.float32)
    norm = lambda x: mt.multi_tensor_l2norm(0, None, [_t(x)])[0]  # noqa
    jnorm = lambda x: jmt.multi_tensor_l2norm(0, None, [_j(x)])[0]  # noqa
    return [
        ("adam", lambda: mt.multi_tensor_adam(
            0, None, [_t(g), _t(p), _t(m), _t(v)], 1e-2, 0.9, 0.99, 1e-8, 2,
            1, True, 0.1),
         lambda: jmt.multi_tensor_adam(
             0, None, [_j(g), _j(p), _j(m), _j(v)], 1e-2, 0.9, 0.99, 1e-8,
             jnp.int32(2), 1, True, 0.1)),
        ("adagrad", lambda: mt.multi_tensor_adagrad(
            0, None, [_t(g), _t(p), _t(v)], 1e-2, 1e-10, 0, 0.1),
         lambda: jmt.multi_tensor_adagrad(
             0, None, [_j(g), _j(p), _j(v)], 1e-2, 1e-10, 0, 0.1)),
        ("sgd", lambda: mt.multi_tensor_sgd(
            0, None, [_t(g), _t(p), _t(m)], 0.1, 0.9, 0.0, 0.01, True, False,
            False),
         lambda: jmt.multi_tensor_sgd(
             0, None, [_j(g), _j(p), _j(m)], 0.1, 0.9, 0.0, 0.01, True,
             False, False)),
        ("lamb_stage1", lambda: mt.multi_tensor_lamb_stage1(
            0, None, [_t(g), _t(p), _t(m), _t(v)], 0.9, 0.999, 1e-6, 2,
            True, 0.01, True, norm(g), 1.0),
         lambda: jmt.multi_tensor_lamb_stage1(
             0, None, [_j(g), _j(p), _j(m), _j(v)], 0.9, 0.999, 1e-6,
             jnp.int32(2), True, 0.01, True, jnorm(g), 1.0)),
        ("novograd", lambda: mt.multi_tensor_novograd(
            0, None, [_t(g), _t(p), _t(m), to_torch(vec).clone()], 1e-2,
            0.95, 0.98, 1e-8, 2, True, 0.01, True, 2),
         lambda: jmt.multi_tensor_novograd(
             0, None, [_j(g), _j(p), _j(m), jnp.asarray(vec)], 1e-2, 0.95,
             0.98, 1e-8, jnp.int32(2), True, 0.01, True, 2)),
    ]


@pytest.mark.parametrize("op", ["adam", "adagrad", "sgd", "lamb_stage1",
                                "novograd"])
def test_optimizer_ops_propagate_non_finite_gradients_as_jax(op):
    """An inf and a nan in the gradients: the ops do not look for them (the
    optimizers skip such steps before calling them), so they reach the
    same outputs as in the JAX ops: the same non-finite elements, the
    finite ones within 1e-6."""
    g, p, m, v = _lists(4, 21)
    g[0][1, 1] = np.inf
    g[2][0, 1, 1] = np.nan
    ((_, ours, theirs),) = [c for c in _op_calls(g, p, m, v) if c[0] == op]
    ours, theirs = ours(), theirs()
    flat_o = [t for x in ours for t in (x if isinstance(x, list) else [x])]
    flat_t = [t for x in theirs for t in (x if isinstance(x, list) else [x])]
    assert len(flat_o) == len(flat_t)
    for a, b in zip(flat_o, flat_t):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], atol=1e-6, rtol=1e-6)
