"""Port parity: amp O1 (``amp/lists.py``, ``amp/autocast.py``, the O1 path
of ``amp.initialize`` and the handle, ``amp``'s module-level functions)
against apex_tpu.amp on the CPU. The output dtype of every list entry on
fp32 and bf16 inputs against its JAX counterpart under the JAX autocast;
the four cases that fix what is patched (``x @ w`` stays fp32, a matmul
call goes bf16, an fp32-output product stays fp32, ``exp`` of bf16 goes
fp32); nesting, ``enabled=False`` and the uninstall after an exception;
then O1 on the 784-256-10 MLP of BASELINE configs[0]: loss and gradients
against the JAX package's O1 within bf16 tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax import lax

import apex_tpu.amp as jamp
from apex_tpu.mlp import MLP as JaxMLP
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu_torch import amp
from apex_tpu_torch.amp import lists
from apex_tpu_torch.fused_dense import fused_dense as fd
from apex_tpu_torch.mlp import MLP, load_jax_params
from apex_tpu_torch.optimizers import FusedAdam
from torch_parity import assert_within_bf16_ulp, to_torch

_R = np.random.RandomState(0)
A = _R.randn(4, 3).astype(np.float32)
B = _R.randn(3, 2).astype(np.float32)
V = _R.randn(3).astype(np.float32)
W = _R.randn(4).astype(np.float32)
A3 = _R.randn(2, 4, 3).astype(np.float32)
B3 = _R.randn(2, 3, 2).astype(np.float32)
C = _R.randn(4, 2).astype(np.float32)
X1 = _R.randn(1, 2, 8).astype(np.float32)
K1 = _R.randn(3, 2, 3).astype(np.float32)
X2 = _R.randn(1, 2, 6, 6).astype(np.float32)
K2 = _R.randn(3, 2, 3, 3).astype(np.float32)
X3 = _R.randn(1, 2, 5, 5, 5).astype(np.float32)
K3 = _R.randn(3, 2, 3, 3, 3).astype(np.float32)
KT1 = _R.randn(2, 3, 3).astype(np.float32)     # conv_transpose: (in, out, k)
KT2 = _R.randn(2, 3, 3, 3).astype(np.float32)
KT3 = _R.randn(2, 3, 3, 3, 3).astype(np.float32)
P = (np.abs(_R.randn(4, 5)) + 0.5).astype(np.float32)   # positive
U = (np.tanh(_R.randn(4, 5)) * 0.9).astype(np.float32)  # in (-1, 1)
LABELS = np.array([0, 3, 1, 4])
T = (_R.rand(4, 5) > 0.5).astype(np.float32)


def _dn(n):
    """JAX dimension numbers for torch's conv_transpose layouts: x (N, C,
    ...), weight (in, out, ...)."""
    sp = "DHW"[3 - n:]
    return ("NC" + sp, "IO" + sp, "NC" + sp)


def _late(name):
    """A call of ``name`` looked up when it is made, so it goes through
    whatever autocast has installed (a reference taken now would not)."""
    def call(*args):
        holder = {"torch": torch, "F": F, "jnp": jnp, "lax": lax,
                  "jax": jax}[name.split(".")[0]]
        for part in name.split(".")[1:]:
            holder = getattr(holder, part)
        return holder(*args)

    return call


# module path, attr -> (inputs, torch call, JAX counterpart call); every
# call looks its function up when it runs
WHITE = {
    ("torch", "matmul"): ((A, B), _late('torch.matmul'), _late('jnp.matmul')),
    ("torch", "mm"): ((A, B), _late('torch.mm'), _late('jnp.matmul')),
    ("torch", "bmm"): ((A3, B3), _late('torch.bmm'), _late('jnp.matmul')),
    ("torch", "mv"): ((A, V), _late('torch.mv'), _late('jnp.dot')),
    ("torch", "addmm"): ((C, A, B), _late('torch.addmm'),
                         lambda c, a, b: jnp.dot(a, b)),
    ("torch", "baddbmm"): ((np.zeros((2, 4, 2), np.float32), A3, B3),
                           _late('torch.baddbmm'),
                           lambda c, a, b: jnp.matmul(a, b)),
    ("torch", "addbmm"): ((C, A3, B3), _late('torch.addbmm'),
                          lambda c, a, b: jnp.einsum("bij,bjk->ik", a, b)),
    ("torch", "addmv"): ((W, A, V), _late('torch.addmv'),
                         lambda c, a, v: jnp.dot(a, v)),
    ("torch", "dot"): ((V, V), _late('torch.dot'), _late('jnp.dot')),
    ("torch", "vdot"): ((V, V), _late('torch.vdot'), _late('jnp.vdot')),
    ("torch", "inner"): ((V, V), _late('torch.inner'), _late('jnp.inner')),
    ("torch", "outer"): ((V, W), _late('torch.outer'), _late('jnp.outer')),
    ("torch", "ger"): ((V, W), _late('torch.ger'), _late('jnp.outer')),
    ("torch", "tensordot"): ((A, B), lambda a, b: torch.tensordot(a, b, 1),
                             lambda a, b: jnp.tensordot(a, b, 1)),
    ("torch", "einsum"): ((A, B), lambda a, b: torch.einsum("ij,jk->ik", a,
                                                            b),
                          lambda a, b: jnp.einsum("ij,jk->ik", a, b)),
    ("torch", "linalg.multi_dot"): (
        (A, B, B.T), lambda *m: torch.linalg.multi_dot(list(m)),
        lambda *m: jnp.linalg.multi_dot(list(m))),
    ("torch.nn.functional", "linear"): (
        (A, B.T), _late('F.linear'),
        lambda x, w: lax.dot_general(x, w, (((1,), (1,)), ((), ())))),
    ("torch.nn.functional", "conv1d"): (
        (X1, K1), _late('F.conv1d'),
        lambda x, k: lax.conv_general_dilated(x, k, (1,), "VALID")),
    ("torch.nn.functional", "conv2d"): (
        (X2, K2), _late('F.conv2d'),
        lambda x, k: lax.conv(x, k, (1, 1), "VALID")),
    ("torch.nn.functional", "conv3d"): (
        (X3, K3), _late('F.conv3d'),
        lambda x, k: lax.conv_with_general_padding(
            x, k, (1, 1, 1), [(0, 0)] * 3, None, None)),
    ("torch.nn.functional", "conv_transpose1d"): (
        (X1, KT1), _late('F.conv_transpose1d'),
        lambda x, k: lax.conv_transpose(x, k, (1,), "VALID",
                                        dimension_numbers=_dn(1))),
    ("torch.nn.functional", "conv_transpose2d"): (
        (X2, KT2), _late('F.conv_transpose2d'),
        lambda x, k: lax.conv_transpose(x, k, (1, 1), "VALID",
                                        dimension_numbers=_dn(2))),
    ("torch.nn.functional", "conv_transpose3d"): (
        (X3, KT3), _late('F.conv_transpose3d'),
        lambda x, k: lax.conv_transpose(x, k, (1, 1, 1), "VALID",
                                        dimension_numbers=_dn(3))),
    ("apex_tpu_torch.fused_dense.fused_dense", "matmul_fp32_out"): (
        (A, B), lambda a, b: fd.matmul_fp32_out(a, b),
        lambda a, b: jnp.matmul(a, b, preferred_element_type=jnp.float32)),
}

BLACK = {
    ("torch", "exp"): ((A,), _late('torch.exp'), _late('jnp.exp')),
    ("torch", "exp2"): ((A,), _late('torch.exp2'), _late('jnp.exp2')),
    ("torch", "expm1"): ((A,), _late('torch.expm1'), _late('jnp.expm1')),
    ("torch", "log"): ((P,), _late('torch.log'), _late('jnp.log')),
    ("torch", "log1p"): ((P,), _late('torch.log1p'), _late('jnp.log1p')),
    ("torch", "log2"): ((P,), _late('torch.log2'), _late('jnp.log2')),
    ("torch", "log10"): ((P,), _late('torch.log10'), _late('jnp.log10')),
    ("torch", "logaddexp"): ((A, A), _late('torch.logaddexp'),
                             _late('jnp.logaddexp')),
    ("torch", "logaddexp2"): ((A, A), _late('torch.logaddexp2'),
                              _late('jnp.logaddexp2')),
    ("torch", "pow"): ((P,), lambda x: torch.pow(x, 2.0),
                       lambda x: jnp.power(x, 2.0)),
    # torch.float_power computes in float64 whatever its inputs; the
    # blacklist casts its inputs to fp32 as for the others
    ("torch", "float_power"): ((P,), lambda x: torch.float_power(x, 2.0),
                               lambda x: jnp.float_power(x, 2.0)),
    ("torch", "reciprocal"): ((P,), _late('torch.reciprocal'),
                              _late('jnp.reciprocal')),
    ("torch", "cosh"): ((A,), _late('torch.cosh'), _late('jnp.cosh')),
    ("torch", "sinh"): ((A,), _late('torch.sinh'), _late('jnp.sinh')),
    ("torch", "tan"): ((U,), _late('torch.tan'), _late('jnp.tan')),
    ("torch", "acos"): ((U,), _late('torch.acos'), _late('jnp.arccos')),
    ("torch", "asin"): ((U,), _late('torch.asin'), _late('jnp.arcsin')),
    ("torch", "cumsum"): ((A,), lambda x: torch.cumsum(x, 0),
                          lambda x: jnp.cumsum(x, 0)),
    ("torch", "cumprod"): ((A,), lambda x: torch.cumprod(x, 0),
                           lambda x: jnp.cumprod(x, 0)),
    ("torch", "prod"): ((A,), _late('torch.prod'), _late('jnp.prod')),
    ("torch", "linalg.norm"): ((A,), _late('torch.linalg.norm'),
                               _late('jnp.linalg.norm')),
    ("torch", "logsumexp"): ((A,), lambda x: torch.logsumexp(x, 0),
                             lambda x: jax.scipy.special.logsumexp(x, 0)),
    ("torch", "rsqrt"): ((P,), _late('torch.rsqrt'), _late('lax.rsqrt')),
    ("torch", "erfinv"): ((U,), _late('torch.erfinv'), _late('lax.erf_inv')),
    ("torch.nn.functional", "softmax"): (
        (A,), lambda x: F.softmax(x, -1), _late('jax.nn.softmax')),
    ("torch.nn.functional", "log_softmax"): (
        (A,), lambda x: F.log_softmax(x, -1), _late('jax.nn.log_softmax')),
    ("torch.nn.functional", "softplus"): ((A,), _late('F.softplus'),
                                          _late('jax.nn.softplus')),
    ("torch.nn.functional", "cross_entropy"): (
        (P,), lambda x: F.cross_entropy(x, torch.from_numpy(LABELS)),
        lambda x: optax.softmax_cross_entropy_with_integer_labels(
            x, jnp.asarray(LABELS))),
    ("torch.nn.functional", "binary_cross_entropy_with_logits"): (
        (A @ np.ones((3, 5), np.float32),),
        lambda x: F.binary_cross_entropy_with_logits(
            x, torch.from_numpy(T).to(x.dtype)),
        lambda x: optax.sigmoid_binary_cross_entropy(x, jnp.asarray(T))),
}


def test_tables_cover_every_entry():
    assert set(WHITE) == set(lists.WHITELIST)
    assert set(BLACK) == set(lists.BLACKLIST)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", sorted(WHITE) + sorted(BLACK),
                         ids=lambda e: f"{e[0]}.{e[1]}")
def test_entry_output_dtype_matches_jax(entry, in_dtype):
    inputs, tfn, jfn = {**WHITE, **BLACK}[entry]
    with amp.autocast():
        ours = tfn(*[to_torch(a).to(getattr(torch, in_dtype))
                     for a in inputs])
    with jamp.autocast():
        theirs = jfn(*[jnp.asarray(a, getattr(jnp, in_dtype))
                       for a in inputs])
    expected = f"torch.{np.dtype(theirs.dtype).name}"
    if entry == ("torch", "float_power"):
        expected = "torch.float64"
    assert str(ours.dtype) == expected
    # outside any autocast the function is the original again
    assert not getattr(_resolve(entry), "__wrapped_by_amp__", False)


def _resolve(entry):
    import importlib

    holder = importlib.import_module(entry[0])
    for part in entry[1].split(".")[:-1]:
        holder = getattr(holder, part)
    return getattr(holder, entry[1].split(".")[-1])


def test_the_four_cases_match_jax():
    x, w = to_torch(A), to_torch(B)
    jx, jw = jnp.asarray(A), jnp.asarray(B)
    with amp.autocast():
        ours = [(x @ w).dtype, torch.matmul(x, w).dtype,
                fd.matmul_fp32_out(x, w).dtype,
                torch.exp(x.to(torch.bfloat16)).dtype]
    with jamp.autocast():
        theirs = [(jx @ jw).dtype, jnp.matmul(jx, jw).dtype,
                  jnp.matmul(jx, jw,
                             preferred_element_type=jnp.float32).dtype,
                  jnp.exp(jx.astype(jnp.bfloat16)).dtype]
    assert ours == [torch.float32, torch.bfloat16, torch.float32,
                    torch.float32]
    assert [np.dtype(t).name for t in theirs] == [
        "float32", "bfloat16", "float32", "float32"]


def test_nesting_disable_and_uninstall_after_an_exception():
    x = to_torch(A)
    w = to_torch(B)
    orig = torch.matmul
    with amp.autocast():
        assert torch.matmul is not orig
        with amp.autocast(enabled=False):
            assert torch.matmul(x, w).dtype == torch.float32
            with amp.autocast(compute_dtype=torch.float16):
                assert torch.matmul(x, w).dtype == torch.float16
        assert torch.matmul(x, w).dtype == torch.bfloat16
    assert torch.matmul is orig
    with pytest.raises(RuntimeError, match="boom"):
        with amp.autocast():
            raise RuntimeError("boom")
    assert torch.matmul is orig and F.linear.__name__ == "linear"

    @amp.autocast()
    def decorated(a, b):
        return torch.mm(a, b)

    assert decorated(x, w).dtype == torch.bfloat16
    assert torch.mm(x, w).dtype == torch.float32


def test_casts_recurse_into_lists_only_floating():
    x = to_torch(A)
    with amp.autocast():
        out = torch.linalg.multi_dot([x, to_torch(B), to_torch(B.T)])
        idx = torch.cumsum(torch.arange(4), 0)
    assert out.dtype == torch.bfloat16 and idx.dtype == torch.int64


def test_function_decorators_match_jax():
    x = to_torch(A)
    jx = jnp.asarray(A)
    half = amp.half_function(lambda a: a)
    flt = amp.float_function(lambda a: a)
    assert half(x).dtype == torch.bfloat16
    assert np.dtype(jamp.half_function(lambda a: a)(jx).dtype).name == \
        "bfloat16"
    with amp.autocast(compute_dtype=torch.float16, enabled=False):
        assert half(x).dtype == torch.float16
    assert flt(x.bfloat16()).dtype == torch.float32
    f = lambda a: a  # noqa: E731
    assert amp.promote_function(f) is f


def test_module_level_functions_use_the_last_handle():
    net = torch.nn.Linear(3, 2)
    opt = FusedAdam(net.parameters(), lr=0.1)
    net, opt, handle = amp.initialize(net, opt, opt_level="O2",
                                      verbosity=0, device="cpu")
    st = handle.init_state()
    loss = net(to_torch(A).bfloat16()).float().sum()
    assert amp.scale_loss(loss, st).item() == pytest.approx(
        loss.item() * 2.0 ** 16)
    assert list(amp.master_params(opt)) == []
    amp.scale_loss(loss, st).backward()
    opt.step(grad_scale=st.loss_scale)
    masters = list(amp.master_params(opt))
    assert len(masters) == 2 and all(m.dtype == torch.float32
                                     for m in masters)
    sd = amp.state_dict()
    sd["loss_scaler0"]["loss_scale"] = 8.0
    amp.load_state_dict(sd)
    assert handle.state_dict()["loss_scaler0"]["loss_scale"] == 8.0


def _mnist(n, seed):
    """examples/train_mnist.py's synthetic MNIST."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(10, 784).astype("float32") * 0.5
    labels = rng.randint(0, 10, n)
    images = centers[labels] + rng.randn(n, 784).astype("float32")
    return images, labels


@pytest.fixture(scope="module")
def mlp_params():
    params = JaxMLP((784, 256, 10)).init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 784)))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("cast_input", [False, True])
def test_o1_mlp_loss_and_grads_match_jax(mlp_params, cast_input):
    """O1 on the 784-256-10 MLP, batch 32: the loss and every gradient
    within one bf16 ulp (``assert_within_bf16_ulp``: of the larger
    magnitude, floored at 2^-8 for the loss and at the tensor's largest
    gradient for the gradients, whose near-zero elements keep the ulp of
    the bf16 products they are summed from). ``cast_input``: the input
    cast to the compute dtype first (``examples/train_mnist.py``'s
    recipe), else fp32 inputs whose first product the patch casts."""
    x, y = _mnist(32, 1)
    jparams, _, jh = jamp.initialize(jax.tree.map(jnp.asarray, mlp_params),
                                     JaxAdam(lr=1e-3), opt_level="O1",
                                     verbosity=0)
    jmodel = JaxMLP((784, 256, 10))

    def jloss(p):
        xx = jnp.asarray(x)
        if cast_input:
            xx = xx.astype(jnp.bfloat16)
        logits = jmodel.apply(p, xx)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             axis=1))

    (jl, found), jg = jh.value_and_grad(jloss, jh.init_state())(jparams)
    assert not bool(found)

    model = load_jax_params(MLP((784, 256, 10), device="cpu"), mlp_params)
    opt = FusedAdam(model.parameters(), lr=1e-3)
    model, opt, h = amp.initialize(model, opt, opt_level="O1", verbosity=0,
                                   device="cpu")
    assert model.layers[0].weight.dtype == torch.float32
    assert not opt.master_weights

    def loss_fn(xx):
        if cast_input:
            xx = xx.to(h.properties.compute_dtype)
        logits = model(xx)
        return F.cross_entropy(logits.float(), torch.from_numpy(y))

    st = h.init_state()
    loss = h.traced(loss_fn)(to_torch(x))
    h.scale_loss(loss, st).backward()
    assert_within_bf16_ulp(loss, np.asarray(jl))
    for i, layer in enumerate(model.layers):
        jl_ = jg["params"][f"layer_{i}"]
        for ours, theirs in ((layer.weight.grad.t(), jl_["kernel"]),
                             (layer.bias.grad, jl_["bias"])):
            ours = ours / st.loss_scale
            theirs = np.asarray(theirs, np.float32)
            assert_within_bf16_ulp(ours, theirs,
                                   floor=float(np.abs(theirs).max()))
