"""Port parity for the ResNet tier: ``BatchNorm2d_NHWC`` (the residual
``z``, the fused ReLU, local and with ``bn_group`` 2 and 4 over gloo),
the ``GroupBatchNorm2d`` factory, ``Bottleneck`` at strides 1 and 2,
``ResNet`` tiny (forward and one FusedSGD step), ResNet-50 at full width
through ``load_jax_params``, the dtypes amp O2 leaves, and ResNet tiny
trained by ``build_train_step(ddp=)`` at world 4 with its BatchNorm
statistics over every rank, against the JAX single-device step on the
concatenated batch. Parameters are random (numpy, from seeds) in the
JAX modules' tree layout, found by ``jax.eval_shape``.

Tolerances: fp32 throughout; BatchNorm over groups of ranks averages
each rank's (mean, mean of squares) where the JAX reference takes the
two-pass statistics of the concatenated batch, and convolutions sum in
another order than XLA's: 1e-5 on a block, 1e-4 relative on the logits
of ResNet-50's 53 convolutions and on two SGD steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
import apex_tpu.amp as jamp
from apex_tpu.contrib.bottleneck import Bottleneck as JaxBottleneck
from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JaxBN
from apex_tpu.models import ResNet as JaxResNet
from apex_tpu.models import ResNetConfig as JaxResNetConfig
from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu_torch import amp
from apex_tpu_torch.contrib.bottleneck import Bottleneck
from apex_tpu_torch.contrib.cudnn_gbn import GroupBatchNorm2d
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.models import ResNet, ResNetConfig, load_resnet_jax_params
from apex_tpu_torch.models.resnet import load_jax_trees
from apex_tpu_torch.optimizers import FusedSGD

GROUPBN_CASES = {
    "group2": dict(bn_group=2),
    "group4": dict(bn_group=4),
    "group4_plain": dict(bn_group=4, fuse_relu=False, with_z=False),
}


def random_trees(module, x_shape, seed):
    """``(params, batch_stats)`` numpy trees of a flax module, random:
    he-scaled conv kernels, BatchNorm weights near 1, biases, ``fc`` and
    running statistics of unit-ish scale."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros(x_shape), train=False))
    rng = np.random.RandomState(seed)

    def fill(path, sd):
        name, shape = path[-1].key, sd.shape
        if name == "kernel" and len(shape) == 4:
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:3]))
        elif name == "weight":
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "running_var":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = 0.1 * rng.randn(*shape)
        return a.astype(np.float32)

    trees = jax.tree_util.tree_map_with_path(fill, shapes)
    return trees["params"], trees["batch_stats"]


def _jax_apply(module, params, stats, x, train=True):
    out = module.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), train=train, mutable=["batch_stats"])
    return out[0], out[1]["batch_stats"]


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def tiny_trees():
    return random_trees(JaxResNet(JaxResNetConfig.tiny()),
                        (1, td.RESNET_HW, td.RESNET_HW, 3), seed=1)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, tiny_trees):
    tmp = tmp_path_factory.mktemp("world4")
    params_path, stats_path = tmp / "params.npz", tmp / "stats.npz"
    td.save_tree(params_path, tiny_trees[0])
    td.save_tree(stats_path, tiny_trees[1])
    jobs = [(k, "groupbn", kw) for k, kw in GROUPBN_CASES.items()]
    jobs += [("indivisible", "groupbn_indivisible", {}),
             ("resnet", "resnet_ddp", dict(params_path=str(params_path),
                                           stats_path=str(stats_path)))]
    return td.run_worlds({4: jobs}, tmp)[4]


# -- BatchNorm2d_NHWC ------------------------------------------------------

def _jax_groupbn(xs, zs, ws, fuse_relu, with_z):
    """JAX ``BatchNorm2d_NHWC`` over the concatenated batch: y, the
    gradients of ``sum(y * w)`` and the running statistics."""
    x, z, w = (jnp.asarray(np.concatenate(list(a))) for a in (xs, zs, ws))
    c = xs.shape[-1]
    weight, bias = td.bn_affine(c)
    bn = JaxBN(c, fuse_relu=fuse_relu)
    stats = {"running_mean": jnp.zeros(c), "running_var": jnp.ones(c)}

    def loss(params, x, z):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                          z=z if with_z else None, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    params = {"weight": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    (_, (y, new)), (gp, gx, gz) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(params, x, z)
    return {"y": y, "dx": gx, "dz": gz, "dweight": gp["weight"],
            "dbias": gp["bias"], "running_mean": new["running_mean"],
            "running_var": new["running_var"]}


def _check_groupbn(ours, xs, zs, ws, groups, fuse_relu=True, with_z=True):
    n = xs.shape[1]
    for group in groups:
        group = list(group)
        ref = _jax_groupbn(xs[group], zs[group], ws[group], fuse_relu,
                           with_z)
        for i, rank in enumerate(group):
            for key in ("y", "dx") + (("dz",) if with_z else ()):
                _close(ours[rank][key], ref[key][i * n:(i + 1) * n])
            for key in ("running_mean", "running_var"):
                _close(ours[rank][key], ref[key], atol=1e-6)
        for key in ("dweight", "dbias"):
            _close(np.sum([ours[r][key] for r in group], 0), ref[key],
                   atol=1e-4)


@pytest.mark.parametrize("fuse_relu,with_z", [(True, True), (False, False),
                                              (True, False)])
def test_groupbn_local_matches_jax(fuse_relu, with_z):
    xs, zs, ws = td.groupbn_inputs(1)
    bn = BatchNorm2d_NHWC(xs.shape[-1], fuse_relu=fuse_relu, device="cpu")
    weight, bias = td.bn_affine(xs.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    x = torch.from_numpy(xs[0].copy()).requires_grad_()
    z = torch.from_numpy(zs[0].copy()).requires_grad_()
    y = bn(x, z=z if with_z else None)
    (y * torch.from_numpy(ws[0])).sum().backward()
    ours = {"y": y.detach(), "dx": x.grad, "dz": z.grad,
            "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}
    ours = [{k: v.detach().numpy() for k, v in ours.items()
             if v is not None}]
    _check_groupbn(ours, xs, zs, ws, [[0]], fuse_relu, with_z)
    bn.eval()                     # eval: the running statistics
    y = bn(torch.from_numpy(xs[0]))
    mean, var = bn.running_mean.numpy(), bn.running_var.numpy()
    exp = (xs[0] - mean) / np.sqrt(var + 1e-5) * weight + bias
    _close(y.detach(), np.maximum(exp, 0) if fuse_relu else exp)


@pytest.mark.parametrize("case", list(GROUPBN_CASES))
def test_groupbn_shares_statistics_over_groups_of_ranks(world4, case):
    kw = GROUPBN_CASES[case]
    g = kw["bn_group"]
    xs, zs, ws = td.groupbn_inputs(4)
    groups = [range(s, s + g) for s in range(0, 4, g)]
    _check_groupbn(td.value(world4, case), xs, zs, ws, groups,
                   kw.get("fuse_relu", True), kw.get("with_z", True))


def test_groupbn_refuses_a_world_bn_group_does_not_divide(world4):
    for msg in td.value(world4, "indivisible"):
        assert "not divisible by bn_group (3)" in msg


def test_group_batchnorm2d_factory():
    bn = GroupBatchNorm2d(8, 2, eps=1e-3, momentum=0.2, fuse_relu=True,
                          device="cpu")
    assert isinstance(bn, BatchNorm2d_NHWC)
    assert (bn.num_features, bn.bn_group, bn.eps, bn.momentum,
            bn.fuse_relu) == (8, 2, 1e-3, 0.2, True)
    with pytest.raises(RuntimeError, match="initialize torch.distributed"):
        bn(torch.zeros(2, 3, 3, 8))


# -- Bottleneck and ResNet -------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_matches_jax(stride):
    """An (8, 7) image: flax's SAME pads the stride-2 3x3 by (0, 1) on
    the even axis and (1, 1) on the odd one."""
    jb = JaxBottleneck(8, 4, 16, stride=stride)
    x = np.random.RandomState(3).randn(2, 8, 7, 8).astype(np.float32)
    params, stats = random_trees(jb, x.shape, seed=stride)
    ours = Bottleneck(8, 4, 16, stride=stride, device="cpu")
    load_jax_trees(ours, params, stats)
    y = ours(torch.from_numpy(x))
    jy, jstats = _jax_apply(jb, params, stats, x)
    assert y.shape == jy.shape == (2, 8 // stride, (7 + stride - 1) // stride,
                                   16)
    _close(y.detach(), jy)
    _close(ours.bn2.running_var, jstats["bn2"]["running_var"], atol=1e-6)


def _ce(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                         1))


@pytest.fixture(scope="module")
def jax_sgd_steps():
    """``run(params, stats, x, labels, steps) -> (losses, params,
    stats)``: jitted JAX single-device steps of ResNet tiny with
    FusedSGD."""
    model = JaxResNet(JaxResNetConfig.tiny())
    opt = JaxSGD(**td.RESNET_SGD)

    def loss(p, s, x, labels):
        logits, new = _jax_apply(model, p, s, x)
        return _ce(logits, labels), new

    @jax.jit
    def step(p, s, st, x, labels):
        (val, s), g = jax.value_and_grad(loss, has_aux=True)(p, s, x,
                                                             labels)
        p, st = opt.step(g, st, p)
        return val, p, s, st

    def run(params, stats, x, labels, steps):
        st, losses = opt.init(params), []
        for _ in range(steps):
            val, params, stats, st = step(params, stats, st, x, labels)
            losses.append(float(val))
        return losses, params, stats

    return run


def _by_port_name(params, stats):
    model = ResNet(ResNetConfig.tiny(), device="cpu")
    load_jax_trees(model, jax.tree.map(np.asarray, params),
                   jax.tree.map(np.asarray, stats))
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    return {n: t.detach().numpy() for n, t in named.items()}


def test_resnet_tiny_forward_and_one_sgd_step(tiny_trees, jax_sgd_steps):
    params, stats = tiny_trees
    images, labels = td.resnet_inputs(4)
    model = load_resnet_jax_params(params, stats, ResNetConfig.tiny(),
                                   device="cpu")
    logits = model(torch.from_numpy(images))
    jlogits, _ = jax.jit(lambda p, s, x: _jax_apply(
        JaxResNet(JaxResNetConfig.tiny()), p, s, x))(params, stats, images)
    _close(logits.detach(), jlogits)
    opt = FusedSGD(model.parameters(), **td.RESNET_SGD)
    loss = td.resnet_loss_fn(model)({"x": torch.from_numpy(images),
                                     "y": torch.from_numpy(labels)}, None)
    loss.backward()
    opt.step()
    jlosses, jparams, jstats = jax_sgd_steps(params, stats, images, labels,
                                             1)
    assert abs(loss.item() - jlosses[0]) <= 1e-5 * abs(jlosses[0])
    theirs = _by_port_name(jparams, jstats)
    for name, p in model.named_parameters():
        _close(p.detach(), theirs[name], rtol=1e-4, atol=1e-6)


def test_resnet50_load_jax_params_forward():
    """ResNet-50 at full width (stages 3-4-6-3, width 64, 1000 classes),
    every leaf loaded; eval-mode logits at 32x32, batch 2, against the
    JAX module's."""
    cfg = JaxResNetConfig.resnet50()
    x = np.random.RandomState(5).randn(2, 32, 32, 3).astype(np.float32)
    params, stats = random_trees(JaxResNet(cfg), x.shape, seed=2)
    model = load_resnet_jax_params(params, stats, ResNetConfig.resnet50(),
                                   device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    model.eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jax.jit(lambda p, s, x: JaxResNet(cfg).apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats, x))
    assert np.abs(ours - theirs).max() <= 1e-4 * np.abs(theirs).max()


def test_load_jax_params_raises_on_a_missing_or_extra_leaf(tiny_trees):
    params, stats = tiny_trees
    cfg = ResNetConfig.tiny()
    with pytest.raises(KeyError, match="lack"):
        load_resnet_jax_params({k: v for k, v in params.items()
                                if k != "fc"}, stats, cfg, device="cpu")
    with pytest.raises(KeyError, match="no port parameter"):
        load_resnet_jax_params({**params, "extra": {"kernel": np.zeros(
            (2, 2), np.float32)}}, stats, cfg, device="cpu")
    with pytest.raises(KeyError, match="running_var"):
        load_resnet_jax_params(params, {**stats, "bn_stem": {
            "running_mean": stats["bn_stem"]["running_mean"]}}, cfg,
            device="cpu")


def test_o2_dtypes_equal_jax_amp(tiny_trees):
    """amp O2 keeps every BatchNorm parameter (and running statistic)
    fp32 and casts convolutions and ``fc`` to bf16, in both packages."""
    params, stats = tiny_trees
    jp, _, _ = jamp.initialize(jax.tree.map(jnp.asarray, params),
                               JaxSGD(lr=0.1), opt_level="O2", verbosity=0)
    model = load_resnet_jax_params(params, stats, ResNetConfig.tiny(),
                                   device="cpu")
    opt = FusedSGD(model.parameters(), lr=0.1)
    model, opt, _ = amp.initialize(model, opt, opt_level="O2", verbosity=0,
                                   device="cpu")
    ours = {n: p.dtype for n, p in model.named_parameters()}
    theirs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [k.key for k in path]
        name = ".".join(keys[:-1] + ["weight" if keys[-1] == "kernel"
                                     else keys[-1]])
        theirs[name] = str(leaf.dtype)
    assert {n: str(d).replace("torch.", "") for n, d in ours.items()} == \
        theirs
    assert {str(d) for d in ours.values()} == {"torch.float32",
                                               "torch.bfloat16"}
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert ours["bn_stem.weight"] == torch.float32
    assert ours["stage1_block0.downsample_conv.weight"] == torch.bfloat16


# -- configs[3]'s path over gloo -------------------------------------------

def test_resnet_ddp_world4_is_the_big_batch_step(world4, tiny_trees,
                                                 jax_sgd_steps):
    """Four ranks, two images each, ``bn_group`` 4, DDP, two FusedSGD
    steps: every rank ends with the same bits, and the losses, parameters
    and running statistics are the JAX single-device steps' on the eight
    images."""
    ranks = td.value(world4, "resnet")
    for res in ranks[1:]:
        assert res["losses"] == ranks[0]["losses"]
        for part in ("params", "buffers"):
            for name, a in res[part].items():
                np.testing.assert_array_equal(a, ranks[0][part][name])
    images, labels = td.resnet_inputs(4)
    jlosses, jparams, jstats = jax_sgd_steps(*tiny_trees, images, labels,
                                             td.RESNET_STEPS)
    np.testing.assert_allclose(ranks[0]["losses"], jlosses, rtol=1e-5)
    theirs = _by_port_name(jparams, jstats)
    for part in ("params", "buffers"):
        for name, a in ranks[0][part].items():
            _close(a, theirs[name], rtol=1e-4, atol=1e-5)
