"""The port's training robustness layer: crash-safe checkpoints (a torn
save is skipped, a directory from before markers stays loadable); the
port's ``TrainLoop`` against apex_tpu's on the 8-16-4 MLP of
``tests/test_faults.py`` with FusedAdam and the same weights, under
transient retries, exhaustion with the ``finally`` drain, and the
watchdog's skip/rescale/halt ladder (losses within 1e-6 relative, equal
``stats()`` and loss-scale sequences); a crash and a resume through
``load_train_state`` of GPT tiny at dropout 0.1 under amp O2, bitwise
equal to the uninterrupted run; and a checkpoint saved and loaded by a
world of 2 gloo ranks."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn

from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.train import NonFiniteLossError as JaxNonFinite
from apex_tpu.train import WatchdogConfig as JaxWatchdog
from apex_tpu.train import build_train_step as jax_build_train_step
from apex_tpu.utils import faults as jf
from apex_tpu_torch import amp
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
from apex_tpu_torch.observability import Observability
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.train import (
    NonFiniteLossError,
    TrainLoop,
    WatchdogConfig,
    build_train_step,
    lm_loss_fn,
    make_lm_batch,
)
from apex_tpu_torch.utils import checkpoint as ck
from apex_tpu_torch.utils import faults as pf

import torch_dist

torch.set_num_threads(1)


# -- crash-safe checkpoints ------------------------------------------------

def test_torn_checkpoint_save_is_skipped_on_resume(tmp_path, monkeypatch):
    d = str(tmp_path)
    ck.save_checkpoint(d, 1, params={"w": torch.ones(3)})
    ck.save_checkpoint(d, 2, params={"w": torch.full((3,), 2.0)})
    assert ck.latest_step(d) == 2

    def crash(*a, **k):
        raise pf.SimulatedCrash("killed between payload and marker")

    monkeypatch.setattr(ck, "_write_marker", crash)
    with pytest.raises(pf.SimulatedCrash):
        ck.save_checkpoint(d, 3, params={"w": torch.full((3,), 3.0)})
    monkeypatch.undo()
    assert (tmp_path / "step_000000003").exists()     # torn, invisible
    assert ck.latest_step(d) == 2
    restored = ck.load_checkpoint(d)
    assert restored["_step"] == 2
    assert torch.equal(restored["params"]["w"], torch.full((3,), 2.0))
    with pytest.raises(FileNotFoundError, match="torn"):
        ck.load_checkpoint(d, step=3)
    ck.save_checkpoint(d, 3, params={"w": torch.full((3,), 9.0)})
    assert ck.latest_step(d) == 3
    assert ck.read_marker(d, 3) == {"step": 3, "trees": ["_step", "params"]}
    # an overwrite drops the marker first: a crash midway reads as torn
    monkeypatch.setattr(ck, "_write_marker", crash)
    with pytest.raises(pf.SimulatedCrash):
        ck.save_checkpoint(d, 3, params={"w": torch.zeros(3)})
    monkeypatch.undo()
    assert ck.latest_step(d) == 2
    assert ck.read_marker(d, 3) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ck.load_checkpoint(str(tmp_path / "empty"))


def test_markerless_checkpoints_stay_loadable(tmp_path):
    d = str(tmp_path)
    # numpy leaves: loaded in full (weights_only refuses them)
    ck.save_checkpoint(d, 4, params={"w": np.ones(2)},
                       fingerprint={"mesh_shape": None, "tag": "x"})
    ck.save_checkpoint(d, 5, params={"w": np.full(2, 5.0)})
    assert ck.read_marker(d, 4)["fingerprint"]["tag"] == "x"
    for f in tmp_path.glob("*.complete"):
        f.unlink()
    (tmp_path / ck._ERA_SENTINEL).unlink()
    assert ck.latest_step(d) == 5
    np.testing.assert_array_equal(ck.load_checkpoint(d)["params"]["w"],
                                  np.full(2, 5.0))
    assert ck.load_checkpoint(d, step=4)["_step"] == 4
    # the first new save makes the directory marker-governed
    ck.save_checkpoint(d, 6, params={"w": np.zeros(2)})
    assert ck.latest_step(d) == 6
    with pytest.raises(FileNotFoundError, match="torn"):
        ck.load_checkpoint(d, step=5)


# -- TrainLoop against apex_tpu's on the MLP ---------------------------------

class _JaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.Dense(16, param_dtype=jnp.float32)(x)
        return fnn.Dense(4, param_dtype=jnp.float32)(fnn.relu(x))


@pytest.fixture(scope="module")
def mlp():
    params = jax.device_get(_JaxNet().init(jax.random.PRNGKey(0),
                                           jnp.zeros((2, 8)))["params"])
    rng = np.random.RandomState(0)
    batches = [(rng.randn(1, 4, 8).astype("f4"), rng.randint(0, 4, (1, 4)))
               for _ in range(8)]
    return jax.tree.map(np.asarray, params), batches


def _jax_loop(mlp, scaler=False, **kwargs):
    params, _ = mlp
    model = _JaxNet()

    def loss_fn(p, mb):
        x, y = mb
        logits = model.apply({"params": p}, x).astype(jnp.float32)
        onehot = jax.nn.one_hot(y, 4)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1))

    step = jax_build_train_step(loss_fn, JaxFusedAdam(lr=1e-2),
                                amp=JaxLossScaler() if scaler else None,
                                accum_steps=1)
    return step.loop(step.init(jax.tree.map(jnp.asarray, params)),
                     **kwargs)


def _port_loop(mlp, scaler=False, **kwargs):
    params, _ = mlp
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    with torch.no_grad():
        for lin, name in ((net[0], "Dense_0"), (net[2], "Dense_1")):
            p = params[name]
            lin.weight.copy_(torch.from_numpy(np.array(p["kernel"].T)))
            lin.bias.copy_(torch.from_numpy(np.array(p["bias"])))

    def loss_fn(mb, generator):
        logits = net(mb["x"]).float()
        onehot = torch.nn.functional.one_hot(mb["y"], 4)
        return -torch.mean(torch.sum(
            onehot * torch.log_softmax(logits, -1), -1))

    ts = build_train_step(loss_fn, FusedAdam(net.parameters(), lr=1e-2),
                          amp=LossScaler() if scaler else None)
    return ts.loop(ts.init(), **kwargs)


def _batches(mlp, name, n=None):
    out = []
    for x, y in mlp[1][:n]:
        if name == "jax":
            out.append((jnp.asarray(x), jnp.asarray(y)))
        else:
            out.append({"x": torch.from_numpy(x),
                        "y": torch.from_numpy(y).long()})
    return out


def _same_metrics(port, ref):
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        a, b = float(p["loss"]), float(j["loss"])
        assert (math.isnan(a) and math.isnan(b)) or \
            abs(a - b) <= 1e-6 * abs(b), (a, b)
        for k in ("loss_scale", "step", "steps_skipped", "skipped"):
            assert p[k] == j[k], k


SCENARIOS = {
    # (specs, loop kwargs, batches, dynamic scaler, the error it ends in)
    "retry": ([dict(site="train_step", kind="transient", at=(1, 5))], {},
              None, False, None),
    "exhaustion": ([dict(site="train_step", kind="transient",
                         at=tuple(range(2, 40)))], dict(max_retries=1),
                   None, False, "DispatchFailedError"),
    "ladder": ([dict(site="train_step", kind="nan", every=1)],
               dict(watchdog=(1, 2, 1.0)), None, True, "NonFinite"),
    "halt_last": ([dict(site="train_step", kind="nan", every=1)],
                  dict(watchdog=(3, 3, 1.0)), 7, False, "NonFinite"),
    "recovery": ([dict(site="train_step", kind="nan", at=(1, 2))],
                 dict(watchdog=(2, 1, 1.0)), None, False, None),
    "backoff": ([dict(site="train_step", kind="transient", at=(3,))],
                dict(retry_backoff_s=1e-4, max_retries=3), None, True,
                None),
}


def _play(name, mlp, scenario):
    specs, kw, n, scaler, err = SCENARIOS[scenario]
    fmod = jf if name == "jax" else pf
    kw = dict(kw)
    if "watchdog" in kw:
        s, r, m = kw["watchdog"]
        wd = JaxWatchdog if name == "jax" else WatchdogConfig
        kw["watchdog"] = wd(skip_steps=s, rescale_steps=r, min_scale=m)
    plan = fmod.FaultPlan([fmod.FaultSpec(**s) for s in specs])
    make = _jax_loop if name == "jax" else _port_loop
    loop = make(mlp, scaler=scaler, faults=plan, **kw)
    raised = None
    try:
        loop.run(_batches(mlp, name, n))
    except (jf.DispatchFailedError, pf.DispatchFailedError):
        raised = "DispatchFailedError"
    except (JaxNonFinite, NonFiniteLossError):
        raised = "NonFinite"
    return dict(metrics=loop.last_run_metrics, stats=loop.stats(),
                raised=raised, fired=list(plan.fired),
                scale=float(np.asarray(loop.state.scaler_state.loss_scale)))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_train_loop_matches_jax(mlp, scenario):
    j, p = _play("jax", mlp, scenario), _play("port", mlp, scenario)
    assert p["raised"] == j["raised"] == SCENARIOS[scenario][4]
    _same_metrics(p["metrics"], j["metrics"])
    assert p["stats"] == j["stats"]
    assert p["fired"] == j["fired"] and p["scale"] == j["scale"]
    s = p["stats"]
    if scenario == "retry":
        assert s["dispatch_retries"] == 2
        clean = _port_loop(mlp)
        clean.run(_batches(mlp, "port"))
        _same_metrics(p["metrics"], clean.last_run_metrics)
    if scenario == "exhaustion":
        assert [m["step"] for m in p["metrics"]] == [1, 2]
    if scenario == "ladder":
        assert (s["watchdog_skips"], s["watchdog_rescales"],
                s["watchdog_halts"]) == (1, 2, 1)
        scales = [m["loss_scale"] for m in p["metrics"]]
        assert p["scale"] == scales[0] / 4 == 2.0 ** 14
    if scenario == "halt_last":
        assert s["watchdog_halts"] == 1 and len(p["metrics"]) == 6
    if scenario == "recovery":
        assert (s["watchdog_skips"], s["watchdog_rescales"]) == (2, 0)


def test_loop_knobs(mlp, tmp_path):
    loop = _port_loop(mlp)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        loop.save_checkpoint()
    with pytest.raises(ValueError, match="rung widths"):
        WatchdogConfig(skip_steps=-1)
    # an observed loop: its checkpoints are counted and recorded
    obs = Observability()
    loop = _port_loop(mlp, checkpoint_dir=str(tmp_path), checkpoint_every=3,
                      obs=obs)
    loop.run(_batches(mlp, "port"))
    s = loop.stats()
    assert (s["checkpoints_saved"], s["last_checkpoint_step"]) == (2, 6)
    assert ck.latest_step(str(tmp_path)) == 6
    m = loop.stats(deep=True)["observability"]["metrics"]
    assert m["train_checkpoints_total"] == 2
    assert m["train_steps_total"] == s["steps_dispatched"]
    assert [e["step"] for e in obs.recorder.tail()
            if e["kind"] == "checkpoint"] == [3, 6]


# -- crash and resume of GPT tiny, dropout 0.1, amp O2 ------------------------

GPT_CFG = dict(dropout=0.1, dtype=torch.bfloat16)


def _gpt(seed=0):
    cfg = GPTConfig.tiny(**GPT_CFG)
    model = GPTLMHeadModel(cfg, device="cpu", seed=seed, trainable=True)
    opt = FusedAdam(model.parameters(), lr=1e-3, weight_decay=0.1,
                    adam_w_mode=True)
    model, opt, handle = amp.initialize(model, opt, opt_level="O2",
                                        verbosity=0, device="cpu")
    ts = build_train_step(lm_loss_fn(model), opt, amp=handle, seed=5)
    return model, opt, ts


def _gpt_batches(n=6):
    cfg = GPTConfig.tiny(**GPT_CFG)
    return [make_lm_batch(cfg, 2, 16, seed=100 + i, device="cpu",
                          accum_steps=1) for i in range(n)]


def _state_tensors(model, opt, ts):
    out = {f"param.{n}": p.detach().clone()
           for n, p in model.named_parameters()}
    for i, p in enumerate(model.parameters()):
        for k, v in sorted(opt.state[p].items()):
            if isinstance(v, torch.Tensor):
                out[f"state.{i}.{k}"] = v.clone()
    out["generator"] = ts.generator.get_state()
    return out


def test_crash_and_resume_is_bitwise(tmp_path):
    batches = _gpt_batches()
    model, opt, ts = _gpt()
    loop = ts.loop(ts.init())
    ref = loop.run(batches)
    ref_state = _state_tensors(model, opt, ts)
    ref_sst = loop.state.scaler_state

    plan = pf.FaultPlan([pf.FaultSpec(site="train_step", kind="transient",
                                      at=(1,)),
                         pf.FaultSpec(site="train_step", kind="crash",
                                      at=(5,))])
    model, opt, ts = _gpt()
    loop = ts.loop(ts.init(), faults=plan, checkpoint_dir=str(tmp_path),
                   checkpoint_every=2)
    with pytest.raises(pf.SimulatedCrash):
        loop.run(batches)
    s = loop.stats()
    assert s["dispatch_retries"] == 1 and s["last_checkpoint_step"] == 4
    # the process is gone: a new model (other weights), optimizer and step
    model, opt, ts = _gpt(seed=9)
    state, k = ck.load_train_state(str(tmp_path), ts)
    assert k == 4 and state.step == 4
    resumed = TrainLoop(ts, state)
    tail = resumed.run(batches[k:])
    assert [m["loss"] for m in tail] == [m["loss"] for m in ref[k:]]
    got = _state_tensors(model, opt, ts)
    assert got.keys() == ref_state.keys()
    assert any(".master" in n for n in got)       # O2's fp32 masters
    for n, t in ref_state.items():
        assert got[n].dtype == t.dtype, n
        assert torch.equal(got[n], t), n
    assert resumed.state.scaler_state == ref_sst
    assert resumed.state.step == len(batches)


def test_checkpoint_in_a_gloo_world_of_two(tmp_path):
    ckpt = tmp_path / "ckpt"
    res = torch_dist.run_worlds(
        {2: [("ck", "ddp_checkpoint", dict(ckpt_dir=str(ckpt)))]},
        tmp_path)
    ranks = torch_dist.value(res[2], "ck")
    for r in ranks:
        assert r["step"] == 2 and r["steps"] == (4, 4)
        assert r["listing"] == [".checkpoint-markers", "step_000000002",
                                "step_000000002.complete"]
        for a, b in zip(r["params"], r["resumed"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        np.testing.assert_array_equal(a, b)
