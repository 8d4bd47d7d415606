"""The fleet parity harness of the port's fleet tests: one scenario (a
traffic list, actions at ticks, fault plans, fleet and engine knobs) is
played through the JAX package's ``FleetRouter`` and the port's, on the
same tiny GPT weights (``load_jax_params``), under a constant clock, and
each tick's owners, stream events and ``stats()`` are logged for the
tests to compare. Greedy traffic only across packages: the two sample
from different PRNGs (the port's ``token_generator`` is not threefry)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import apex_tpu.observability as jobs
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.serving import engine as jax_engine
from apex_tpu.serving import fleet as jax_fleet
from apex_tpu.serving import kv_cache as jax_kv
from apex_tpu.utils import faults as jax_faults
import apex_tpu_torch.observability as pobs
from apex_tpu_torch.models import GPTConfig, load_jax_params
from apex_tpu_torch.serving import build_mesh
from apex_tpu_torch.serving import engine as port_engine
from apex_tpu_torch.serving import fleet as port_fleet
from apex_tpu_torch.serving import kv_cache as port_kv
from apex_tpu_torch.utils import faults as port_faults

# per package: (engine module, fleet module, faults module, observability,
# kv_cache module)
PKGS = {
    "jax": (jax_engine, jax_fleet, jax_faults, jobs, jax_kv),
    "port": (port_engine, port_fleet, port_faults, pobs, port_kv),
}
# the JAX fleet tests' geometry: two lanes, blocks of 4, prefix caching
ENGINE_KW = dict(max_batch=2, block_size=4, num_blocks=32,
                 max_prefill_len=8, max_seq_len=32, seed=7,
                 enable_prefix_caching=True)
TIME_FIELDS = ("t", "dur_s", "wait_s", "host_span_s", "ewma", "seq")


def tiny_models():
    """(JAX model, its params, the port's model with the same weights)."""
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return model, params, port


def make_fleet(name, tiny, n=2, fleet_kw=None, faults=None, obs=None,
               clock=None, mesh_shape=(1, 1), **engine_kw):
    """A fleet of package ``name`` over ``tiny``: the JAX one with an fp32
    pool (its default follows the process's last amp policy), the port's
    on the CPU with a CPU mesh of ``mesh_shape``."""
    model, params, port = tiny
    emod, fmod = PKGS[name][0], PKGS[name][1]
    config = emod.EngineConfig(mesh_shape=mesh_shape,
                               **{**ENGINE_KW, **engine_kw})
    fconfig = fmod.FleetConfig(num_replicas=n, **(fleet_kw or {}))
    kw = dict(faults=faults, obs=obs,
              clock=(lambda: 0.0) if clock is None else clock)
    if name == "jax":
        config = dataclasses.replace(config, kv_dtype=jnp.float32)
        return fmod.FleetRouter(model, params, config, fconfig, **kw)
    n_dev = mesh_shape[0] * mesh_shape[1]
    return fmod.FleetRouter(port, config, fconfig, device="cpu",
                            mesh=build_mesh(mesh_shape, ["cpu"] * n_dev),
                            **kw)


def greedy_reqs(name, n=5, prompt_len=6, new=5, seed=3, uid="r",
                tenant=None, step=0):
    """``n`` greedy requests of package ``name`` (prompts of
    ``prompt_len + step * k`` tokens from ``seed``)."""
    emod = PKGS[name][0]
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        kw = {} if tenant is None else {"tenant": tenant}
        out.append(emod.Request(
            f"{uid}{k}", [int(t) for t in rng.randint(
                1, 50, prompt_len + step * k)],
            max_new_tokens=new, **kw))
    return out


def plans(name, specs_by_replica):
    """Per-replica ``FaultPlan`` s of package ``name`` from ``[(specs,
    seed) or None]`` where ``specs`` are ``FaultSpec`` keyword dicts."""
    fmod = PKGS[name][2]
    out = []
    for item in specs_by_replica:
        if item is None:
            out.append(None)
            continue
        specs, seed = item
        out.append(fmod.FaultPlan([fmod.FaultSpec(**s) for s in specs],
                                  seed=seed))
    return out


def results(res):
    return {u: (list(r.tokens), r.status) for u, r in res.items()}


def play(name, tiny, reqs=None, actions=None, add_at=None, max_ticks=400,
         **fleet_args):
    """Build a fleet, add ``reqs`` (a function of the package name; each
    add through ``try_add``, its verdict logged), run ticks calling
    ``actions[tick](fleet, name)`` before each step (``add_at[tick]``
    adds more requests there), and log every tick's owners, stream
    events and full ``stats()``. Returns ``(log, results, fleet)``."""
    fleet = make_fleet(name, tiny, **fleet_args)
    log = []
    pending = dict(add_at or {})
    if reqs is not None:
        log.append(("add", [fleet.try_add(r) for r in reqs(name)]))
    tick = 0
    while fleet.has_work or pending:
        if tick in pending:
            log.append(("add", [fleet.try_add(r)
                                for r in pending.pop(tick)(name)]))
        if actions and tick in actions:
            log.append(("act", actions[tick](fleet, name)))
        fleet.step()
        log.append((tick, fleet.owners(), fleet.pop_stream_events(),
                    fleet.stats()))
        tick += 1
        assert tick < max_ticks, "the fleet did not drain"
    out = results(fleet.run(return_status=True))
    log.append(("final", fleet.stats()))
    return log, out, fleet


def strip_times(events):
    """Recorder events without their time fields (the two packages' clocks
    and sequence numbers are their own)."""
    return [{k: v for k, v in e.items() if k not in TIME_FIELDS}
            for e in events]


def to_numpy(payload):
    """A port payload (CPU tensors; fp32 here) as numpy arrays."""
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in payload.items()}
