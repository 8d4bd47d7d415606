"""Port parity for the fault plans and the artifact checksums: the port's
``utils/faults.py`` and ``utils/integrity.py`` against apex_tpu's on the
same specs, seeds and inputs. Plans fire at the same call indices and
hand out the same corruption seeds, the ``perturb_*`` functions flip the
same bytes, tokens and leaves, the records round trip, ``guarded_call``
retries and gives up alike, and the checksums are the same hex strings.
Also ``nan_corrupt`` on a torch pytree and the fused-qkv layout helpers
of ``utils/checkpoint.py``."""

import json

import numpy as np
import pytest
import torch

from apex_tpu.utils import checkpoint as jck
from apex_tpu.utils import faults as jf
from apex_tpu.utils import integrity as ji
from apex_tpu_torch.utils import checkpoint as pck
from apex_tpu_torch.utils import faults as pf
from apex_tpu_torch.utils import integrity as pi

torch.set_num_threads(1)

# (site, kind, trigger) rules: exact indices, every-N, seeded draws, a
# bound, corrupt specs, two probabilistic rules at one site
SPECS = [
    dict(site="decode", kind="transient", at=(2, 5)),
    dict(site="decode", kind="transient", prob=0.3),
    dict(site="decode", kind="corrupt", every=4),
    dict(site="prefill", kind="transient", every=3, max_fires=2),
    dict(site="prefill", kind="crash", at=(11,)),
    dict(site="train_step", kind="nan", prob=0.25),
    dict(site="train_step", kind="nan", every=5, max_fires=1),
    dict(site="checkpoint", kind="corrupt", prob=0.5),
    dict(site="draft", kind="transient", prob=0.2, max_fires=3),
]
SITES = ("decode", "prefill", "train_step", "checkpoint", "draft")


def _plans(seed, specs=SPECS):
    return (jf.FaultPlan([jf.FaultSpec(**s) for s in specs], seed=seed),
            pf.FaultPlan([pf.FaultSpec(**s) for s in specs], seed=seed))


def _drive(mod, plan, n=60):
    """Fire the sites in a fixed interleaving; log each call's outcome and
    corruption seed."""
    log = []
    for i in range(n):
        site = SITES[(i * 7 + i // 3) % len(SITES)]
        try:
            out = "nan" if plan.fire(site) else "ok"
        except mod.TransientDispatchError:
            out = "transient"
        except mod.SimulatedCrash:
            out = "crash"
        log.append((site, out, plan.corrupt_seed(site)))
    return log


@pytest.mark.parametrize("seed", [0, 11, 12345])
def test_plan_fires_like_jax(seed):
    jp, pp = _plans(seed)
    assert _drive(pf, pp) == _drive(jf, jp)
    assert pp.fired == jp.fired
    assert pp.counts() == jp.counts()
    assert all(pp.calls(s) == jp.calls(s) for s in SITES + ("other",))
    kinds = {k for _, k, _ in pp.fired}
    assert kinds == {"transient", "corrupt", "nan", "crash"}


def test_corruption_seeds_and_perturbations_match_jax():
    for args in ((0, "decode", 3), (7, "checkpoint", 0), (2 ** 31, "x", 9)):
        assert pf.corruption_seed(*args) == jf.corruption_seed(*args)
    rng = np.random.RandomState(0)
    payload = {"k": rng.randn(3, 4).astype(np.float32),
               "v": rng.randint(0, 255, (5,)).astype(np.uint8),
               "meta": "not an array", "empty": np.zeros(0)}
    tree = {"a": [1, 2.5, {"b": 3}], "c": True, "d": "s", "e": [[4.0]]}
    toks = rng.randint(0, 50, (4, 3))
    counts = np.array([3, 0, 2, 1])
    for seed in (1, 99, 2 ** 32 + 5):
        a = pf.perturb_payload(payload, seed)
        b = jf.perturb_payload(payload, seed)
        assert sorted(a) == sorted(b)
        for k in ("k", "v"):
            np.testing.assert_array_equal(a[k], b[k])
        assert any(not np.array_equal(a[k], payload[k]) for k in ("k", "v"))
        assert pf.perturb_json(tree, seed) == jf.perturb_json(tree, seed)
        np.testing.assert_array_equal(
            pf.perturb_tokens(toks, counts, 50, seed),
            jf.perturb_tokens(toks, counts, 50, seed))
    # nothing to perturb: unchanged in both
    assert pf.perturb_json({"s": "x"}, 3) == {"s": "x"}
    np.testing.assert_array_equal(
        pf.perturb_tokens(toks, np.zeros(4, int), 50, 3), toks)


def test_records_round_trip_and_split_like_jax():
    jp, pp = _plans(5)
    rec = pf.plan_record(pp)
    assert rec == jf.plan_record(jp)
    assert json.loads(json.dumps(rec)) == rec
    # a record written by either package rebuilds the same unfired plan
    a, b = pf.plan_from_record(jf.plan_record(jp)), jf.plan_from_record(rec)
    assert _drive(pf, a) == _drive(jf, b)
    here, there = pf.split_plan(pp, "decode")
    jhere, jthere = jf.split_plan(jp, "decode")
    assert pf.plan_record(here) == jf.plan_record(jhere)
    assert pf.plan_record(there) == jf.plan_record(jthere)
    assert pf.split_plan(None, "decode") == (None, None)
    assert pf.split_plan(pf.FaultPlan([], 1), "x") == (None, None)
    with pytest.raises(ValueError, match="kind"):
        pf.plan_from_record({"specs": [dict(site="s", kind="meteor")]})


def test_spec_validation_and_wire_chaos_match_jax():
    for bad, match in ((dict(kind="meteor"), "kind"),
                       (dict(kind="nan", prob=1.5), "prob"),
                       (dict(kind="nan", every=0), "every")):
        for mod in (pf, jf):
            with pytest.raises(ValueError, match=match):
                mod.FaultSpec(site="s", **bad)
    assert pf.FaultSpec(site="s", kind="nan", at=[3]).at == (3,)
    for mod in (pf, jf):
        with pytest.raises(ValueError, match="not valid at site"):
            mod.validate_wire_specs([mod.FaultSpec(site="wire",
                                                   kind="crash")])
    specs = [dict(site="wire", kind="transient", at=(1,)),
             dict(site="wire", kind="corrupt", every=3)]
    jp, pp = _plans(4, specs)
    jhook, phook = jf.wire_chaos(jp), pf.wire_chaos(pp)
    body = json.dumps({"id": 7, "tokens": [1, 2, 3], "x": 0.5}).encode()
    outs = [phook(body) for _ in range(7)]
    assert outs == [jhook(body) for _ in range(7)]
    assert outs[1] == body[: len(body) // 2] and outs[0] == body
    assert outs[2] != body and json.loads(outs[2])["id"] is not None


def test_guarded_call_retries_and_exhaustion_match_jax():
    for mod in (pf, jf):
        plan = mod.FaultPlan([mod.FaultSpec(site="s", kind="transient",
                                            at=(0, 1, 4, 5, 6))])
        seen = []
        out, nan = mod.guarded_call(lambda x: x + 1, 41, plan=plan,
                                    site="s", retries=2,
                                    on_retry=seen.append)
        assert (out, nan, seen) == (42, False, [1, 2])
        assert mod.guarded_call(lambda: 1, plan=plan, site="s")[0] == 1
        with pytest.raises(mod.DispatchFailedError, match="'s' failed 3") \
                as ei:
            mod.guarded_call(lambda: 1, plan=plan, site="s", retries=2)
        assert ei.value.attempts == 3 and ei.value.site == "s"
        assert isinstance(ei.value.last, mod.TransientDispatchError)
        crash = mod.FaultPlan([mod.FaultSpec(site="s", kind="crash",
                                             at=(0,))])
        with pytest.raises(mod.SimulatedCrash):
            mod.guarded_call(lambda: 1, plan=crash, site="s", retries=5)
        nan_plan = mod.FaultPlan([mod.FaultSpec(site="s", kind="nan",
                                                at=(0,))])
        assert mod.guarded_call(lambda: 2.0, plan=nan_plan,
                                site="s") == (2.0, True)
    # a real error is not transient in the port: it propagates at once
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal"):
        pf.guarded_call(boom, retries=3)
    assert calls == [1] and pf.TRANSIENT_ERRORS == (
        pf.TransientDispatchError,)


def test_nan_corrupt_and_wrap_on_torch_trees():
    tree = {"x": torch.ones(3), "h": torch.ones(2, dtype=torch.bfloat16),
            "i": torch.arange(2), "np": np.ones(2, np.float32),
            "ni": np.arange(2), "n": 3, "f": 1.5,
            "l": [torch.zeros(1, dtype=torch.float64)]}
    out = pf.nan_corrupt(tree)
    assert torch.isnan(out["x"]).all() and torch.isnan(out["h"]).all()
    assert out["h"].dtype == torch.bfloat16
    assert torch.isnan(out["l"][0]).all()
    assert np.isnan(out["np"]).all()
    assert torch.equal(out["i"], torch.arange(2))
    np.testing.assert_array_equal(out["ni"], [0, 1])
    assert (out["n"], out["f"]) == (3, 1.5)
    assert not torch.isnan(tree["x"]).any()       # a new tree
    plan = pf.FaultPlan([pf.FaultSpec(site="f", kind="nan", at=(0,))])
    fn = plan.wrap("f", lambda: {"x": torch.ones(3), "i": torch.arange(2)})
    first, second = fn(), fn()
    assert torch.isnan(first["x"]).all()
    assert torch.equal(first["i"], torch.arange(2))
    assert not torch.isnan(second["x"]).any()


def test_checksums_match_jax_and_seals_survive_json():
    rng = np.random.RandomState(3)
    payload = {"k": rng.randn(2, 3).astype(np.float32),
               "v": rng.randint(0, 9, (4,)).astype(np.int8),
               "checksum": "ignored", "n": None}
    h = ji.payload_checksum(payload)
    assert pi.payload_checksum(payload) == h
    # a torch tensor checksums as its numpy array
    tp = dict(payload, k=torch.from_numpy(payload["k"]),
              v=torch.from_numpy(payload["v"]))
    assert pi.payload_checksum(tp) == h
    assert pi.verify_payload(payload, h, "spill_get")
    assert not pi.verify_payload(payload, None, "spill_get")
    with pytest.raises(pi.IntegrityError, match="spill_get"):
        pi.verify_payload(pf.perturb_payload(payload, 5), h, "spill_get")
    record = {"version": 1, "b": [1, 2.25, {"z": None, "a": "s"}],
              1: "int key", "t": (3, 4), "flag": True}
    assert pi.record_checksum(record) == ji.record_checksum(record)
    sealed = pi.seal_record(dict(record))
    assert sealed["checksum"] == ji.seal_record(dict(record))["checksum"]
    wire = json.loads(json.dumps(sealed))
    assert pi.is_sealed(wire) and pi.verify_record(wire, "restore")
    assert ji.verify_record(wire, "restore")      # verifies across packages
    assert not pi.verify_record(record, "restore")   # unsealed: legacy
    bad = pf.perturb_json(wire, 17)
    for mod in (pi, ji):
        with pytest.raises(mod.IntegrityError, match="restore") as ei:
            mod.verify_record(bad, "restore")
        assert ei.value.site == "restore"


def test_qkv_layout_helpers_match_jax():
    rng = np.random.RandomState(1)
    tree = {"h_0": {"attn": {"qkv": {"kernel": rng.randn(4, 12),
                                     "bias": rng.randn(12)},
                             "out": {"kernel": rng.randn(4, 4)}},
                    "ln": {"scale": rng.randn(4)}},
            "attn_qkv": {"kernel": rng.randn(4, 6)}}
    split = pck.split_fused_qkv(tree)
    jsplit = jck.split_fused_qkv(tree)
    assert set(split["h_0"]["attn"]) == {"q", "k", "v", "out"}
    assert set(split) == {"h_0", "attn_q", "attn_k", "attn_v"}
    for a, b in ((split["h_0"]["attn"]["k"]["bias"],
                  jsplit["h_0"]["attn"]["k"]["bias"]),
                 (split["attn_v"]["kernel"], jsplit["attn_v"]["kernel"])):
        np.testing.assert_array_equal(a, b)
    merged = pck.merge_split_qkv(split)
    np.testing.assert_array_equal(merged["h_0"]["attn"]["qkv"]["kernel"],
                                  tree["h_0"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(merged["attn_qkv"]["kernel"],
                                  tree["attn_qkv"]["kernel"])
    clash = dict(split["h_0"]["attn"], qkv={"kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="mixed-layout"):
        pck.merge_split_qkv(clash)
    assert pck.state_mesh_shape(None) is None
