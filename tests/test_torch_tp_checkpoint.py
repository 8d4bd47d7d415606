"""Per-rank train-state checkpoints under a model-parallel layout
(``apex_tpu_torch.utils.checkpoint``): a tiny BERT 3-D step at dropout
0.1 on 2 gloo ranks, at TP 2 (sequence parallelism on) and at PP 2, saved
after 2 steps, loaded into wrecked modules (other weights, a fresh
optimizer and generator) and stepped 2 more: bitwise the uninterrupted
run on every rank. Each rank writes its own payload, the marker carries
the layout's mesh shape (the JAX package's fingerprint, read back by the
JAX package's own ``read_marker`` and ``latest_step``), and a load onto
another layout, onto none, or of a rank-0 save under a layout raises a
``ValueError`` naming both shapes. The data-parallel save (no layout,
rank 0 writes) keeps its one payload.
"""

import os

import numpy as np
import pytest
import torch

import torch_dist as td
import torch_pp_cases as pc
from apex_tpu.utils import checkpoint as jck
from apex_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)

LAYOUTS = ("tp", "pp")
SHAPES = {"tp": [["pipeline", 1], ["data", 1], ["expert", 1], ["tensor", 2]],
          "pp": [["pipeline", 2], ["data", 1], ["expert", 1], ["tensor", 1]]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_checkpoint")
    jobs = [(layout, "torch_pp_cases:train_state_checkpoint",
             dict(ckpt_dir=str(root / layout), layout=layout))
            for layout in LAYOUTS]
    jobs.append(("ddp", "ddp_checkpoint", dict(ckpt_dir=str(root / "ddp"))))
    res = td.run_worlds({2: jobs}, root, timeout_s=240)[2]
    return root, res


@pytest.mark.parametrize("layout", LAYOUTS)
def test_resume_is_bitwise_on_every_rank(world, layout):
    ranks = td.value(world[1], layout)
    for res in ranks:
        assert res["at"] == pc.CK_STEPS
        assert res["steps"] == (2 * pc.CK_STEPS, 2 * pc.CK_STEPS)
        assert res["losses2"] == res["losses"]
        assert set(res["resumed"]) == set(res["params"])
        for name, p in res["params"].items():
            np.testing.assert_array_equal(res["resumed"][name], p)
    # the ranks hold different parameters: the shards (TP) or the stages
    # (PP); a rank-0 load would have copied rank 0's into rank 1
    a, b = (r["params"] for r in ranks)
    differ = [n for n in a if n in b and a[n].shape == b[n].shape
              and not np.array_equal(a[n], b[n])]
    assert differ if layout == "tp" else set(a) != set(b)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_rank_writes_its_payload_under_the_marker(world, layout):
    root, res = world
    ranks = td.value(res, layout)
    for r in ranks:
        assert r["shape"] == SHAPES[layout]
        assert r["listing"] == ["rank_00000.pt", "rank_00001.pt"]
        assert r["marker"]["fingerprint"] == {"mesh_shape": SHAPES[layout]}
    # the JAX package reads the marker and sees the same complete step
    d = str(root / layout)
    assert jck.latest_step(d) == ck.latest_step(d) == pc.CK_STEPS
    assert jck.read_marker(d, pc.CK_STEPS) == ranks[0]["marker"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", ["other layout", "no layout",
                                  "rank-0 save"])
def test_a_mismatched_layout_is_refused(world, layout, case):
    other = "pp" if layout == "tp" else "tp"
    for r in td.value(world[1], layout):
        msg = r["refusals"][case]
        assert msg is not None and "mesh" in msg
        saved, want = {"other layout": (SHAPES[layout], SHAPES[other]),
                       "no layout": (SHAPES[layout], None),
                       "rank-0 save": (None, SHAPES[layout])}[case]
        assert f"mesh of shape {saved}" in msg
        assert f"layout is {want}" in msg


def test_state_mesh_shape_is_none_without_a_layout(world):
    for layout in LAYOUTS:
        for r in td.value(world[1], layout):
            assert r["no_layout_shape"] is None
    assert ck.state_mesh_shape(None) is None


def test_a_data_parallel_save_keeps_one_payload(world):
    root, res = world
    for r in td.value(res, "ddp"):
        assert r["step"] == 2 and r["steps"] == (4, 4)
        assert r["listing"] == [".checkpoint-markers", "step_000000002",
                                "step_000000002.complete"]
        for a, b in zip(r["params"], r["resumed"]):
            np.testing.assert_array_equal(a, b)
    assert os.listdir(ck.checkpoint_path(str(root / "ddp"), 2)) == [
        "state.pt"]
    assert ck.read_marker(str(root / "ddp"), 2).get("fingerprint") is None
