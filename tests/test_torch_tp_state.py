"""Port parity for ``apex_tpu_torch.transformer.parallel_state``: the
pure layout (rank grid and every axis's rank lists) against the JAX
mesh's device positions, flat, with expert parallelism and in the hybrid
multi-slice layouts, with a permuted device list; the validation errors
against the JAX module's; and, in one spawned gloo world of 4, the
getters (plain ints), the groups (a sum over each), the flag
max-reduce, and a train step that spans one rank of the world."""

import jax
import numpy as np
import pytest
import torch

import torch_dist as td
from apex_tpu.transformer import parallel_state as jps
from apex_tpu_torch.transformer import parallel_state as ps

torch.set_num_threads(1)

# (world, tp, pp, ep, kw)
LAYOUTS = {
    "tp4_dp2": (8, 4, 1, 1, {}),
    "tp2_pp2_dp2": (8, 2, 2, 1, {}),
    "tp2_ep2_dp2": (8, 2, 1, 2, {}),
    "tp8": (8, 8, 1, 1, {}),
    "tp2_dcn_dp2": (8, 2, 1, 1, dict(dcn_data_parallel_size_=2,
                                     num_slices=2)),
    "tp2_pp2_dcn_pp2": (8, 2, 2, 1, dict(
        dcn_pipeline_model_parallel_size_=2, num_slices=2)),
    "tp2_pp2_dp2_dcn_both": (8, 2, 2, 1, dict(
        dcn_data_parallel_size_=2, dcn_pipeline_model_parallel_size_=2,
        num_slices=4)),
    "tp2_world4": (4, 2, 1, 1, {}),
}
ORDERS = ("identity", "permuted")


def _order(world, kind):
    if kind == "identity":
        return list(range(world))
    return list(np.random.RandomState(world).permutation(world))


def _jax_positions(world, tp, pp, ep, kw, order):
    """The JAX mesh over the devices listed in ``order``, as the array of
    each device's position in that list."""
    devices = [jax.devices()[i] for i in order]
    mesh = jps.initialize_model_parallel(tp, pp, None, None, ep,
                                         devices=devices, **kw)
    try:
        pos = {d.id: i for i, d in enumerate(devices)}
        return np.vectorize(lambda d: pos[d.id])(mesh.devices), (
            jps.get_data_parallel_world_size(),
            jps.get_expert_data_parallel_world_size(),
            jps.get_num_slices(),
            jps.get_ici_data_parallel_world_size(),
            jps.get_ici_pipeline_model_parallel_world_size())
    finally:
        jps.destroy_model_parallel()


def _groups_of(grid, axes):
    """Rank tuples along ``axes`` of the JAX mesh's axis order, every
    other coordinate fixed (an independent walk of the grid)."""
    out = set()
    shape = grid.shape
    others = [a for a in range(4) if a not in axes]
    for idx in np.ndindex(*[shape[a] for a in others]):
        sel = [slice(None)] * 4
        for a, i in zip(others, idx):
            sel[a] = i
        out.add(tuple(int(r) for r in grid[tuple(sel)].reshape(-1)))
    return out


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_is_the_jax_mesh(name, order):
    world, tp, pp, ep, kw = LAYOUTS[name]
    ranks = _order(world, order)
    positions, sizes = _jax_positions(world, tp, pp, ep, kw, ranks)
    lay = ps.layout(world, tp, pp, ep, ranks=ranks, **kw)
    expected = np.asarray(ranks)[positions]
    np.testing.assert_array_equal(lay.mesh.devices, expected)
    assert lay.mesh.shape == dict(zip(("pipeline", "data", "expert",
                                       "tensor"), expected.shape))
    assert (lay.dp * lay.ep, lay.dp, lay.num_slices, lay.dp // lay.dcn_dp,
            lay.pp // lay.dcn_pp) == sizes
    for axis, axes in (("pipeline", [0]), ("data", [1]), ("expert", [2]),
                       ("tensor", [3]), (("data", "expert"), [1, 2])):
        assert set(lay.groups[axis]) == _groups_of(expected, axes), axis
        # every rank in exactly one group of each axis
        flat = sorted(r for g in lay.groups[axis] for r in g)
        assert flat == sorted(ranks)


BAD = {
    "tp_does_not_divide": (8, 3, 1, 1, {}),
    "ep_does_not_divide": (8, 2, 1, 3, {}),
    "dcn_product": (8, 2, 1, 1, dict(dcn_data_parallel_size_=2,
                                     num_slices=4)),
    "dp_not_divisible_by_dcn": (8, 2, 1, 1, dict(dcn_data_parallel_size_=3,
                                                 num_slices=3)),
    "pp_not_divisible_by_dcn": (8, 2, 2, 1, dict(
        dcn_pipeline_model_parallel_size_=4)),
}


@pytest.mark.parametrize("name", list(BAD))
def test_validation_errors_match_jax(name):
    world, tp, pp, ep, kw = BAD[name]
    with pytest.raises(RuntimeError) as theirs:
        jps.initialize_model_parallel(tp, pp, None, None, ep,
                                      devices=jax.devices()[:world], **kw)
    jps.destroy_model_parallel()
    with pytest.raises(RuntimeError) as ours:
        ps.layout(world, tp, pp, ep, **kw)
    assert str(ours.value) == str(theirs.value)


def test_uninitialized_state():
    ps.destroy_model_parallel()
    assert not ps.model_parallel_is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        ps.get_mesh()
    with pytest.raises(RuntimeError, match="not initialized"):
        ps.get_tensor_model_parallel_rank()
    assert ps.get_tensor_model_parallel_world_size() == 1
    # one process without a process group: world 1 only
    mesh = ps.initialize_model_parallel(1)
    try:
        assert mesh.shape == {"pipeline": 1, "data": 1, "expert": 1,
                              "tensor": 1}
        assert ps.get_tensor_model_parallel_rank() == 0
        assert ps.is_pipeline_first_stage() and ps.is_pipeline_last_stage()
    finally:
        ps.destroy_model_parallel()
    with pytest.raises(RuntimeError, match="not divisible"):
        ps.initialize_model_parallel(2)


WORLD_LAYOUTS = [dict(tensor_model_parallel_size_=2),
                 dict(tensor_model_parallel_size_=4),
                 dict(tensor_model_parallel_size_=2,
                      pipeline_model_parallel_size_=2),
                 dict(tensor_model_parallel_size_=1,
                      expert_model_parallel_size_=2)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return td.run_worlds(
        {4: [("getters", "torch_tp_cases:state_getters",
              dict(layouts=WORLD_LAYOUTS)),
             ("solo", "torch_tp_cases:solo_step", {}),
             ("subset", "torch_tp_cases:subset_step", {})]},
        tmp_path_factory.mktemp("tp_state"))[4]


@pytest.fixture(scope="module")
def world(results):
    return td.value(results, "getters")


def test_a_one_rank_step_in_a_world_reduces_nothing(results):
    """The train step's flag spans the ranks of its model-parallel layout
    or its DDP group: rank 0's step without either, inside a world of 4,
    finishes alone."""
    solo = td.value(results, "solo")
    assert solo[0] == {"step": 1, "skipped": False}
    assert solo[1:] == [None, None, None]


def test_a_layout_of_some_ranks_reduces_the_flag_over_them(results):
    """A layout of ranks 1 and 2 of a world of 4: rank 2's overflow skips
    the step on both, without ranks 0 and 3, and the next step runs."""
    sub = td.value(results, "subset")
    assert sub[0] is None and sub[3] is None
    for rec in sub[1:3]:
        assert rec == {"skipped": [True, False], "moved": True}


@pytest.mark.parametrize("which", range(len(WORLD_LAYOUTS)))
def test_getters_and_groups_in_a_world(world, which):
    kw = WORLD_LAYOUTS[which]
    tp = kw.get("tensor_model_parallel_size_", 1)
    pp = kw.get("pipeline_model_parallel_size_", 1)
    ep = kw.get("expert_model_parallel_size_", 1)
    lay = ps.layout(4, tp, pp, ep)
    grid = lay.mesh.devices
    for rank, recs in enumerate(world):
        rec = recs[which]
        assert rec["mesh"] == grid.tolist()
        p, d, e, t = (int(c[0]) for c in np.nonzero(grid == rank))
        assert rec["ranks"] == [t, p, d, e]
        assert rec["sizes"] == [tp, pp, lay.dp * ep, ep, lay.dp]
        assert rec["types"] == ["int", "int"]
        assert rec["first"] == (p == 0) and rec["last"] == (p == pp - 1)
        for axis, (total, groups) in rec["sums"].items():
            key = (("data", "expert") if axis == "data" and ep > 1
                   else axis)
            assert [tuple(g) for g in groups] == list(lay.groups[key])
            mine = next(g for g in groups if rank in g)
            assert total == sum(r + 1 for r in mine), axis
        assert rec["flag"] is True       # rank 3's flag reaches every rank
