"""Model-parallel rank bookkeeping over ``torch.distributed`` (counterpart
of :mod:`apex_tpu.transformer.parallel_state`).

The JAX module lays a ``("pipeline", "data", "expert", "tensor")`` mesh
out of a flat device list; a torch job runs one process a rank, so here
the same grid holds ranks: rank ``ranks[i]`` sits where position ``i`` of
the JAX device list sits in the JAX mesh (``reshape(pp, dp, ep, tp)``,
tensor innermost). The hybrid multi-slice layout is the JAX one with a
slice read as a node: positions split into ``num_slices`` contiguous
nodes, and tensor and expert parallelism (and the inner data and pipeline
factors) stay inside a node, so only the outer data and pipeline factors
cross nodes.

:func:`layout` is the pure layout: world and sizes in, the rank grid and
every axis's rank lists out, with no process group. A process knows its
rank, so every size and rank getter returns a plain int (the JAX rank
getters return traced ``axis_index`` values). The ``get_*_group()``
getters return this rank's ``torch.distributed`` group, made through
:func:`apex_tpu_torch.utils.collectives.reduction_group` from the rank
lists that the ``get_*_ranks()`` getters return; every group of every
axis is made on every rank, in one order, when the state is initialized
(``new_group`` is collective). Without an initialized process group the
state initializes at world 1 only, where no collective runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from apex_tpu_torch.utils import collectives

TENSOR_AXIS = "tensor"
PIPELINE_AXIS = "pipeline"
DATA_AXIS = "data"
EXPERT_AXIS = "expert"
AXES = (PIPELINE_AXIS, DATA_AXIS, EXPERT_AXIS, TENSOR_AXIS)


class RankMesh(NamedTuple):
    """The rank grid (the JAX ``Mesh``'s counterpart): ``devices`` is the
    ``(pp, dp, ep, tp)`` array of ranks, ``shape`` the axis sizes."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


class Layout(NamedTuple):
    """What :func:`layout` returns: the mesh, the sizes and, per axis
    name (and for the ``("data", "expert")`` pair), the tuple of rank
    tuples that group the ranks along it; under ``AXES`` the one group of
    every rank of the mesh, in grid order."""

    mesh: RankMesh
    tp: int
    pp: int
    dp: int
    ep: int
    dcn_dp: int
    dcn_pp: int
    num_slices: int
    groups: dict


def _axis_groups(grid: np.ndarray, axes: Sequence[int]) -> tuple:
    """Rank tuples along ``axes`` of ``grid``: one per position of the
    other axes, in grid order."""
    rest = [a for a in range(grid.ndim) if a not in axes]
    moved = np.transpose(grid, rest + list(axes))
    n = int(np.prod([grid.shape[a] for a in axes]))
    return tuple(tuple(int(r) for r in row) for row in moved.reshape(-1, n))


def layout(world: int,
           tensor_model_parallel_size_: int = 1,
           pipeline_model_parallel_size_: int = 1,
           expert_model_parallel_size_: int = 1,
           *,
           dcn_data_parallel_size_: int = 1,
           dcn_pipeline_model_parallel_size_: int = 1,
           num_slices: Optional[int] = None,
           ranks: Optional[Sequence[int]] = None) -> Layout:
    """The rank grid of ``world`` ranks (``ranks``, in device-list order;
    ``range(world)`` when not given) with the JAX module's validation
    and its flat or hybrid layout."""
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != world:
        raise ValueError(f"{len(ranks)} ranks given for a world of {world}")
    tp = int(tensor_model_parallel_size_)
    pp = int(pipeline_model_parallel_size_)
    ep = int(expert_model_parallel_size_)
    dcn_dp = int(dcn_data_parallel_size_)
    dcn_pp = int(dcn_pipeline_model_parallel_size_)
    if world % (tp * pp * ep) != 0:
        raise RuntimeError(
            f"world size ({world}) is not divisible by tensor parallel size "
            f"({tp}) times pipeline parallel size ({pp}) times expert "
            f"parallel size ({ep})"
        )
    dp = world // (tp * pp * ep)
    n_slices = (int(num_slices) if num_slices is not None
                else dcn_dp * dcn_pp)
    if dcn_dp * dcn_pp != n_slices:
        raise RuntimeError(
            f"dcn_data_parallel_size_ ({dcn_dp}) * "
            f"dcn_pipeline_model_parallel_size_ ({dcn_pp}) must equal the "
            f"slice count ({n_slices})")
    if dp % dcn_dp or pp % dcn_pp:
        raise RuntimeError(
            f"dp ({dp}) / pp ({pp}) must be divisible by their DCN "
            f"factors ({dcn_dp} / {dcn_pp})")
    if world % n_slices:
        raise RuntimeError(
            f"world size ({world}) is not divisible by the slice count "
            f"({n_slices})")
    if n_slices == 1:
        grid = np.asarray(ranks, dtype=np.int64).reshape(pp, dp, ep, tp)
    else:
        per_slice = world // n_slices
        ici_pp, ici_dp = pp // dcn_pp, dp // dcn_dp
        if ici_pp * ici_dp * ep * tp != per_slice:
            raise RuntimeError(
                f"per-slice device count ({per_slice}) != ici_pp * ici_dp "
                f"* ep * tp ({ici_pp}*{ici_dp}*{ep}*{tp})")
        # a slice is a node: contiguous positions of the rank list
        grid = np.empty((pp, dp, ep, tp), dtype=np.int64)
        for s in range(n_slices):
            sp, sd = divmod(s, dcn_dp)   # slice coords on (dcn_pp, dcn_dp)
            block = np.asarray(ranks[s * per_slice:(s + 1) * per_slice],
                               dtype=np.int64).reshape(ici_pp, ici_dp, ep, tp)
            grid[sp * ici_pp:(sp + 1) * ici_pp,
                 sd * ici_dp:(sd + 1) * ici_dp] = block
    groups = {PIPELINE_AXIS: _axis_groups(grid, [0]),
              DATA_AXIS: _axis_groups(grid, [1]),
              EXPERT_AXIS: _axis_groups(grid, [2]),
              TENSOR_AXIS: _axis_groups(grid, [3]),
              (DATA_AXIS, EXPERT_AXIS): _axis_groups(grid, [1, 2]),
              AXES: _axis_groups(grid, [0, 1, 2, 3])}
    return Layout(RankMesh(grid, AXES), tp, pp, dp, ep, dcn_dp, dcn_pp,
                  n_slices, groups)


_LAYOUT: Optional[Layout] = None
_RANK = 0                    # this process's rank in the world
_COORDS = (0, 0, 0, 0)       # its (pipeline, data, expert, tensor) position
_VIRTUAL_PP_SIZE: Optional[int] = None


def initialize_model_parallel(
    tensor_model_parallel_size_: int = 1,
    pipeline_model_parallel_size_: int = 1,
    virtual_pipeline_model_parallel_size_: Optional[int] = None,
    pipeline_model_parallel_split_rank_: Optional[int] = None,
    expert_model_parallel_size_: int = 1,
    *,
    dcn_data_parallel_size_: int = 1,
    dcn_pipeline_model_parallel_size_: int = 1,
    num_slices: Optional[int] = None,
    ranks: Optional[Sequence[int]] = None,
) -> RankMesh:
    """Lay the world's ranks out (:func:`layout`) and make every axis's
    process groups (reference: ``initialize_model_parallel``). Data
    parallelism is ``world // (tp * pp * ep)``; expert parallelism is
    carved out of it, as in the JAX module. ``ranks`` orders the ranks as
    the JAX device list (every rank of the world by default)."""
    global _LAYOUT, _RANK, _COORDS, _VIRTUAL_PP_SIZE
    import torch.distributed as dist

    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if ranks is not None:
        world = len(ranks)
    lay = layout(world, tensor_model_parallel_size_,
                 pipeline_model_parallel_size_, expert_model_parallel_size_,
                 dcn_data_parallel_size_=dcn_data_parallel_size_,
                 dcn_pipeline_model_parallel_size_=(
                     dcn_pipeline_model_parallel_size_),
                 num_slices=num_slices, ranks=ranks)
    where = np.argwhere(lay.mesh.devices == rank)
    if len(where) != 1:
        raise RuntimeError(f"rank {rank} is not in the model-parallel "
                           f"ranks {lay.mesh.devices.ravel().tolist()}")
    if dist.is_initialized():
        # every axis's groups on every rank, in one order: new_group is a
        # collective call
        for key in (TENSOR_AXIS, DATA_AXIS, PIPELINE_AXIS, EXPERT_AXIS,
                    (DATA_AXIS, EXPERT_AXIS), AXES):
            collectives.reduction_group(lay.groups[key])
    _LAYOUT, _RANK = lay, rank
    _COORDS = tuple(int(c) for c in where[0])
    _VIRTUAL_PP_SIZE = virtual_pipeline_model_parallel_size_
    return lay.mesh


def model_parallel_is_initialized() -> bool:
    return _LAYOUT is not None


def destroy_model_parallel():
    """Forget the layout (the process groups stay cached with the
    default group, as ``new_group``'s do)."""
    global _LAYOUT, _RANK, _COORDS, _VIRTUAL_PP_SIZE
    _LAYOUT, _RANK, _COORDS = None, 0, (0, 0, 0, 0)
    _VIRTUAL_PP_SIZE = None


def _layout() -> Layout:
    if _LAYOUT is None:
        raise RuntimeError("model parallel mesh is not initialized")
    return _LAYOUT


def get_mesh() -> RankMesh:
    return _layout().mesh


# -- rank lists and groups ------------------------------------------------

def _ranks(key) -> tuple:
    return _layout().groups[key]


def get_tensor_model_parallel_ranks() -> tuple:
    return _ranks(TENSOR_AXIS)


def get_pipeline_model_parallel_ranks() -> tuple:
    return _ranks(PIPELINE_AXIS)


def get_data_parallel_ranks() -> tuple:
    """Rank lists of the full data-parallel gradient sync of dense
    params: ``("data", "expert")`` under expert parallelism (the JAX
    getter's axis pair), else ``"data"``. Pass them to
    ``DistributedDataParallel(process_group=...)``."""
    if _layout().ep > 1:
        return _ranks((DATA_AXIS, EXPERT_AXIS))
    return _ranks(DATA_AXIS)


def get_expert_model_parallel_ranks() -> tuple:
    return _ranks(EXPERT_AXIS)


def get_expert_data_parallel_ranks() -> tuple:
    """Rank lists of the gradient sync of expert params: ``"data"``."""
    return _ranks(DATA_AXIS)


def _group(ranks: tuple):
    return collectives.reduction_group(ranks)[0]


def get_tensor_model_parallel_group():
    return _group(get_tensor_model_parallel_ranks())


def get_pipeline_model_parallel_group():
    return _group(get_pipeline_model_parallel_ranks())


def get_data_parallel_group():
    return _group(get_data_parallel_ranks())


def get_expert_model_parallel_group():
    return _group(get_expert_model_parallel_ranks())


def get_expert_data_parallel_group():
    return _group(get_expert_data_parallel_ranks())


# -- sizes ------------------------------------------------------------------

def get_tensor_model_parallel_world_size() -> int:
    return _LAYOUT.tp if _LAYOUT is not None else 1


def get_pipeline_model_parallel_world_size() -> int:
    return _LAYOUT.pp if _LAYOUT is not None else 1


def get_data_parallel_world_size() -> int:
    """The full data-parallel replica group's size: ``dp * ep``."""
    return _LAYOUT.dp * _LAYOUT.ep if _LAYOUT is not None else 1


def get_expert_data_parallel_world_size() -> int:
    return _LAYOUT.dp if _LAYOUT is not None else 1


def get_expert_model_parallel_world_size() -> int:
    return _LAYOUT.ep if _LAYOUT is not None else 1


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PP_SIZE


def get_num_slices() -> int:
    return _LAYOUT.num_slices if _LAYOUT is not None else 1


def get_dcn_data_parallel_world_size() -> int:
    return _LAYOUT.dcn_dp if _LAYOUT is not None else 1


def get_dcn_pipeline_model_parallel_world_size() -> int:
    return _LAYOUT.dcn_pp if _LAYOUT is not None else 1


def get_ici_data_parallel_world_size() -> int:
    """The inner (inside a node) factor of the data-parallel axis."""
    return (get_expert_data_parallel_world_size()
            // get_dcn_data_parallel_world_size())


def get_ici_pipeline_model_parallel_world_size() -> int:
    return (get_pipeline_model_parallel_world_size()
            // get_dcn_pipeline_model_parallel_world_size())


# -- this rank's position (ints: a process knows its rank) ----------------

def get_tensor_model_parallel_rank() -> int:
    _layout()
    return _COORDS[3]


def get_pipeline_model_parallel_rank() -> int:
    _layout()
    return _COORDS[0]


def get_data_parallel_rank() -> int:
    _layout()
    return _COORDS[1]


def get_expert_model_parallel_rank() -> int:
    _layout()
    return _COORDS[2]


def is_pipeline_first_stage(ignore_virtual: bool = True) -> bool:
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = True) -> bool:
    return (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)
