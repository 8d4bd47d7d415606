"""The serving mesh: one controller over a grid of shards (counterpart of
:mod:`apex_tpu.serving.mesh`).

The JAX engine is one controller over a GSPMD mesh: it annotates the
weights and the KV pools with ``NamedSharding`` and XLA inserts the
collectives. PyTorch has no partitioner, so the port splits the weights
and the pools itself, sums the row-parallel partial products itself, and
runs each batch shard's lanes against its own block range. The engine
stays one controller, as the JAX one is:

- :func:`build_mesh` makes a logical ``("batch", "model")`` grid of
  ``torch.device`` s: the first ``B * M`` CUDA devices row-major, or an
  explicit ``devices=`` list, which may put several shards on one device
  (every shape then runs on one card, and the CPU tests run them on
  ``cpu``).
- Shard ``(b, m)`` owns its own contiguous allocation of the KV pools
  (:class:`~apex_tpu_torch.serving.kv_cache.ShardedKVCache`: blocks
  ``[b N / B, (b + 1) N / B)``, heads ``[m H / M, (m + 1) H / M)``) and its
  own copies of the GPT weights split as the JAX ``gpt_param_pspec``
  splits them (:func:`shard_params`, :class:`~apex_tpu_torch.models.gpt.
  GPTServeShard`): the qkv and ``mlp_in`` kernels by column with their
  biases and scales, ``attn_out``/``mlp_out`` by row (bias and scale
  replicated, the bias added once after the sum), embeddings and norms
  replicated.
- At model axis ``M > 1`` each model shard runs its heads; the two
  row-parallel partials a block are summed in shard order on the first
  model shard's device (a plain add when the shards share a device; on
  distinct devices the partials are copied there and the sum copied
  back). :class:`CollectiveLog` counts each such sum as one
  ``all-reduce`` of a forward, per program.
- At batch axis ``B > 1`` lane ``i`` belongs to batch shard ``i // (
  max_batch / B)``, the allocator keeps its blocks in that shard's range,
  and each batch shard runs only its own lanes with block tables made
  local by subtracting the shard's base. No sum crosses the batch axis.

The host machinery (admission, DRR, quotas, the ladder, drafters,
snapshot, spill and integrity) does not change with the mesh: block ids
and chain hashes are layout-free, and spill payloads and migration
records carry every head, so a ``(1, 2)`` engine's records import into a
``(1, 1)`` engine and the reverse. ``mesh_shape`` is part of the
snapshot fingerprint: a snapshot restores across equal meshes only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MESH_AXES = ("batch", "model")

# the programs whose forwards the log keeps apart
PROGRAMS = ("prefill", "decode", "verify")


def validate_mesh_shape(mesh_shape, num_heads: Optional[int] = None,
                        knob: str = "mesh_shape",
                        max_batch: Optional[int] = None,
                        num_blocks: Optional[int] = None
                        ) -> Tuple[int, int]:
    """Validate (and normalize to a tuple) a ``(batch, model)`` mesh
    shape: two positive ints; when the caller knows the model, a model
    axis dividing ``num_heads``; when it knows the engine geometry, a
    batch axis dividing ``max_batch`` and ``num_blocks``. The JAX
    package's named-knob errors. The device count is checked where the
    devices are chosen, in :func:`build_mesh`."""
    try:
        shape = tuple(int(v) for v in mesh_shape)
        if any(s != v for s, v in zip(shape, mesh_shape)):
            raise ValueError   # a non-integral axis (1.5)
    except (TypeError, ValueError):
        raise ValueError(
            f"{knob} must be a (batch, model) pair of ints, "
            f"got {mesh_shape!r}")
    if len(shape) != 2:
        raise ValueError(
            f"{knob} must have exactly 2 axes (batch, model), "
            f"got {mesh_shape!r}")
    if any(v < 1 for v in shape):
        raise ValueError(
            f"{knob} axes must be >= 1, got {mesh_shape!r}")
    if num_heads is not None and num_heads % shape[1]:
        raise ValueError(
            f"{knob} model axis ({shape[1]}) must divide the model's "
            f"num_heads ({num_heads}): the KV pools and qkv projections "
            "shard over heads")
    if max_batch is not None and max_batch % shape[0]:
        raise ValueError(
            f"{knob} batch axis ({shape[0]}) must divide max_batch "
            f"({max_batch}): decode lanes split into equal per-shard "
            "groups")
    if num_blocks is not None and num_blocks % shape[0]:
        raise ValueError(
            f"{knob} batch axis ({shape[0]}) must divide num_blocks "
            f"({num_blocks}): the KV pool splits into equal contiguous "
            "shard ranges")
    return shape


def _normalize(device) -> torch.device:
    """A device with its index (``cuda`` means the current card), so two
    spellings of one device compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """A logical ``("batch", "model")`` grid of devices: ``devices[b][m]``
    holds shard ``(b, m)``. Several coordinates may name one device."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = MESH_AXES

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return (len(self.devices), len(self.devices[0]))

    def device(self, b: int, m: int) -> torch.device:
        return self.devices[b][m]


def build_mesh(mesh_shape, devices: Optional[Sequence] = None
               ) -> ServingMesh:
    """The ``(batch, model)`` mesh of a validated shape over ``devices``
    (row-major; several entries may name one device), by default the
    first ``batch * model`` CUDA devices. Equal shapes over equal device
    lists build equal meshes."""
    shape = validate_mesh_shape(mesh_shape)
    n = shape[0] * shape[1]
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > 1 and n > have:
            raise ValueError(
                f"mesh_shape {shape} needs {n} devices but only {have} "
                f"are available (pass devices= to build_mesh to place "
                f"several shards on one device)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_normalize(d) for d in devices]
    if len(devices) != n:
        raise ValueError(
            f"mesh_shape {shape} needs {n} devices, devices= lists "
            f"{len(devices)}")
    grid = tuple(tuple(devices[b * shape[1]:(b + 1) * shape[1]])
                 for b in range(shape[0]))
    return ServingMesh(grid)


def cache_shardings(mesh: ServingMesh, num_blocks: int, num_heads: int
                    ) -> Dict[Tuple[int, int], Dict[str, object]]:
    """The pool layout: for each shard ``(b, m)`` its global block range,
    its head range and its device (the JAX ``KVCache.partition_specs``
    bound to a mesh: the block axis over ``batch``, the head axis over
    ``model``)."""
    B, M = mesh.mesh_shape
    Nl, Hl = num_blocks // B, num_heads // M
    return {(b, m): {"blocks": (b * Nl, (b + 1) * Nl),
                     "heads": (m * Hl, (m + 1) * Hl),
                     "device": mesh.device(b, m)}
            for b in range(B) for m in range(M)}


def shard_cache(mesh: ServingMesh, cache):
    """A :class:`~apex_tpu_torch.serving.kv_cache.KVCache` split into the
    mesh's shards: each shard's blocks and heads copied into a contiguous
    allocation of its own on its device (scales with their payload)."""
    from apex_tpu_torch.serving.kv_cache import KVCache, ShardedKVCache

    layout = cache_shardings(mesh, cache.num_blocks, cache.num_heads)
    B, M = mesh.mesh_shape
    rows = []
    for b in range(B):
        row = []
        for m in range(M):
            lay = layout[(b, m)]
            (b0, b1), (h0, h1) = lay["blocks"], lay["heads"]

            def piece(t):
                if t is None:
                    return None
                return t[:, b0:b1, :, h0:h1].to(
                    device=lay["device"], copy=True,
                    memory_format=torch.contiguous_format)

            row.append(KVCache(k=piece(cache.k), v=piece(cache.v),
                               k_scale=piece(cache.k_scale),
                               v_scale=piece(cache.v_scale)))
        rows.append(row)
    return ShardedKVCache(rows)


def shard_params(mesh: ServingMesh, model) -> List[list]:
    """The GPT LM's weights split over the mesh: ``out[b][m]`` is the
    :class:`~apex_tpu_torch.models.gpt.GPTServeShard` of model shard
    ``m`` on device ``(b, m)`` (the ``gpt_param_split`` rule: column and
    row splits copied into buffers of their own, replicated leaves
    shared where they already lie on the device; at model axis 1 a shard
    on the model's device shares all its weights). Coordinates with the
    same model index on the same device share one shard."""
    from apex_tpu_torch.models.gpt import GPTServeShard

    B, M = mesh.mesh_shape
    made: Dict[Tuple[int, torch.device], object] = {}
    out = []
    for b in range(B):
        row = []
        for m in range(M):
            key = (m, mesh.device(b, m))
            if key not in made:
                made[key] = GPTServeShard(model, m, M, mesh.device(b, m))
            row.append(made[key])
        out.append(row)
    return out


def expected_collectives(mesh_shape, num_layers: Optional[int] = None
                         ) -> dict:
    """The collective contract of one forward of a program, per mesh
    shape (the JAX one, with the port's floor): at model axis 1
    (``(1, 1)`` and every ``(B, 1)``) exactly zero collectives; at model
    axis ``M > 1`` at least ``2 * num_layers`` ``all-reduce`` (the two
    row-parallel sums a block; 1 when the layer count is unknown). The
    batch axis adds nothing at any shape. The JAX contract also forbids
    an ``all-to-all`` (a gather of heads or lanes); the port's shards
    exchange nothing but these sums, so it has no other kind to count."""
    shape = validate_mesh_shape(mesh_shape)
    if shape[1] == 1:
        return {"exact_total_ops": 0}
    return {"min_ops": {"all-reduce": 2 * num_layers if num_layers else 1}}


class CollectiveLog:
    """The sums across model shards, counted as ``all-reduce`` s per
    program: :meth:`begin` opens one forward of a program (of one batch
    group), :meth:`all_reduce` sums partials and counts one op and the
    summed bytes, :meth:`end` closes the forward. ``last[program]`` holds
    the newest forward's ``{"ops", "bytes"}``, ``totals[program]`` and
    ``forwards[program]`` the run's sums."""

    def __init__(self):
        self.last: Dict[str, Dict[str, int]] = {}
        self.totals: Dict[str, Dict[str, int]] = {
            p: {"ops": 0, "bytes": 0} for p in PROGRAMS}
        self.forwards: Dict[str, int] = {p: 0 for p in PROGRAMS}
        self._program: Optional[str] = None
        self._current = {"ops": 0, "bytes": 0}

    def begin(self, program: str) -> None:
        if program not in PROGRAMS:
            raise ValueError(f"unknown program {program!r} (expected one "
                             f"of {PROGRAMS})")
        self._program = program
        self._current = {"ops": 0, "bytes": 0}

    def all_reduce(self, parts):
        """The partials summed in shard order on the first one's device
        (:func:`~apex_tpu_torch.models.gpt.sum_partials`), counted."""
        from apex_tpu_torch.models.gpt import sum_partials

        total = sum_partials(parts)
        self._current["ops"] += 1
        self._current["bytes"] += total.numel() * total.element_size()
        return total

    def end(self) -> None:
        prog = self._program
        self.last[prog] = self._current
        for key, n in self._current.items():
            self.totals[prog][key] += n
        self.forwards[prog] += 1
        self._program = None
