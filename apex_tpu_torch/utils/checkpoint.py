"""Crash-safe checkpoints of training state (counterpart of
:mod:`apex_tpu.utils.checkpoint`, on ``torch.save`` payloads).

Layout under ``directory``:

- ``step_NNNNNNNNN/`` holds one ``torch.save`` file, the named trees
  plus ``"_step"``;
- ``step_NNNNNNNNN.complete`` is the step's commit marker, a small JSON
  manifest (step, tree names, an optional fingerprint) written through a
  temp file and ``os.replace``: its existence defines "this save
  finished";
- ``.checkpoint-markers`` marks the directory as marker-governed; it is
  written before the first payload, so even a torn first save reads as
  torn.

:func:`latest_step` and :func:`load_checkpoint` see only steps whose
marker exists, and naming a torn step raises ``FileNotFoundError``. An
overwrite removes the marker first. A directory with no marker and no
sentinel (written before markers existed) keeps every step loadable.

:func:`save_train_state` / :func:`load_train_state` checkpoint a
:class:`~apex_tpu_torch.train.TrainStep`'s whole state: the
:class:`~apex_tpu_torch.train.TrainState`, every parameter of its
optimizer, ``optimizer.state_dict()`` (moments, fp32 masters, step
counts) and the state of the step's dropout generator, so a resumed run
is bit-identical to the uninterrupted one. Under an initialized process
group without a model-parallel layout (data parallelism alone: the ranks
hold equal states) rank 0 writes, every rank waits at a barrier, and every
rank loads. Under a model-parallel layout
(:mod:`apex_tpu_torch.transformer.parallel_state` with an axis above 1)
every rank holds its own shards, so every rank writes its own payload,
``step_NNNNNNNNN/rank_NNNNN.pt`` (its position in the layout's grid), and
loads its own; the layout's first rank writes the marker after a barrier
that follows every rank's write, and the marker's fingerprint records the
layout's shape (:func:`state_mesh_shape`). A load refuses a checkpoint of
another layout, a per-rank checkpoint without a layout and a rank-0
checkpoint under one: a rank's payload holds its shards, not the global
arrays the JAX package saves, so it cannot be resharded or loaded whole.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

_PAYLOAD = "state.pt"
_ERA_SENTINEL = ".checkpoint-markers"


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(os.fspath(directory)),
                        f"step_{step:09d}")


def _marker_path(directory: str, step: int) -> str:
    """The step's commit marker, a sibling of its directory."""
    return checkpoint_path(directory, step) + ".complete"


def _write_marker(directory: str, step: int, names,
                  fingerprint: Optional[dict] = None) -> None:
    """The terminal write of a save: the JSON manifest to a temp file,
    renamed into place, so the marker itself is never seen torn."""
    marker = _marker_path(directory, step)
    tmp = marker + ".tmp"
    manifest = {"step": int(step), "trees": sorted(names)}
    if fingerprint:
        manifest["fingerprint"] = fingerprint
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, marker)


def read_marker(directory: str, step: int) -> Optional[dict]:
    """The step's marker manifest, or None (a torn save, or a directory
    from before markers)."""
    marker = _marker_path(directory, step)
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return json.load(f)


def state_mesh_shape(state=None) -> Optional[list]:
    """The mesh fingerprint of the process's training state:
    ``[[axis, size], ...]`` of the initialized model-parallel layout in
    ``parallel_state.AXES`` order, or None without one (none initialized,
    or every axis of size 1). JSON-shaped, so it round-trips through the
    marker unchanged. A port state holds no mesh of its own (its shards
    live in the model's layers), so ``state`` is not read: the layout is
    the process's."""
    from apex_tpu_torch.transformer import parallel_state

    if not parallel_state.model_parallel_is_initialized():
        return None
    shape = parallel_state.get_mesh().shape
    if all(n == 1 for n in shape.values()):
        return None
    return [[axis, int(shape[axis])] for axis in parallel_state.AXES]


def save_checkpoint(directory: str, step: int,
                    fingerprint: Optional[dict] = None, **trees) -> str:
    """Save the named trees (None values dropped) as one checkpoint under
    ``directory/step_NNNNNNNNN``, overwriting that step; returns its
    path. ``fingerprint`` (a small JSON-able dict) rides in the marker."""
    path = checkpoint_path(directory, step)
    _begin_save(directory, step)
    payload = {k: v for k, v in trees.items() if v is not None}
    payload["_step"] = step
    _write_payload(path, _PAYLOAD, payload)
    _write_marker(directory, step, payload.keys(), fingerprint=fingerprint)
    return path


def _begin_save(directory: str, step: int) -> None:
    """What a save does before its payload: the directory and its
    sentinel, and the step's old marker removed (an overwrite torn
    halfway reads as torn)."""
    root = os.path.abspath(os.fspath(directory))
    os.makedirs(root, exist_ok=True)
    era = os.path.join(root, _ERA_SENTINEL)
    if not os.path.exists(era):
        with open(era, "w") as f:
            f.write("markers govern this directory\n")
    marker = _marker_path(directory, step)
    if os.path.exists(marker):
        os.remove(marker)
    os.makedirs(checkpoint_path(directory, step), exist_ok=True)


def _write_payload(path: str, name: str, payload) -> None:
    """``payload`` to ``path/name`` through a temp file and
    ``os.replace``."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, name + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, name))


def _rank_payload(position: int) -> str:
    return f"rank_{position:05d}.pt"


def _directory_is_marker_governed(directory: str) -> bool:
    if os.path.exists(os.path.join(directory, _ERA_SENTINEL)):
        return True
    return any(name.endswith(".complete")
               for name in os.listdir(directory))


def latest_step(directory: str) -> Optional[int]:
    """The highest complete step in ``directory``, or None; in a
    directory from before markers every step counts as complete."""
    if not os.path.isdir(directory):
        return None
    strict = _directory_is_marker_governed(directory)
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith((".complete",
                                                           ".tmp")):
            try:
                step = int(name[len("step_"):])
            except ValueError:
                continue
            if not strict or os.path.exists(_marker_path(directory, step)):
                steps.append(step)
    return max(steps) if steps else None


def _complete_step(directory: str, step: Optional[int]) -> int:
    """``step``, or the latest complete one for None; a named step whose
    marker is missing raises ``FileNotFoundError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    elif (not os.path.exists(_marker_path(directory, step))
          and os.path.isdir(directory)
          and _directory_is_marker_governed(directory)):
        raise FileNotFoundError(
            f"checkpoint step {step} under {directory!r} has no commit "
            f"marker — the save did not finish (torn checkpoint); "
            f"resume from latest_step() instead")
    return step


def load_checkpoint(directory: str, step: Optional[int] = None):
    """The saved trees of ``step`` (None: the latest complete one), with
    ``"_step"``, on the CPU. Loaded with ``weights_only=True`` where the
    payload allows it (tensors, numbers, containers), else in full. A
    named step whose marker is missing raises ``FileNotFoundError``."""
    step = _complete_step(directory, step)
    return _load_payload(os.path.join(checkpoint_path(directory, step),
                                      _PAYLOAD))


def _load_payload(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # numpy arrays and other non-tensor leaves; the file is one that
        # save_checkpoint wrote
        return torch.load(path, map_location="cpu", weights_only=False)


def _cpu_copy(tree):
    return pytree.tree_map(
        lambda x: (x.detach().to("cpu", copy=True)
                   if isinstance(x, torch.Tensor) else x), tree)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _layout_rank():
    """``(position, ranks)`` of this process in the model-parallel layout:
    its index in the grid's flat order and the grid's ranks in that
    order."""
    from apex_tpu_torch.transformer import parallel_state

    ranks = tuple(int(r) for r in parallel_state.get_mesh().devices.ravel())
    rank = dist.get_rank() if _distributed() else ranks[0]
    return ranks.index(rank), ranks


def _layout_barrier(ranks) -> None:
    if _distributed() and len(ranks) > 1:
        from apex_tpu_torch.utils.collectives import reduction_group

        dist.barrier(group=reduction_group((ranks,))[0])


def save_train_state(directory: str, state, train_step) -> str:
    """Checkpoint ``state`` (a ``TrainState``) with ``train_step``'s
    parameters, optimizer state and generator under
    ``directory/step_{state.step}``; returns the path. Under a
    model-parallel layout every rank of it must call this: each writes
    its own payload, and the marker follows the last of them."""
    opt = train_step.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    step = int(state.step)
    path = checkpoint_path(directory, step)
    trees = dict(
        train_state={"step": step,
                     "scaler_state": dict(state.scaler_state._asdict())},
        params=[p.detach().to("cpu", copy=True) for p in params],
        optimizer=_cpu_copy(opt.state_dict()),
        generator=train_step.generator.get_state())
    shape = state_mesh_shape(state)
    if shape is None:
        if not _distributed() or dist.get_rank() == 0:
            save_checkpoint(directory, step, **trees)
        if _distributed():
            dist.barrier()
        return path
    position, ranks = _layout_rank()
    if position == 0:
        _begin_save(directory, step)
    _layout_barrier(ranks)              # the old marker is gone
    _write_payload(path, _rank_payload(position), dict(trees, _step=step))
    _layout_barrier(ranks)              # every rank's payload is in place
    if position == 0:
        _write_marker(directory, step, list(trees) + ["_step"],
                      fingerprint={"mesh_shape": shape})
    _layout_barrier(ranks)              # the marker is visible to all
    return path


def load_train_state(directory: str, train_step, step: Optional[int] = None):
    """Load a :func:`save_train_state` checkpoint (None: the latest
    complete step) into ``train_step`` in place: the parameters through
    ``copy_``, then ``optimizer.load_state_dict`` (which keeps fp32
    masters fp32), then the generator's state. Returns ``(state,
    step)``. Under a model-parallel layout each rank reads its own
    payload; a checkpoint saved under another layout (or under none, or
    per rank when no layout is up now) raises ``ValueError`` naming both
    mesh shapes."""
    from apex_tpu_torch.amp.scaler import ScalerState
    from apex_tpu_torch.train.step import TrainState

    step = _complete_step(directory, step)
    marker = read_marker(os.path.abspath(os.fspath(directory)), step) or {}
    saved = (marker.get("fingerprint") or {}).get("mesh_shape")
    want = state_mesh_shape()
    if saved != want:
        why = ("each rank's payload holds its own shards, which load onto "
               "the same layout only" if saved is not None else
               "rank 0's payload holds its own shards only")
        raise ValueError(
            f"checkpoint step {step} under {directory!r} was saved from a "
            f"mesh of shape {saved} but this process's model-parallel "
            f"layout is {want}: refusing the load ({why})")
    if saved is None:
        ck = load_checkpoint(directory, step)
    else:
        ck = _load_payload(os.path.join(checkpoint_path(directory, step),
                                        _rank_payload(_layout_rank()[0])))
    opt = train_step.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    saved = ck["params"]
    if len(saved) != len(params):
        raise ValueError(f"checkpoint holds {len(saved)} parameters, the "
                         f"optimizer {len(params)}")
    with torch.no_grad():
        for p, s in zip(params, saved):
            if p.shape != s.shape:
                raise ValueError(f"checkpoint parameter of shape "
                                 f"{tuple(s.shape)} for one of "
                                 f"{tuple(p.shape)}")
            p.copy_(s)
    opt.load_state_dict(ck["optimizer"])
    train_step.generator.set_state(ck["generator"])
    ts = ck["train_state"]
    state = TrainState(int(ts["step"]), ScalerState(**ts["scaler_state"]))
    return state, int(ck["_step"])


# -- fused-qkv <-> split-q/k/v parameter layouts ------------------------------
#
# Trees in the JAX parameter layout (nested dicts of "kernel"/"bias"
# arrays, as load_jax_params reads them): the tensor-parallel blocks keep
# one fused qkv projection ([q | k | v] along the output axis), the others
# three q/k/v projections. These convert a tree between the two.

_QKV_FUSED_NAMES = {"qkv": ("q", "k", "v"),
                    "attn_qkv": ("attn_q", "attn_k", "attn_v")}


def _is_linear_params(v) -> bool:
    return (isinstance(v, dict) and "kernel" in v
            and all(k in ("kernel", "bias") for k in v))


def split_fused_qkv(params, fused_names=None):
    """Every fused ``qkv`` linear as three ``q``/``k``/``v`` linears
    (split on the last axis, [q | k | v] order); the input is not
    modified. ``fused_names`` maps a fused name to its three split
    names."""
    fused_names = dict(_QKV_FUSED_NAMES if fused_names is None
                       else fused_names)

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k in fused_names and _is_linear_params(v):
                for i, name in enumerate(fused_names[k]):
                    out[name] = {
                        a: np.split(np.asarray(arr), 3, axis=-1)[i]
                        for a, arr in v.items()}
            else:
                out[k] = walk(v)
        return out

    return walk(params)


def merge_split_qkv(params, fused_names=None):
    """Inverse of :func:`split_fused_qkv`: ``q``/``k``/``v`` linears
    concatenated on the last axis into one fused linear, where all three
    are present."""
    fused_names = dict(_QKV_FUSED_NAMES if fused_names is None
                       else fused_names)

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        done = set()
        for fused, names in fused_names.items():
            if all(n in tree and _is_linear_params(tree[n]) for n in names):
                if fused in tree:
                    raise ValueError(
                        f"cannot merge {names} into {fused!r}: the "
                        f"subtree already contains a {fused!r} entry "
                        f"(mixed-layout checkpoint); resolve the "
                        f"collision before merging")
                out[fused] = {
                    a: np.concatenate(
                        [np.asarray(tree[n][a]) for n in names], axis=-1)
                    for a in tree[names[0]]}
                done.update(names)
        for k, v in tree.items():
            if k not in done:
                out[k] = walk(v)
        return out

    return walk(params)
