"""Pipeline schedule efficiency: tick accounting and measurement
(counterpart of :mod:`apex_tpu.transformer.pipeline_parallel.efficiency`).

- :func:`tick_accounting` is the JAX module's analytic contract, copied:
  per-stage active ticks, total ticks, bubble fraction and work-normalized
  time units of the 1F1B-role schedule (``num_chunks=1``) and the
  interleaved one (``num_chunks=v``).
- :func:`schedule_ticks` is the counterpart of the JAX
  ``compiled_tick_count``, which reads the scan's trip count from the
  compiled HLO; the port has no compiler to ask, so it reads the
  schedules' own records (:func:`.schedules.last_schedule_record`, one
  list a stage): every ``F`` and ``B`` takes one tick, a rank runs its
  operations in the recorded order, a forward of global stage ``g`` waits
  for ``g - 1``'s forward of its microbatch and a backward for its
  forward and for ``g + 1``'s backward. It returns the makespan
  (``total_ticks``) and each stage's active ticks. A forward-only
  pipeline's total is the JAX scan's trip count, ``v * m + pp - 1``.
- :func:`measure_pipeline_ticks` times the port's forward pipeline on the
  wall clock at several microbatch counts over the ranks of an
  initialized pipeline group, fits ``T(m) = a * (m + pp - 1) + c`` and
  reports the slope against one directly-timed stage application
  (``slope_over_stage_cost``: ~1 with one device a stage, ~pp where the
  stages time-share one device, ~pp^2 for a schedule that degenerated
  into sequential sweeps).
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import numpy as np
import torch


def tick_accounting(pp: int, num_microbatches: int,
                    num_chunks: int = 1) -> Dict[str, float]:
    """Analytic schedule accounting (see module docstring).

    Returns a dict with ``total_ticks``, ``active_ticks_per_stage``,
    ``utilization``, ``bubble_fraction``, and ``time_units`` — the
    work-normalized wall-time proxy (per-tick cost is 1/num_chunks of a
    full stage, so interleaving shrinks the bubble's absolute cost even
    though it adds ticks)."""
    if pp < 1 or num_microbatches < 1 or num_chunks < 1:
        raise ValueError("pp, num_microbatches, num_chunks must be >= 1")
    m, v = num_microbatches, num_chunks
    total_ticks = v * m + pp - 1
    active = v * m
    return {
        "total_ticks": total_ticks,
        "active_ticks_per_stage": active,
        "utilization": active / total_ticks,
        "bubble_fraction": (pp - 1) / total_ticks,
        "time_units": total_ticks / v,
    }


def schedule_ticks(records: Sequence[Sequence[tuple]]) -> dict:
    """Ticks of a recorded schedule run: ``records[s]`` is stage ``s``'s
    :func:`~.schedules.last_schedule_record`. Returns ``total_ticks``
    (the makespan at one tick an ``F`` or ``B``),
    ``active_ticks_per_stage`` and ``bubble_fraction`` (the share of
    ``pp * total_ticks`` stage-ticks without work). Raises if the records
    cannot all run (a schedule that would deadlock)."""
    pp = len(records)
    ops = [[(op[0], op[1] * pp + s, op[2]) for op in rec
            if op[0] in ("F", "B")] for s, rec in enumerate(records)]
    num_g = max((g for rec in ops for _, g, _ in rec), default=-1) + 1
    done = {}
    clock = [0] * pp
    pos = [0] * pp
    left = sum(len(r) for r in ops)
    while left:
        progressed = False
        for s in range(pp):
            while pos[s] < len(ops[s]):
                kind, g, m = ops[s][pos[s]]
                if kind == "F":
                    deps = [("F", g - 1, m)] if g > 0 else []
                else:
                    deps = [("F", g, m)] + (
                        [("B", g + 1, m)] if g + 1 < num_g else [])
                if any(d not in done for d in deps):
                    break
                end = max([clock[s]] + [done[d] for d in deps]) + 1
                done[(kind, g, m)] = clock[s] = end
                pos[s] += 1
                left -= 1
                progressed = True
        if not progressed:
            stuck = {s: ops[s][pos[s]] for s in range(pp)
                     if pos[s] < len(ops[s])}
            raise RuntimeError(f"the recorded schedule cannot run on: "
                               f"stages wait on {stuck}")
    total = max(clock) if clock else 0
    active = [len(r) for r in ops]
    return {"total_ticks": total, "active_ticks_per_stage": active,
            "bubble_fraction": (1.0 - sum(active) / (pp * total)
                                if total else 0.0)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_pipeline_ticks(microbatch_counts: Sequence[int] = (2, 8),
                           hidden: int = 256, mb_size: int = 4,
                           reps: int = 3, device=None) -> Dict[str, float]:
    """Wall-clock the port's forward pipeline (:func:`.spmd_pipeline`,
    stage ``tanh(x @ w) @ w.T * 0.5``) at each microbatch count on the
    ranks of this rank's initialized pipeline group (every rank of it
    calls this), and fit ``T(m) = a * (m + pp - 1) + c``.

    Returns ``per_tick_seconds`` (the fitted ``a``), ``fit_residual``
    (relative RMS of the fit), ``measured`` (``{m: seconds}``, each the
    least of ``reps`` runs, between a barrier and this rank's end),
    ``stage_seconds`` (one stage application on this rank's device) and
    ``slope_over_stage_cost`` (``a / stage_seconds``)."""
    import torch.distributed as dist

    from apex_tpu_torch.ops._common import resolve_device
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        spmd_pipeline,
    )
    from apex_tpu_torch.utils.collectives import reduction_group

    device = resolve_device(device)
    pp = parallel_state.get_pipeline_model_parallel_world_size()
    stage = parallel_state.get_pipeline_model_parallel_rank()
    group = (reduction_group(
        parallel_state.get_pipeline_model_parallel_ranks())[0]
        if dist.is_initialized() else None)
    rng = np.random.RandomState(0)
    w = torch.from_numpy(
        rng.randn(pp, hidden, hidden).astype("f4") * 0.1)[stage].to(device)

    def stage_fn(wl, x, mb_idx):
        return torch.tanh(x @ wl) @ wl.T * 0.5

    def once(fn, together=True):
        if together and group is not None:
            dist.barrier(group=group)
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        return time.perf_counter() - t0

    measured = {}
    for m in microbatch_counts:
        xs = torch.from_numpy(
            rng.randn(m, mb_size, hidden).astype("f4")).to(device)

        def run(xs=xs, m=m):
            spmd_pipeline(stage_fn, w, xs, num_microbatches=m)

        once(run)                              # warm
        measured[int(m)] = min(once(run) for _ in range(reps))
    x1 = torch.from_numpy(rng.randn(mb_size, hidden).astype("f4")).to(device)
    with torch.no_grad():
        stage_fn(w, x1, 0)
        stage_seconds = min(once(lambda: stage_fn(w, x1, 0), False)
                            for _ in range(max(reps * 3, 8)))
    ms = np.asarray(sorted(measured), np.float64)
    ts = np.asarray([measured[int(m)] for m in ms])
    A = np.stack([ms + pp - 1, np.ones_like(ms)], axis=1)
    (a, c), *_ = np.linalg.lstsq(A, ts, rcond=None)
    resid = ts - A @ np.asarray([a, c])
    return {
        "per_tick_seconds": float(a),
        "fit_residual": float(np.sqrt(np.mean(resid ** 2)) / np.mean(ts)),
        "stage_seconds": float(stage_seconds),
        "slope_over_stage_cost": float(a / stage_seconds),
        "measured": {int(m): float(measured[int(m)]) for m in ms},
    }
