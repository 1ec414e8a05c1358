"""Autotuning planner: measured per-layer backend and GANAX kernel-route
selection with persistent plans.

The port of ``repro.tune``:

* :mod:`repro_torch.tune.planner` — :class:`Planner` (in-memory + JSON
  plan file, measurement counters, corrupt/stale fallback),
  :class:`PlanKey`, :class:`Plan`.
* :mod:`repro_torch.tune.candidates` — the (backend × kernel route)
  configurations valid for a layer geometry.
* :mod:`repro_torch.tune.measure` — warmup + median-of-k timing of one
  candidate on the unified op (CUDA events on the card).
* :mod:`repro_torch.tune.zoo` — tune the Table-I GAN model zoo; backs
  ``python -m repro_torch.tune``.

The process-wide planner (:func:`get_planner`) is what
``backend="auto"`` consults at dispatch.  Its plan file defaults to
``$REPRO_TUNE_PLANS`` (in memory only when unset); install a configured
planner with :func:`set_planner`.
"""

from __future__ import annotations

import os

from repro_torch import obs as _obs
from repro_torch.tune.candidates import (Candidate, default_backend_pool,
                                         enumerate_candidates)
from repro_torch.tune.measure import (measure_candidate, synthesize_inputs,
                                      time_fn)
from repro_torch.tune.planner import (PLAN_FORMAT_VERSION, Plan, PlanKey,
                                      Planner, plan_key_for_op)
from repro_torch.tune.zoo import (layer_plan_keys, tune_model_zoo,
                                  warm_gan_plans)

__all__ = [
    "Candidate", "Plan", "PlanKey", "Planner", "PLAN_FORMAT_VERSION",
    "default_backend_pool", "enumerate_candidates", "measure_candidate",
    "synthesize_inputs", "time_fn", "plan_key_for_op", "layer_plan_keys",
    "warm_gan_plans", "tune_model_zoo", "get_planner", "set_planner",
]

_PLANNER: Planner | None = None


def get_planner(create: bool = True) -> Planner | None:
    """The process-wide planner consulted by ``backend="auto"``.

    Created on first use; persists to the path in the
    ``REPRO_TUNE_PLANS`` environment variable when set (in memory
    otherwise).  ``create=False`` returns None instead of creating one,
    for observers that must not allocate a planner."""
    global _PLANNER
    if _PLANNER is None and create:
        _PLANNER = Planner(path=os.environ.get("REPRO_TUNE_PLANS"))
    return _PLANNER


def set_planner(planner: Planner | None) -> Planner | None:
    """Install (or clear, with None) the process-wide planner."""
    global _PLANNER
    _PLANNER = planner
    return planner


def _planner_stats():
    """The process-wide planner's counters for ``obs.collect()``, or
    None when there is none (observing must not create one)."""
    planner = get_planner(create=False)
    return None if planner is None else planner.stats()


_obs.register_collector("tune.planner", _planner_stats)
