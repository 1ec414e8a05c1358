"""Tuning entry points for the Table-I GAN model zoo.

The port of ``repro.tune.zoo``.  The per-model layer walk lives in
:class:`repro_torch.program.ProgramSpec`: the zoo derives every plan key
from a built spec (``spec.plan_keys()``), so the tuner keys exactly the
fused ops the programs run.  ``layer_plan_keys`` turns a raw layer
topology into plan keys; ``warm_gan_plans`` resolves (measuring on a
miss) a plan for every layer of a config; ``tune_model_zoo`` drives the
whole zoo and returns the tuner CLI's payload (tuned against heuristic
time per layer and per generator).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.dataflow import DataflowPolicy
from repro_torch.device import default_platform, platform_of
from repro_torch.tune.measure import time_interleaved
from repro_torch.tune.planner import Plan, PlanKey, Planner

__all__ = ["layer_plan_keys", "warm_gan_plans", "tune_model_zoo"]


def layer_plan_keys(layers, batch: int, dtype: str = "float32",
                    platform: str | None = None, epilogues=None
                    ) -> list[tuple[str, PlanKey]]:
    """(layer name, PlanKey) per ConvLayer-like entry of ``layers``;
    ``epilogues`` (one :class:`Epilogue` per layer, optional) folds the
    fused bias/activation into the keys; ``platform`` defaults to the
    card's when there is one."""
    platform = platform or default_platform()
    if epilogues is None:
        epilogues = [None] * len(layers)
    out = []
    for l, ep in zip(layers, epilogues):
        out.append((l.name, PlanKey(
            kind="tconv" if l.transposed else "conv",
            batch=int(batch),
            in_spatial=tuple(l.in_spatial),
            kernel=tuple(l.kernel),
            strides=tuple(l.strides),
            paddings=tuple(l.paddings),
            cin=int(l.cin), cout=int(l.cout),
            dtype=dtype, platform=platform,
            **({} if ep is None else ep.key_fields()))))
    return out


def _zoo_keys(cfg, batch: int, *, generator_only: bool = False,
              dtype: str = "float32", platform: str | None = None
              ) -> list[tuple[str, PlanKey]]:
    """("g/<name>" | "d/<name>", PlanKey) per layer of a ``GanConfig``,
    from the :class:`~repro_torch.program.ProgramSpec` walk (the
    heuristic policy keeps the build planner-free)."""
    from repro_torch.program import ProgramSpec
    roles = [("g", "generator")]
    if not generator_only:
        roles.append(("d", "discriminator"))
    out = []
    for prefix, role in roles:
        spec = ProgramSpec.build(cfg, batch, role, policy=DataflowPolicy(),
                                 dtype=dtype, platform=platform)
        out.extend((f"{prefix}/{name}", key)
                   for name, key in spec.plan_keys())
    return out


def warm_gan_plans(cfg, batch: int, planner: Planner | None = None, *,
                   generator_only: bool = False, measure: bool = True,
                   dtype: str = "float32", platform: str | None = None
                   ) -> dict[str, Plan]:
    """A plan for every layer of ``cfg`` (a ``GanConfig``), keyed on the
    fused per-layer epilogues the model runs, on ``platform`` (default:
    the card's when there is one): ``{"g/<name>" | "d/<name>": Plan}``.
    With a warm plan cache (or plan file) this measures nothing."""
    if planner is None:
        from repro_torch.tune import get_planner
        planner = get_planner()
    return {name: planner.plan(key, measure=measure)
            for name, key in _zoo_keys(cfg, batch,
                                       generator_only=generator_only,
                                       dtype=dtype, platform=platform)}


def _time_generator_pair(cfg, params, z, specs, device, *, warmup: int,
                         repeats: int) -> list[float]:
    """Median seconds per forward for each generator spec on the same
    parameters and latents, timed in turns."""
    from repro_torch.models.gan import Generator

    thunks = []
    for spec in specs:
        net = Generator(cfg, params, device, spec=spec)
        net.requires_grad_(False)

        def run(net=net):
            with torch.inference_mode():
                return net(z)
        thunks.append(run)
    return time_interleaved(thunks, warmup=max(1, warmup),
                            repeats=repeats, device=z.device)


def tune_model_zoo(models: Sequence[str], planner: Planner, *,
                   batch: int = 2, channel_scale: float = 0.25,
                   warmup: int = 1, repeats: int = 3,
                   end_to_end: bool = True, device="cuda",
                   log=print) -> dict:
    """Tune every layer of every model in ``models`` on ``device``
    (default: the card); return the tuner CLI's payload.

    Per model: every layer geometry is tuned through the planner (shared
    geometries hit the plan cache), then, with ``end_to_end``, the
    generator forward is timed with the heuristic policy and with
    ``backend="auto"`` on the fresh plans, in turns."""
    from repro_torch.device import resolve_device
    from repro_torch.models.gan import GanConfig, init_gan
    from repro_torch.program import ProgramSpec

    dev = resolve_device(device)
    platform = platform_of(dev)
    out: dict[str, dict] = {}
    for name in models:
        cfg = GanConfig(name=name, channel_scale=channel_scale)
        meas0 = planner.measurements
        plans = warm_gan_plans(cfg, batch, planner, platform=platform)
        keys = dict(_zoo_keys(cfg, batch, platform=platform))
        layer_rows = {}
        tuned_us = 0.0
        complete = True
        for lname, plan in plans.items():
            heur = planner.heuristic_plan(keys[lname])
            layer_rows[lname] = {
                "backend": plan.backend,
                "route": plan.route.to_json() if plan.route else None,
                "blocks": list(plan.blocks) if plan.blocks else None,
                "source": plan.source,
                "tuned_us": plan.measured_us,
                "heuristic_backend": heur.backend}
            if plan.measured_us is None:
                complete = False
            else:
                tuned_us += plan.measured_us
        row = {"layers": layer_rows,
               "measurements": planner.measurements - meas0,
               "layer_tuned_us_sum": tuned_us if complete else None}
        if end_to_end:
            g_params, _ = init_gan(cfg, torch.Generator().manual_seed(0),
                                   device=dev)
            z = torch.zeros((batch, cfg.z_dim), device=dev)
            specs = [ProgramSpec.build(cfg, batch, "generator",
                                       policy=DataflowPolicy(backend=b),
                                       planner=planner, platform=platform)
                     for b in (None, "auto")]
            heur_s, tuned_s = _time_generator_pair(
                cfg, g_params, z, specs, dev, warmup=warmup,
                repeats=max(repeats, 5))
            row["generator_heuristic_us"] = heur_s * 1e6
            row["generator_tuned_us"] = tuned_s * 1e6
            row["generator_speedup"] = heur_s / tuned_s if tuned_s else None
            log(f"  {name:9s} generator: heuristic={heur_s * 1e6:9.0f}us  "
                f"tuned={tuned_s * 1e6:9.0f}us  "
                f"speedup={row['generator_speedup']:.2f}x  "
                f"({row['measurements']} measurements)")
        else:
            log(f"  {name:9s} tuned {len(layer_rows)} layers "
                f"({row['measurements']} measurements)")
        out[name] = row
    return out
