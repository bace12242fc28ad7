"""Declarative sweep registry — one entry per paper figure or table.

Counterpart of ``repro.experiments.registry``, entry for entry and field
for field.  Each :class:`SweepDef` declares what the paper varied (the axis
and its values), what it compared (the strategies) and the sizing of its
``smoke`` and full grids.  :meth:`SweepDef.expand` turns an entry into
:class:`~repro_torch.fl.experiment.ExperimentSpec` cells; the orchestrator
(:mod:`repro_torch.experiments.orchestrator`) runs them and writes
``BENCH_feddif_<sweep>.json``.

==================  =======================  ==================================
name                paper artifact           axis
==================  =======================  ==================================
``fig3_alpha``      Fig. 3                   Dirichlet concentration α
``fig4_epsilon``    Fig. 4                   halting tolerance ε (min IID dist)
``fig5_gamma_min``  Fig. 5                   min spectral efficiency γ_min
``fig6_tasks``      Fig. 6 / Table I         ML task (logistic…cnn, lm)
``table2_strategies``  Table II              strategy (FedAvg…FedDif)
``fig_lm``          LM diffusion             strategy, int8 adapter hops
``fig7_scaling``    scaling (beyond paper)   client population N (with churn)
``fig_async``       async (beyond paper)     engine preset (sync vs buffered)
``fig_scenarios``   world (beyond paper)     wireless scenario (static…energy)
==================  =======================  ==================================

``fig7_scaling`` runs under churn and ``fig_scenarios`` in the evolving
wireless world.  ``fig_async`` runs the buffered-async plane
(:mod:`repro_torch.fl.async_plane`) against the same event queue with a
barrier.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.channels.world import SCENARIOS
from repro_torch.fl.engine import ENGINE_PRESETS, UNPORTED_PRESETS
from repro_torch.fl.experiment import ExperimentSpec
from repro_torch.fl.models import TASK_MODELS
from repro_torch.fl.server import STRATEGIES, FLConfig

__all__ = ["AXIS_TARGETS", "SCENARIOS", "SweepCell", "SweepDef", "REGISTRY",
           "register", "get_sweep", "sweep_names", "expand_sweep"]

# Axis name -> (which dataclass it lands on, field name).
AXIS_TARGETS = {
    "alpha": ("spec", "alpha"),
    "epsilon": ("fl", "epsilon"),
    "gamma_min": ("fl", "gamma_min"),
    "task": ("spec", "task"),
    "strategy": ("fl", "strategy"),
    "num_clients": ("fl", "num_clients"),   # num_models tracks it (M = N)
    "engine": ("fl", "engine"),             # EngineSpec preset name
    "scenario": ("fl", "scenario"),         # wireless world scenario name
}

@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One grid point of a sweep: an axis value × strategy, ready to run."""
    sweep: str
    figure: str
    axis: str
    value: Any
    strategy: str
    spec: ExperimentSpec

    @property
    def label(self) -> str:
        if self.axis == "strategy":
            return f"strategy={self.value}"
        return f"{self.axis}={self.value}/{self.strategy}"

    def with_fl(self, **overrides) -> "SweepCell":
        """Copy of this cell with ``FLConfig`` fields replaced."""
        return dataclasses.replace(
            self, spec=dataclasses.replace(
                self.spec, fl=dataclasses.replace(self.spec.fl, **overrides)))


@dataclasses.dataclass(frozen=True)
class SweepDef:
    """Declarative description of one paper figure/table sweep."""
    name: str
    figure: str
    axis: str                       # key of AXIS_TARGETS
    values: tuple                   # full-mode axis values
    smoke_values: tuple             # CPU-smoke axis values (subset)
    description: str = ""
    strategies: tuple = ("feddif",)   # compared per point (ignored when the
                                      # axis itself is "strategy")
    rounds: int = 20
    smoke_rounds: int = 2
    num_clients: int = 10
    smoke_num_clients: int = 4
    num_samples: int = 8000
    smoke_num_samples: int = 1000
    spec_overrides: dict = dataclasses.field(default_factory=dict)
    fl_overrides: dict = dataclasses.field(default_factory=dict)
    # Per-axis-value strategy overrides (fig7_scaling drops the Hungarian
    # auction at N ≥ 1024).  Ignored when the axis itself is "strategy".
    value_strategies: dict = dataclasses.field(default_factory=dict)

    def expand(self, smoke: bool = True, topology_seed: int = 0,
               executor: str = "host", planner: str = "host",
               **overrides) -> list[SweepCell]:
        """Expand to concrete cells.

        ``smoke`` picks the smoke grid over the full one; ``topology_seed``
        is stamped on every cell so diffusion plans are shared across
        replicate seeds; ``executor`` (``"host"`` | ``"fleet"``) and
        ``planner`` (``"host"`` | ``"jax"``, the device planner) are
        stamped on every cell's ``FLConfig``; ``overrides`` are extra
        ``ExperimentSpec`` fields (e.g. ``num_samples=500`` in tests)."""
        values = self.smoke_values if smoke else self.values
        clients = self.smoke_num_clients if smoke else self.num_clients
        rounds = self.smoke_rounds if smoke else self.rounds
        samples = self.smoke_num_samples if smoke else self.num_samples

        cells: list[SweepCell] = []
        for value in values:
            strategies = ((value,) if self.axis == "strategy"
                          else self.value_strategies.get(value,
                                                         self.strategies))
            for strategy in strategies:
                fl_kwargs: dict = dict(
                    strategy=strategy, rounds=rounds, num_clients=clients,
                    num_models=clients, seed=0, topology_seed=topology_seed,
                    executor=executor, planner=planner)
                spec_kwargs: dict = dict(
                    task="fcn", alpha=1.0, num_samples=samples, data_seed=0)
                fl_kwargs.update(self.fl_overrides)
                spec_kwargs.update(self.spec_overrides)
                where, field = AXIS_TARGETS[self.axis]
                if where == "fl":
                    fl_kwargs[field] = value
                    if field == "num_clients":
                        # The paper trains M ≤ N; scaling sweeps keep M = N.
                        fl_kwargs["num_models"] = value
                elif field != "strategy":
                    spec_kwargs[field] = value
                spec_kwargs.update(overrides)
                spec = ExperimentSpec(fl=FLConfig(**fl_kwargs), **spec_kwargs)
                cells.append(SweepCell(sweep=self.name, figure=self.figure,
                                       axis=self.axis, value=value,
                                       strategy=strategy, spec=spec))
        return cells

    def validate(self) -> None:
        """Raise ``ValueError`` for an axis, strategy, task, engine preset
        or scenario that neither package knows."""
        def need(ok: bool, what) -> None:
            if not ok:
                raise ValueError(f"sweep {self.name!r}: {what}")

        need(self.axis in AXIS_TARGETS, f"unknown axis {self.axis!r}")
        need(set(self.smoke_values) <= set(self.values),
             "smoke values must be a subset of the values")
        strategies = list(self.strategies)
        for group in self.value_strategies.values():
            strategies += list(group)
        if self.axis == "strategy":
            strategies += list(self.values)
        for s in strategies:
            need(s in STRATEGIES, f"unknown strategy {s!r}")
        known = {"task": TASK_MODELS,
                 "engine": (*ENGINE_PRESETS, *UNPORTED_PRESETS),
                 "scenario": SCENARIOS}.get(self.axis)
        if known is not None:
            for v in self.values:
                need(v in known, f"unknown {self.axis} {v!r}")


REGISTRY: dict[str, SweepDef] = {}


def register(defn: SweepDef) -> SweepDef:
    defn.validate()
    if defn.name in REGISTRY:
        raise ValueError(f"duplicate sweep {defn.name!r}")
    REGISTRY[defn.name] = defn
    return defn


def get_sweep(name: str) -> SweepDef:
    if name not in REGISTRY:
        raise KeyError(f"unknown sweep {name!r}; "
                       f"registered: {', '.join(sorted(REGISTRY))}")
    return REGISTRY[name]


def sweep_names() -> list[str]:
    return sorted(REGISTRY)


def expand_sweep(name: str, smoke: bool = True, **overrides
                 ) -> list[SweepCell]:
    """Convenience: ``get_sweep(name).expand(...)``."""
    return get_sweep(name).expand(smoke=smoke, **overrides)


# --------------------------------------------------------------- the entries

register(SweepDef(
    name="fig3_alpha",
    figure="Fig. 3",
    axis="alpha",
    description="Accuracy / diffusion rounds / comm cost vs Dirichlet "
                "concentration α (degree of non-IIDness).",
    values=(0.1, 0.2, 0.5, 1.0, 100.0),
    smoke_values=(0.2, 1.0),
    strategies=("fedavg", "feddif"),
))

register(SweepDef(
    name="fig4_epsilon",
    figure="Fig. 4",
    axis="epsilon",
    description="Minimum tolerable IID distance ε — the halting knob of "
                "Algorithm 2's diffusion loop (accuracy vs comm trade-off).",
    values=(0.0, 0.02, 0.04, 0.1, 0.2),
    smoke_values=(0.0, 0.2),
    strategies=("feddif",),
))

register(SweepDef(
    name="fig5_gamma_min",
    figure="Fig. 5",
    axis="gamma_min",
    description="Minimum tolerable QoS γ_min (bit/s/Hz) — constraint (18e) "
                "on which D2D links the auction may schedule.",
    values=(0.5, 1.0, 2.0, 4.0),
    smoke_values=(1.0, 4.0),
    strategies=("feddif",),
))

register(SweepDef(
    name="fig6_tasks",
    figure="Fig. 6 / Table I",
    axis="task",
    description="FedDif vs FedAvg across the paper's five evaluation models.",
    values=TASK_MODELS,
    smoke_values=("logistic", "fcn"),
    strategies=("fedavg", "feddif"),
))

register(SweepDef(
    name="fig7_scaling",
    figure="Scaling (beyond paper)",
    axis="num_clients",
    description="Large-N fleet scaling: client population N (M = N models) "
                "× strategy under per-round churn/straggler dropout — the "
                "regime the 2-D (clients × model) sharded executor targets "
                "(run with --executor sharded).  At N ≥ 1024 the Hungarian "
                "auction control plane is O(N³), so only the auction-free "
                "strategies run there.",
    values=(20, 64, 256, 1024, 4096),
    smoke_values=(20, 64),
    strategies=("fedavg", "d2d_random_walk", "feddif"),
    value_strategies={1024: ("fedavg", "d2d_random_walk"),
                      4096: ("fedavg", "d2d_random_walk")},
    rounds=6,
    smoke_rounds=2,
    num_samples=25600,
    smoke_num_samples=6400,
    fl_overrides={"churn_rate": 0.05, "max_diffusion_rounds": 8},
))

register(SweepDef(
    name="fig_lm",
    figure="LM diffusion (beyond paper)",
    axis="strategy",
    description="FedDif-over-LMs: strategies on the small LoRA transformer "
                "with Dirichlet-partitioned token data, hopping the "
                "int8-packed trainable-adapter view (repro.fl.adapters) — "
                "the Eq.-15 ledger charges packed adapter bits per D2D hop "
                "plus a one-time round-0 base broadcast.",
    values=("fedavg", "d2d_random_walk", "feddif"),
    smoke_values=("fedavg", "feddif"),
    rounds=10,
    smoke_rounds=2,
    num_clients=8,
    smoke_num_clients=4,
    num_samples=4096,
    smoke_num_samples=768,
    spec_overrides={"task": "lm", "dim": 32},
    fl_overrides={"hop_quant": "int8", "max_diffusion_rounds": 4},
))

register(SweepDef(
    name="fig_async",
    figure="Async rounds (beyond paper)",
    axis="engine",
    description="Buffered-async (FedBuff-style) round plane vs the same "
                "event queue with a full barrier (async_barrier), under "
                "lognormal compute stragglers, channel-drawn link delays "
                "and 5% per-round churn: accuracy vs the virtual clock and "
                "arrival throughput.  Both arms share the delay model, so "
                "the gap isolates what buffering K=frac·M arrivals per "
                "server tick buys.",
    values=("async_barrier", "async"),
    smoke_values=("async_barrier", "async"),
    strategies=("fedavg", "d2d_random_walk"),
    rounds=10,
    smoke_rounds=2,
    num_clients=16,
    smoke_num_clients=4,
    fl_overrides={"churn_rate": 0.05, "max_diffusion_rounds": 4},
))

register(SweepDef(
    name="fig_scenarios",
    figure="World scenarios (beyond paper)",
    axis="scenario",
    description="The time-evolving wireless world (channels/world): static "
                "placement (the paper's per-round redraw), random-waypoint "
                "mobility stepping under the diffusion loop, multi-cell "
                "placement with SINR handoff + inter-cell interference, and "
                "finite per-client TX-energy budgets (depleted clients drop "
                "out).  Strategy × scenario matrix of accuracy and the "
                "ledger (incl. joules) — how much of FedDif's gain survives "
                "a world that moves under it.",
    values=("static", "mobile", "multicell", "energy_capped"),
    smoke_values=("static", "mobile", "energy_capped"),
    strategies=("fedavg", "d2d_random_walk", "feddif"),
    rounds=12,
    smoke_rounds=2,
    num_clients=20,
    smoke_num_clients=4,
    num_samples=8000,
    smoke_num_samples=1000,
    fl_overrides={"max_diffusion_rounds": 6},
))

register(SweepDef(
    name="table2_strategies",
    figure="Table II",
    axis="strategy",
    description="Communication efficiency (sub-frames / transmitted models / "
                "Eq. 15 bandwidth) across strategies, incl. the auction-free "
                "d2d_random_walk ablation.",
    values=("fedavg", "stc", "fedswap", "d2d_random_walk", "feddif"),
    smoke_values=("fedavg", "d2d_random_walk", "feddif"),
    rounds=25,
))
