"""EngineSpec / RunResult — the typed engine selection and result API.

Counterpart of ``repro.fl.engine``.  :class:`EngineSpec` is the single
authority on which execution plane runs: :func:`resolve_engine` maps an
``FLConfig`` onto it (``cfg.engine`` — a spec or an :data:`ENGINE_PRESETS`
name — wins; otherwise the ``executor=``/``planner=`` fields map through
:meth:`EngineSpec.from_config`, without the reference's deprecation
warning).  The port runs ``mode="host"`` and ``"fleet"``; ``run_federated``
raises for ``"async"`` (ROADMAP A11) and ``"sharded"`` (A12), whose knobs
come with those planes.  The reference's presets of those planes
(:data:`UNPORTED_PRESETS`) resolve to their bare mode, so they are refused
the same way.

:class:`RunResult` is what ``run_federated`` returns: params, ledger, a
:class:`RunHistory` of per-round curves, the engine used, and the
planner's ``planner_stats``.  The reference's flat ``FLResult`` attributes
(``final_params``, ``accuracy``, ``loss``, …) are properties, and
``params, ledger, history = result`` unpacks.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["EngineSpec", "ENGINE_PRESETS", "ENGINE_MODES", "UNPORTED_PRESETS",
           "resolve_engine", "RunHistory", "RunResult", "SHARDED_CROSSOVER_N"]

#: Fleet size below which a sharded request downgrades to the fleet plane
#: (the reference's measured crossover, kept so specs resolve alike).
SHARDED_CROSSOVER_N = 64

#: Execution planes a spec can name.
ENGINE_MODES = ("host", "fleet", "sharded", "async", "auto")


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """The typed engine selection: the execution plane ``mode`` and the
    control plane ``planner`` ("host" | "jax", the device planner)."""
    mode: str = "host"
    planner: str = "host"

    def validate(self) -> None:
        assert self.mode in ENGINE_MODES, self.mode
        assert self.planner in ("host", "jax"), self.planner

    def auto(self, num_clients: int) -> "EngineSpec":
        """Resolve "auto" and downgrade infeasible sharded requests:
        sharded above :data:`SHARDED_CROSSOVER_N` clients on more than one
        CUDA device, fleet otherwise.  Idempotent; never changes an explicit
        host/fleet/async request."""
        mode = self.mode
        multi = torch.cuda.device_count() > 1
        if mode == "auto":
            mode = ("sharded" if multi and num_clients >= SHARDED_CROSSOVER_N
                    else "fleet")
        if mode == "sharded" and num_clients < SHARDED_CROSSOVER_N:
            mode = "fleet"
        return self if mode == self.mode \
            else dataclasses.replace(self, mode=mode)

    @classmethod
    def from_config(cls, cfg) -> "EngineSpec":
        """Map the ``FLConfig`` string fields onto a spec."""
        return cls(mode=str(getattr(cfg, "executor", "host")),
                   planner=str(getattr(cfg, "planner", "host")))

    @classmethod
    def preset(cls, name: str) -> "EngineSpec":
        """A named preset, or the bare plane of one the port does not run
        (:data:`UNPORTED_PRESETS`), which ``run_federated`` refuses naming
        its ROADMAP item."""
        if name in ENGINE_PRESETS:
            return ENGINE_PRESETS[name]
        if name in UNPORTED_PRESETS:
            return cls(mode=UNPORTED_PRESETS[name])
        raise ValueError(f"unknown engine preset {name!r}; expected one of "
                         f"{sorted(ENGINE_PRESETS)}")


#: Named engine presets: the reference's, for the planes the port runs.
ENGINE_PRESETS: dict[str, EngineSpec] = {
    "host": EngineSpec(mode="host"),
    "fleet": EngineSpec(mode="fleet"),
    "auto": EngineSpec(mode="auto"),
}

#: The reference's other presets, each with the plane it selects: the port
#: resolves them to that bare mode, which ``run_federated`` refuses.
UNPORTED_PRESETS: dict[str, str] = {"sharded": "sharded", "async": "async",
                                    "async_barrier": "async"}


def resolve_engine(cfg) -> EngineSpec:
    """``FLConfig`` → :class:`EngineSpec`: ``cfg.engine`` wins when set (a
    spec or a preset name), else the ``executor``/``planner`` fields; ``mode="auto"``
    resolves against ``cfg.num_clients``."""
    eng = getattr(cfg, "engine", None)
    if eng is None:
        spec = EngineSpec.from_config(cfg)
    elif isinstance(eng, str):
        spec = EngineSpec.preset(eng)
    elif isinstance(eng, EngineSpec):
        spec = eng
    else:
        raise TypeError(f"FLConfig.engine must be an EngineSpec or a preset "
                        f"name, got {type(eng).__name__}")
    if spec.mode == "auto":
        spec = spec.auto(int(getattr(cfg, "num_clients", 0)))
    spec.validate()
    return spec


@dataclasses.dataclass
class RunHistory:
    """Per-round curves of one run: the reference's fields that the
    synchronous planes fill (the async plane's come with ROADMAP A11, the
    phase profile with A15)."""
    accuracy: list = dataclasses.field(default_factory=list)
    loss: list = dataclasses.field(default_factory=list)
    diffusion_rounds: list = dataclasses.field(default_factory=list)
    iid_distance: list = dataclasses.field(default_factory=list)
    round_wall_s: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RunResult:
    """What ``run_federated`` returns: params, the Eq.-15 ledger, the
    per-round :class:`RunHistory`, the engine used, the config, and the
    planner's :attr:`~repro_torch.core.diffusion.DiffusionPlanner.stats`."""
    params: Any
    ledger: Any
    history: RunHistory
    engine: EngineSpec | None = None
    config: Any = None
    planner_stats: dict = dataclasses.field(default_factory=dict)

    def __iter__(self):
        yield self.params
        yield self.ledger
        yield self.history

    @property
    def final_params(self):
        return self.params

    @property
    def accuracy(self) -> list:
        return self.history.accuracy

    @property
    def loss(self) -> list:
        return self.history.loss

    @property
    def diffusion_rounds(self) -> list:
        return self.history.diffusion_rounds

    @property
    def iid_distance(self) -> list:
        return self.history.iid_distance

    @property
    def round_wall_s(self) -> list:
        return self.history.round_wall_s

    def rounds_to_accuracy(self, target: float) -> int | None:
        for i, a in enumerate(self.history.accuracy):
            if a >= target:
                return i + 1
        return None

    @classmethod
    def from_histories(cls, *, accuracy, loss, ledger, diffusion_rounds,
                       iid_distance, config=None, final_params=None,
                       round_wall_s=(), phase_s=(), engine=None,
                       **async_hist) -> "RunResult":
        """Build a result from the flat legacy field spelling (replication
        engines, tests).  The phase profile is ROADMAP item A15 and the
        async plane's curves A11: passing either raises."""
        if len(phase_s):
            raise NotImplementedError(
                "RunHistory.phase_s is ROADMAP item A15 (phase profiling)")
        if async_hist:
            raise NotImplementedError(
                f"the async plane's curves {sorted(async_hist)} are ROADMAP "
                f"item A11 (the buffered-async plane)")
        hist = RunHistory(accuracy=list(accuracy), loss=list(loss),
                          diffusion_rounds=list(diffusion_rounds),
                          iid_distance=list(iid_distance),
                          round_wall_s=list(round_wall_s))
        return cls(params=final_params, ledger=ledger, history=hist,
                   engine=engine, config=config)
