"""EngineSpec / RunResult — the typed engine selection and result API.

Counterpart of ``repro.fl.engine``.  :class:`EngineSpec` is the single
authority on which execution plane runs: :func:`resolve_engine` maps an
``FLConfig`` onto it (``cfg.engine`` — a spec or an :data:`ENGINE_PRESETS`
name — wins; otherwise the ``executor=``/``planner=`` fields map through
:meth:`EngineSpec.from_config`, without the reference's deprecation
warning).  The port runs ``mode="host"``, ``"fleet"`` and ``"async"`` (the
buffered-async plane, :mod:`repro_torch.fl.async_plane`, with its
:class:`AsyncSpec` knobs and the ``async`` / ``async_barrier`` presets);
``run_federated`` raises for ``"sharded"`` (ROADMAP A12), whose knobs come
with that plane.  The reference's ``sharded`` preset
(:data:`UNPORTED_PRESETS`) resolves to its bare mode, so it is refused the
same way.

:class:`RunResult` is what ``run_federated`` returns: params, ledger, a
:class:`RunHistory` of per-round curves (the async plane's virtual clock,
arrivals, staleness and parked hops among them), the engine used, and the
planner's ``planner_stats``.  The reference's flat ``FLResult`` attributes
(``final_params``, ``accuracy``, ``loss``, …) are properties, and
``params, ledger, history = result`` unpacks.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["AsyncSpec", "EngineSpec", "ENGINE_PRESETS", "ENGINE_MODES",
           "UNPORTED_PRESETS",
           "resolve_engine", "engine_fingerprint", "RunHistory", "RunResult",
           "SHARDED_CROSSOVER_N"]

#: Fleet size below which a sharded request downgrades to the fleet plane
#: (the reference's measured crossover, kept so specs resolve alike).
SHARDED_CROSSOVER_N = 64

#: Execution planes a spec can name.
ENGINE_MODES = ("host", "fleet", "sharded", "async", "auto")


@dataclasses.dataclass(frozen=True)
class AsyncSpec:
    """Knobs of the buffered-async (FedBuff-style) round plane, the
    reference's fields and defaults.

    The defaults are degenerate on purpose: ``buffer_k`` and
    ``buffer_frac`` both ``None`` aggregate every arrival of the round (a
    barrier), ``delay_scale=0`` makes every arrival instantaneous and
    ``staleness_beta=0`` turns the discount off, so ``EngineSpec(mode=
    "async")`` with stock knobs gives the sync host executor's bits.

    Attributes:
      buffer_k: aggregate the first K arrivals per server tick; ``None``
        defers to ``buffer_frac`` (``K = max(1, round(frac · M))``).
      staleness_alpha / staleness_beta: a contribution aggregated ``s``
        ticks after it was issued weighs ``alpha / (1 + s)^beta``.
      max_staleness: drop contributions older than this many ticks.
      delay_scale: seconds of local training per data row at unit speed;
        0 disables the whole delay model.
      delay_sigma: sigma of the lognormal per-client, per-round jitter.
      hop_deadline_s: park hops whose payload reaches the carrier later.
      population: size of the simulated user population the cohort is
        drawn from (:mod:`repro_torch.fl.population`); 0 disables it.
      avail_alpha / avail_beta / speed_sigma: the population's
        availability Beta shape and persistent speed sigma.
    """
    buffer_k: int | None = None
    buffer_frac: float | None = None
    staleness_alpha: float = 1.0
    staleness_beta: float = 0.0
    max_staleness: int | None = None
    delay_scale: float = 0.0
    delay_sigma: float = 0.0
    hop_deadline_s: float | None = None
    population: int = 0
    avail_alpha: float = 2.0
    avail_beta: float = 2.0
    speed_sigma: float = 0.5

    def discount(self, staleness) -> float:
        """Staleness weight multiplier ``alpha / (1 + s) ** beta``."""
        return float(self.staleness_alpha
                     / (1.0 + float(staleness)) ** self.staleness_beta)

    def resolve_k(self, num_contributions: int) -> int:
        """K for a tick with ``num_contributions`` fresh contributions."""
        if self.buffer_k is not None:
            return max(1, min(int(self.buffer_k), num_contributions))
        if self.buffer_frac is not None:
            return max(1, min(int(round(self.buffer_frac
                                        * num_contributions)),
                              num_contributions))
        return num_contributions

    def validate(self) -> None:
        assert self.buffer_k is None or self.buffer_k >= 1, self.buffer_k
        assert self.buffer_frac is None or 0.0 < self.buffer_frac <= 1.0, \
            self.buffer_frac
        assert self.staleness_alpha > 0.0, self.staleness_alpha
        assert self.staleness_beta >= 0.0, self.staleness_beta
        assert self.delay_scale >= 0.0, self.delay_scale
        assert self.population >= 0, self.population


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """The typed engine selection: the execution plane ``mode``, the
    control plane ``planner`` ("host" | "jax", the device planner), the
    async plane's inner op executor ``data_plane`` ("auto" | "host" |
    "fleet") and its knobs ``buffered``."""
    mode: str = "host"
    planner: str = "host"
    data_plane: str = "auto"
    buffered: AsyncSpec = dataclasses.field(default_factory=AsyncSpec)

    def validate(self) -> None:
        assert self.mode in ENGINE_MODES, self.mode
        assert self.planner in ("host", "jax"), self.planner
        assert self.data_plane in ("auto", "host", "fleet"), self.data_plane
        self.buffered.validate()

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

    def inner_data_plane(self, num_clients: int) -> str:
        """The async plane's inner op executor, "auto" resolved by size:
        the fleet plane from :data:`SHARDED_CROSSOVER_N` clients on."""
        if self.data_plane != "auto":
            return self.data_plane
        return "fleet" if num_clients >= SHARDED_CROSSOVER_N else "host"

    def describe(self) -> str:
        """Stable one-line fingerprint (the checkpoint config guard): the
        reference's string character for character, with its defaults for
        the sharded plane's knobs (ROADMAP A12), so checkpoints of either
        package are guarded alike."""
        b = self.buffered
        base = (f"{self.mode}/planner={self.planner}/overlap=auto"
                f"/transport=auto/mb=32/km=1")
        if self.mode != "async":
            return base
        return (base + f"/data={self.data_plane}/k={b.buffer_k}"
                f"/frac={b.buffer_frac}/a={b.staleness_alpha}"
                f"/b={b.staleness_beta}/smax={b.max_staleness}"
                f"/ds={b.delay_scale}/sig={b.delay_sigma}"
                f"/ddl={b.hop_deadline_s}/pop={b.population}"
                f"/av={b.avail_alpha},{b.avail_beta}"
                f"/spd={b.speed_sigma}")

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
#: "async" is the headline buffered-async configuration (half-buffer
#: ticks, the staleness discount, lognormal stragglers, channel-drawn link
#: delays); "async_barrier" is the same delay model with K = everything,
#: the sync comparison arm of ``fig_async`` (a tick waits for the slowest
#: arrival).
ENGINE_PRESETS: dict[str, EngineSpec] = {
    "host": EngineSpec(mode="host"),
    "fleet": EngineSpec(mode="fleet"),
    "auto": EngineSpec(mode="auto"),
    "async": EngineSpec(mode="async", buffered=AsyncSpec(
        buffer_frac=0.5, staleness_beta=0.5,
        delay_scale=0.01, delay_sigma=1.0)),
    "async_barrier": EngineSpec(mode="async", buffered=AsyncSpec(
        delay_scale=0.01, delay_sigma=1.0)),
}

#: The reference's other presets, each with the plane it selects: the port
#: resolves them to that bare mode, which ``run_federated`` refuses.
UNPORTED_PRESETS: dict[str, str] = {"sharded": "sharded"}


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


def engine_fingerprint(cfg) -> str:
    """Resolved-engine fingerprint for the checkpoint config guard."""
    return resolve_engine(cfg).describe()


@dataclasses.dataclass
class RunHistory:
    """Per-round curves of one run, the reference's fields.  ``phase_s``
    holds, under ``FLConfig.profile_phases``, one dict of seconds per
    round: ``plan`` and, on the fleet plane, ``train``,
    ``hop_collective`` and ``mix``.  The async plane fills the last four:
    per server tick the virtual clock, the contributions aggregated and
    their mean staleness, and per round the parked hops."""
    accuracy: list = dataclasses.field(default_factory=list)
    loss: list = dataclasses.field(default_factory=list)
    diffusion_rounds: list = dataclasses.field(default_factory=list)
    iid_distance: list = dataclasses.field(default_factory=list)
    round_wall_s: list = dataclasses.field(default_factory=list)
    phase_s: list = dataclasses.field(default_factory=list)
    virtual_s: list = dataclasses.field(default_factory=list)
    arrivals: list = dataclasses.field(default_factory=list)
    staleness: list = dataclasses.field(default_factory=list)
    parked_hops: list = dataclasses.field(default_factory=list)


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

    @property
    def phase_s(self) -> list:
        return self.history.phase_s

    def rounds_to_accuracy(self, target: float) -> int | None:
        for i, a in enumerate(self.history.accuracy):
            if a >= target:
                return i + 1
        return None

    def time_to_accuracy(self, target: float) -> float | None:
        """Virtual seconds to reach ``target`` accuracy (async plane; the
        round count when no virtual clock was recorded)."""
        r = self.rounds_to_accuracy(target)
        if r is None:
            return None
        if self.history.virtual_s:
            return float(self.history.virtual_s[min(
                r - 1, len(self.history.virtual_s) - 1)])
        return float(r)

    @classmethod
    def from_histories(cls, *, accuracy, loss, ledger, diffusion_rounds,
                       iid_distance, config=None, final_params=None,
                       round_wall_s=(), phase_s=(), engine=None,
                       **async_hist) -> "RunResult":
        """Build a result from the flat legacy field spelling (replication
        engines, tests); ``async_hist`` takes the async plane's curves."""
        hist = RunHistory(accuracy=list(accuracy), loss=list(loss),
                          diffusion_rounds=list(diffusion_rounds),
                          iid_distance=list(iid_distance),
                          round_wall_s=list(round_wall_s),
                          phase_s=list(phase_s), **async_hist)
        return cls(params=final_params, ledger=ledger, history=hist,
                   engine=engine, config=config)
