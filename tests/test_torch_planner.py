"""The port's device planner (``planner="jax"``) against the JAX package's.

On the CPU both packages take the broadcast composite for the Eq.-32 bids,
so decisions must coincide exactly: the channel twins, the tensor DoL
state, the Bertsekas auction (``dst`` and ``converged``), the padded plan
tensors of ``_plan_rounds`` (with and without learning-value fusion), and
the hop lists and post-plan states of ``DiffusionPlanner(mode="jax")``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channels.resources import (outage_probability_jax,
                                      required_bandwidth_jax,
                                      spectral_efficiency_jax)
from repro.channels.topology import CellTopology as JTopology
from repro.core import DiffusionPlanner as JPlanner
from repro.core import DiffusionState as JState
from repro.core import PlannerState as JPlannerState
from repro.core import planner as jplanner
from repro.core.matching import auction_assign as j_auction
from repro_torch.channels.resources import (outage_probability_t,
                                            required_bandwidth_t,
                                            spectral_efficiency_t)
from repro_torch.core import dol as tdol
from repro_torch.core import planner as tplanner
from repro_torch.core.diffusion import DiffusionPlanner
from repro_torch.core.dol import DiffusionState, PlannerState
from repro_torch.core.matching import auction_assign


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.as_tensor(np.array(x))


# ----------------------------------------------------------- channel twins

def test_channel_twins_match_jnp():
    rng = np.random.default_rng(0)
    snr = (10.0 ** rng.uniform(-3, 6, size=(12, 12))).astype(np.float32)
    snr[0, :3] = [0.0, 1e-13, 1e-30]
    np.testing.assert_allclose(spectral_efficiency_t(_t(snr)).numpy(),
                               np.asarray(spectral_efficiency_jax(snr)),
                               rtol=1e-6)
    gamma = np.array(spectral_efficiency_jax(snr))
    gamma[1, :2] = [0.0, 1e-10]                      # dead links cost ∞
    np.testing.assert_array_equal(
        required_bandwidth_t(_t(np.float32(1e6)), _t(gamma)).numpy(),
        np.asarray(required_bandwidth_jax(jnp.float32(1e6), gamma)))
    for gmin in (0.5, 1.0, 4.0):
        got = outage_probability_t(_t(np.float32(gmin)), _t(snr)).numpy()
        want = np.asarray(outage_probability_jax(jnp.float32(gmin), snr))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)


# -------------------------------------------------------------- DoL state

def _planner_state(seed, m=10, n=12, c=10):
    rng = np.random.default_rng(seed)
    dol = rng.dirichlet(np.ones(c), m).astype(np.float32)
    chain = rng.integers(0, 3000, m).astype(np.float32)
    dol[0], chain[0] = 0.0, 0.0                     # a never-trained model
    visited = rng.random((m, n)) < 0.3
    holder = rng.integers(0, n, m)
    dsi = rng.dirichlet(np.ones(c) * 0.5, n).astype(np.float32)
    sizes = rng.integers(0, 800, n).astype(np.float32)
    dst = rng.permutation(n)[:m]
    mask = rng.random(m) < 0.7
    return dol, chain, visited, holder, dsi, sizes, dst, mask


@pytest.mark.parametrize("seed", range(3))
def test_record_round_matches_reference_loop(seed):
    """record_round gives the bits of the reference's record_round as its
    jitted planner loop compiles it (one fused multiply-add in Eq. 2)."""
    dol, chain, visited, holder, dsi, sizes, dst, mask = _planner_state(seed)
    want = jax.jit(lambda s, *a: s.record_round(*a))(
        JPlannerState(jnp.asarray(dol), jnp.asarray(chain),
                      jnp.asarray(visited), jnp.asarray(holder, jnp.int32)),
        jnp.asarray(dst, jnp.int32), jnp.asarray(mask), jnp.asarray(dsi),
        jnp.asarray(sizes))
    got = PlannerState(_t(dol), _t(chain), _t(visited), _t(holder)
                       ).record_round(_t(dst), _t(mask), _t(dsi), _t(sizes))
    np.testing.assert_array_equal(got.dol.numpy(), np.asarray(want.dol))
    np.testing.assert_array_equal(got.chain_size.numpy(),
                                  np.asarray(want.chain_size))
    np.testing.assert_array_equal(got.visited.numpy(),
                                  np.asarray(want.visited))
    np.testing.assert_array_equal(got.holder.numpy(), np.asarray(want.holder))


def test_tensor_dol_math_matches_numpy_and_reference():
    """record_training, iid_distance_t and the candidate composite on
    tensors give the numpy control plane's bits, and the reference's."""
    n, m, c = 5, 4, 6
    rng = np.random.default_rng(1)
    dsi = rng.dirichlet(np.ones(c), n).astype(np.float32)
    sizes = rng.integers(50, 200, n).astype(np.float64)
    host, fstate = JState.init(m, n, c), PlannerState.init(m, n, c)
    jf = JPlannerState.init(m, n, c)
    for mi in range(m):
        host.record_training(mi, mi % n, dsi[mi % n], float(sizes[mi % n]))
        jf = jf.record_training(mi, mi % n, dsi[mi % n],
                                float(sizes[mi % n]))
        fstate = fstate.record_training(mi, mi % n, _t(dsi[mi % n]),
                                        float(sizes[mi % n]))
    np.testing.assert_array_equal(fstate.dol.numpy(), host.dol)
    np.testing.assert_array_equal(fstate.dol.numpy(), np.asarray(jf.dol))
    np.testing.assert_array_equal(fstate.holder.numpy(), host.holder)
    dol, chain, _, _, dsi2, sizes2, _, _ = _planner_state(4)
    np.testing.assert_array_equal(tdol.iid_distance_t(_t(dol)).numpy(),
                                  tdol.iid_distance(dol))
    np.testing.assert_array_equal(
        tdol.iid_distance_candidates_t(_t(dol), _t(chain), _t(dsi2),
                                       _t(sizes2)).numpy(),
        tdol.iid_distance_candidates(dol, chain, dsi2, sizes2))
    # functional() / update_from round-trip
    port = DiffusionState.init(m, n, c)
    port.update_from(fstate, rounds_advanced=1)
    np.testing.assert_array_equal(port.dol, host.dol)
    assert port.round_index == 1
    back = port.functional("cpu")
    assert torch.equal(back.dol, fstate.dol)
    assert back.holder.dtype == torch.int64


# ---------------------------------------------------------------- auction

@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("m", [3, 10, 20])
@pytest.mark.parametrize("n", [5, 10, 20])
def test_auction_assign_matches_reference(m, n, seed):
    """Same ``dst`` and ``converged`` as the reference's auction on
    matrices with non-positive, -inf and nan entries and exact ties."""
    rng = np.random.default_rng(100 * seed + 10 * m + n)
    w = rng.normal(size=(m, n)).astype(np.float32)
    if seed == 1:
        w = np.round(w, 1)                         # many exact ties
    w[rng.random((m, n)) < 0.1] = -np.inf
    w[rng.random((m, n)) < 0.05] = np.nan
    want_dst, want_ok = j_auction(jnp.asarray(w))
    stats = {}
    dst, ok = auction_assign(_t(w), stats=stats)
    np.testing.assert_array_equal(dst.numpy(), np.asarray(want_dst))
    assert bool(ok) == bool(want_ok)
    assert stats["auction_iterations"] > 0
    assert stats["auction_host_reads"] >= stats["auction_iterations"]


def test_auction_iteration_cap_reports_unconverged():
    w = np.random.default_rng(3).uniform(0.5, 1.0, (10, 10)).astype(
        np.float32)
    want_dst, want_ok = j_auction(jnp.asarray(w), max_iters=2)
    dst, ok = auction_assign(_t(w), max_iters=2)
    assert not bool(want_ok) and not bool(ok)
    np.testing.assert_array_equal(dst.numpy(), np.asarray(want_dst))


# ---------------------------------------------------------- _plan_rounds

def _kernel_test_inputs():
    """The inputs of tests/test_diffusion_kernels.py's in-loop check."""
    rng = np.random.default_rng(7)
    m, n, c, r = 3, 6, 5, 4
    return dict(
        dol0=rng.dirichlet(np.ones(c), size=m).astype(np.float32),
        chain_size0=rng.integers(50, 200, size=m).astype(np.float32),
        visited0=np.zeros((m, n), bool),
        holder0=np.arange(m),
        dsi=rng.dirichlet(np.ones(c), size=n).astype(np.float32),
        data_sizes=rng.integers(50, 200, size=n).astype(np.float32),
        gamma_seq=(1.0 + rng.random((r, n, n))).astype(np.float32),
        mean_snr=np.full((n, n), 10.0, np.float32),
        epsilon=0.01, gamma_min=0.5, outage_max=0.9,
        bandwidth_budget=1e9, model_bits=1e5)


def _default_config_inputs(seed):
    """N=M=C=10 planner inputs, as tests/test_planner_jax.py builds them."""
    n = m = c = 10
    rng = np.random.default_rng(seed)
    dsi = rng.dirichlet(np.ones(c) * 0.5, n).astype(np.float32)
    sizes = rng.integers(200, 800, n).astype(np.float64)
    state = _mkstate(JState, n, m, c, dsi, sizes)
    pos = JTopology().sample_positions(np.random.default_rng(seed + 50), n)
    planner = JPlanner()
    inp, _ = jplanner.plan_round_inputs(planner, state, dsi, sizes,
                                        np.random.default_rng(seed + 7),
                                        positions=pos)
    d = {k: np.asarray(v) for k, v in inp._asdict().items()
         if v is not None and k in tplanner.PlanInputs._fields}
    return {k: (float(v) if v.ndim == 0 else v) for k, v in d.items()}


def _run_both(d, values=None, weight=0.0):
    jin = jplanner.PlanInputs(
        **{k: (jnp.float32(v) if isinstance(v, float)
               else jnp.asarray(v, jnp.int32 if k == "holder0" else None))
           for k, v in d.items()},
        value=None if values is None else jnp.asarray(values, jnp.float32),
        value_weight=None if values is None else jnp.float32(weight))
    want = jplanner._plan_rounds(jin, metric="w1_norm",
                                 allow_retraining=False,
                                 use_value=values is not None)
    tin = tplanner.PlanInputs(
        **{k: (torch.tensor(v, dtype=torch.float32) if isinstance(v, float)
               else _t(v)) for k, v in d.items()},
        value=None if values is None else _t(values.astype(np.float32)),
        value_weight=weight)
    got = tplanner._plan_rounds(tin, metric="w1_norm",
                                allow_retraining=False)
    return want, got


@pytest.mark.parametrize("case", ["kernel_test", "default_0", "default_2"])
@pytest.mark.parametrize("fused", [False, True])
def test_plan_rounds_matches_reference(case, fused):
    d = (_kernel_test_inputs() if case == "kernel_test"
         else _default_config_inputs(int(case[-1])))
    n = d["dsi"].shape[0]
    values = (np.random.default_rng(5).uniform(size=n).astype(np.float32)
              if fused else None)
    want, got = _run_both(d, values, 0.7 if fused else 0.0)
    assert got.num_rounds == int(want.num_rounds) > 0
    np.testing.assert_array_equal(got.scheduled.numpy(),
                                  np.asarray(want.scheduled))
    np.testing.assert_array_equal(got.dst.numpy(), np.asarray(want.dst))
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(want.src))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               atol=1e-4)
    np.testing.assert_allclose(got.state.dol.numpy(),
                               np.asarray(want.state.dol), atol=1e-7)
    assert got.converged == bool(want.converged)


# ------------------------------------------------ DiffusionPlanner modes

def _mkstate(cls, n, m, c, dsi, sizes):
    state = cls.init(m, n, c)
    for mi in range(m):
        state.record_training(mi, mi % n, dsi[mi % n], float(sizes[mi % n]))
    return state


def _hoplist(plan):
    return [(h.model, h.src, h.dst, h.round_index) for h in plan.hops]


def _plan(planner, cls, seed, values=None, weight=0.0):
    n = m = c = 10
    rng = np.random.default_rng(seed)
    dsi = rng.dirichlet(np.ones(c) * 0.5, n).astype(np.float32)
    sizes = rng.integers(200, 800, n).astype(np.float64)
    pos = JTopology().sample_positions(np.random.default_rng(seed + 50), n)
    state = _mkstate(cls, n, m, c, dsi, sizes)
    plan = planner.plan_communication_round(
        state, dsi, sizes, np.random.default_rng(seed + 7), positions=pos,
        values=values, value_weight=weight)
    return plan, state


def _assert_same_plan(a, sa, b, sb):
    assert a.num_rounds == b.num_rounds > 0
    assert _hoplist(a) == _hoplist(b)
    for ha, hb in zip(a.hops, b.hops):
        assert ha.gamma == hb.gamma and ha.bandwidth == hb.bandwidth
    np.testing.assert_array_equal(sa.holder, sb.holder)
    np.testing.assert_array_equal(sa.visited, sb.visited)
    np.testing.assert_array_equal(sa.dol, sb.dol)
    assert sa.round_index == sb.round_index


@pytest.mark.parametrize("seed", range(3))
def test_device_planner_matches_reference_device_planner(seed):
    plan, state = _plan(DiffusionPlanner(mode="jax", device="cpu"),
                        DiffusionState, seed)
    ref, ref_state = _plan(JPlanner(mode="jax"), JState, seed)
    _assert_same_plan(plan, state, ref, ref_state)


@pytest.mark.parametrize("seed", [0, 2])
def test_device_planner_matches_host_planner(seed):
    """At seeds 0 and 2 the reference's two modes agree, and so do the
    port's (at seed 1 the auction and the Hungarian break a tie apart)."""
    dev, dev_state = _plan(DiffusionPlanner(mode="jax", device="cpu"),
                           DiffusionState, seed)
    host, host_state = _plan(DiffusionPlanner(), DiffusionState, seed)
    assert _hoplist(dev) == _hoplist(host)
    np.testing.assert_array_equal(dev_state.holder, host_state.holder)
    np.testing.assert_array_equal(dev_state.visited, host_state.visited)
    np.testing.assert_allclose(dev_state.dol, host_state.dol, rtol=3e-5,
                               atol=1e-7)


@pytest.mark.parametrize("mode", ["host", "jax"])
def test_planner_with_learning_values_matches_reference(mode):
    values = np.random.default_rng(11).uniform(size=10)
    kw = {"device": "cpu"} if mode == "jax" else {}
    plan, state = _plan(DiffusionPlanner(mode=mode, **kw), DiffusionState,
                        0, values, 0.5)
    ref, ref_state = _plan(JPlanner(mode=mode), JState, 0, values, 0.5)
    _assert_same_plan(plan, state, ref, ref_state)
    for a, b in zip(plan.hops, ref.hops):
        assert a.decrement == b.decrement
    plain, _ = _plan(DiffusionPlanner(mode=mode, **kw), DiffusionState, 0)
    assert _hoplist(plain) != _hoplist(plan)    # the values steer the plan


def test_device_planner_stats_and_device_default():
    planner = DiffusionPlanner(mode="jax", device="cpu")
    _plan(planner, DiffusionState, 0)
    s = planner.stats
    assert s["plans"] == 1 and s["seconds"] > 0.0
    assert s["loop_iterations"] >= 1
    assert s["auction_host_reads"] >= s["auction_iterations"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _plan(DiffusionPlanner(mode="jax"), DiffusionState, 0)
    planner.underlay = True
    with pytest.raises(ValueError, match="underlay"):
        tplanner.plan_communication_round_jax(
            planner, None, np.zeros((2, 2)), np.ones(2),
            np.random.default_rng(0))
