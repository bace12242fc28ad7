"""The paper's Appendix-C knobs and Lemmas 1–2 in the port, against ``repro``.

* XLA-CPU's float32 log (``xla_log``/``xla_log_t``) bit for bit against
  ``jnp.log``: every float32 of one binade, random mantissas at every
  exponent from 2^-41 to 2^1 (the metrics clip at 1e-12), zeros, subnormals
  and the specials;
* ``xla_cumsum`` against ``jnp.cumsum`` (chunks of 16 beyond 16 entries);
* the IID metrics' host forms against the reference's eager
  ``iid_distance`` / ``iid_distance_candidates`` bit for bit at C = 10 and
  100 (and 3, 20, 33); their tensor forms against the reference's jitted
  ``iid_distance`` and its jitted bid expression ``iid − dol_bid_scores``,
  the planner's;
* the device planner's and the host planner's hop lists against the
  reference's ``mode="jax"`` and ``mode="host"`` for each metric;
* ``ops.bid_fused`` routing (the composite for the Appendix-C metrics);
* Lemma 1 / Corollary 1 / Lemma 2 / Eq. (27) helpers bit for bit on
  ``tests/test_core_dol.py``'s cases;
* underlay, gossip and retrainable FedDif runs (both planes) against the
  reference's runs from its init: ledgers equal, params within atol 2e-4 /
  rtol 2e-3, accuracy within 0.05; the phase profile's keys.
"""
import dataclasses
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channels.topology import CellTopology as JTopology
from repro.core import DiffusionPlanner as JPlanner
from repro.core import DiffusionState as JState
from repro.core import dol as jdol
from repro.core.auction import AuctionConfig as JAuction
from repro.fl import ExperimentSpec as JSpec
from repro.fl import FLConfig as JConfig
from repro.fl import run_experiment as j_run
from repro.fl.models import build_task_model as j_build
from repro.kernels import ref as jref
from repro_torch.core import dol as tdol
from repro_torch.core.auction import AuctionConfig
from repro_torch.core.diffusion import DiffusionPlanner
from repro_torch.core.dol import DiffusionState
from repro_torch.fl import (ExperimentSpec, FLConfig, params_from_numpy,
                            params_to_numpy, run_experiment)
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

METRICS = ("kld", "jsd", "w1_true")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _assert_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ------------------------------------------------------------ XLA's log

def _binade(e):
    lo = np.float32(2.0 ** e).view(np.int32)
    hi = np.float32(2.0 ** (e + 1)).view(np.int32)
    return np.arange(lo, hi, dtype=np.int32).view(np.float32)


def test_xla_log_every_float_of_a_binade():
    """All 2^23 float32 in [0.5, 1): the numpy and the tensor emulation."""
    x = _binade(-1)
    want = np.asarray(jnp.log(x))
    _assert_bits(tdol.xla_log(x), want)
    _assert_bits(tdol.xla_log_t(torch.from_numpy(x)).numpy(), want)


def test_xla_log_every_exponent_the_metrics_reach():
    """65,536 random mantissas at each exponent 2^-41 … 2^1, the range of
    ``clip(p, 1e-12, 1)`` and of ``1 + SNR`` at the planner's links."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (np.float32(2.0 ** e).view(np.int32) + rng.integers(
            0, 1 << 23, 65536, dtype=np.int32)).view(np.float32)
        for e in range(-41, 2)])
    want = np.asarray(jnp.log(x))
    _assert_bits(tdol.xla_log(x), want)
    _assert_bits(tdol.xla_log_t(torch.from_numpy(x)).numpy(), want)


def test_xla_log_special_values():
    x = np.array([0.0, 1e-45, 1e-40, 1.1754942e-38, 1e-12, 1.0, 2.0, 1e30,
                  np.inf, -0.0, -1.0, np.nan, 0.5993075, 0.16572084],
                 np.float32)
    want = np.asarray(jnp.log(x))
    _assert_bits(tdol.xla_log(x), want)
    _assert_bits(tdol.xla_log_t(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("n", [1, 10, 16, 17, 100, 256])
def test_xla_cumsum_matches_jnp(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(6, n)).astype(np.float32)
    want = np.asarray(jnp.cumsum(x, axis=-1))
    _assert_bits(tdol.xla_cumsum(x), want)
    _assert_bits(tdol.xla_cumsum_t(torch.from_numpy(x)).numpy(), want)
    if n >= 100:      # the chunked order is not the sequential one
        assert not np.array_equal(_bits(np.cumsum(x, -1)), _bits(want))


# ---------------------------------------------------------------- metrics

def _simplex(rng, shape, c, zeros=True):
    p = rng.dirichlet(np.full(c, 0.3), size=shape).astype(np.float32)
    if zeros:                      # empty classes hit the 1e-12 clip
        p[..., 0] = np.where(rng.random(shape) < 0.3, 0.0, p[..., 0])
    return p


@pytest.mark.parametrize("c", [3, 10, 20, 33, 100])
@pytest.mark.parametrize("metric", METRICS + ("w1_norm",))
def test_host_metrics_equal_reference_eager(metric, c):
    rng = np.random.default_rng(c)
    for shape in ((8,), (8, 8), (3, 5)):
        p = _simplex(rng, shape, c)
        _assert_bits(tdol.iid_distance(p, metric),
                     jdol.iid_distance(jnp.asarray(p), metric))


@pytest.mark.parametrize("c", [10, 100])
@pytest.mark.parametrize("metric", METRICS)
def test_host_candidates_equal_reference_eager(metric, c):
    rng = np.random.default_rng(c + 1)
    dol = _simplex(rng, (8,), c)
    chain = rng.integers(0, 2000, 8).astype(np.float32)
    chain[0] = 0.0
    dsi = _simplex(rng, (10,), c)
    sizes = rng.integers(50, 600, 10).astype(np.float32)
    _assert_bits(tdol.iid_distance_candidates(dol, chain, dsi, sizes, metric),
                 jdol.iid_distance_candidates(dol, chain, dsi, sizes, metric))


@pytest.mark.parametrize("c", [10, 17, 18, 20, 24, 32, 100])
@pytest.mark.parametrize("metric", METRICS)
def test_tensor_metrics_equal_reference_jit(metric, c):
    """``iid_distance_t`` gives the bits of the reference's jitted
    ``iid_distance`` (the class sums in XLA's compiled forms: a chain of
    fused multiply-adds, eight or four lanes and a tree with an epilogue
    after it (jsd at C = 18 and 20), or windows past 32)."""
    rng = np.random.default_rng(c + 2)
    for shape in ((8,), (10,), (20,)):
        p = _simplex(rng, shape, c)
        want = jax.jit(partial(jdol.iid_distance, metric=metric))(p)
        _assert_bits(tdol.iid_distance_t(torch.from_numpy(p), metric).numpy(),
                     want)
        if metric != "w1_true" and c <= 16:    # it is not the eager form
            assert not np.array_equal(_bits(tdol.iid_distance(p, metric)),
                                      _bits(want))


def _bid_inputs(rng, m, n, c):
    dol = _simplex(rng, (m,), c)
    chain = rng.integers(0, 500, m).astype(np.float32)
    chain[0] = 0.0
    dsi = _simplex(rng, (n,), c, zeros=False)
    sizes = rng.integers(50, 500, n).astype(np.float32)
    return dol, chain, dsi, sizes


def _jit_bids(dol, chain, dsi, sizes, metric):
    return jdol.iid_distance(dol, metric)[:, None] - jref.dol_bid_scores_ref(
        dol, chain, dsi, sizes, metric)


@pytest.mark.parametrize("c", [5, 10, 11, 13, 14, 15, 16, 17, 18, 20, 24,
                               32, 100])
@pytest.mark.parametrize("metric", METRICS)
def test_tensor_bids_match_reference_planner_expression(metric, c):
    """The device planner's bids (``ops.bid_fused`` on the CPU, given the
    model distances in the bid expression's forms, ``site="bid_iid"``, as
    the planner gives them) against the reference's jitted bid expression,
    bit for bit (the vectorized client loop at N = 4 and 8, the scalar one
    at every other N); jsd at C = 24 and 32 too since ROADMAP C7's
    probes, and jsd at 11, 13–16, 18 and 20 and kld at 20 since its pairwise
    probes read the lane forms (``core/dol.py::_LANE_SUMS``)."""
    rng = np.random.default_rng(c + 3)
    for m, n in ((8, 8), (10, 10), (20, 20), (6, 4), (5, 2)):
        args = _bid_inputs(rng, m, n, c)
        want = np.asarray(jax.jit(partial(_jit_bids, metric=metric))(*args))
        t = [torch.from_numpy(a) for a in args]
        got = tops.bid_fused(tdol.iid_distance_t(t[0], metric,
                                                 site="bid_iid"),
                             *t, metric=metric).numpy()
        _assert_bits(got, want)


# kld's bid expression at C = 100 where XLA-CPU splits the (M, N, C)
# candidate fusion over both M and N for its threads (on an 8-thread host
# ``outer_dimension_partitions`` [3, 2] at M = 4, N = 28 or 32): the last
# partition contracts D_i·d_i, as the port does, the other five D_{k−1}·ψ
# (ROADMAP C7).  The largest gap measured there, 1–2 ulps of the bids.
_C7_PARTITIONED_GAP = 1.2e-7


def _partitioned_over_m_and_n(args, metric) -> bool:
    """Whether XLA-CPU splits the bid expression's candidate fusion over
    both of its outer dimensions on this host."""
    hlo = jax.jit(partial(_jit_bids, metric=metric)).lower(
        *args).compile().as_text()
    return any(line.count('"outer_dimension_partitions":["') == 1
               and '","' in line.split("outer_dimension_partitions")[1]
               for line in hlo.splitlines() if "add_multiply_fusion =" in line)


@pytest.mark.parametrize("m,n", [(4, 16), (4, 28), (4, 32), (32, 32),
                                 (8, 64)])
def test_kld_bids_at_100_classes_by_partitioning(m, n):
    """kld bids at C = 100 against the reference's jitted bid expression:
    bit for bit where XLA-CPU partitions the candidate fusion over M alone
    (or not at all), within _C7_PARTITIONED_GAP where it splits M and N."""
    rng = np.random.default_rng(m * 100 + n)
    args = _bid_inputs(rng, m, n, 100)
    want = np.asarray(jax.jit(partial(_jit_bids, metric="kld"))(*args))
    t = [torch.from_numpy(a) for a in args]
    got = tops.bid_fused(tdol.iid_distance_t(t[0], "kld"), *t,
                         metric="kld").numpy()
    if _partitioned_over_m_and_n(args, "kld"):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_C7_PARTITIONED_GAP)
    else:
        _assert_bits(got, want)


def test_ops_bid_fused_refuses_other_metrics():
    """The Appendix-C metrics do not reach the ``bid_fused`` kernel: on
    either device they take the composite (the candidate Eq. 2, the
    metric, the subtraction, the value factor), as the reference routes
    them; an unknown metric is refused."""
    rng = np.random.default_rng(7)
    t = [torch.from_numpy(a) for a in _bid_inputs(rng, 4, 8, 6)]
    value = torch.from_numpy(rng.random(8).astype(np.float32))
    for metric in METRICS:
        iid = tdol.iid_distance_t(t[0], metric)
        want = iid[:, None] - tref.dol_bid_scores_ref(*t, metric)
        got = tops.bid_fused(iid, *t, metric=metric)
        assert torch.equal(got, want)
        assert torch.equal(tops.dol_bid_scores(*t, metric=metric),
                           tref.dol_bid_scores_ref(*t, metric))
        assert torch.equal(tops.bid_fused(iid, *t, value, 0.5, metric=metric),
                           tref.bid_value_fuse_ref(want, value, 0.5))
    with pytest.raises(ValueError, match="unknown IID metric"):
        tops.bid_fused(iid, *t, metric="l2")


# ---------------------------------------------------- planners, per metric

def _mkstate(cls, n, m, c, dsi, sizes):
    state = cls.init(m, n, c)
    for mi in range(m):
        h = int(state.holder[mi])
        state.record_training(mi, h, dsi[h], float(sizes[h]))
    return state


def _plan(planner, cls, seed, c=10, n=8):
    rng = np.random.default_rng(seed)
    dsi = rng.dirichlet(np.ones(c) * 0.5, n).astype(np.float32)
    sizes = rng.integers(200, 800, n).astype(np.float64)
    pos = JTopology().sample_positions(np.random.default_rng(seed + 50), n)
    state = _mkstate(cls, n, n, c, dsi, sizes)
    return planner.plan_communication_round(
        state, dsi, sizes, np.random.default_rng(seed + 7), positions=pos)


def _hops(plan):
    return [(h.model, h.src, h.dst, h.round_index, h.gamma, h.bandwidth)
            for h in plan.hops]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", ["host", "jax"])
def test_planner_hop_lists_match_reference(metric, mode):
    """Both planner modes, each against the reference's same mode, on two
    seeds at (N, M, C) = (8, 8, 10) and one at (10, 10, 100)."""
    for seed, c, n in ((0, 10, 8), (1, 10, 8), (4, 100, 10)):
        kw = dict(epsilon=0.02)
        want = _plan(JPlanner(auction=JAuction(metric=metric), mode=mode,
                              **kw), JState, seed, c, n)
        got = _plan(DiffusionPlanner(auction=AuctionConfig(metric=metric),
                                     mode=mode, device="cpu", **kw),
                    DiffusionState, seed, c, n)
        assert got.num_rounds == want.num_rounds > 0
        assert _hops(got) == _hops(want)
        _assert_bits(got.final_iid_distance, want.final_iid_distance)


def test_auction_matching_matches_reference():
    """``auction_matching``: the numpy wrapper of the auction, pair list for
    pair list the reference's, forbidden edges at −inf."""
    from repro.core.matching import auction_matching as j_match
    from repro_torch.core.matching import auction_matching
    rng = np.random.default_rng(3)
    for m, n in ((4, 6), (8, 8), (10, 12)):
        w = rng.random((m, n)).astype(np.float32)
        w[w < 0.2] = 0.0
        forbid = rng.random((m, n)) < 0.15
        assert auction_matching(w, forbid) == j_match(w, forbid)
        assert auction_matching(w) == j_match(w)


# ---------------------------------------------------------- Lemmas 1–2

def test_uniform_dol_and_dsi_from_counts():
    for c in (3, 8, 10, 100):
        _assert_bits(tdol.uniform_dol(c), jdol.uniform_dol(c))
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 50, (6, 10)).astype(np.float32)
    counts[2] = 0.0                       # an empty client → uniform
    for x in (counts, counts[0], rng.integers(0, 9, (3, 4, 40))):
        _assert_bits(tdol.dsi_from_counts(x), jdol.dsi_from_counts(x))


def test_optimal_dsi_and_feasibility_bound():
    """``test_optimal_dsi_lemma1_drives_dol_to_uniform``'s cases."""
    rng = np.random.default_rng(0)
    for _ in range(10):
        dol = rng.dirichlet(np.ones(6)).astype(np.float32)
        chain = float(rng.uniform(100, 1000))
        dmin = tdol.min_feasible_data_size(dol, chain)
        _assert_bits(dmin, jdol.min_feasible_data_size(jnp.asarray(dol),
                                                       chain))
        di = float(dmin) + float(rng.uniform(10, 100))
        dstar = tdol.optimal_dsi(dol, chain, di)
        _assert_bits(dstar, jdol.optimal_dsi(jnp.asarray(dol), chain, di))
        new, _ = tdol.update_dol(dol, chain, dstar, di)
        assert float(tdol.iid_distance(new)) < 1e-5
    dols = rng.dirichlet(np.ones(10), 4).astype(np.float32)
    chains = rng.uniform(0, 900, 4).astype(np.float32)
    _assert_bits(tdol.min_feasible_data_size(dols, chains),
                 jdol.min_feasible_data_size(dols, chains))
    _assert_bits(tdol.optimal_dsi(dols, chains, np.float32(40.0)),
                 jdol.optimal_dsi(dols, chains, 40.0))


def test_closed_form_iid_distance_lemma2():
    """``test_closed_form_iid_distance_lemma2``'s case, and a batch."""
    rng = np.random.default_rng(1)
    c = 5
    dol = rng.dirichlet(np.ones(c)).astype(np.float32)
    chain = 500.0
    di = float(tdol.min_feasible_data_size(dol, chain)) + 50.0
    dstar = tdol.optimal_dsi(dol, chain, di)
    phi = rng.normal(0, 1, c).astype(np.float32)
    phi -= phi.mean()
    new, total = tdol.update_dol(dol, chain, dstar + phi / di, di)
    closed = tdol.closed_form_iid_distance(phi, total)
    _assert_bits(closed, jdol.closed_form_iid_distance(jnp.asarray(phi),
                                                       total))
    assert float(tdol.iid_distance(new)) == pytest.approx(float(closed),
                                                          rel=1e-3, abs=1e-5)
    for c in (5, 10, 40):
        phis = rng.normal(0, 3, (7, c)).astype(np.float32)
        tot = rng.uniform(1, 900, 7).astype(np.float32)
        _assert_bits(tdol.closed_form_iid_distance(phis, tot),
                     jdol.closed_form_iid_distance(phis, tot))


def test_entropy_equals_reference():
    rng = np.random.default_rng(3)
    u = tdol.uniform_dol(10)
    _assert_bits(tdol.entropy(u), jdol.entropy(jnp.asarray(u)))
    for _ in range(20):
        p = rng.dirichlet(np.ones(10)).astype(np.float32)
        _assert_bits(tdol.entropy(p), jdol.entropy(jnp.asarray(p)))
        assert float(tdol.entropy(p)) <= float(tdol.entropy(u)) + 1e-5
    batch = _simplex(rng, (4, 6), 100)
    _assert_bits(tdol.entropy(batch), jdol.entropy(jnp.asarray(batch)))


# --------------------------------------------------------------- FL runs

def _specs(executor="host", planner="host", **kw):
    fl = dict(rounds=2, num_clients=6, num_models=6, seed=0, topology_seed=3)
    fl.update(kw)
    data = dict(task="fcn", alpha=0.3, num_samples=900)
    return (JSpec(fl=JConfig(executor=executor, planner=planner, **fl),
                  **data),
            ExperimentSpec(fl=FLConfig(executor=executor, planner=planner,
                                       **fl), **data))


def run_both(executor="host", planner="host", **kw):
    """The reference's run and the port's from the reference's init."""
    j_spec, t_spec = _specs(executor, planner, **kw)
    with warnings.catch_warnings():     # the reference's legacy engine fields
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = j_run(j_spec)
    init = jax.tree.map(np.asarray, j_build("fcn").init(
        jax.random.PRNGKey(0)))
    port = run_experiment(t_spec, device="cpu",
                          init_fn=lambda gen: params_from_numpy(init))
    return ref, port


def assert_runs_match(ref, port):
    assert port.ledger.as_dict() == ref.ledger.as_dict()
    assert port.diffusion_rounds == ref.diffusion_rounds
    np.testing.assert_allclose(port.iid_distance, ref.iid_distance,
                               atol=1e-6)
    for a, b in zip(jax.tree.leaves(ref.final_params),
                    jax.tree.leaves(params_to_numpy(port.final_params))):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), atol=2e-4,
                                   rtol=2e-3)
    np.testing.assert_allclose(port.accuracy, ref.accuracy, atol=0.05)


@pytest.mark.parametrize("executor,kw", [
    ("host", dict(strategy="feddif", underlay=True)),
    ("fleet", dict(strategy="feddif", underlay=True)),
    ("host", dict(strategy="gossip")),
    ("host", dict(strategy="feddif", allow_retraining=True,
                  max_diffusion_rounds=4)),
], ids=["underlay-host", "underlay-fleet", "gossip", "retrainable"])
def test_appendix_runs_match_reference(executor, kw):
    assert_runs_match(*run_both(executor, **kw))


@pytest.mark.parametrize("metric", ["jsd", "kld"])
def test_device_planner_metric_runs_match_reference(metric):
    """FedDif with ``planner="jax"`` and an Appendix-C metric on the fleet
    plane: the reference's ``mode="jax"`` run, ledger for ledger."""
    assert_runs_match(*run_both("fleet", "jax", strategy="feddif",
                                metric=metric))


def test_underlay_charges_more_subframes_than_overlay():
    """Appendix C-F: the co-channel CUEs lower the D2D SINR, so the same
    run in underlay mode charges more sub-frames (the reference's
    ``tests/test_fl_system.py`` bar)."""
    _, over = _specs(strategy="feddif", rounds=2)
    _, under = _specs(strategy="feddif", rounds=2, underlay=True)
    a = run_experiment(over, device="cpu")
    b = run_experiment(under, device="cpu")
    assert b.ledger.subframes > a.ledger.subframes


def test_device_planner_refuses_the_underlay():
    with pytest.raises(ValueError, match="underlay"):
        DiffusionPlanner(mode="jax", underlay=True)
    _, spec = _specs("fleet", "jax", strategy="feddif", underlay=True)
    with pytest.raises(ValueError, match="underlay"):
        run_experiment(spec, device="cpu")


@pytest.mark.parametrize("executor,keys", [
    ("fleet", {"train", "hop_collective", "mix", "plan"}),
    ("host", {"plan"})])
def test_phase_profile_keys(executor, keys):
    """``profile_phases``: one dict per round; the fleet plane's executor
    times its train / hop / mix primitives, the host plane reports the
    server's plan seconds only, as in the reference."""
    _, spec = _specs(executor, strategy="feddif", profile_phases=True)
    res = run_experiment(spec, device="cpu")
    assert len(res.phase_s) == 2
    for ph in res.phase_s:
        assert set(ph) == keys
        assert all(v >= 0.0 for v in ph.values())
    plain = run_experiment(dataclasses.replace(
        spec, fl=dataclasses.replace(spec.fl, profile_phases=False)),
        device="cpu")
    assert plain.phase_s == []
    assert plain.ledger.as_dict() == res.ledger.as_dict()
