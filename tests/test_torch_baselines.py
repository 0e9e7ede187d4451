"""The port's baselines (``repro_torch.core.baselines``: Flux [36], PoTC
[29], COLA [21]) against the reference's.

Mirrors ``tests/test_baselines.py`` on the port's copies, each on a port
``ClusterState`` converted from ``conftest.make_cluster``'s reference one,
and holds every plan and every PoTC step equal to the reference's on the
same seeded state: allocations, migrations and their cost, load distance,
loads and split fractions.
"""

import numpy as np
import pytest

import repro.core.baselines as ref_baselines
from conftest import make_cluster

pytest.importorskip("torch")

import repro_torch.core.stats as port_stats  # noqa: E402
from repro_torch.core import solve_allocation  # noqa: E402
from repro_torch.core.baselines import (  # noqa: E402
    PotcSimulator,
    cola_allocate,
    flux_rebalance,
)


def to_port(state) -> port_stats.ClusterState:
    """The port's ``ClusterState`` holding copies of a reference one's arrays."""
    p = state.out_pairs
    return port_stats.ClusterState(
        num_nodes=state.num_nodes,
        capacity=state.capacity.copy(),
        kill=state.kill.copy(),
        alive=state.alive.copy(),
        kg_operator=state.kg_operator.copy(),
        kg_load=state.kg_load.copy(),
        kg_state_bytes=state.kg_state_bytes.copy(),
        alloc=state.alloc.copy(),
        out_pairs=port_stats.PairRates(
            p.src.copy(), p.dst.copy(), p.rate.copy(), p.num_keygroups
        ),
        downstream={k: list(v) for k, v in state.downstream.items()},
        kg_tuple_rate=None if state.kg_tuple_rate is None else state.kg_tuple_rate.copy(),
    )


def port_cluster(**kw) -> port_stats.ClusterState:
    return to_port(make_cluster(**kw))


def test_flux_respects_migration_cap():
    state = port_cluster(seed=0)
    plan = flux_rebalance(state, max_migrations=7)
    assert plan.num_migrations <= 7


def test_flux_reduces_imbalance():
    state = port_cluster(seed=1)
    plan = flux_rebalance(state, max_migrations=13)
    assert plan.load_distance <= state.load_distance() + 1e-9


def test_milp_beats_flux_given_same_budget():
    """The paper's §5.2.1 headline: MILP > Flux at equal maxMigrations."""
    wins = 0
    for seed in range(5):
        state = port_cluster(seed=seed)
        flux = flux_rebalance(state, max_migrations=13)
        milp = solve_allocation(state, max_migrations=13, time_limit=3.0)
        if milp.load_distance <= flux.load_distance + 1e-9:
            wins += 1
    assert wins >= 4, f"MILP only won {wins}/5"


def test_potc_runs_and_has_overhead():
    state = port_cluster(seed=2)
    sim = PotcSimulator(state)
    _, ld0 = sim.step(state.kg_load)
    for _ in range(5):
        loads, ld = sim.step(state.kg_load)
    assert np.isfinite(ld)
    # The merge step is a continuous overhead even in steady state (paper).
    assert sim.continuous_overhead > 0.0


def test_cola_collocation_quality():
    state = port_cluster(seed=3, one_to_one_frac=0.9)
    plan = cola_allocate(state)
    # From-scratch partitioning should collocate most 1-1 traffic...
    assert state.collocation_factor(plan.alloc) > state.collocation_factor() + 10
    # ...at the price of many migrations (paper Fig. 12 behaviour).
    assert plan.num_migrations > state.num_keygroups / 4


def test_cola_balanced():
    state = port_cluster(seed=4)
    plan = cola_allocate(state, balance_tol=0.15)
    loads = state.node_loads(plan.alloc)
    live = state.nodes_a
    assert loads[live].max() <= loads[live].mean() * 1.6 + 1.0


_PLAN_FIELDS = ("status", "solve_seconds", "load_distance", "migrations", "migration_cost")


def _same_plan(a, b):
    assert np.array_equal(a.alloc, b.alloc)
    for f in _PLAN_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_baselines_equal_reference_on_the_same_state(seed):
    """Flux and COLA plans and every PoTC step equal the reference's,
    bit for bit, on the same seeded cluster."""
    ref = make_cluster(seed=seed, one_to_one_frac=0.9 if seed == 3 else 0.5)
    port = to_port(ref)
    for budget in (1, 7, 13):
        _same_plan(
            flux_rebalance(port, max_migrations=budget),
            ref_baselines.flux_rebalance(ref, max_migrations=budget),
        )
    for tol, s in ((0.10, 0), (0.15, seed)):
        _same_plan(
            cola_allocate(port, balance_tol=tol, seed=s),
            ref_baselines.cola_allocate(ref, balance_tol=tol, seed=s),
        )
    sims = PotcSimulator(port, seed=seed), ref_baselines.PotcSimulator(ref, seed=seed)
    assert np.array_equal(sims[0].h1, sims[1].h1)
    assert np.array_equal(sims[0].h2, sims[1].h2)
    rng = np.random.default_rng(seed)
    for _ in range(6):
        kg_load = ref.kg_load * rng.uniform(0.5, 1.5, ref.num_keygroups)
        (pl, pd), (rl, rd) = sims[0].step(kg_load), sims[1].step(kg_load)
        assert pl.tobytes() == rl.tobytes()
        assert pd == rd
        assert sims[0].split_frac.tobytes() == sims[1].split_frac.tobytes()
    assert sims[0].continuous_overhead == sims[1].continuous_overhead
