"""The port's scenario generator (``repro_torch.workloads``) against the
reference's.

Mirrors ``tests/test_workloads.py`` on the port's copy -- byte-identical
streams per seed, the component shapes (flash crowd, diurnal drift,
churn), engine pluggability on the port's CPU engine -- and holds every
scenario's batches byte for byte to the reference's (``GRID_SCENARIOS``
and ``flash_ramp``, at the skew grid's and at a larger size): both draw
from numpy's ``default_rng(seed)`` alone.
"""

import dataclasses

import numpy as np
import pytest

import repro.workloads as ref_workloads

pytest.importorskip("torch")

from repro_torch.engine import Engine  # noqa: E402
from repro_torch.engine.topology import OperatorSpec, Topology  # noqa: E402
from repro_torch.workloads import (  # noqa: E402
    GRID_SCENARIOS,
    Churn,
    Diurnal,
    FlashCrowd,
    ScenarioSpec,
    make_scenario,
    scenario_batches,
    scenario_schema,
    scenario_stream,
)
from repro_torch.workloads.scenarios import SCENARIO_DTYPE  # noqa: E402


def _concat(spec, ticks=24):
    """The stream's first ``ticks`` batches, flattened to comparable arrays."""
    ks, vs, ts = [], [], []
    for k, v, t in scenario_batches(spec, ticks):
        ks.append(k)
        vs.append(v)
        ts.append(t)
    return np.concatenate(ks), np.concatenate(vs), np.concatenate(ts)


# ------------------------------------------------------------- determinism
def test_equal_specs_yield_byte_identical_streams():
    spec = make_scenario("flash_crowd", rate=64.0, key_space=128, seed=9)
    a = _concat(spec)
    b = _concat(make_scenario("flash_crowd", rate=64.0, key_space=128, seed=9))
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()
    assert a[2].tobytes() == b[2].tobytes()


def test_different_seeds_differ():
    base = dict(rate=64.0, key_space=128)
    a = _concat(make_scenario("zipf", seed=1, **base))
    b = _concat(make_scenario("zipf", seed=2, **base))
    assert a[0].tobytes() != b[0].tobytes()


def test_stream_is_restartable_not_stateful():
    """Two independent iterators over the same spec agree tick by tick —
    generation must not lean on hidden global state."""
    spec = ScenarioSpec(rate=32.0, key_space=64, seed=3, churn=Churn(8))
    s1, s2 = scenario_stream(spec), scenario_stream(spec)
    for _ in range(12):
        (k1, v1, t1), (k2, v2, t2) = next(s1), next(s2)
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(t1, t2)


def test_hypothesis_property_seed_determinism():
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=20, deadline=None)
    @hypothesis.given(
        seed=st.integers(0, 2**31 - 1),
        rate=st.floats(0.0, 64.0, allow_nan=False),
        key_space=st.integers(1, 64),
        zipf_a=st.floats(0.0, 2.5, allow_nan=False),
        scenario=st.sampled_from(GRID_SCENARIOS),
    )
    def prop(seed, rate, key_space, zipf_a, scenario):
        spec = dataclasses.replace(
            make_scenario(scenario, rate=rate, key_space=key_space, seed=seed),
            zipf_a=zipf_a,
        )
        a = _concat(spec, ticks=6)
        b = _concat(spec, ticks=6)
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()
        assert a[2].tobytes() == b[2].tobytes()

    prop()


# ------------------------------------------------------------ batch contract
def test_batch_shapes_and_dtypes():
    keys, values, ts = _concat(ScenarioSpec(rate=64.0, key_space=32, seed=0))
    assert keys.dtype == np.int64
    assert values.dtype == SCENARIO_DTYPE
    assert ts.dtype == np.float64
    assert np.array_equal(values["entity"], keys)
    assert (keys >= 0).all() and (keys < 32).all()
    schema = scenario_schema()
    assert schema.value == SCENARIO_DTYPE


def test_spec_validation():
    with pytest.raises(ValueError, match="key_space"):
        ScenarioSpec(key_space=0)
    with pytest.raises(ValueError, match="rate"):
        ScenarioSpec(rate=-1.0)
    with pytest.raises(ValueError, match="zipf_a"):
        ScenarioSpec(zipf_a=-0.1)
    with pytest.raises(ValueError, match="unknown scenario"):
        make_scenario("tsunami")


# --------------------------------------------------------------- components
def test_flash_crowd_factor_step_ramp_duration():
    step = FlashCrowd(at_tick=10, ramp_ticks=0, duration=5)
    assert step.factor(9) == 0.0
    assert step.factor(10) == 1.0
    assert step.factor(14) == 1.0
    assert step.factor(15) == 0.0
    ramp = FlashCrowd(at_tick=0, ramp_ticks=4)
    assert [ramp.factor(t) for t in (0, 1, 2, 3, 4)] == [0.0, 0.25, 0.5, 0.75, 1.0]
    assert ramp.factor(1000) == 1.0  # duration=None → holds forever


def test_flash_crowd_raises_traffic_and_concentrates_it():
    base = dict(rate=256.0, key_space=64, zipf_a=0.5, seed=4)
    calm = ScenarioSpec(**base)
    surge = ScenarioSpec(flash=FlashCrowd(at_tick=0, hot_keys=1, boost=32.0), **base)
    n_calm = sum(len(k) for k, _, _ in scenario_batches(calm, 16))
    surge_keys = np.concatenate([k for k, _, _ in scenario_batches(surge, 16)])
    assert len(surge_keys) > 1.5 * n_calm  # a crowd adds traffic
    top_share = np.bincount(surge_keys).max() / len(surge_keys)
    assert top_share > 0.4  # and concentrates it on the boosted key


def test_diurnal_multipliers_rotate_across_cohorts():
    d = Diurnal(period_ticks=40.0, amplitude=0.6, cohorts=4)
    m0 = d.multipliers(0)
    assert m0.shape == (4,)
    assert (m0 >= 0.0).all()
    # half a period later the wave inverts: a different cohort leads
    m_half = d.multipliers(20)
    assert int(np.argmax(m0)) != int(np.argmax(m_half))
    np.testing.assert_allclose(d.multipliers(40), m0, atol=1e-12)


def test_churn_turns_over_the_alive_set():
    spec = ScenarioSpec(
        rate=128.0, key_space=64, zipf_a=0.0, churn=Churn(lifetime_ticks=4), seed=5
    )
    batches = scenario_batches(spec, 8)
    early = set(np.concatenate([k for k, _, _ in batches[:4]]).tolist())
    late = set(np.concatenate([k for k, _, _ in batches[4:]]).tolist())
    # phases are randomized, so the sets overlap — but neither contains the
    # other: some keys died and others were born across the half-lifetime
    assert early - late and late - early


# ------------------------------------------------------------- engine plug
def test_drive_scenario_feeds_an_engine():
    from repro_torch.workloads import drive_scenario

    def count(state, keys, values, ts):
        state["n"] = state.get("n", 0) + len(keys)
        return state, None

    t = Topology()
    t.add_operator(
        OperatorSpec(
            "src", None, num_keygroups=4, is_source=True, schema=scenario_schema()
        )
    )
    t.add_operator(OperatorSpec("count", count, num_keygroups=4, is_sink=True))
    t.connect("src", "count")
    eng = Engine(t, 2, service_rate=1e9, seed=0, device="cpu")
    spec = ScenarioSpec(rate=64.0, key_space=32, seed=6)
    accepted = drive_scenario(eng, "src", spec, 10)
    for _ in range(4):
        eng.tick()
    counted = sum(
        eng.store.get(kg).get("n", 0) for kg in range(t.kg_base(1), t.kg_base(1) + 4)
    )
    assert accepted > 0
    assert counted == accepted


# ------------------------------------------------------------- vs reference
def test_public_surface_matches_reference():
    import repro_torch.workloads as port_workloads

    assert port_workloads.__all__ == ref_workloads.__all__
    assert GRID_SCENARIOS == ref_workloads.GRID_SCENARIOS
    assert SCENARIO_DTYPE == ref_workloads.SCENARIO_DTYPE


@pytest.mark.parametrize(
    "rate,key_space,ticks", [(384.0, 2048, 40), (8192.0, 1 << 16, 20)], ids=["grid", "large"]
)
@pytest.mark.parametrize("name", GRID_SCENARIOS + ("flash_ramp",), ids=str)
def test_scenario_batches_byte_identical_to_reference(name, rate, key_space, ticks):
    """Every batch, tick by tick: keys, values and ts bytes and dtypes."""
    port = scenario_batches(make_scenario(name, rate=rate, key_space=key_space, seed=3), ticks)
    ref = ref_workloads.scenario_batches(
        ref_workloads.make_scenario(name, rate=rate, key_space=key_space, seed=3), ticks
    )
    assert len(port) == len(ref) == ticks
    assert sum(len(k) for k, _, _ in port) > 0
    for (pk, pv, pt), (rk, rv, rt) in zip(port, ref):
        for a, b in ((pk, rk), (pv, rv), (pt, rt)):
            assert a.dtype == b.dtype
            assert a.tobytes() == b.tobytes()


def test_hypothesis_property_matches_reference():
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=20, deadline=None)
    @hypothesis.given(
        seed=st.integers(0, 2**31 - 1),
        rate=st.floats(0.0, 64.0, allow_nan=False),
        key_space=st.integers(1, 64),
        zipf_a=st.floats(0.0, 2.5, allow_nan=False),
        scenario=st.sampled_from(GRID_SCENARIOS + ("flash_ramp",)),
    )
    def prop(seed, rate, key_space, zipf_a, scenario):
        kw = dict(rate=rate, key_space=key_space, seed=seed)
        port = dataclasses.replace(make_scenario(scenario, **kw), zipf_a=zipf_a)
        ref = dataclasses.replace(ref_workloads.make_scenario(scenario, **kw), zipf_a=zipf_a)
        a, b = _concat(port, ticks=6), _concat(ref, ticks=6)
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()

    prop()
