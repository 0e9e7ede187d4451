"""The port's checkpoints (``repro_torch.checkpoint``, no jax) against the
reference's.

Mirrors ``tests/test_checkpoint_atomicity.py`` on the port's
:class:`CheckpointManager`: a writer SIGKILLed before the rename commit or
mid-stage never corrupts the latest restorable checkpoint, and a fresh
manager prunes the stage it left.  Beyond it: round trips of numpy and torch
leaves (bfloat16 and float8 included, with ``ml_dtypes`` unimportable),
``keep`` retention, ``save_async`` (torch leaves snapshotted at the call),
the layout shared with the reference (``MANIFEST.json`` and ``arrays.npz``
leaf for leaf; ``treedef.pkl`` is each package's own), and the engine
payload both ways: a reference ``EngineCheckpointer`` checkpoint restores a
port engine to the state the reference's ``restore_engine`` gives a
reference engine, and a port checkpoint restores a reference engine the
same way (states, routing table, window, cursors equal).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import signal
import sys
import time

import numpy as np
import pytest

from conformance import normalize

torch = pytest.importorskip("torch")

import repro.data.jobs as ref_jobs  # noqa: E402
import repro.data.synthetic as ref_synthetic  # noqa: E402
import repro.engine as ref_engine  # noqa: E402
from repro.checkpoint.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.engine import checkpointing as ref_ckpt  # noqa: E402

import repro_torch.data.jobs as port_jobs  # noqa: E402
import repro_torch.data.synthetic as port_synthetic  # noqa: E402
import repro_torch.engine as port_engine  # noqa: E402
from repro_torch.checkpoint import checkpoint as port_ck  # noqa: E402
from repro_torch.checkpoint.checkpoint import MANIFEST, CheckpointManager  # noqa: E402
from repro_torch.engine import checkpointing as port_ckpt  # noqa: E402

_ctx = mp.get_context("fork")


def _tree(step: int) -> dict:
    return {"w": np.full(8, float(step)), "bias": np.arange(3) + step}


# ---------------------------------------------------------------------------
# Crash-during-checkpoint atomicity (tests/test_checkpoint_atomicity.py)
# ---------------------------------------------------------------------------


def _wedged_writer(directory: str, staged, wedge: str, api: str) -> None:
    """Child body: start writing step 2, signal, then hang until SIGKILL
    (``"rename"``: at the commit; ``"treedef"``: mid-stage, before the
    manifest, which is written last)."""

    def hang(*a, **k):
        staged.set()
        time.sleep(600)

    if wedge == "rename":
        port_ck.os.rename = hang
    else:
        port_ck.pickle.dump = hang
    mgr = CheckpointManager(directory, keep=3)
    if api == "save":
        mgr.save(2, _tree(2), metadata={"ingest_cursor": 2})
    else:
        mgr.save_async(2, _tree(2), metadata={"ingest_cursor": 2})
        mgr.wait()


def _kill_mid_save(directory: str, wedge: str, api: str) -> None:
    staged = _ctx.Event()
    child = _ctx.Process(target=_wedged_writer, args=(directory, staged, wedge, api))
    child.start()
    try:
        assert staged.wait(timeout=30.0), "writer never reached the wedge"
        os.kill(child.pid, signal.SIGKILL)
    finally:
        child.join(timeout=30.0)
    assert child.exitcode == -signal.SIGKILL


@pytest.mark.parametrize("api", ["save", "save_async"])
def test_kill_before_commit_restores_previous_checkpoint(tmp_path, api):
    directory = str(tmp_path / "ck")
    mgr = CheckpointManager(directory, keep=3)
    mgr.save(1, _tree(1), metadata={"ingest_cursor": 1})

    _kill_mid_save(directory, "rename", api)

    stages = [n for n in os.listdir(directory) if n.endswith(".tmp")]
    assert len(stages) == 1
    assert os.path.exists(os.path.join(directory, stages[0], MANIFEST))
    assert mgr.steps() == [1]

    healed = CheckpointManager(directory, keep=3)
    assert not [n for n in os.listdir(directory) if n.endswith(".tmp")]
    assert healed.steps() == [1]
    tree, meta = healed.restore()
    assert meta["step"] == 1
    assert meta["ingest_cursor"] == 1
    np.testing.assert_array_equal(tree["w"], _tree(1)["w"])
    np.testing.assert_array_equal(tree["bias"], _tree(1)["bias"])


def test_kill_mid_stage_leaves_no_manifest_and_restores_previous(tmp_path):
    directory = str(tmp_path / "ck")
    mgr = CheckpointManager(directory, keep=3)
    mgr.save(1, _tree(1), metadata={"ingest_cursor": 1})

    _kill_mid_save(directory, "treedef", "save")

    stages = [n for n in os.listdir(directory) if n.endswith(".tmp")]
    assert len(stages) == 1
    assert not os.path.exists(os.path.join(directory, stages[0], MANIFEST))

    healed = CheckpointManager(directory, keep=3)
    assert not [n for n in os.listdir(directory) if n.endswith(".tmp")]
    assert healed.steps() == [1]
    tree, meta = healed.restore()
    assert meta["step"] == 1
    np.testing.assert_array_equal(tree["w"], _tree(1)["w"])


def test_kill_with_no_prior_checkpoint_restores_nothing(tmp_path):
    directory = str(tmp_path / "ck")
    CheckpointManager(directory, keep=3)

    _kill_mid_save(directory, "rename", "save")

    healed = CheckpointManager(directory, keep=3)
    assert healed.steps() == []
    assert healed.latest_step() is None
    with pytest.raises(FileNotFoundError):
        healed.restore()


# ---------------------------------------------------------------------------
# Leaves, retention, async, layout
# ---------------------------------------------------------------------------


def _mixed_tree():
    g = torch.Generator().manual_seed(0)
    return {
        "layers": [
            {"w": torch.randn(4, 8, generator=g).to(torch.bfloat16),
             "b": torch.randn(8, generator=g)},
            {"w": torch.randn(4, 8, generator=g).to(torch.bfloat16),
             "b": torch.randn(8, generator=g)},
        ],
        "f8": torch.randn(6, generator=g).to(torch.float8_e4m3fn),
        "ids": torch.arange(5, dtype=torch.int64),
        "host": (np.arange(6, dtype=np.int32).reshape(2, 3), np.float64(2.5)),
        "skip": None,
        "step": 7,
    }


def _assert_same_tree(a, b):
    if isinstance(a, dict):
        assert list(a) == sorted(b)  # restored in sorted-key order
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif a is None:
        assert b is None
    elif isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.device.type == "cpu"
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    else:
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


def test_round_trip_numpy_and_torch_leaves_without_ml_dtypes(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # import now raises
    tree = _mixed_tree()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, tree, metadata={"note": "x"})
    back, meta = mgr.restore()
    assert meta == {"step": 3, "note": "x"}
    _assert_same_tree(back, tree)
    assert back["layers"][0]["w"].dtype == torch.bfloat16
    assert isinstance(back["host"][0], np.ndarray) and back["skip"] is None


def test_layout_matches_the_reference_leaf_for_leaf(tmp_path):
    """Same dict-key leaf order (sorted, as jax.tree.flatten), same npz
    arrays, bf16 as a uint16 view: the npz of either package holds the
    same arrays; the manifests carry the same metadata."""
    import ml_dtypes

    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    ref_tree = {"z": np.arange(4), "a": w.astype(ml_dtypes.bfloat16), "m": w}
    port_tree = {"z": np.arange(4), "a": torch.from_numpy(w).to(torch.bfloat16), "m": w}
    RefManager(str(tmp_path / "ref")).save(1, ref_tree, metadata={"k": 1})
    CheckpointManager(str(tmp_path / "port")).save(1, port_tree, metadata={"k": 1})
    arrays = []
    for side in ("ref", "port"):
        d = tmp_path / side / "step_0000000001"
        assert sorted(os.listdir(d)) == ["MANIFEST.json", "arrays.npz", "treedef.pkl"]
        with np.load(d / "arrays.npz") as z:
            arrays.append([z[k] for k in z.files])
        with open(d / "MANIFEST.json") as f:
            assert json.load(f)["metadata"] == {"step": 1, "k": 1}
    (ref_a, port_a) = arrays
    assert len(ref_a) == len(port_a) == 3
    for x, y in zip(ref_a, port_a):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert port_a[0].dtype == np.uint16  # "a": the bf16 leaf, first in order


def test_params_and_adamw_state_match_the_reference_leaf_for_leaf(tmp_path):
    """A trainer checkpoint, ``(params, AdamWState)``: the reference
    flattens its registered dataclass in field order (step, m, v), the port
    describes it so; the two npz files hold equal leaves in the same order,
    and the port's round-trips (the dataclass restored, bf16 included)."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro.optim import AdamW as RefAdamW
    from repro_torch.models.weights import to_torch
    from repro_torch.optim import AdamW, AdamWState

    rng = np.random.default_rng(2)
    host = {"w": rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16),
            "blocks": [{"z": rng.standard_normal((2, 5)).astype(np.float32),
                        "a": rng.standard_normal(5).astype(ml_dtypes.bfloat16)}]}
    grads = {"w": np.full((3, 4), 0.01, np.float32),
             "blocks": [{"z": np.full((2, 5), -0.02, np.float32),
                         "a": np.full(5, 0.03, np.float32)}]}
    ref_p = jax.tree.map(jnp.asarray, host)
    _, ref_state = RefAdamW().update(jax.tree.map(jnp.asarray, grads), RefAdamW().init(ref_p),
                                     ref_p)
    port_p = to_torch(host)
    _, port_state = AdamW().update(to_torch(grads), AdamW().init(port_p), port_p)
    RefManager(str(tmp_path / "ref")).save(4, (ref_p, ref_state))
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(4, (port_p, port_state))
    arrays = []
    for side in ("ref", "port"):
        with np.load(tmp_path / side / "step_0000000004" / "arrays.npz") as z:
            arrays.append([z[k] for k in z.files])
    assert len(arrays[0]) == len(arrays[1]) == 3 + 1 + 3 + 3  # params, step, m, v
    for x, y in zip(*arrays):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    (params, state), meta = mgr.restore()
    assert meta == {"step": 4} and isinstance(state, AdamWState)
    _assert_same_tree(params, port_p)
    assert int(state.step) == 1 and state.step.dtype == torch.int32
    _assert_same_tree(state.m, port_state.m)
    _assert_same_tree(state.v, port_state.v)
    assert params["w"].dtype == torch.bfloat16


def test_keep_retention_prunes_after_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(step))
        assert mgr.steps() == list(range(max(1, step - 1), step + 1))
    tree, meta = mgr.restore(step=3)
    assert meta["step"] == 3
    np.testing.assert_array_equal(tree["w"], _tree(3)["w"])
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=1)


def test_save_async_snapshots_torch_leaves_at_the_call(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=3)
    t = torch.arange(6, dtype=torch.float32)
    tree = {"t": t, "n": np.arange(3)}
    mgr.save_async(5, tree, metadata={"ingest_cursor": 5})
    t.add_(100.0)  # after the call: must not reach the write
    mgr.wait()
    assert mgr.latest_step() == 5
    back, meta = mgr.restore()
    assert meta == {"step": 5, "ingest_cursor": 5}
    assert torch.equal(back["t"], torch.arange(6, dtype=torch.float32))
    np.testing.assert_array_equal(back["n"], np.arange(3))
    mgr.save_async(6, {"t": t})
    mgr.save_async(7, {"t": t})  # waits for the pending write first
    mgr.wait()
    assert mgr.steps() == [5, 6, 7]


# ---------------------------------------------------------------------------
# The engine payload, across the packages
# ---------------------------------------------------------------------------

_KGS = 6
_NODES = 3


def _engines(kind, directory=None):
    """A reference or port ``.typed()`` engine on Real Job 3 with its feed."""
    jobs, synth, eng_mod = {
        "ref": (ref_jobs, ref_synthetic, ref_engine),
        "port": (port_jobs, port_synthetic, port_engine),
    }[kind]
    cfg = eng_mod.ExecutionConfig.typed()
    if directory is not None:
        cfg = cfg.replace(checkpoint=eng_mod.config.CheckpointPolicy(str(directory), every=1))
    kw = {} if kind == "ref" else {"device": "cpu"}
    eng = eng_mod.Engine(
        jobs.real_job_3(keygroups_per_op=_KGS), _NODES, config=cfg,
        service_rate=400.0, seed=0, **kw,
    )
    feed = synth.airline_stream(synth.StreamSpec(rate=80.0, seed=5))
    return eng, feed


def _drive(eng, feed, ticks):
    for _ in range(ticks):
        k, v, ts = next(feed)
        eng.push_source("airline", k, v, ts)
        eng.tick()


def _engine_view(eng):
    win = eng.window
    pairs = win.pair_counts()
    return {
        "states": [normalize(s) for _, s in eng.store.items()],
        "table": eng.router.table.tolist(),
        "usage": {r: u.tolist() for r, u in win.kg_usage.items()},
        "arrivals": win.kg_arrivals.tolist(),
        "pairs": (pairs.src.tolist(), pairs.dst.tolist(), pairs.rate.tolist()),
        "samples": int(win.samples),
        "ticks_this_period": eng._ticks_this_period,
        "ingest_cursor": eng.ingest_cursor,
        "queue_costs": eng.queue_costs(),
    }


def _npz_tree(directory):
    """The payload leaf of the newest checkpoint, read from arrays.npz (the
    layout both packages share; treedef.pkl is each package's own)."""
    steps = sorted(n for n in os.listdir(directory) if n.startswith("step_"))
    with np.load(os.path.join(directory, steps[-1], "arrays.npz")) as z:
        return {"payload_u8": z[z.files[0]]}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_engine_payload_restores_the_other_package(tmp_path, writer):
    """A checkpoint written by ``writer``'s engine (periodic, through its
    EngineCheckpointer) restores a reference and a port engine to equal
    state; both then continue alike."""
    eng, feed = _engines(writer, tmp_path / "ck")
    _drive(eng, feed, 5)
    eng.end_period()  # every=1: commits a checkpoint after the fold
    _drive(eng, feed, 3)
    # Park a key group's queued runs (a push queues the source's runs; a
    # redirect without install parks them) so the envelope carries a
    # backlog, and checkpoint mid-period by hand.
    k, v, ts = next(feed)
    eng.push_source("airline", k, v, ts)
    kg = int(eng.topology.keygroups_of(0, k, v)[0])
    eng.redirect(kg, (eng.router.node_of(kg) + 1) % _NODES)
    assert eng._backlog[kg]
    eng._checkpointer.save(eng)
    tree = _npz_tree(str(tmp_path / "ck"))
    ref_payload = ref_ckpt.payload_from_tree(tree)
    port_payload = port_ckpt.payload_from_tree(tree)
    assert ref_payload["ingest_cursor"] == port_payload["ingest_cursor"] == 9
    assert ref_payload["table"][kg] == eng.router.table[kg]
    ref_eng, ref_feed = _engines("ref")
    port_eng, port_feed = _engines("port")
    ref_ckpt.restore_engine(ref_eng, ref_payload)
    port_ckpt.restore_engine(port_eng, port_payload)
    assert _engine_view(port_eng) == _engine_view(ref_eng)
    assert port_eng._backlog == {} and any(port_eng.queue_costs())
    for f in (ref_feed, port_feed):
        for _ in range(9):
            next(f)
    _drive(ref_eng, ref_feed, 3)
    _drive(port_eng, port_feed, 3)
    assert port_eng.metrics.sink_outputs == ref_eng.metrics.sink_outputs
    assert _engine_view(port_eng) == _engine_view(ref_eng)


def _drain(eng, max_ticks=60):
    for _ in range(max_ticks):
        if not any(eng.queue_costs()):
            return
        eng.tick()
    raise AssertionError("engine failed to quiesce")


def test_periodic_checkpoint_cadence_and_restore(tmp_path):
    """The port engine's ``CheckpointPolicy(every=2)``: a commit every second
    ``end_period``, keyed by the cumulative tick count, ``keep`` newest kept;
    an engine restored from the latest continues exactly as the original
    (each period drains first: queued tuples at a cut are the loss bound)."""
    policy = port_engine.CheckpointPolicy(str(tmp_path / "ck"), every=2, keep=2)
    cfg = port_engine.ExecutionConfig(checkpoint=policy)
    assert cfg.name == "soa+seg+schema+ckpt2"
    eng = port_engine.Engine(port_jobs.real_job_3(keygroups_per_op=_KGS), _NODES,
                             config=cfg, service_rate=400.0, seed=0, device="cpu")
    feed = port_synthetic.airline_stream(port_synthetic.StreamSpec(rate=80.0, seed=5))
    commits = []
    for p in range(5):
        _drive(eng, feed, 3)
        _drain(eng)
        eng.end_period()
        if p % 2:
            commits.append(eng.metrics.ticks)
    assert CheckpointManager(policy.directory).steps() == commits[-2:]
    payload, meta = eng._checkpointer.latest_payload()
    assert meta["ingest_cursor"] == 12 and payload["ticks"] == commits[-1]
    assert meta["period"] == 4
    # The original ran one more period past the cut: rewind it too.
    restored = port_engine.Engine(port_jobs.real_job_3(keygroups_per_op=_KGS), _NODES,
                                  service_rate=400.0, seed=3, device="cpu")
    port_ckpt.restore_engine(restored, payload)
    port_ckpt.restore_engine(eng, payload)
    assert _engine_view(restored) == _engine_view(eng)
    tail = [next(feed) for _ in range(4)]
    marks = []
    for e in (eng, restored):
        marks.append(len(e.metrics.sink_outputs))
        for k, v, ts in tail:
            e.push_source("airline", k, v, ts)
            e.tick()
        _drain(e)
    assert eng.metrics.sink_outputs[marks[0]:] == restored.metrics.sink_outputs[marks[1]:]
    assert _engine_view(restored) == _engine_view(eng)
