"""The port's serve loop against the reference's.

* ``DecodeWorker`` ticks: the same carried parameters and admitted
  sequences in both, step times patched to a fixed clock, then tokens,
  positions, occupancy, evictions and returned (tokens, seconds) compared
  tick by tick.  Tokens are compared in float32 (caches cast to float32 in
  both, since ``init_cache`` hard-wires bf16), where the two agree to
  ~1e-5 and no argmax is a near tie; in bf16 everything but the token
  values is compared.
* The serve loop: the reference's ``main()`` against the port's
  ``serve_loop`` with the same settings and ``max_migrations=0``, both
  clocks patched: every ``ClusterState`` handed to the controller and
  every log line agree.  (With migrations the reference cannot be followed:
  see below.)
* Migration: the port's ``extract``/``install`` move one slot's rows along
  the batch axis (axis 1 of the stacked ``scan`` leaves), bit for bit, and
  leave every other slot unchanged.  The reference's ``extract``
  (launch/serve.py:97) slices axis 0 of those leaves, which is the layer
  axis: ``test_reference_extract_slices_the_layer_axis`` pins that fault,
  which the port does not copy.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# CI's tier-1 job installs no torch: skip this module there, not fail collection.
torch = pytest.importorskip("torch")

import repro.launch.serve as ref_serve
from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params

import repro_torch.launch.serve as serve
from repro_torch.configs import get_config
from repro_torch.launch.serve import DecodeWorker, serve_loop, slot_rows
from repro_torch.models import init_params
from repro_torch.models.weights import to_torch

STEP_SECONDS = 2.0**-7  # exact in binary: every step time is the same float


class FixedClock:
    """Stands in for the ``time`` module: each call advances a fixed step."""

    def __init__(self):
        self._ticks = itertools.count()

    def perf_counter(self):
        return next(self._ticks) * STEP_SECONDS


@pytest.fixture
def fixed_clocks(monkeypatch):
    monkeypatch.setattr(ref_serve, "time", FixedClock())
    monkeypatch.setattr(serve, "time", FixedClock())


def _pair_of_workers(dtype, slots=4, seed=0):
    ref_cfg = dataclasses.replace(ref_get_config("glm4_9b", smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config("glm4_9b", smoke=True), dtype=dtype)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(seed))
    params = to_torch(jax.tree.map(np.asarray, ref_params))
    ref_w = ref_serve.DecodeWorker(0, ref_cfg, ref_params, slots, capacity=1.25)
    w = DecodeWorker(0, cfg, params, slots, capacity=1.25, device="cpu")
    if dtype == "float32":
        ref_w.cache = jax.tree.map(lambda a: a.astype(jnp.float32), ref_w.cache)
        w.cache = jax.tree.map(lambda t: t.float(), w.cache)
    return ref_w, w


def _admit(worker, slot, sid, prompt_len, token):
    worker.occupant[slot] = sid
    worker.positions[slot] = prompt_len
    worker.tokens[slot, 0] = token


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_worker_ticks_match_reference(dtype, fixed_clocks):
    ref_w, w = _pair_of_workers(dtype)
    for worker in (ref_w, w):
        _admit(worker, 0, 10, 5, 1)
        _admit(worker, 2, 11, 9, 7)
    targets = {10: 4, 11: 2}
    generated = {10: 0, 11: 0}
    for tick in range(5):
        if tick == 1:  # a late arrival fills slot 3
            for worker in (ref_w, w):
                _admit(worker, 3, 12, 3, 42)
            targets[12], generated[12] = 3, 0
        got_ref, got = ref_w.decode_tick(), w.decode_tick()
        assert got[0] == got_ref[0]
        assert got[1] == pytest.approx(got_ref[1], rel=1e-12)
        assert np.array_equal(w.positions, ref_w.positions)
        assert w.occupant == ref_w.occupant
        if dtype == "float32":
            assert np.array_equal(w.tokens, ref_w.tokens), tick
        else:  # bf16 ties may differ: keep the inputs identical
            w.tokens[:] = ref_w.tokens
        # Evict finished sequences, as the loop does.
        for slot in ref_w.active():
            sid = ref_w.occupant[slot]
            generated[sid] += 1
            if generated[sid] >= targets[sid]:
                ref_w.evict(slot)
                w.evict(slot)
    assert w.occupant == ref_w.occupant == [None] * 4
    assert w.free_slots() == ref_w.free_slots()


SERVE_SETTINGS = dict(ticks=30, workers=3, slots=4, arrival_rate=1.5, spl_ticks=10,
                      max_migrations=0, hetero=0.5, seed=0)


def _record_states(monkeypatch):
    """Patch both packages' AdaptationFramework to record every state."""
    states = {"ref": [], "port": []}

    def recording(cls, key):
        class Recording(cls):
            def adapt(self, state, **kw):
                states[key].append(state)
                return super().adapt(state, **kw)

        return Recording

    monkeypatch.setattr(ref_serve, "AdaptationFramework",
                        recording(ref_serve.AdaptationFramework, "ref"))
    monkeypatch.setattr(serve, "AdaptationFramework",
                        recording(serve.AdaptationFramework, "port"))
    return states


def _argv(arch, settings):
    argv = ["--arch", arch]
    for name, value in settings.items():
        argv += [f"--{name.replace('_', '-')}", str(value)]
    return argv


def _serve_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("[serve]")]


def _assert_same_states(states):
    assert len(states["port"]) == len(states["ref"]) == 3
    for port_state, ref_state in zip(states["port"], states["ref"]):
        for field in ("kg_operator", "kg_load", "alloc", "kg_state_bytes", "capacity",
                      "alive"):
            a, b = getattr(port_state, field), getattr(ref_state, field)
            assert np.array_equal(np.asarray(a), np.asarray(b)), field
        assert port_state.num_nodes == ref_state.num_nodes


def test_serve_loop_matches_reference_main(fixed_clocks, monkeypatch, capsys):
    settings = SERVE_SETTINGS
    states = _record_states(monkeypatch)
    monkeypatch.setattr("sys.argv", ["serve", *_argv("glm4_9b", settings)])
    ref_serve.main()
    ref_lines = _serve_lines(capsys.readouterr().out)

    cfg = get_config("glm4_9b", smoke=True)
    params = to_torch(jax.tree.map(
        np.asarray, ref_init_params(ref_get_config("glm4_9b", smoke=True),
                                    jax.random.PRNGKey(settings["seed"]))))
    lines = []
    stats = serve_loop(cfg, params, device="cpu", log=lines.append, **settings)

    assert lines == ref_lines
    _assert_same_states(states)
    assert stats.completed == int(ref_lines[-1].split()[2])
    assert stats.decode_tokens > 0 and stats.migrations == 0


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "moonshot_v1_16b_a3b", "xlstm_1_3b",
                                  "whisper_small"])
def test_serve_main_matches_reference_main(arch, fixed_clocks, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --device cpu``
    against the reference's ``main()``: the loop's bookkeeping (log lines,
    controller states) does not depend on the decoded values, so the two
    agree line for line -- though the reference's windowed decode is wrong
    past RecurrentGemma's window (ROADMAP queue 3), Whisper is served
    against an empty encoder in both, and the parameters differ (each
    package's own ``init_params``)."""
    states = _record_states(monkeypatch)
    argv = _argv(arch, SERVE_SETTINGS)
    monkeypatch.setattr("sys.argv", ["serve", *argv])
    ref_serve.main()
    ref_lines = _serve_lines(capsys.readouterr().out)
    serve.main(argv + ["--device", "cpu"])
    lines = _serve_lines(capsys.readouterr().out)
    assert lines == ref_lines and len(lines) == 4
    _assert_same_states(states)


def _fill(worker, seed):
    """Distinct random values in every cache leaf, deterministically."""
    g = torch.Generator().manual_seed(seed)
    for entry in worker.cache["scan"] + worker.cache["rem"]:
        for a in entry.values():
            a.copy_(torch.randn(a.shape, generator=g).to(a.dtype))


def test_migration_moves_one_slot_along_the_batch_axis():
    cfg = get_config("glm4_9b", smoke=True)
    params = init_params(cfg, 0, device="cpu")
    src = DecodeWorker(0, cfg, params, 4, device="cpu")
    dst = DecodeWorker(1, cfg, params, 4, device="cpu")
    _fill(src, 1)
    _fill(dst, 2)
    src.positions[2], src.tokens[2, 0] = 17, 99
    blob = src.extract(2)
    leaf = blob["cache"]["scan"][0]["k"]
    assert leaf.shape == (cfg.cycles, 1, cfg.max_seq_len, cfg.num_kv_heads,
                          cfg.resolved_head_dim)
    assert torch.equal(leaf[:, 0], src.cache["scan"][0]["k"][:, 2])
    before = slot_rows(dst.cache, 0), slot_rows(dst.cache, 3), slot_rows(dst.cache, 2)
    dst.install(1, blob, sid=5)
    assert dst.occupant[1] == 5 and dst.positions[1] == 17 and dst.tokens[1, 0] == 99
    for name in ("k", "v"):
        moved = dst.cache["scan"][0][name][:, 1]
        assert torch.equal(moved, src.cache["scan"][0][name][:, 2])
        for slot, rows in zip((0, 3, 2), before):
            assert torch.equal(dst.cache["scan"][0][name][:, slot],
                               rows["scan"][0][name][:, 0])


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "moonshot_v1_16b_a3b"])
def test_migration_moves_recurrent_ring_and_remainder_rows(arch):
    """Every leaf, whatever its rank: RG-LRU state ``h`` (cycles, slots, W)
    and ``conv`` (cycles, slots, 3, W), the LOCAL_ATTN ring, the MoE
    layers' k/v, and the remainder blocks' leaves (slot axis 0)."""
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, 0, device="cpu")
    src = DecodeWorker(0, cfg, params, 4, device="cpu")
    dst = DecodeWorker(1, cfg, params, 4, device="cpu")
    _fill(src, 3)
    _fill(dst, 4)
    blob = src.extract(1)
    before = {slot: slot_rows(dst.cache, slot) for slot in (0, 1, 3)}
    dst.install(2, blob, sid=9)
    ranks = set()
    for part, axis in (("scan", 1), ("rem", 0)):
        for i, entry in enumerate(dst.cache[part]):
            for name, a in entry.items():
                ranks.add((part, a.dim()))
                assert blob["cache"][part][i][name].shape[axis] == 1
                assert torch.equal(a.select(axis, 2), src.cache[part][i][name].select(axis, 1))
                for slot, rows in before.items():
                    assert torch.equal(a.select(axis, slot),
                                       rows[part][i][name].select(axis, 0))
    if arch == "recurrentgemma_2b":
        assert {("scan", 3), ("scan", 4), ("scan", 5), ("rem", 2), ("rem", 3)} <= ranks


def test_reference_extract_slices_the_layer_axis():
    """Documents the reference's fault (launch/serve.py:97, 105-109)."""
    cfg = ref_get_config("glm4_9b", smoke=True)
    params = ref_init_params(cfg, jax.random.PRNGKey(0))
    worker = ref_serve.DecodeWorker(0, cfg, params, 8)
    leaf = worker.cache["scan"][0]["k"]
    assert leaf.shape == (cfg.cycles, 8, cfg.max_seq_len, cfg.num_kv_heads,
                          cfg.resolved_head_dim)
    # extract(slot) takes rows along axis 0 -- layers, not slots.
    assert worker.extract(0)["cache"]["scan"][0]["k"].shape == (1, *leaf.shape[1:])
    assert worker.extract(3)["cache"]["scan"][0]["k"].shape == (0, *leaf.shape[1:])
