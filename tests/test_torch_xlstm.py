"""The port's xLSTM (``repro_torch.models.xlstm``) against the reference.

Parameters are the reference's own (``init_from_specs`` / ``init_params``
from a PRNG key), carried to torch bit for bit by ``to_torch``; inputs are
drawn with numpy.  SMOKE size, on the CPU.

Tolerances (``tests/test_torch_models.py``'s):

* float32: ``F32_TOL`` (atol = rtol = 2e-4), atol scaled by the largest
  magnitude of the compared values where it exceeds 1, as
  ``tests/test_torch_train.py`` does for gradients.  The packages differ
  only in the order of their sums (the port's chunk is batched matmuls
  over (batch, head), the reference's einsums).
* bfloat16 (the config's own dtype): ``BF16_TOL`` (atol 0.75, rtol 0.15,
  ``tests/test_models.py:105-106``) on decode logits, plus the argmax.

The reference's multi-chunk mLSTM contracts its carried state with the
wrong index (Cᵀq, ``src/repro/models/xlstm.py:150-152``; its decode step
computes C q, ``:209``), so past the first 256-token chunk its forward
departs from its own recurrent decode.  The port computes C q.  Past 256
tokens the port's forward is held against both packages' recurrent decode,
which agree; ``test_reference_mlstm_carry_contracts_the_value_index`` pins
the reference's departure.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# CI's tier-1 job installs no torch: skip this module there, not fail collection.
torch = pytest.importorskip("torch")

import repro.launch.train as ref_train  # noqa: E402
import repro.models.xlstm as ref_xlstm  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models.common import init_from_specs as ref_init_from_specs  # noqa: E402
from repro.models.kvcache import init_cache as ref_init_cache  # noqa: E402

import repro_torch.launch.train as port_train  # noqa: E402
import repro_torch.models.xlstm as xlstm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import DecodeWorker, slot_rows  # noqa: E402
from repro_torch.models import Model, init_params, make_serve_step, make_train_step  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten  # noqa: E402
from repro_torch.models.kvcache import init_cache  # noqa: E402
from repro_torch.models.transformer import param_specs  # noqa: E402
from repro_torch.models.weights import to_torch  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_torch_models.py:55
#: Past a few hundred tokens (256-token chunks, positions up to 511) the
#: port's f32 logits are further than F32_TOL's 2e-4 from the same in
#: float64, and within half of LONG_TOL's atol of them
#: (``test_long_tol_is_above_the_f32_rounding_floor``).  The planted fault
#: (the carry read as Cᵀq) moves the logits by more than 0.5.
LONG_TOL = dict(atol=2e-3, rtol=2e-4)
BF16_TOL = dict(atol=0.75, rtol=0.15)  # tests/test_models.py:105-106
ARCH = "xlstm_1_3b"


def _configs(dtype=None, **kw):
    ref, port = ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    if dtype is not None:
        kw["dtype"] = dtype
    return dataclasses.replace(ref, **kw), dataclasses.replace(port, **kw)


def _carried(ref_cfg, seed):
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_params, to_torch(jax.tree.map(np.asarray, ref_params))


def _block_params(specs_fn, seed):
    ref_cfg, cfg = _configs("float32")
    ref_p = ref_init_from_specs(specs_fn(ref_cfg), jax.random.PRNGKey(seed), jnp.float32)
    return ref_cfg, cfg, ref_p, to_torch(jax.tree.map(np.asarray, ref_p))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=F32_TOL):
    """``tol``, its atol scaled by the largest magnitude of ``want`` where
    that exceeds 1 (a block's output reaches ~50, an mLSTM state ~100:
    F32_TOL's atol is for values of order one)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol["atol"] * scale, rtol=tol["rtol"])


def _assert_tree_close(port_tree, ref_tree, tol=F32_TOL):
    ref_leaves, port_leaves = jax.tree.leaves(ref_tree), tree_leaves(port_tree)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, tol)



def _assert_argmax_where_clear(got, want):
    """bf16 logits' argmax agrees on every row whose top-2 margin exceeds
    twice the measured difference (chip_smoke.py's rule): bf16 matmuls sum
    in an order that depends on the CPU's thread count, so a near tie may
    break either way from run to run."""
    got, want = got[:, 0], want[:, 0]
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * np.abs(got - want).max()
    assert np.array_equal(got[clear].argmax(-1), want[clear].argmax(-1))

# ---------------------------------------------------------------------------
# (a) the blocks, f32, at one chunk (where the reference is right)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [12, 256])
def test_mlstm_chunk_parallel_matches_reference_f32(s):
    ref_cfg, cfg, ref_p, p = _block_params(ref_xlstm.mlstm_specs, seed=5)
    x = _x(cfg, 2, s, seed=6)
    ref_h, ref_state = ref_xlstm.mlstm_chunk_parallel(ref_cfg, ref_p, jnp.asarray(x))
    h, state = xlstm.mlstm_chunk_parallel(cfg, p, torch.from_numpy(x))
    assert h.shape == (2, s, cfg.num_heads, cfg.d_model // cfg.num_heads)
    _close(h, ref_h)
    for a, b in zip(state, ref_state):
        _close(a, b)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("s", [12, 256])
def test_block_output_and_built_state_match_reference_f32(kind, s):
    specs = {"mlstm": ref_xlstm.mlstm_specs, "slstm": ref_xlstm.slstm_specs}[kind]
    ref_cfg, cfg, ref_p, p = _block_params(specs, seed=7)
    x = _x(cfg, 2, s, seed=8)
    ref_y, ref_cache = getattr(ref_xlstm, f"{kind}_block")(ref_cfg, ref_p, jnp.asarray(x))
    y, cache = getattr(xlstm, f"{kind}_block")(cfg, p, torch.from_numpy(x))
    _close(y, ref_y)
    assert list(cache) == list(ref_cache)
    _assert_tree_close(cache, ref_cache)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_step_from_a_given_state_matches_reference_f32(kind):
    """One recurrent step from a random state (the mLSTM's m, the sLSTM's
    m and n kept in the gates' range); the port updates the state in
    place."""
    specs = {"mlstm": ref_xlstm.mlstm_specs, "slstm": ref_xlstm.slstm_specs}[kind]
    ref_cfg, cfg, ref_p, p = _block_params(specs, seed=9)
    rng = np.random.default_rng(10)
    b, d, h = 2, cfg.d_model, cfg.num_heads
    hd = d // h
    if kind == "mlstm":
        state = {"C": rng.standard_normal((b, h, hd, hd)), "n": rng.standard_normal((b, h, hd)),
                 "m": rng.standard_normal((b, h))}
    else:
        state = {"c": rng.standard_normal((b, d)), "n": rng.uniform(0.5, 2.0, (b, d)),
                 "h": rng.standard_normal((b, d)), "m": rng.standard_normal((b, d))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    x = _x(cfg, b, 1, seed=11)
    ref_y, ref_new = getattr(ref_xlstm, f"{kind}_block")(
        ref_cfg, ref_p, jnp.asarray(x), cache={k: jnp.asarray(v) for k, v in state.items()})
    cache = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    y, new = getattr(xlstm, f"{kind}_block")(cfg, p, torch.from_numpy(x), cache=cache)
    assert new is cache
    _close(y, ref_y)
    _assert_tree_close(new, ref_new)


def test_chunk_constraint_raises_like_the_reference():
    """A sequence longer than a chunk must be a whole number of chunks:
    257 to 511 tokens raise in both packages."""
    ref_cfg, cfg, ref_p, p = _block_params(ref_xlstm.mlstm_specs, seed=5)
    x = _x(cfg, 1, 300, seed=6)
    with pytest.raises(AssertionError):
        ref_xlstm.mlstm_chunk_parallel(ref_cfg, ref_p, jnp.asarray(x))
    with pytest.raises(ValueError, match="256-token chunks"):
        xlstm.mlstm_chunk_parallel(cfg, p, torch.from_numpy(x))


# ---------------------------------------------------------------------------
# (b), (c) past the first chunk
# ---------------------------------------------------------------------------

PREFIX, TOTAL = 256, 512


def _teacher_forced(model, params, cache, toks, step, convert):
    """Decode ``toks[:, PREFIX:]`` one by one from ``cache``: (B, n, V)."""
    out = []
    for pos in range(PREFIX, TOTAL):
        logits, cache = step(params, cache, convert(toks[:, pos : pos + 1]),
                             convert(np.full((toks.shape[0],), pos, np.int32)))
        out.append(np.asarray(logits[:, 0], np.float32))
    return np.stack(out, axis=1)


@pytest.fixture(scope="module")
def past_one_chunk():
    """Both packages' logits over 512 tokens of SMOKE xLSTM in f32: the
    full forwards, and teacher-forced decode from a 256-token prefill."""
    ref_cfg, cfg = _configs("float32")
    ref_params, params = _carried(ref_cfg, seed=2)
    toks = _tokens(cfg, 2, TOTAL, seed=3)
    ref_model = RefModel(ref_cfg)
    ref_full = np.asarray(ref_model.forward(ref_params, tokens=jnp.asarray(toks))[0])
    _, ref_cache, _ = ref_model.forward(ref_params, tokens=jnp.asarray(toks[:, :PREFIX]),
                                        build_cache=True)
    ref_dec = _teacher_forced(ref_model, ref_params, ref_cache, toks,
                              jax.jit(ref_model.decode_step), jnp.asarray)
    model = Model(cfg)
    full = model.forward(params, tokens=torch.from_numpy(toks))[0].numpy()
    _, cache, _ = model.forward(params, tokens=torch.from_numpy(toks[:, :PREFIX]),
                                build_cache=True)
    dec = _teacher_forced(model, params, cache, toks, model.decode_step,
                          lambda a: torch.from_numpy(a))
    return dict(ref_full=ref_full, ref_dec=ref_dec, full=full, dec=dec)


def test_forward_past_one_chunk_matches_recurrent_decode_f32(past_one_chunk):
    """(b): positions 256-511 of the port's 512-token (two-chunk) forward
    against its own recurrent decode and the reference's, at LONG_TOL; the
    two decodes agree too, and the first chunk equals the reference's
    forward."""
    r = past_one_chunk
    np.testing.assert_allclose(r["full"][:, PREFIX:], r["dec"], **LONG_TOL)
    np.testing.assert_allclose(r["full"][:, PREFIX:], r["ref_dec"], **LONG_TOL)
    np.testing.assert_allclose(r["dec"], r["ref_dec"], **LONG_TOL)
    np.testing.assert_allclose(r["full"][:, :PREFIX], r["ref_full"][:, :PREFIX], **LONG_TOL)


def test_forward_past_one_chunk_equals_recurrent_decode_f64():
    """The port alone in float64 (its recurrences keep float64 inputs in
    float64; the norms and the logits stay float32): the two-chunk forward
    and the recurrent decode agree to 1e-5 at positions 256-511, where the
    f32 comparison needs LONG_TOL.  With the carry read as Cᵀq (the
    reference's contraction) the same check fails by more than 0.5."""
    import repro_torch.configs.base as base

    _, cfg = _configs("float64")
    assert base.torch_dtype("float64") == torch.float64
    params = tree_map(lambda t: t.double(), init_params(get_config(ARCH, smoke=True), 4,
                                                        device="cpu"))
    toks = torch.from_numpy(_tokens(cfg, 2, TOTAL, seed=5))
    model = Model(cfg)
    full = model.forward(params, tokens=toks)[0][:, PREFIX:]
    _, cache, _ = model.forward(params, tokens=toks[:, :PREFIX], build_cache=True)
    assert cache["scan"][0]["C"].dtype == torch.float64
    dec = _teacher_forced(model, params, cache, toks.numpy(), model.decode_step,
                          lambda a: torch.from_numpy(a))
    np.testing.assert_allclose(full.numpy(), dec, atol=1e-5, rtol=1e-5)
    saved = xlstm.carry_readout
    xlstm.carry_readout = lambda q, c: q @ c
    try:
        faulty = model.forward(params, tokens=toks)[0][:, PREFIX:]
    finally:
        xlstm.carry_readout = saved
    assert np.abs(faulty.numpy() - dec).max() > 0.5


def test_long_tol_is_above_the_f32_rounding_floor(past_one_chunk):
    """LONG_TOL's ground: the port's f32 forward over 512 tokens is within
    half of LONG_TOL's atol of the same in float64 (parameters cast up),
    and more than F32_TOL's 2e-4 away from it somewhere."""
    _, cfg = _configs("float64")
    params = tree_map(lambda t: t.double(), _carried(_configs("float32")[0], seed=2)[1])
    toks = _tokens(cfg, 2, TOTAL, seed=3)
    full64 = Model(cfg).forward(params, tokens=torch.from_numpy(toks))[0].numpy()
    floor = np.abs(past_one_chunk["full"] - full64).max()
    assert 2e-4 < floor < LONG_TOL["atol"] / 2


def test_reference_mlstm_carry_contracts_the_value_index(past_one_chunk):
    """(c): the reference's fault.  Its forward reads the carried state as
    Cᵀq (``xlstm.py:150-152``) where its decode reads C q (``:209``): at
    position 256, the first token of the second chunk, its forward departs
    from its own prefill-plus-decode by more than 0.5 in logits of
    magnitude ~5, while the port's forward does not."""
    r = past_one_chunk
    ref_gap = np.abs(r["ref_full"][:, PREFIX] - r["ref_dec"][:, 0]).max()
    assert ref_gap > 0.5
    assert np.abs(r["full"][:, PREFIX] - r["dec"][:, 0]).max() < LONG_TOL["atol"]
    # ... and the reference is right within its first chunk.
    np.testing.assert_allclose(r["ref_full"][:, :PREFIX], r["full"][:, :PREFIX], **LONG_TOL)


# ---------------------------------------------------------------------------
# (d) the model: forward, built cache, decode, gradients
# ---------------------------------------------------------------------------


def test_param_tree_matches_reference():
    ref_cfg, cfg = _configs()
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = init_params(cfg, 0, device="cpu")
    shapes = tree_map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), params)
    assert shapes == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref_params)
    # to_torch carries every xLSTM leaf bit for bit (bf16 as its raw bits).
    carried = to_torch(jax.tree.map(np.asarray, ref_params))
    for got, want in zip(tree_leaves(carried), jax.tree.leaves(ref_params)):
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(want).view(
            np.int16).tobytes()


def test_full_width_size():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size) == (48, 2048, 4, 50_304)
    specs = tree_leaves(param_specs(cfg), is_leaf=lambda x: hasattr(x, "initializer"))
    assert sum(int(np.prod(spec.shape)) for spec in specs) == 1_943_425_360  # the config's own estimate: 1,716,498,432


@pytest.mark.parametrize("s", [12, 256])
def test_forward_cache_and_decode_match_reference_f32(s):
    ref_cfg, cfg = _configs("float32")
    ref_params, params = _carried(ref_cfg, seed=2)
    b = 2
    toks = _tokens(cfg, b, s, seed=3)
    ref_logits, ref_cache, _ = RefModel(ref_cfg).forward(
        ref_params, tokens=jnp.asarray(toks), build_cache=True, cache_capacity=s + 8)
    logits, cache, aux = Model(cfg).forward(
        params, tokens=torch.from_numpy(toks), build_cache=True, cache_capacity=s + 8)
    assert float(aux) == 0.0
    _close(logits, ref_logits)
    _assert_tree_close(cache, ref_cache)
    assert cache["scan"][0]["C"].shape == (cfg.cycles, b, cfg.num_heads, 32, 32)
    for step, nxt in enumerate((7, 11)):
        pos = np.full((b,), s + step, np.int32)
        tok = np.full((b, 1), nxt, np.int32)
        ref_dec, ref_cache = RefModel(ref_cfg).decode_step(
            ref_params, ref_cache, jnp.asarray(tok), jnp.asarray(pos))
        dec, cache = Model(cfg).decode_step(params, cache, torch.from_numpy(tok),
                                            torch.from_numpy(pos))
        _close(dec, ref_dec)
        _assert_tree_close(cache, ref_cache)


def test_decode_step_on_init_cache_matches_reference_bf16():
    ref_cfg, cfg = _configs()
    ref_params, params = _carried(ref_cfg, seed=1)
    b = 2
    ref_cache = ref_init_cache(ref_cfg, b, 64)
    cache = init_cache(cfg, b, 64, device="cpu")
    serve = make_serve_step(cfg)
    toks = _tokens(cfg, b, 3, seed=8)
    for step in range(3):
        tok = toks[:, step : step + 1]
        pos = np.array([step, step + 5], np.int32)
        ref_logits, ref_cache = RefModel(ref_cfg).decode_step(
            ref_params, ref_cache, jnp.asarray(tok), jnp.asarray(pos))
        logits, cache = serve(params, cache, torch.from_numpy(tok), torch.from_numpy(pos))
        ref_np = np.asarray(ref_logits, np.float32)
        np.testing.assert_allclose(logits.numpy(), ref_np, **BF16_TOL)
        _assert_argmax_where_clear(logits.numpy(), ref_np)


@pytest.mark.parametrize("s", [12, 256])
def test_loss_and_every_gradient_match_reference_f32(s):
    """``Model.loss`` and each parameter leaf's gradient against
    ``jax.value_and_grad`` of the reference's loss (F32_TOL at 12 tokens,
    LONG_TOL at 256; atol scaled by the leaf's largest magnitude), through
    the remat'd cycles."""
    ref_cfg, cfg = _configs("float32")
    ref_params, params = _carried(ref_cfg, seed=0)
    toks = _tokens(cfg, 2, s + 1, seed=1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ref_loss, ref_grads = jax.value_and_grad(RefModel(ref_cfg).loss)(
        ref_params, jax.tree.map(jnp.asarray, batch))
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = Model(cfg).loss(tree_unflatten(params, live),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, live)
    tol = F32_TOL if s < 256 else LONG_TOL
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), **tol)
    for got, want in zip(grads, jax.tree.leaves(ref_grads)):
        _close(got, want, tol)


def test_train_step_changes_every_leaf():
    """In float32: in bf16 a first step of lr 1e-3 leaves the leaves that
    start at 1 (``b_f``, the norms' scales) at 1, in both packages."""
    _, cfg = _configs("float32")
    params = init_params(cfg, 0, device="cpu")
    opt = AdamW(learning_rate=1e-3)
    toks = torch.from_numpy(_tokens(cfg, 2, 17, seed=3))
    new, state, metrics = make_train_step(cfg, opt)(
        params, opt.init(params), {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    for old, leaf in zip(tree_leaves(params), tree_leaves(new)):
        assert leaf.dtype == old.dtype and not torch.equal(leaf, old)


# ---------------------------------------------------------------------------
# (f) migration of the recurrent states, (h) the trainer
# ---------------------------------------------------------------------------


def test_migration_moves_every_xlstm_state_row():
    """``C``, ``n``, ``m`` (mLSTM) and ``c``, ``n``, ``h``, ``m`` (sLSTM):
    one slot's rows along the batch axis (axis 1 of the stacked leaves),
    bit for bit, the destination's other slots unchanged."""
    cfg = get_config(ARCH, smoke=True)
    params = init_params(cfg, 0, device="cpu")
    src, dst = (DecodeWorker(w, cfg, params, 4, device="cpu") for w in (0, 1))
    g = torch.Generator().manual_seed(3)
    for worker in (src, dst):
        for entry in worker.cache["scan"]:
            for a in entry.values():
                a.copy_(torch.randn(a.shape, generator=g).to(a.dtype))
    blob = src.extract(1)
    before = {slot: slot_rows(dst.cache, slot) for slot in (0, 1, 3)}
    dst.install(2, blob, sid=9)
    names = set()
    for i, entry in enumerate(dst.cache["scan"]):
        for name, a in entry.items():
            names.add((name, a.dim()))
            assert torch.equal(a[:, 2], src.cache["scan"][i][name][:, 1])
            for slot, rows in before.items():
                assert torch.equal(a[:, slot], rows["scan"][i][name][:, 0])
    assert names == {("C", 5), ("n", 4), ("m", 3), ("c", 3), ("n", 3), ("h", 3), ("m", 3)}


def test_trainer_period_matches_reference(monkeypatch, tmp_path):
    """(h): one period of ``train.main --arch xlstm_1_3b`` (seq-len 16, one
    chunk) from the reference's parameters: the losses at F32_TOL and the
    period's shard assignment equal (both trainers on counting clocks, as
    in tests/test_torch_train.py)."""
    import itertools
    import sys

    class Clock:
        def __init__(self):
            self._t = itertools.count()

        def perf_counter(self):
            return float(next(self._t))

    seen = {"losses": [], "assignments": [], "params": None}

    class Recording(ref_train.AdaptationFramework):
        def adapt(self, state):
            result = super().adapt(state)
            seen["assignments"].append(result.state.alloc.tolist())
            return result

    make_step, real_jit = ref_train.make_train_step, jax.jit

    def recording_step(cfg, opt):
        step = real_jit(make_step(cfg, opt))

        def run(*args):
            out = step(*args)
            seen["losses"].append(float(out[2]["loss"]))
            return out

        return run

    def carried_init(cfg, key):
        params = ref_init_params(cfg, key)
        seen["params"] = to_torch(jax.tree.map(np.asarray, params))
        return params

    f32 = lambda reduced: lambda *a: dataclasses.replace(reduced(*a), dtype="float32")  # noqa
    monkeypatch.setattr(ref_train, "reduced_config", f32(ref_train.reduced_config))
    monkeypatch.setattr(ref_train, "AdaptationFramework", Recording)
    monkeypatch.setattr(ref_train, "make_train_step", recording_step)
    monkeypatch.setattr(ref_train, "init_params", carried_init)
    monkeypatch.setattr(ref_train, "time", Clock())
    monkeypatch.setattr(ref_train.jax, "jit", lambda f: f)  # the step is jitted inside
    monkeypatch.setattr(port_train, "reduced_config", f32(port_train.reduced_config))
    monkeypatch.setattr(port_train, "init_params", lambda cfg, seed, device: seen["params"])
    monkeypatch.setattr(port_train, "time", Clock())
    args = ["--arch", ARCH, "--d-model", "64", "--layers", "4", "--vocab", "512", "--steps", "4",
            "--spl-steps", "4", "--batch", "4", "--seq-len", "16", "--num-shards", "4",
            "--num-workers", "2", "--ckpt-every", "4"]
    monkeypatch.setattr(sys, "argv", ["train", *args, "--ckpt-dir", str(tmp_path / "ref")])
    ref_train.main()
    out = port_train.main([*args, "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert len(out["periods"]) == len(seen["assignments"]) == 1
    assert out["periods"][0]["assignment"] == seen["assignments"][0]
    np.testing.assert_allclose(out["losses"], seen["losses"], **F32_TOL)
