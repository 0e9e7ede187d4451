"""The port's encoder-decoder path (Whisper) against the reference.

``Model.encode``, the cross sublayer (``transformer._cross_part`` through
``layers.cross_attention``), the built ``cross`` cache, decode against it,
``Model.loss`` gradients, the empty-encoder serve path and cache
migration, on the SMOKE config (2 encoder and 2 decoder layers) on the CPU.
Parameters are the reference's own, carried by ``to_torch``; token ids and
frame embeddings (the stub frontend's input) are drawn with numpy.

Tolerances:

* float32: ``ENC_TOL`` (atol 5e-3, rtol 2e-4; atol scaled by the largest
  magnitude compared where it exceeds 1).  At the reference's init the
  encoder's attention is sharp (wq's std is 1/sqrt(heads) = 1/2), so
  rounding is amplified: the port's f32 logits are further than
  ``tests/test_torch_models.py``'s F32_TOL (2e-4) from the same in
  float64, and within half of ENC_TOL of them
  (``test_enc_tol_is_above_the_f32_rounding_floor``).
* bfloat16: ``BF16_TOL`` (``tests/test_models.py:105-106``) on decode
  logits, plus the argmax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# CI's tier-1 job installs no torch: skip this module there, not fail collection.
torch = pytest.importorskip("torch")

import repro.launch.train as ref_train  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models.kvcache import init_cache as ref_init_cache  # noqa: E402
from repro.models.layers import full_attention as ref_full_attention  # noqa: E402

import repro_torch.launch.train as port_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.launch.serve import DecodeWorker, slot_rows  # noqa: E402
from repro_torch.models import Model, init_params, make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import make_train_step  # noqa: E402
from repro_torch.models.common import ParamSpec, tree_leaves, tree_map, tree_unflatten  # noqa: E402
from repro_torch.models.kvcache import init_cache  # noqa: E402
from repro_torch.models.layers import cross_attention  # noqa: E402
from repro_torch.models.transformer import param_specs  # noqa: E402
from repro_torch.models.weights import to_torch  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

ENC_TOL = dict(atol=5e-3, rtol=2e-4)
BF16_TOL = dict(atol=0.75, rtol=0.15)  # tests/test_models.py:105-106
ARCH = "whisper_small"
ENC_LEN = 20


def _configs(dtype=None):
    ref, port = ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    if dtype is not None:
        ref, port = dataclasses.replace(ref, dtype=dtype), dataclasses.replace(port, dtype=dtype)
    return ref, port


def _carried(ref_cfg, seed):
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_params, to_torch(jax.tree.map(np.asarray, ref_params))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _frames(cfg, b, t=ENC_LEN, seed=4):
    return np.random.default_rng(seed).standard_normal((b, t, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=ENC_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol["atol"] * scale, rtol=tol["rtol"])


def _assert_tree_close(port_tree, ref_tree, tol=ENC_TOL):
    assert jax.tree.structure(jax.tree.map(np.asarray, ref_tree)) == jax.tree.structure(
        tree_map(lambda t: t.numpy(), port_tree))
    for a, b in zip(tree_leaves(port_tree), jax.tree.leaves(ref_tree)):
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
# parameters
# ---------------------------------------------------------------------------


def test_param_tree_matches_reference_and_carries_bit_for_bit():
    ref_cfg, cfg = _configs()
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = init_params(cfg, 0, device="cpu")
    shapes = tree_map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), params)
    assert shapes == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref_params)
    assert set(params["encoder"]) == {"blocks", "final_norm", "pos_embed"}
    assert params["encoder"]["pos_embed"].shape == (1 << 16, cfg.d_model)
    assert set(params["blocks"][0]) == {"attn", "mlp", "cross"}
    carried = to_torch(jax.tree.map(np.asarray, ref_params))
    for got, want in zip(tree_leaves(carried), jax.tree.leaves(ref_params)):
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(want).view(
            np.int16).tobytes()


def test_full_width_size():
    cfg = get_config(ARCH)
    assert (cfg.cycles, cfg.encoder_layers, cfg.d_model, cfg.num_heads,
            cfg.resolved_head_dim, cfg.vocab_size) == (12, 12, 768, 12, 64, 51_865)
    specs = tree_leaves(param_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))
    # The config's own estimate (no positions, 277,882,368) leaves out the
    # encoder's (65,536, 768) and the decoder's (448, 768) learned positions.
    assert sum(int(np.prod(spec.shape)) for spec in specs) == 328_616_448


# ---------------------------------------------------------------------------
# encoder, forward, cross cache, decode (f32)
# ---------------------------------------------------------------------------


def test_encode_matches_reference_f32():
    ref_cfg, cfg = _configs("float32")
    ref_params, params = _carried(ref_cfg, seed=2)
    frames = _frames(cfg, 2)
    ref_out = RefModel(ref_cfg).encode(ref_params, jnp.asarray(frames))
    out = Model(cfg).encode(params, torch.from_numpy(frames))
    assert out.shape == (2, ENC_LEN, cfg.d_model)
    _close(out, ref_out)


@pytest.mark.parametrize("s", [1, 12])
def test_forward_cross_cache_and_decode_match_reference_f32(s):
    ref_cfg, cfg = _configs("float32")
    ref_params, params = _carried(ref_cfg, seed=2)
    b, cap = 2, 20
    toks, frames = _tokens(cfg, b, s, seed=3), _frames(cfg, b)
    ref_logits, ref_cache, _ = RefModel(ref_cfg).forward(
        ref_params, tokens=jnp.asarray(toks), encoder_embeds=jnp.asarray(frames),
        build_cache=True, cache_capacity=cap)
    logits, cache, aux = Model(cfg).forward(
        params, tokens=torch.from_numpy(toks), encoder_embeds=torch.from_numpy(frames),
        build_cache=True, cache_capacity=cap)
    assert float(aux) == 0.0
    _close(logits, ref_logits)
    _assert_tree_close(cache, ref_cache)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    assert cache["cross"]["k"].shape == (cfg.cycles, b, ENC_LEN, kv, hd)
    # init_cache(enc_len=...) builds the same shapes and dtypes (bf16 model).
    zeros = init_cache(get_config(ARCH, smoke=True), b, cap, enc_len=ENC_LEN, device="cpu")
    assert tree_map(lambda t: tuple(t.shape), zeros) == tree_map(lambda t: tuple(t.shape), cache)
    for step, nxt in enumerate((7, 11)):
        pos = np.full((b,), s + step, np.int32)
        tok = np.full((b, 1), nxt, np.int32)
        ref_dec, ref_cache = RefModel(ref_cfg).decode_step(
            ref_params, ref_cache, jnp.asarray(tok), jnp.asarray(pos))
        dec, cache = Model(cfg).decode_step(params, cache, torch.from_numpy(tok),
                                            torch.from_numpy(pos))
        _close(dec, ref_dec)
        _assert_tree_close(cache, ref_cache)


def test_enc_tol_is_above_the_f32_rounding_floor():
    """ENC_TOL's ground: the port's own f32 logits (prefill and one decode
    step, the cross cache's decode) are within half of ENC_TOL of the same
    in float64, parameters and frames cast up; and more than F32_TOL's
    2e-4 away from them somewhere, which is why ENC_TOL is wider."""
    _, cfg = _configs("float32")
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    params = _carried(_configs("float32")[0], seed=2)[1]
    toks, frames = _tokens(cfg, 2, 12, seed=3), torch.from_numpy(_frames(cfg, 2))
    out = {}
    for c, cast in ((cfg, torch.float32), (cfg64, torch.float64)):
        p = tree_map(lambda t: t.to(cast), params)
        logits, cache, _ = Model(c).forward(p, tokens=torch.from_numpy(toks),
                                            encoder_embeds=frames.to(cast), build_cache=True,
                                            cache_capacity=20)
        dec, _ = Model(c).decode_step(p, cache, torch.full((2, 1), 7), torch.full((2,), 12))
        out[cast] = torch.cat([logits, dec], dim=1).numpy()
    floor = np.abs(out[torch.float32] - out[torch.float64]).max()
    assert 2e-4 < floor < ENC_TOL["atol"] / 2


def test_prefill_step_matches_reference_f32():
    from repro.models import make_prefill_step as ref_make_prefill_step

    ref_cfg, cfg = _configs("float32")
    ref_params, params = _carried(ref_cfg, seed=6)
    toks, frames = _tokens(cfg, 2, 9, seed=7), _frames(cfg, 2, seed=8)
    ref_last, ref_cache = ref_make_prefill_step(ref_cfg)(
        ref_params, {"tokens": jnp.asarray(toks), "encoder_embeds": jnp.asarray(frames)})
    last, cache = make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks), "encoder_embeds": torch.from_numpy(frames)})
    assert last.shape == (2, 1, cfg.vocab_size)
    _close(last, ref_last)
    _assert_tree_close(cache, ref_cache)


def test_forward_without_encoder_embeds_raises_like_the_reference():
    ref_cfg, cfg = _configs()
    ref_params, params = _carried(ref_cfg, seed=0)
    toks = _tokens(cfg, 1, 4, seed=0)
    with pytest.raises(AssertionError):
        RefModel(ref_cfg).forward(ref_params, tokens=jnp.asarray(toks))
    with pytest.raises(ValueError, match="encoder_embeds"):
        Model(cfg).forward(params, tokens=torch.from_numpy(toks))


def test_decode_on_a_prefill_cache_matches_reference_bf16():
    """bf16 decode steps against the cross cache a prefill built, both
    packages starting from the reference's cache (carried by ``to_torch``):
    in bf16 the sharp encoder puts each package's output ~1.4 from its own
    f32 forward (measured at this seed), so the two packages' prefills are
    compared in f32 (above) and the bf16 decode from one cache.  Attention
    scores of ~100 rounded to bf16 move a decode step's logits by up to
    ~0.4 between the packages, so the argmax must agree on the rows whose
    top-2 margin exceeds twice the measured difference (chip_smoke.py's
    rule for its decode check)."""
    ref_cfg, cfg = _configs()
    ref_params, params = _carried(ref_cfg, seed=1)
    b, s = 2, 6
    toks, frames = _tokens(cfg, b, s + 3, seed=8), _frames(cfg, b, seed=9)
    # Frames in the model's dtype: the reference's encoder scan rejects
    # float32 frames under bf16 parameters (its carry changes dtype).
    _, ref_cache, _ = RefModel(ref_cfg).forward(
        ref_params, tokens=jnp.asarray(toks[:, :s]),
        encoder_embeds=jnp.asarray(frames, jnp.bfloat16), build_cache=True, cache_capacity=16)
    cache = to_torch(jax.tree.map(np.asarray, ref_cache))
    assert cache["cross"]["k"].dtype == torch.bfloat16
    serve = make_serve_step(cfg)
    for step in range(3):
        tok = toks[:, s + step : s + step + 1]
        pos = np.full((b,), s + step, np.int32)
        ref_logits, ref_cache = RefModel(ref_cfg).decode_step(
            ref_params, ref_cache, jnp.asarray(tok), jnp.asarray(pos))
        logits, cache = serve(params, cache, torch.from_numpy(tok), torch.from_numpy(pos))
        ref_np = np.asarray(ref_logits, np.float32)
        got = logits.float().numpy()
        np.testing.assert_allclose(got, ref_np, **BF16_TOL)
        _assert_argmax_where_clear(got, ref_np)


# ---------------------------------------------------------------------------
# the empty encoder (the serve loop's), (e)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 5])
def test_cross_attention_over_no_frames_is_the_references_zeros(s):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, s, 4, 24)).astype(np.float32)
    k = np.zeros((2, 0, 4, 24), np.float32)
    ref = np.asarray(ref_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                        causal=False))
    reset_launch_counts()
    out = cross_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k))
    assert not any(launch_counts().values())
    assert np.array_equal(ref, np.zeros_like(q)) and torch.equal(out, torch.zeros_like(out))


def test_decode_on_init_cache_with_an_empty_encoder_matches_reference_bf16():
    """The serve loop's cache (``enc_len`` 0, the reference's
    ``DecodeWorker``): the cross sublayers add exactly 0."""
    ref_cfg, cfg = _configs()
    ref_params, params = _carried(ref_cfg, seed=1)
    b = 2
    ref_cache = ref_init_cache(ref_cfg, b, cfg.max_seq_len)
    cache = init_cache(cfg, b, cfg.max_seq_len, device="cpu")
    assert cache["cross"]["k"].shape == (cfg.cycles, b, 0, cfg.num_kv_heads, 24)
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


# ---------------------------------------------------------------------------
# gradients, training
# ---------------------------------------------------------------------------


def _batch(cfg, b=2, s=9, seed=1):
    toks = _tokens(cfg, b, s + 1, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "encoder_embeds": _frames(cfg, b, seed=seed + 1)}


def test_loss_and_every_gradient_match_reference_f32():
    """``Model.loss`` with ``encoder_embeds`` and each parameter leaf's
    gradient (the encoder's, the cross sublayers' and ``pos_embed``'s
    included) against ``jax.value_and_grad`` of the reference's, through
    the remat'd encoder layers and decoder cycles."""
    ref_cfg, cfg = _configs("float32")
    ref_params, params = _carried(ref_cfg, seed=0)
    batch = _batch(cfg)
    ref_loss, ref_grads = jax.value_and_grad(RefModel(ref_cfg).loss)(
        ref_params, jax.tree.map(jnp.asarray, batch))
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = Model(cfg).loss(tree_unflatten(params, live),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), **ENC_TOL)
    for got, want in zip(grads, jax.tree.leaves(ref_grads)):
        _close(got, want)
    assert all(bool(g.any()) for g in grads if g.numel() < 1 << 16)  # encoder leaves reached


def test_train_step_changes_every_leaf_f32():
    """One step in float32 (AdamW without weight decay) moves every leaf;
    of the two position tables, exactly the rows a position reached."""
    _, cfg = _configs("float32")
    params = init_params(cfg, 0, device="cpu")
    opt = AdamW(learning_rate=1e-3, weight_decay=0.0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    new, state, metrics = make_train_step(cfg, opt)(params, opt.init(params), batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    for old_pe, new_pe, used in ((params["pos_embed"], new["pos_embed"], 9),
                                 (params["encoder"]["pos_embed"], new["encoder"]["pos_embed"],
                                  ENC_LEN)):
        assert not (new_pe[:used] == old_pe[:used]).all(-1).any()
        assert torch.equal(new_pe[used:], old_pe[used:])
    for old, leaf in zip(tree_leaves(params), tree_leaves(new)):
        assert not torch.equal(leaf, old)


def test_trainer_raises_where_the_reference_fails(monkeypatch, tmp_path):
    """The token pipeline yields no ``encoder_embeds``: the reference's
    trainer fails at its first step (its forward asserts them), the port's
    raises there with a message that says so."""
    import sys

    args = ["--arch", ARCH, "--d-model", "64", "--layers", "2", "--vocab", "512", "--steps",
            "2", "--batch", "2", "--seq-len", "8", "--num-shards", "2", "--num-workers", "2"]
    monkeypatch.setattr(sys, "argv", ["train", *args, "--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(AssertionError):
        ref_train.main()
    with pytest.raises(ValueError, match="no encoder_embeds"):
        port_train.main([*args, "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])


# ---------------------------------------------------------------------------
# migration of the cross rows, (f)
# ---------------------------------------------------------------------------


def test_migration_moves_the_cross_rows_with_the_self_attention_rows():
    """With an encoder of ``ENC_LEN`` frames in the cache, a migration
    moves the slot's ``cross`` k/v (batch axis 1) beside its ``scan``
    rows, bit for bit, the destination's other slots unchanged."""
    cfg = get_config(ARCH, smoke=True)
    params = init_params(cfg, 0, device="cpu")
    src, dst = (DecodeWorker(w, cfg, params, 4, device="cpu") for w in (0, 1))
    g = torch.Generator().manual_seed(3)
    for worker in (src, dst):
        worker.cache = init_cache(cfg, 4, cfg.max_seq_len, enc_len=ENC_LEN, device="cpu")
        for a in tree_leaves(worker.cache):
            a.copy_(torch.randn(a.shape, generator=g).to(a.dtype))
    blob = src.extract(1)
    assert set(blob["cache"]) == {"scan", "rem", "cross"}
    before = {slot: slot_rows(dst.cache, slot) for slot in (0, 1, 3)}
    dst.install(2, blob, sid=9)
    for part in (dst.cache["scan"][0], dst.cache["cross"]):
        src_part = src.cache["scan"][0] if part is dst.cache["scan"][0] else src.cache["cross"]
        for name, a in part.items():
            assert torch.equal(a[:, 2], src_part[name][:, 1])
    for slot, rows in before.items():
        for name, a in dst.cache["cross"].items():
            assert torch.equal(a[:, slot], rows["cross"][name][:, 0])
