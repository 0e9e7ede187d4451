"""The port's training path against the reference, on the CPU.

* The optimizer (``repro_torch.optim``) and the token pipeline
  (``repro_torch.data.pipeline``): the reference's own tests
  (``tests/test_substrates.py``) run on the port, and the port is held to
  the reference bit for bit: AdamW's params over 5 steps (float32 equal,
  bfloat16 ``torch.equal`` after the cast), ``linear_warmup``,
  ``compress_int8``, the pipeline's batches.  Where the reference's float32
  arithmetic is not correctly rounded, the port cannot be held to its bits:
  XLA's ``cos`` and ``pow`` are within an ulp on the CPU, torch's too, at
  different points, so ``cosine_schedule`` is held to rtol 1e-6 (a few
  ulps once ``1 + cos`` cancels; exactly in the warm-up and on the
  floor), and a clipped AdamW step's global norm sums in another order
  (rtol 1e-6 there).
* The model: for every smoke arch the port runs, in float32, ``Model.loss``
  and every parameter leaf's gradient against ``jax.value_and_grad`` of the
  reference's loss on the same (carried) parameters, and one
  ``make_train_step`` step's parameters against the reference's step, at
  ``F32_TOL`` (``tests/test_torch_models.py``); a gradient leaf's atol
  scales with its largest magnitude (F32_TOL's atol is for values of order
  one, and an embedding's gradient sums many tokens' terms).  The three
  remat policies give equal losses and gradients.
* The kernels' autograd Functions: each backward formula under
  ``torch.autograd.gradcheck`` in float64, with the plain forward in the
  kernel's place (a CUDA kernel has no CPU mode; ``tests/test_torch_cuda.py``
  holds the Functions on the card).
* The trainer: ``repro_torch.launch.train.main --device cpu`` at a tiny size
  against ``repro.launch.train.main`` on the same float32 config and
  parameters: each period's shard assignment equal, each step's loss at
  ``F32_TOL``; a ``--restore`` resumes bit for bit.
"""

import dataclasses
import functools
import importlib
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# CI's tier-1 job installs no torch: skip this module there, not fail collection.
torch = pytest.importorskip("torch")

import repro.launch.train as ref_train  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import PipelineConfig as RefPipelineConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as RefTokenPipeline  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import make_train_step as ref_make_train_step  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import compress_int8 as ref_compress_int8  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.optim import decompress_int8 as ref_decompress_int8  # noqa: E402
from repro.optim import linear_warmup as ref_warmup  # noqa: E402

import repro_torch.launch.train as port_train  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import PipelineConfig, Prefetcher, TokenPipeline  # noqa: E402
from repro_torch.models import Model, make_train_step  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.models.weights import to_torch  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamW,
    compress_int8,
    cosine_schedule,
    decompress_int8,
    linear_warmup,
)
from repro_torch.optim.compress import compressed_psum  # noqa: E402

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_torch_models.py:56
#: Every decoder-only smoke arch (Whisper's batches need encoder_embeds:
#: tests/test_torch_encdec.py).
ARCHS = ["dbrx_132b", "gemma_7b", "glm4_9b", "llama3_2_3b", "mistral_nemo_12b",
         "moonshot_v1_16b_a3b", "qwen2_vl_7b", "recurrentgemma_2b", "xlstm_1_3b"]


def _bits(x) -> bytes:
    """The bytes of a jax array or a tensor (bfloat16 as its raw bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


# ---------------------------------------------------------------------------
# optimizer: the reference's tests (tests/test_substrates.py:69-90) on the port
# ---------------------------------------------------------------------------


def test_adamw_converges_on_quadratic():
    opt = AdamW(learning_rate=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        (grad,) = torch.autograd.grad(torch.sum(w**2), w)
        updates, state = opt.update({"w": grad}, state, params)
        params = {"w": params["w"] + updates["w"]}
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_bounds_update():
    opt = AdamW(learning_rate=1.0, grad_clip=1e-3)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    updates, _ = opt.update({"w": torch.full((3,), 1e6)}, state, params)
    assert torch.isfinite(updates["w"]).all()


def test_cosine_schedule_shape():
    fn = cosine_schedule(1.0, 10, 100)
    assert float(fn(torch.tensor(0))) < 0.2
    assert abs(float(fn(torch.tensor(10))) - 1.0) < 1e-6
    assert float(fn(100)) < 0.2


# ---------------------------------------------------------------------------
# optimizer: against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 20, 200), (1.0, 10, 100), (0.5, 0, 7)])
def test_schedules_match_reference_at_every_step(peak, warmup, total):
    ref_w, port_w = ref_warmup(peak, warmup), linear_warmup(peak, warmup)
    ref_c, port_c = ref_cosine(peak, warmup, total), cosine_schedule(peak, warmup, total)
    for step in range(total + 5):
        assert _bits(ref_w(jnp.asarray(step))) == _bits(port_w(step))
        assert _bits(port_w(torch.tensor(step))) == _bits(port_w(step))
        want, got = np.asarray(ref_c(jnp.asarray(step))), port_c(step).numpy()
        assert got.dtype == np.float32
        if step < warmup or step >= total:  # warm-up and floor: no cosine involved
            assert want.tobytes() == got.tobytes(), step
        else:  # each package's float32 cos is within an ulp of the true value
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tree(seed, dtype):
    """A small param (or grad) tree: matrices, a vector, a stacked 3-D leaf
    and a list, as numpy arrays of ``dtype`` (the 3-D leaf float32)."""
    import ml_dtypes

    dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[dtype]
    r = np.random.default_rng(seed)
    return {"w": r.normal(size=(40, 50)).astype(dt), "b": r.normal(size=(7,)).astype(dt),
            "blocks": [r.normal(size=(3, 20, 2)).astype(np.float32),
                       r.normal(size=(6,)).astype(dt)]}


@pytest.mark.parametrize("lr", ["constant", "warmup", "cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_bit_for_bit(dtype, lr):
    """5 steps on the same params and grads (norm under the clip, so the
    clip scale is exactly 1): updates, moments and the params after
    ``(p + u).astype(p.dtype)`` equal bit for bit; ``apply`` gives the same
    params as ``update`` followed by the add."""
    ref_lr, port_lr = {"constant": (1e-2, 1e-2),
                       "warmup": (ref_warmup(1e-2, 3), linear_warmup(1e-2, 3)),
                       "cosine": (ref_cosine(1e-2, 2, 6), cosine_schedule(1e-2, 2, 6))}[lr]
    ref_opt, opt = RefAdamW(learning_rate=ref_lr), AdamW(learning_rate=port_lr)
    ref_p = jax.tree.map(jnp.asarray, _tree(0, dtype))
    port_p = to_torch(_tree(0, dtype))
    ref_s, port_s = ref_opt.init(ref_p), opt.init(port_p)
    applied_p, applied_s = port_p, opt.init(port_p)
    for i in range(5):
        g = jax.tree.map(lambda a: (a * 0.01).astype(np.float32), _tree(100 + i, "float32"))
        ref_u, ref_s = ref_opt.update(jax.tree.map(jnp.asarray, g), ref_s, ref_p)
        port_u, port_s = opt.update(to_torch(g), port_s, port_p)
        applied_p, applied_s = opt.apply(to_torch(g), applied_s, applied_p)
        ref_p = jax.tree.map(lambda p, u: (p + u).astype(p.dtype), ref_p, ref_u)
        port_p = tree_unflatten(port_p, [(p + u).to(p.dtype) for p, u in
                                         zip(tree_leaves(port_p), tree_leaves(port_u))])
        for ref_tree, port_tree in ((ref_u, port_u), (ref_s.m, port_s.m), (ref_s.v, port_s.v),
                                    (ref_p, port_p), (ref_p, applied_p)):
            for a, b in zip(jax.tree.leaves(ref_tree), tree_leaves(port_tree)):
                assert _bits(a) == _bits(b), i
        assert int(port_s.step) == int(applied_s.step) == int(ref_s.step) == i + 1


def test_adamw_clipped_steps_match_reference():
    """With the clip active the scale depends on the global norm, which
    XLA and torch sum in different orders: equal to rtol 1e-6."""
    ref_opt, opt = RefAdamW(learning_rate=1e-2), AdamW(learning_rate=1e-2)
    ref_p, port_p = jax.tree.map(jnp.asarray, _tree(0, "float32")), to_torch(_tree(0, "float32"))
    ref_s, port_s = ref_opt.init(ref_p), opt.init(port_p)
    for i in range(5):
        g = _tree(100 + i, "float32")  # global norm ≈ 48, clipped to 1
        ref_u, ref_s = ref_opt.update(jax.tree.map(jnp.asarray, g), ref_s, ref_p)
        port_u, port_s = opt.update(to_torch(g), port_s, port_p)
        ref_p = jax.tree.map(lambda p, u: p + u, ref_p, ref_u)
        port_p = tree_unflatten(port_p, [p + u for p, u in
                                         zip(tree_leaves(port_p), tree_leaves(port_u))])
        assert float(opt.global_norm(to_torch(g))) > 1.0
        for a, b in zip(jax.tree.leaves(ref_u), tree_leaves(port_u)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-8)


def test_adamw_apply_spends_the_state_in_place():
    opt = AdamW(learning_rate=1e-2)
    params = to_torch(_tree(0, "float32"))
    state = opt.init(params)
    m_before = tree_leaves(state.m)
    _, new_state = opt.apply(to_torch(_tree(1, "float32")), state, params)
    assert all(a is b for a, b in zip(tree_leaves(new_state.m), m_before))
    assert int(new_state.step) == 1 and int(state.step) == 0


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_int8_compression_matches_reference(scale):
    x = np.random.default_rng(7).normal(0, scale, 4096).astype(np.float32)
    ref_q, ref_s = ref_compress_int8(jnp.asarray(x))
    q, s = compress_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert _bits(ref_q) == _bits(q) and _bits(ref_s) == _bits(s)
    assert _bits(ref_decompress_int8(ref_q, ref_s)) == _bits(decompress_int8(q, s))


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 0.37), (2, 1.0), (3, 55.5), (4, 1e3),
                                        (5, 2.5e-2), (6, 7e2), (7, 3.0)])
def test_property_int8_compression_bounded_error(seed, scale):
    """tests/test_substrates.py's property on the port, at fixed draws."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, scale, 64).astype(np.float32))
    q, s = compress_int8(x)
    back = decompress_int8(q, s)
    assert float((back - x).abs().max()) <= float(s) + 1e-9
    assert q.dtype == torch.int8


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 3e-3), (2, 4e2)])
def test_compressed_psum_matches_reference_on_one_device(seed, scale):
    """The int8 all-reduce over a one-shard ``pod`` axis: bit-equal to the
    reference's inside a ``shard_map`` on a one-device mesh; outside a mesh
    context, or over an axis the mesh lacks, it raises."""
    from jax.sharding import PartitionSpec as P

    from repro.optim.compress import compressed_psum as ref_compressed_psum

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import activation_rules

    x = np.random.default_rng(seed).normal(0, scale, 257).astype(np.float32)
    ref_mesh = jax.make_mesh((1,), ("pod",), devices=jax.devices()[:1])
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:  # jax < 0.6
        from jax.experimental.shard_map import shard_map
    want = jax.jit(shard_map(lambda a: ref_compressed_psum(a, "pod"), mesh=ref_mesh,
                             in_specs=P(), out_specs=P()))(jnp.asarray(x))
    mesh = make_mesh((1,), ("pod",), device="cpu")
    with activation_rules({}, mesh=mesh):
        got = compressed_psum(torch.from_numpy(x), "pod")
        with pytest.raises(ValueError, match="no 'data'"):
            compressed_psum(torch.from_numpy(x), "data")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="mesh"):
        compressed_psum(torch.from_numpy(x), "pod")


# ---------------------------------------------------------------------------
# data pipeline: the reference's tests (tests/test_substrates.py:93-133) on the
# port, and byte equality
# ---------------------------------------------------------------------------


def test_pipeline_deterministic_restart():
    cfg = PipelineConfig(vocab_size=1000, seq_len=16, global_batch=8, num_shards=4)
    a = TokenPipeline(cfg)
    b1 = a.next_batch()
    b2 = a.next_batch()
    cursor = a.cursor()
    b3 = a.next_batch()
    b = TokenPipeline(cfg)
    b.restore(cursor)
    b3r = b.next_batch()
    np.testing.assert_array_equal(b3["tokens"], b3r["tokens"])
    assert not np.array_equal(b1["tokens"], b2["tokens"])


def test_pipeline_labels_shift():
    cfg = PipelineConfig(vocab_size=100, seq_len=8, global_batch=4, num_shards=2)
    batch = TokenPipeline(cfg).next_batch()
    assert batch["tokens"].shape == (4, 8)
    assert batch["labels"].shape == (4, 8)
    assert (batch["tokens"] < 100).all()
    np.testing.assert_array_equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])


def test_prefetcher_passthrough():
    cfg = PipelineConfig(vocab_size=100, seq_len=8, global_batch=4, num_shards=2)
    pipe = TokenPipeline(cfg)
    ref = TokenPipeline(cfg)
    pf = Prefetcher(iter(pipe), depth=2)
    for _ in range(3):
        got = next(pf)
        np.testing.assert_array_equal(got["tokens"], ref.next_batch()["tokens"])
    pf.close()


@pytest.mark.parametrize("vocab,seq,batch,shards,seed", [(32_768, 256, 16, 16, 0),
                                                         (512, 16, 8, 4, 3), (1000, 9, 6, 6, 11)])
def test_pipeline_batches_equal_reference_bytes(vocab, seq, batch, shards, seed):
    args = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, num_shards=shards, seed=seed)
    ref, port = RefTokenPipeline(RefPipelineConfig(**args)), TokenPipeline(PipelineConfig(**args))
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    cursor = ref.cursor()
    cursor["assignment"] = np.arange(shards)[::-1].copy()
    ref2, port2 = RefTokenPipeline(RefPipelineConfig(**args)), TokenPipeline(PipelineConfig(**args))
    ref2.restore(cursor)
    port2.restore(cursor)
    assert port2.cursor()["step"] == ref2.cursor()["step"] == 3
    np.testing.assert_array_equal(port2.cursor()["assignment"], ref2.cursor()["assignment"])
    assert ref2.next_batch()["tokens"].tobytes() == port2.next_batch()["tokens"].tobytes()


# ---------------------------------------------------------------------------
# model: loss, gradients and one train step against the reference (f32)
# ---------------------------------------------------------------------------


def _configs(arch, **kw):
    ref = dataclasses.replace(ref_get_config(arch, smoke=True), dtype="float32", **kw)
    port = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)
    return ref, port


def _batch(cfg, b=2, s=17, seed=1):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch):
    ref_cfg, _ = _configs(arch)
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    loss, grads = jax.value_and_grad(RefModel(ref_cfg).loss)(
        params, jax.tree.map(jnp.asarray, _batch(ref_cfg)))
    return jax.tree.map(np.asarray, params), float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(cfg, params, batch):
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = Model(cfg).loss(tree_unflatten(params, live),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, live)


def _assert_leaf_close(got: np.ndarray, want: np.ndarray, what: str):
    """F32_TOL, its atol scaled by the leaf's largest magnitude."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=F32_TOL["atol"] * scale, rtol=F32_TOL["rtol"],
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference_f32(arch):
    _, cfg = _configs(arch)
    ref_params, ref_loss, ref_grads = _reference_loss_and_grads(arch)
    loss, grads = _port_loss_and_grads(cfg, to_torch(ref_params), _batch(cfg))
    np.testing.assert_allclose(float(loss), ref_loss, **F32_TOL)
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(ref_grads)[0]]
    leaves = jax.tree.leaves(ref_grads)
    assert len(leaves) == len(grads)
    for path, want, got in zip(paths, leaves, grads):
        assert got.shape == want.shape, path
        _assert_leaf_close(got.numpy(), want, f"{arch} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference_f32(arch):
    """A first AdamW step moves each element by about -lr·sign(g): where
    |g| is within the gradients' rounding of 0 (under 1e-4 of its leaf's
    largest) the sign can differ between the packages, and such an element
    is held to the step's bound 2·lr instead of F32_TOL."""
    ref_cfg, cfg = _configs(arch)
    ref_params, _, ref_grads = _reference_loss_and_grads(arch)
    lr = 1e-3
    ref_opt, opt = RefAdamW(learning_rate=lr), AdamW(learning_rate=lr)
    batch = _batch(cfg)
    ref_p = jax.tree.map(jnp.asarray, ref_params)
    ref_new, ref_state, ref_m = jax.jit(ref_make_train_step(ref_cfg, ref_opt))(
        ref_p, ref_opt.init(ref_p), jax.tree.map(jnp.asarray, batch))
    params = to_torch(ref_params)
    new, state, m = make_train_step(cfg, opt)(params, opt.init(params),
                                              {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), **F32_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), **F32_TOL)
    assert int(state.step) == int(ref_state.step) == 1
    for want, got, g in zip(jax.tree.leaves(ref_new), tree_leaves(new),
                            jax.tree.leaves(ref_grads)):
        want, got = np.asarray(want), got.numpy()
        sure = np.abs(g) >= 1e-4 * np.abs(g).max()
        np.testing.assert_allclose(got[sure], want[sure], **F32_TOL)
        assert np.all(np.abs(got - want) <= 2 * lr + F32_TOL["atol"])


@pytest.mark.parametrize("arch", ["llama3_2_3b", "recurrentgemma_2b", "moonshot_v1_16b_a3b"])
def test_remat_policies_give_equal_losses_and_gradients(arch):
    results = {}
    for remat in ("none", "full", "dots"):
        _, cfg = _configs(arch, remat=remat)
        params = to_torch(_reference_loss_and_grads(arch)[0])
        results[remat] = _port_loss_and_grads(cfg, params, _batch(cfg))
    for remat in ("full", "dots"):
        assert torch.equal(results[remat][0], results["none"][0])
        for a, b in zip(results[remat][1], results["none"][1]):
            assert torch.equal(a, b), remat


def test_train_forward_builds_no_cache_and_keeps_the_aux():
    """With grads on, the trunk runs its cycles under remat and returns no
    cache; the MoE aux is in the loss, as in the reference."""
    ref_cfg, cfg = _configs("moonshot_v1_16b_a3b")
    params = to_torch(_reference_loss_and_grads("moonshot_v1_16b_a3b")[0])
    live = tree_unflatten(params, [p.detach().requires_grad_() for p in tree_leaves(params)])
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    logits, cache, aux = Model(cfg).forward(live, tokens=tokens)
    assert cache is None and aux.requires_grad and float(aux.detach()) > 0
    ref_logits, _, ref_aux = RefModel(ref_cfg).forward(
        jax.tree.map(jnp.asarray, _reference_loss_and_grads("moonshot_v1_16b_a3b")[0]),
        tokens=jnp.asarray(tokens.numpy()))
    np.testing.assert_allclose(float(aux.detach()), float(ref_aux), **F32_TOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), **F32_TOL)


# ---------------------------------------------------------------------------
# the kernels' autograd Functions: backward formulas in float64
# ---------------------------------------------------------------------------


@pytest.fixture
def plain_forwards(monkeypatch):
    """Each Function's kernel launch replaced by its plain version (float64
    kept), so the backward formulas run on the CPU."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    mods = {n: importlib.import_module(f"repro_torch.kernels.{n}.ops")
            for n in ("flash_attention", "rglru_scan", "moe_gemm")}
    monkeypatch.setattr(mods["flash_attention"], "_run", lambda q, k, v, causal, window:
                        attention_ref(q, k, v, causal=causal, window=window).detach())
    monkeypatch.setattr(mods["rglru_scan"], "_run", lambda a, b, h0:
                        rglru_scan_ref(a, b, h0).detach())
    monkeypatch.setattr(mods["moe_gemm"], "_run", lambda x, w: moe_gemm_ref(x, w).detach())
    return mods


def _f64(gen, *shape):
    return torch.randn(shape, generator=gen, dtype=torch.float64).requires_grad_()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3), (False, None)])
def test_flash_attention_function_gradcheck(plain_forwards, causal, window):
    gen = torch.Generator().manual_seed(0)
    q, k, v = _f64(gen, 2, 7, 4, 8), _f64(gen, 2, 7, 2, 8), _f64(gen, 2, 7, 2, 8)
    fn = plain_forwards["flash_attention"].FlashAttentionFn
    assert torch.autograd.gradcheck(lambda *t: fn.apply(*t, causal, window), (q, k, v))


def test_rglru_scan_function_gradcheck(plain_forwards):
    gen = torch.Generator().manual_seed(1)
    a = torch.rand((2, 9, 5), generator=gen, dtype=torch.float64).requires_grad_()
    b, h0 = _f64(gen, 2, 9, 5), _f64(gen, 2, 5)
    assert torch.autograd.gradcheck(plain_forwards["rglru_scan"].RgluScanFn.apply, (a, b, h0))


def test_moe_gemm_function_gradcheck_and_dead_expert_dw(plain_forwards):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((4, 5, 6), generator=gen, dtype=torch.float64)
    x[2] = 0  # an expert no token reached
    x.requires_grad_()
    w = _f64(gen, 4, 6, 3)
    fn = plain_forwards["moe_gemm"].MoeGemmFn
    assert torch.autograd.gradcheck(fn.apply, (x, w))
    (dw,) = torch.autograd.grad(fn.apply(x, w), w, torch.ones(4, 5, 3, dtype=torch.float64))
    assert not dw[2].any() and dw[1].any()


@pytest.mark.parametrize("hd", [106, 20, 3, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_flash_head_dim_padding_keeps_the_attention(hd, dtype):
    """The wrapper pads a head dim that is not a multiple of 8 (the
    trainer's d_model 640 over 6 heads) and prescales q: the same attention
    under the kernel's scale for the padded width."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")
    gen = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn(shape, generator=gen, dtype=dtype)
               for shape in ((2, 9, 6, hd), (2, 9, 2, hd), (2, 9, 2, hd)))
    pq, pk, pv = ops.padded(q, k, v)
    assert pq.shape[-1] % 8 == 0 and pq.shape[-1] - hd < 8
    got = attention_ref(pq, pk, pv, causal=True, window=5)
    torch.testing.assert_close(got[..., :hd], attention_ref(q, k, v, causal=True, window=5),
                               atol=1e-6, rtol=1e-6)
    assert not got[..., hd:].any()


def test_cpu_tensors_take_no_function_and_count_no_launch():
    """On the CPU the wrappers run the plain versions, which autograd
    differentiates; nothing is counted."""
    from repro_torch.kernels import (
        backward_launch_counts,
        flash_attention,
        launch_counts,
        moe_gemm,
        reset_launch_counts,
        rglru_scan,
    )

    reset_launch_counts()
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    out = flash_attention(q, q[:, :, :1].detach(), q[:, :, :1].detach())
    a = torch.rand(1, 4, 3, requires_grad=True)
    h = rglru_scan(a, a.detach(), torch.zeros(1, 3))
    x = torch.randn(2, 3, 4, requires_grad=True)
    y = moe_gemm(x, torch.randn(2, 4, 5))
    for t in (out, h, y):
        assert t.grad_fn is not None and "Fn" not in type(t.grad_fn).__name__
    assert not any(launch_counts().values()) and not any(backward_launch_counts().values())


# ---------------------------------------------------------------------------
# the trainer against the reference's
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--d-model", "64", "--layers", "2", "--vocab", "512", "--steps", "12",
              "--spl-steps", "4", "--batch", "8", "--seq-len", "16", "--num-shards", "8",
              "--num-workers", "4", "--fail-worker", "1", "--fail-at", "5", "--ckpt-every", "4"]


class _Clock:
    """``time.perf_counter`` counting 0, 1, 2, ...: each step's time is 1.
    Within a period the assignment is fixed, so the step times cancel out
    of the shard loads the MILP balances (train.py: g_load ∝ 1 / capacity
    of the shard's worker); a counting clock makes them equal in both
    packages to the last bit, so the MILP gets the same numbers."""

    def __init__(self):
        self._t = itertools.count()

    def perf_counter(self) -> float:
        return float(next(self._t))


def _float32(reduced_config):
    return lambda *a: dataclasses.replace(reduced_config(*a), dtype="float32")


@pytest.fixture
def trainers(monkeypatch, tmp_path):
    """Both trainers on float32 configs, the port starting from the
    reference's parameters, counting clocks; the reference's per-period
    assignments and per-step losses recorded."""
    seen = {"assignments": [], "losses": [], "params": None}

    class Recording(ref_train.AdaptationFramework):
        def adapt(self, state):
            result = super().adapt(state)
            seen["assignments"].append(result.state.alloc.tolist())
            return result

    real_jit = jax.jit

    def recording_step(cfg, opt):
        step = real_jit(ref_make_train_step(cfg, opt))

        def run(*args):
            out = step(*args)
            seen["losses"].append(float(out[2]["loss"]))
            return out

        return run

    def carried_init(cfg, key):
        params = ref_init_params(cfg, key)
        seen["params"] = to_torch(jax.tree.map(np.asarray, params))
        return params

    monkeypatch.setattr(ref_train, "reduced_config", _float32(ref_train.reduced_config))
    monkeypatch.setattr(ref_train, "AdaptationFramework", Recording)
    monkeypatch.setattr(ref_train, "make_train_step", recording_step)
    monkeypatch.setattr(ref_train, "init_params", carried_init)
    monkeypatch.setattr(port_train, "reduced_config", _float32(port_train.reduced_config))
    monkeypatch.setattr(port_train, "init_params", lambda cfg, seed, device: seen["params"])

    def run_reference(args):
        monkeypatch.setattr(sys, "argv", ["train", *args])
        monkeypatch.setattr(ref_train, "time", _Clock())
        monkeypatch.setattr(ref_train.jax, "jit", lambda f: f)
        ref_train.main()
        monkeypatch.setattr(ref_train.jax, "jit", real_jit)

    def run_port(args):
        monkeypatch.setattr(port_train, "time", _Clock())
        return port_train.main([*args, "--device", "cpu"])

    return seen, run_reference, run_port, tmp_path


def test_trainer_matches_reference_and_restores(trainers):
    seen, run_reference, run_port, tmp = trainers
    run_reference([*TRAIN_ARGS, "--ckpt-dir", str(tmp / "ref")])
    out = run_port([*TRAIN_ARGS, "--ckpt-dir", str(tmp / "port")])
    assert [p["assignment"] for p in out["periods"]] == seen["assignments"]
    assert len(seen["assignments"]) == 3
    assert all(p["moved"] <= 4 for p in out["periods"])
    assert 1 not in out["periods"][-1]["assignment"]  # worker 1 failed at step 5
    np.testing.assert_allclose(out["losses"], seen["losses"], **F32_TOL)
    # --restore from step 7 (the step-11 checkpoints removed): steps 8-11
    # again, bit for bit.  Worker 1 lives again (liveness is not
    # checkpointed, in either package), so the last period is held against
    # the reference's restored run.
    import shutil

    for pkg in ("ref", "port"):
        shutil.rmtree(tmp / pkg / "step_0000000011")
    del seen["assignments"][:], seen["losses"][:]
    run_reference([*TRAIN_ARGS, "--ckpt-dir", str(tmp / "ref"), "--restore"])
    again = run_port([*TRAIN_ARGS, "--ckpt-dir", str(tmp / "port"), "--restore"])
    assert again["start"] == again["cursor_step"] == 8
    assert again["restored_assignment"] == out["periods"][1]["assignment"]
    assert again["losses"] == out["losses"][8:]
    for a, b in zip(tree_leaves(again["params"]), tree_leaves(out["params"])):
        assert torch.equal(a, b)
    assert [p["assignment"] for p in again["periods"]] == seen["assignments"]
    np.testing.assert_allclose(again["losses"], seen["losses"], **F32_TOL)
    assert sorted(os.listdir(tmp / "port")) == ["step_0000000007", "step_0000000011"]
