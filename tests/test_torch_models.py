"""The port's LM (configs, model, cache, decode) against the reference.

Parameters are the reference's own (``init_params`` from a PRNG key),
carried to torch bit for bit by ``repro_torch.models.weights.to_torch``;
tokens are drawn with numpy.  All at SMOKE size, on the CPU, where the
port's attention runs the reference's own math.

Tolerances:

* float32 (``dtype="float32"``): the two packages differ only in the order
  of their sums (XLA's dot versus torch's CPU matmul), so logits and caches
  agree to ``F32_TOL`` (atol = rtol = 2e-4, on logits of magnitude ~4).
  The reference runs float32 decode only from a prefill-built cache:
  ``init_cache`` is hard-wired to bf16 (kvcache.py:39) and a float32
  decode on it raises in ``update_kv`` -- the port raises there too.
* bfloat16 (the configs' own dtype): ``tests/test_models.py:105-106``'s
  atol 0.75 / rtol 0.15 on decode logits, plus the argmax.  The MoE configs
  are compared in float32 only: in bfloat16 the router's top-k can meet
  ties, which torch and XLA break differently.

RecurrentGemma's windowed (LOCAL_ATTN) ring departs from the reference in
two places where the reference is at fault (ROADMAP queue 3): its decode
masks the ring by slot index against absolute positions, and its
``fix_local`` slices a wrong-sized ring from prompts shorter than the
window.  The port is held against the reference's *own full forward*
there, and two tests pin the reference's behaviour.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# CI's tier-1 job installs no torch: skip this module there, not fail collection.
torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import shape_applicable as ref_applicable
from repro.models import Model as RefModel
from repro.models import init_params as ref_init_params
from repro.models import make_prefill_step as ref_make_prefill_step
from repro.models.kvcache import init_cache as ref_init_cache

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.models import Model, init_params, make_prefill_step, make_serve_step
from repro_torch.models import make_train_step
from repro_torch.models.common import ParamSpec, tree_leaves, tree_map
from repro_torch.models.kvcache import init_cache, update_kv
from repro_torch.models.transformer import param_specs
from repro_torch.models.weights import to_torch

F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=0.75, rtol=0.15)
DENSE = ["glm4_9b", "llama3_2_3b", "gemma_7b"]
HYBRID_MOE = ["recurrentgemma_2b", "dbrx_132b", "moonshot_v1_16b_a3b"]


def _configs(arch, dtype=None):
    ref, port = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype is not None:
        ref, port = dataclasses.replace(ref, dtype=dtype), dataclasses.replace(port, dtype=dtype)
    return ref, port


def _carried(ref_cfg, seed):
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_params, to_torch(jax.tree.map(np.asarray, ref_params))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def to_numpy(tree):
    """A tree of tensors → numpy, bfloat16 leaves as float32 (exact)."""
    return tree_map(lambda t: t.float().numpy(), tree)


def _assert_tree_close(port_tree, ref_tree, tol):
    ref_np = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_tree)
    port_np = to_numpy(port_tree)
    assert jax.tree.structure(ref_np) == jax.tree.structure(port_np)
    for a, b in zip(jax.tree.leaves(port_np), jax.tree.leaves(ref_np)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_verbatim_copies(arch, smoke):
    ref, port = ref_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    for shape in SHAPES:
        assert shape_applicable(port, SHAPES[shape]) == ref_applicable(ref, REF_SHAPES[shape])


def test_glm4_9b_full_width_size():
    cfg = get_config("glm4_9b")
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (40, 4096, 151_552)
    assert cfg.param_count() == 9_399_762_944


def test_full_width_sizes_of_the_hybrid_and_moe_configs():
    """Shapes and the parameters ``param_specs`` allocates (which the
    configs' own ``param_count`` estimate does not reproduce exactly)."""
    rg, moon = get_config("recurrentgemma_2b"), get_config("moonshot_v1_16b_a3b")
    assert (rg.num_layers, rg.d_model, rg.lru_width, rg.local_window) == (26, 2560, 2560, 2048)
    assert (moon.num_layers, moon.d_model, moon.moe.num_experts, moon.moe.top_k) == (48, 2048,
                                                                                    64, 6)
    for cfg, want in ((rg, 2_894_574_080), (moon, 28_057_995_264)):
        specs = tree_leaves(param_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))
        assert sum(int(np.prod(spec.shape)) for spec in specs) == want


@pytest.mark.parametrize("arch", DENSE + ["qwen2_vl_7b", "mistral_nemo_12b"] + HYBRID_MOE)
def test_param_tree_matches_reference(arch):
    ref_cfg, cfg = _configs(arch)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = init_params(cfg, 0, device="cpu")
    ref_shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref_params)
    shapes = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), params
    )
    assert shapes == ref_shapes
    # The reference's std rule, scale / sqrt(shape[-2]), leaf by leaf.
    specs = tree_leaves(param_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))
    for spec, leaf in zip(specs, tree_leaves(params)):
        if spec.init == "normal" and leaf.numel() >= 4096:
            want = 1.0 / np.sqrt(spec.shape[-2])
            assert abs(float(leaf.float().std()) / want - 1.0) < 0.1, spec.shape


def test_train_step_runs():
    """The training path is ported: one step of a SMOKE config changes the
    parameters, keeps their dtypes and reports a finite loss and norm."""
    from repro_torch.optim import AdamW

    cfg = get_config("glm4_9b", smoke=True)
    params = init_params(cfg, 0, device="cpu")
    opt = AdamW(learning_rate=1e-3)
    tokens = torch.from_numpy(_tokens(cfg, 2, 9, 3))
    new, state, metrics = make_train_step(cfg, opt)(
        params, opt.init(params), {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert int(state.step) == 1
    for old, leaf in zip(tree_leaves(params), tree_leaves(new)):
        assert leaf.dtype == old.dtype and leaf.shape == old.shape
        assert not torch.equal(leaf, old)


# ---------------------------------------------------------------------------
# Forward, prefill cache, decode — float32, tight
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_forward_cache_and_decode_match_reference_f32(arch):
    ref_cfg, cfg = _configs(arch, "float32")
    ref_params, params = _carried(ref_cfg, seed=2)
    b, s, cap = 2, 12, 20
    toks = _tokens(cfg, b, s, seed=3)
    ref_logits, ref_cache, _ = RefModel(ref_cfg).forward(
        ref_params, tokens=jnp.asarray(toks), build_cache=True, cache_capacity=cap
    )
    logits, cache, aux = Model(cfg).forward(
        params, tokens=torch.from_numpy(toks), build_cache=True, cache_capacity=cap
    )
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **F32_TOL)
    _assert_tree_close(cache, ref_cache, F32_TOL)
    assert cache["scan"][0]["k"].shape == (cfg.cycles, b, cap, cfg.num_kv_heads,
                                           cfg.resolved_head_dim)

    # Two decode steps from the prefill-built cache.
    for step, nxt in enumerate((7, 11)):
        pos = np.full((b,), s + step, np.int32)
        tok = np.full((b, 1), nxt, np.int32)
        ref_dec, ref_cache = RefModel(ref_cfg).decode_step(
            ref_params, ref_cache, jnp.asarray(tok), jnp.asarray(pos)
        )
        dec, cache = Model(cfg).decode_step(
            params, cache, torch.from_numpy(tok), torch.from_numpy(pos)
        )
        np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), **F32_TOL)
        _assert_tree_close(cache, ref_cache, F32_TOL)


@pytest.mark.parametrize("arch", HYBRID_MOE)
def test_hybrid_and_moe_forward_cache_and_decode_match_reference_f32(arch):
    """Forward (with the MoE router's aux loss), the built cache and two
    decode steps.  RecurrentGemma's capacity is the prompt length, so its
    ring holds the whole prompt in order and decodes below the window,
    where the reference is right (past it, see the tests below)."""
    ref_cfg, cfg = _configs(arch, "float32")
    ref_params, params = _carried(ref_cfg, seed=2)
    b, s = 2, 12
    cap = s if arch == "recurrentgemma_2b" else 20
    toks = _tokens(cfg, b, s, seed=3)
    ref_logits, ref_cache, ref_aux = RefModel(ref_cfg).forward(
        ref_params, tokens=jnp.asarray(toks), build_cache=True, cache_capacity=cap
    )
    logits, cache, aux = Model(cfg).forward(
        params, tokens=torch.from_numpy(toks), build_cache=True, cache_capacity=cap
    )
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5, atol=1e-12)
    assert (float(aux) > 0) == (cfg.moe is not None)
    _assert_tree_close(cache, ref_cache, F32_TOL)
    for step, nxt in enumerate((7, 11)):
        pos = np.full((b,), s + step, np.int32)
        tok = np.full((b, 1), nxt, np.int32)
        ref_dec, ref_cache = RefModel(ref_cfg).decode_step(
            ref_params, ref_cache, jnp.asarray(tok), jnp.asarray(pos)
        )
        dec, cache = Model(cfg).decode_step(
            params, cache, torch.from_numpy(tok), torch.from_numpy(pos)
        )
        np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), **F32_TOL)
        _assert_tree_close(cache, ref_cache, F32_TOL)


def _local_layer(cfg):
    """Index of RecurrentGemma's LOCAL_ATTN entry in the stacked cache."""
    return cfg.pattern.index("local_attn")


def test_recurrentgemma_decode_past_the_window_matches_reference_forward_f32():
    """A prompt longer than the window (the ring has wrapped), then
    teacher-forced decode steps on to past twice the window: each step's
    logits equal the reference's own full forward over the sequence at
    that position.  The prefill-built ring equals the reference's (its
    slice-and-roll is right for prompts of at least the window)."""
    ref_cfg, cfg = _configs("recurrentgemma_2b", "float32")
    w = cfg.local_window
    ref_params, params = _carried(ref_cfg, seed=12)
    b, s, total = 2, w + 6, 2 * w + 12
    toks = _tokens(cfg, b, total, seed=13)
    ref_logits = np.asarray(RefModel(ref_cfg).forward(ref_params, tokens=jnp.asarray(toks))[0])
    _, ref_cache, _ = RefModel(ref_cfg).forward(
        ref_params, tokens=jnp.asarray(toks[:, :s]), build_cache=True, cache_capacity=4 * w
    )
    logits, cache, _ = Model(cfg).forward(
        params, tokens=torch.from_numpy(toks[:, :s]), build_cache=True, cache_capacity=4 * w
    )
    np.testing.assert_allclose(logits.numpy(), ref_logits[:, :s], **F32_TOL)
    _assert_tree_close(cache, ref_cache, F32_TOL)
    assert cache["scan"][_local_layer(cfg)]["k"].shape[2] == w
    model = Model(cfg)
    for pos in range(s, total):
        dec, cache = model.decode_step(params, cache, torch.from_numpy(toks[:, pos : pos + 1]),
                                       torch.full((b,), pos))
        np.testing.assert_allclose(dec.numpy()[:, 0], ref_logits[:, pos], **F32_TOL)


@pytest.mark.parametrize("s,capacity", [(12, 20), (40, 64), (12, 212)])
def test_recurrentgemma_ring_from_a_short_prompt_is_built_right(s, capacity):
    """s < w: tokens 0..s-1 in slots 0..s-1 and zeros after them -- by
    hand, from the reference's cache built with capacity s (a ring of s
    slots in token order); then a decode below the window matches the
    reference's full forward."""
    ref_cfg, cfg = _configs("recurrentgemma_2b", "float32")
    ref_params, params = _carried(ref_cfg, seed=14)
    b = 2
    toks = _tokens(cfg, b, s + 1, seed=15)
    _, ref_cache, _ = RefModel(ref_cfg).forward(
        ref_params, tokens=jnp.asarray(toks[:, :s]), build_cache=True, cache_capacity=s
    )
    _, cache, _ = Model(cfg).forward(
        params, tokens=torch.from_numpy(toks[:, :s]), build_cache=True, cache_capacity=capacity
    )
    j = _local_layer(cfg)
    ring = min(cfg.local_window, capacity)
    for name in ("k", "v"):
        prompt = np.asarray(ref_cache["scan"][j][name], np.float32)
        by_hand = np.zeros(prompt.shape[:2] + (ring,) + prompt.shape[3:], np.float32)
        by_hand[:, :, :s] = prompt
        np.testing.assert_allclose(cache["scan"][j][name].numpy(), by_hand, **F32_TOL)
    ref_logits = np.asarray(RefModel(ref_cfg).forward(ref_params, tokens=jnp.asarray(toks))[0])
    dec, _ = Model(cfg).decode_step(params, cache, torch.from_numpy(toks[:, s:]),
                                    torch.full((b,), s))
    np.testing.assert_allclose(dec.numpy()[:, 0], ref_logits[:, s], **F32_TOL)


def test_reference_windowed_decode_departs_from_its_own_forward():
    """Documents the reference's fault (transformer.py:172 with
    layers.py:128-139): its ring decode compares slot indices with absolute
    positions, so past the window it masks the newest keys (here, at
    position 131 >= 2w - 1, all of them).  The port's decode matches the
    reference's own full forward there."""
    ref_cfg, cfg = _configs("recurrentgemma_2b", "float32")
    ref_params, params = _carried(ref_cfg, seed=16)
    b, s = 2, 131
    toks = _tokens(cfg, b, s + 1, seed=17)
    ref_full = np.asarray(RefModel(ref_cfg).forward(ref_params, tokens=jnp.asarray(toks))[0])
    ref_model = RefModel(ref_cfg)
    _, ref_cache, _ = ref_model.forward(
        ref_params, tokens=jnp.asarray(toks[:, :s]), build_cache=True, cache_capacity=256
    )
    ref_dec, _ = ref_model.decode_step(ref_params, ref_cache, jnp.asarray(toks[:, s:]),
                                       jnp.full((b,), s, jnp.int32))
    ref_gap = float(np.abs(np.asarray(ref_dec)[:, 0] - ref_full[:, s]).max())
    assert ref_gap > 0.1, ref_gap
    _, cache, _ = Model(cfg).forward(
        params, tokens=torch.from_numpy(toks[:, :s]), build_cache=True, cache_capacity=256
    )
    dec, _ = Model(cfg).decode_step(params, cache, torch.from_numpy(toks[:, s:]),
                                    torch.full((b,), s))
    np.testing.assert_allclose(dec.numpy()[:, 0], ref_full[:, s], **F32_TOL)


@pytest.mark.parametrize("s,capacity,slots", [(12, 20, 8), (40, 64, 24)])
def test_reference_fix_local_slices_a_wrong_sized_ring(s, capacity, slots):
    """Documents the reference's fault (transformer.py:396): for s < w the
    slice starts at s - w < 0, which JAX counts from the end."""
    ref_cfg, cfg = _configs("recurrentgemma_2b", "float32")
    ref_params, params = _carried(ref_cfg, seed=18)
    toks = _tokens(cfg, 1, s, seed=19)
    _, ref_cache, _ = RefModel(ref_cfg).forward(ref_params, tokens=jnp.asarray(toks),
                                                build_cache=True, cache_capacity=capacity)
    j = _local_layer(cfg)
    assert ref_cache["scan"][j]["k"].shape[2] == slots
    _, cache, _ = Model(cfg).forward(params, tokens=torch.from_numpy(toks),
                                     build_cache=True, cache_capacity=capacity)
    assert cache["scan"][j]["k"].shape[2] == min(cfg.local_window, capacity)


def test_reference_fix_local_raises_on_a_short_prompt_in_a_long_ring():
    ref_cfg, cfg = _configs("recurrentgemma_2b", "float32")
    ref_params, _ = _carried(ref_cfg, seed=18)
    toks = jnp.asarray(_tokens(cfg, 1, 12, seed=19))
    with pytest.raises(TypeError, match="nonnegative"):
        RefModel(ref_cfg).forward(ref_params, tokens=toks, build_cache=True, cache_capacity=212)


def test_mrope_backbone_from_embeddings_matches_reference_f32():
    ref_cfg, cfg = _configs("qwen2_vl_7b", "float32")
    ref_params, params = _carried(ref_cfg, seed=4)
    embeds = np.random.default_rng(5).standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    ref_logits, _, _ = RefModel(ref_cfg).forward(ref_params, inputs_embeds=jnp.asarray(embeds))
    logits, _, _ = Model(cfg).forward(params, inputs_embeds=torch.from_numpy(embeds))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **F32_TOL)


@pytest.mark.parametrize("arch", DENSE + HYBRID_MOE)
def test_prefill_step_matches_reference_f32(arch):
    ref_cfg, cfg = _configs(arch, "float32")
    ref_params, params = _carried(ref_cfg, seed=6)
    toks = _tokens(cfg, 2, 9, seed=7)
    ref_last, ref_cache = ref_make_prefill_step(ref_cfg)(ref_params, {"tokens": jnp.asarray(toks)})
    last, cache = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(toks)})
    assert last.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **F32_TOL)
    # No capacity: the cache holds exactly S slots, as in the reference.
    _assert_tree_close(cache, ref_cache, F32_TOL)


def test_f32_decode_on_bf16_init_cache_raises_like_reference():
    _, cfg = _configs("glm4_9b", "float32")
    params = init_params(cfg, 0, device="cpu")
    cache = init_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(TypeError):
        Model(cfg).decode_step(params, cache, torch.ones(2, 1, dtype=torch.int64),
                               torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("entry", ["init_params", "init_cache"])
def test_lm_entry_points_default_to_the_card(entry):
    """Parameters and caches land on the card unless the caller asks for
    the CPU; without CUDA the default raises instead of running on the host."""
    cfg = get_config("glm4_9b", smoke=True)
    make = {"init_params": lambda: init_params(cfg, 0),
            "init_cache": lambda: init_cache(cfg, 2, 16)}[entry]
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in tree_leaves(make()))
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_update_kv_writes_in_place_mod_capacity():
    ck = torch.zeros(3, 4, 2, 8)
    cv = torch.zeros(3, 4, 2, 8)
    kn = torch.arange(3 * 2 * 8, dtype=torch.float32).reshape(3, 1, 2, 8)
    out_k, out_v = update_kv(ck, cv, kn, -kn, torch.tensor([0, 5, 3]))
    assert out_k is ck and out_v is cv
    for row, slot in enumerate((0, 1, 3)):
        assert torch.equal(ck[row, slot], kn[row, 0])
        assert torch.equal(cv[row, slot], -kn[row, 0])
    assert int((ck != 0).any(-1).any(-1).sum()) == 3


# ---------------------------------------------------------------------------
# bf16 decode on an init_cache cache (the serving path)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + ["recurrentgemma_2b"])
def test_decode_step_on_init_cache_matches_reference_bf16(arch):
    ref_cfg, cfg = _configs(arch)
    ref_params, params = _carried(ref_cfg, seed=1)
    b = 2
    ref_cache = ref_init_cache(ref_cfg, b, 64)
    cache = init_cache(cfg, b, 64, device="cpu")
    serve = make_serve_step(cfg)
    ref_model = RefModel(ref_cfg)
    toks = _tokens(cfg, b, 3, seed=8)
    for step in range(3):
        tok = toks[:, step : step + 1]
        pos = np.array([step, step + 5], np.int32)
        ref_logits, ref_cache = ref_model.decode_step(
            ref_params, ref_cache, jnp.asarray(tok), jnp.asarray(pos)
        )
        logits, cache = serve(params, cache, torch.from_numpy(tok), torch.from_numpy(pos))
        assert logits.shape == (b, 1, cfg.vocab_size)
        ref_np = np.asarray(ref_logits, np.float32)
        np.testing.assert_allclose(logits.numpy(), ref_np, **BF16_TOL)
        assert np.array_equal(logits.numpy()[:, 0].argmax(-1), ref_np[:, 0].argmax(-1))
