"""The port's RG-LRU block and MoE layer against the reference's.

Parameters are the reference's own (``init_from_specs`` from a PRNG key,
with the zero- and one-initialised gate biases and Λ redrawn so that every
term of the decay is exercised), carried to torch bit for bit; inputs are
drawn with numpy.  All in float32 at SMOKE width, on the CPU, where the
port's kernels run their plain versions.

Tolerances: ``F32_TOL`` (atol = rtol = 2e-4, tests/test_torch_models.py's),
for sums taken in another order -- the reference's associative scan against
the port's sequential one, and in the MoE combine the k contributions of a
token added by ``index_add_`` in another order than XLA's scatter-add.  The
MoE dispatch itself is integer work and held exactly: ``tokens_per_expert``
bit for bit.  (In bfloat16 the router's top-k can meet ties, which torch
and XLA break differently; the dispatch is compared in float32 only.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# CI's tier-1 job installs no torch: skip this module there, not fail collection.
torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models.common import init_from_specs as ref_init_from_specs
from repro.models.transformer import _block_specs as ref_block_specs
from repro.models.transformer import block_forward as ref_block_forward

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN_MOE
from repro_torch.kernels import launch_counts, moe_gemm, reset_launch_counts
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.models import moe, rglru
from repro_torch.models.transformer import block_forward
from repro_torch.models.weights import to_torch

F32_TOL = dict(atol=2e-4, rtol=2e-4)


def _configs(arch):
    ref = dataclasses.replace(ref_get_config(arch, smoke=True), dtype="float32")
    port = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    return ref, port


def _close(port, ref, tol=F32_TOL):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), **tol)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _rglru_params(ref_cfg, seed):
    p = ref_init_from_specs(ref_rglru.rglru_specs(ref_cfg), jax.random.PRNGKey(seed),
                            jnp.float32)
    rng = np.random.default_rng(seed)
    w = p["lam"].shape[0]
    for name in ("lam", "b_a", "b_i", "conv_b"):
        p[name] = jnp.asarray(rng.standard_normal(w).astype(np.float32))
    return p, to_torch(jax.tree.map(np.asarray, p))


def test_rglru_scan_with_h0_matches_reference_associative_scan():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.2, 0.999, (2, 37, 24)).astype(np.float32)
    b = (0.1 * rng.standard_normal((2, 37, 24))).astype(np.float32)
    h0 = rng.standard_normal((2, 24)).astype(np.float32)
    got = rglru.rglru_scan(*map(torch.from_numpy, (a, b, h0)))
    _close(got, ref_rglru.rglru_scan(*map(jnp.asarray, (a, b, h0))))
    got0 = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got0, ref_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("dtype,w,aligned,path", [
    (torch.float32, 2560, True, "tma"),  # RecurrentGemma-2B's lru_width
    (torch.bfloat16, 2560, True, "tma"),
    (torch.float32, 4, True, "tma"), (torch.float32, 6, True, "direct"),  # 16 vs 24 bytes
    (torch.bfloat16, 8, True, "tma"), (torch.bfloat16, 12, True, "direct"),
    (torch.float32, 2560, False, "direct"),  # a misaligned view
    (torch.float32, 1, True, "direct"), (torch.bfloat16, 4, True, "direct"),
])
def test_rglru_scan_kernel_path_names_the_body(dtype, w, aligned, path):
    assert scan_ops.kernel_path(dtype, w, aligned) == path


@pytest.mark.parametrize("b,s,w,dtype,planned", [
    (8, 2048, 2560, torch.float32, (128, 32, 64)),  # the prefill: 128 blocks, one wave
    (8, 2048, 2560, torch.bfloat16, (128, 64, 32)),
    (2, 5, 8, torch.float32, (2, 32, 1)),  # S below one stage
    (3, 100, 200, torch.float32, (6, 32, 4)),  # S not a multiple of 32; a partial tile
    (1, 64, 64, torch.bfloat16, (1, 64, 1)),
    (1, 65, 64, torch.bfloat16, (1, 64, 2)),
])
def test_rglru_scan_plan_at_the_main_shape_and_the_edges(b, s, w, dtype, planned):
    blocks, steps, stages = scan_ops.plan(b, s, w, dtype)
    assert (blocks, steps, stages) == planned
    # At the prefill the grid is one wave of at most one block per H100 SM.
    assert scan_ops.plan(8, 2048, 2560, dtype)[0] <= 132
    # A stage holds STEP_BYTES of each channel's a; the stages cover S and no more.
    assert steps * dtype.itemsize == scan_ops.STEP_BYTES
    assert (stages - 1) * steps < s <= stages * steps
    # The ring fits a block's shared memory on an H100, whole warps consume it.
    assert scan_ops.STAGES * scan_ops.TILE * 2 * scan_ops.STEP_BYTES + 128 <= 232_448
    assert scan_ops.TILE % 32 == 0


@pytest.mark.parametrize("s", [1, 2, 20])
def test_rglru_block_prefill_and_decode_match_reference(s):
    ref_cfg, cfg = _configs("recurrentgemma_2b")
    ref_p, p = _rglru_params(ref_cfg, seed=s)
    rng = np.random.default_rng(10 + s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)

    ref_out, ref_cache = ref_rglru.rglru_block(ref_cfg, ref_p, jnp.asarray(x))
    out, cache = rglru.rglru_block(cfg, p, torch.from_numpy(x))
    _close(out, ref_out)
    assert cache["h"].dtype == torch.float32 and cache["conv"].shape == (2, 3, cfg.lru_width)
    for name in ("h", "conv"):
        _close(cache[name], ref_cache[name])

    # Three decode steps from the built cache, updated in place.
    h_buf, conv_buf = cache["h"], cache["conv"]
    for step in range(3):
        x_t = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        ref_out, ref_cache = ref_rglru.rglru_block(ref_cfg, ref_p, jnp.asarray(x_t),
                                                   cache=ref_cache)
        out, cache = rglru.rglru_block(cfg, p, torch.from_numpy(x_t), cache=cache)
        _close(out, ref_out)
        for name in ("h", "conv"):
            _close(cache[name], ref_cache[name])
        assert cache["h"] is h_buf and cache["conv"] is conv_buf


def test_rglru_decode_keeps_the_reference_values_in_an_f32_state():
    """bf16 activations: the reference returns h_t in bf16; the port writes
    it into its f32 buffer, which holds the same values exactly."""
    ref_cfg, cfg = ref_get_config("recurrentgemma_2b", smoke=True), get_config(
        "recurrentgemma_2b", smoke=True)
    ref_p = ref_init_from_specs(ref_rglru.rglru_specs(ref_cfg), jax.random.PRNGKey(1),
                                jnp.bfloat16)
    p = to_torch(jax.tree.map(np.asarray, ref_p))
    x = np.random.default_rng(1).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    w = cfg.lru_width
    ref_cache = {"h": jnp.zeros((2, w), jnp.float32), "conv": jnp.zeros((2, 3, w), jnp.bfloat16)}
    cache = {"h": torch.zeros(2, w), "conv": torch.zeros(2, 3, w, dtype=torch.bfloat16)}
    _, ref_cache = ref_rglru.rglru_block(ref_cfg, ref_p, jnp.asarray(x, jnp.bfloat16),
                                         cache=ref_cache)
    _, cache = rglru.rglru_block(cfg, p, torch.from_numpy(x).to(torch.bfloat16), cache=cache)
    assert ref_cache["h"].dtype == jnp.bfloat16 and cache["h"].dtype == torch.float32
    # Same bf16 inputs, bf16 rounding of h_t on both sides.
    np.testing.assert_allclose(cache["h"].numpy(), np.asarray(ref_cache["h"], np.float32),
                               atol=3e-2, rtol=3e-2)
    assert torch.equal(cache["h"], cache["h"].to(torch.bfloat16).float())


def test_rglru_decode_rejects_a_conv_cache_of_another_dtype():
    ref_cfg, cfg = _configs("recurrentgemma_2b")
    _, p = _rglru_params(ref_cfg, 0)
    w = cfg.lru_width
    cache = {"h": torch.zeros(2, w), "conv": torch.zeros(2, 3, w, dtype=torch.bfloat16)}
    with pytest.raises(TypeError, match="in place"):
        rglru.rglru_block(cfg, p, torch.zeros(2, 1, cfg.d_model), cache=cache)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_ARCHS = ["dbrx_132b", "moonshot_v1_16b_a3b"]


def _moe_params(ref_cfg, seed):
    p = ref_init_from_specs(ref_moe.moe_specs(ref_cfg), jax.random.PRNGKey(seed), jnp.float32)
    return p, to_torch(jax.tree.map(np.asarray, p))


def _leaning_inputs(cfg, router, b, s, seed):
    """Random tokens, the first half of each row pushed along expert 0's
    router column so that its bucket overflows the capacity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    col = np.asarray(router, np.float32)[:, 0]
    x[:, : s // 2] += 4.0 * col / np.linalg.norm(col)
    return x


def _overflow(cfg, router, x):
    """Tokens dropped for want of capacity, over all rows (numpy top-k)."""
    moe_cfg = cfg.moe
    logits = x @ np.asarray(router, np.float32)
    chosen = np.argsort(-logits, axis=-1)[..., : moe_cfg.top_k]
    counts = np.stack([np.bincount(row.reshape(-1), minlength=moe_cfg.num_experts)
                       for row in chosen])
    return int(np.maximum(counts - moe.capacity(cfg, x.shape[1]), 0).sum())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference_with_overflow(arch):
    ref_cfg, cfg = _configs(arch)
    ref_p, p = _moe_params(ref_cfg, seed=3)
    b, s = 2, 48
    x = _leaning_inputs(cfg, ref_p["router"], b, s, seed=4)
    assert _overflow(cfg, ref_p["router"], x) > 0

    ref_out, ref_stats = ref_moe.moe_forward(ref_cfg, ref_p, jnp.asarray(x),
                                             return_router_stats=True)
    reset_launch_counts()
    out, stats = moe.moe_forward(cfg, p, torch.from_numpy(x), return_router_stats=True)
    assert launch_counts()["moe_gemm"] == 0  # CPU tensors: the plain version
    _close(out, ref_out)
    assert np.array_equal(stats["tokens_per_expert"].numpy(),
                          np.asarray(ref_stats["tokens_per_expert"]))
    _close(stats["router_logits"], ref_stats["router_logits"])
    assert torch.equal(moe.moe_forward(cfg, p, torch.from_numpy(x)), out)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_aux_matches_reference(arch):
    """The ATTN_MOE block: attention, the MoE FFN and its router z-loss."""
    ref_cfg, cfg = _configs(arch)
    ref_p = ref_init_from_specs(ref_block_specs(ref_cfg, ATTN_MOE), jax.random.PRNGKey(5),
                                jnp.float32)
    p = to_torch(jax.tree.map(np.asarray, ref_p))
    x = _leaning_inputs(cfg, ref_p["moe"]["router"], 2, 40, seed=6)
    positions = np.arange(40)[None, :]
    ref_x, _, ref_aux, _ = ref_block_forward(ref_cfg, ATTN_MOE, ref_p, jnp.asarray(x),
                                             jnp.asarray(positions))
    got_x, _, aux, _ = block_forward(cfg, ATTN_MOE, p, torch.from_numpy(x),
                                  torch.from_numpy(positions))
    # The block's outputs reach |x| ~ 30 at the reference's init; summation
    # order errors scale with the largest terms, so atol scales with them.
    scale = float(np.abs(np.asarray(ref_x)).max())
    _close(got_x, ref_x, dict(atol=F32_TOL["atol"] * scale, rtol=F32_TOL["rtol"]))
    assert float(ref_aux) > 0
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)


def test_moe_decode_skips_router_stats(monkeypatch):
    """A decode step drops the aux, so its MoE layers ask for no router
    stats; a forward asks once per MoE layer, and each layer applies its
    router once (the stats reuse the dispatch's logits and top-k)."""
    import repro_torch.models.transformer as transformer
    from repro_torch.models import Model, init_params

    cfg = _configs("moonshot_v1_16b_a3b")[1]
    params = init_params(cfg, 0, device="cpu")
    asked, routers = [], []
    routed = transformer.moe_forward

    def recording(cfg_, p, x, **kw):
        asked.append(kw.get("return_router_stats", False))
        return routed(cfg_, p, x, **kw)

    topk = torch.topk

    def counting_topk(a, k, *args, **kw):
        if a.shape[-1] == cfg.moe.num_experts:
            routers.append(tuple(a.shape))
        return topk(a, k, *args, **kw)

    monkeypatch.setattr(transformer, "moe_forward", recording)
    monkeypatch.setattr(torch, "topk", counting_topk)
    tokens = torch.from_numpy(np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 12)))
    model = Model(cfg)
    _, cache, aux = model.forward(params, tokens=tokens, build_cache=True, cache_capacity=16)
    layers = cfg.num_layers
    assert asked == [True] * layers and len(routers) == layers and float(aux) > 0
    asked.clear()
    routers.clear()
    model.decode_step(params, cache, tokens[:, -1:], torch.full((2,), 12))
    assert asked == [False] * layers and len(routers) == layers


@pytest.mark.parametrize("s", [1, 40])
def test_moe_products_get_contiguous_operands(s, monkeypatch):
    """The card's kernel takes contiguous operands only; at the decode shape
    (S = 1: capacity 1, (E, B, d) products, no drop) the fold's reshape
    alone would hand it a strided view."""
    ref_cfg, cfg = _configs("moonshot_v1_16b_a3b")
    ref_p, p = _moe_params(ref_cfg, seed=7)
    x = np.random.default_rng(8).standard_normal((3, s, cfg.d_model)).astype(np.float32)
    if s == 1:
        assert moe.capacity(cfg, 1) == 1 and _overflow(cfg, ref_p["router"], x) == 0
    shapes = []

    def contiguous_only(a, w):
        assert a.is_contiguous() and w.is_contiguous()
        shapes.append(tuple(a.shape))
        return moe_gemm(a, w)

    monkeypatch.setattr(moe, "moe_gemm", contiguous_only)
    _close(moe.moe_forward(cfg, p, torch.from_numpy(x)),
           ref_moe.moe_forward(ref_cfg, ref_p, jnp.asarray(x)))
    cap = moe.capacity(cfg, s)
    assert shapes[0] == (cfg.moe.num_experts, 3 * cap, cfg.d_model) and len(shapes) == 3


@pytest.mark.parametrize("s", [1, 8])
def test_moe_dispatch_zeroes_the_rows_of_experts_no_token_chose(s, monkeypatch):
    """The premise of the expert kernel's skip: in Moonlight-SMOKE's
    dispatch, the rows of x that an expert gets from a sequence none of
    whose tokens chose it (by the reference's top-k on the same logits) are
    exactly zero, in the gate/up products' input and in the down product's
    input; every chosen expert has a nonzero row.  The layer still matches
    the reference."""
    ref_cfg, cfg = _configs("moonshot_v1_16b_a3b")
    ref_p, p = _moe_params(ref_cfg, seed=11)
    b = 4
    x = np.random.default_rng(12).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    _, ref_chosen = jax.lax.top_k(jnp.asarray(x) @ ref_p["router"], k)
    ref_chosen = np.asarray(ref_chosen)  # (B, S, k)
    seen = []

    def recording(a, w):
        seen.append(a.clone())
        return moe_gemm(a, w)

    monkeypatch.setattr(moe, "moe_gemm", recording)
    out = moe.moe_forward(cfg, p, torch.from_numpy(x))
    _close(out, ref_moe.moe_forward(ref_cfg, ref_p, jnp.asarray(x)))
    cap = moe.capacity(cfg, s)
    assert len(seen) == 3  # gate, up (the same x) and down
    for a in seen:
        assert a.shape[:2] == (e, b * cap)
        rows = a.reshape(e, b, cap, -1)
        for row in range(b):
            chosen = set(ref_chosen[row].reshape(-1).tolist())
            for ex in range(e):
                zero = bool((rows[ex, row] == 0).all())  # +0 and -0 alike
                assert zero == (ex not in chosen), f"expert {ex}, row {row}"
    # Some (expert, sequence) rows are dead: the skip has work to skip.
    assert sum(len(set(c.reshape(-1).tolist())) for c in ref_chosen) < b * e
    live = sorted(set(ref_chosen.reshape(-1).tolist()))
    for a in seen:
        assert [ex for ex in range(e) if bool((a[ex] != 0).any())] == live


def test_load_balancing_loss_matches_reference():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((50, 8)).astype(np.float32)
    chosen = np.argsort(-logits, axis=-1)[:, :2]
    got = moe.load_balancing_loss(torch.from_numpy(logits), torch.from_numpy(chosen), 8)
    ref = ref_moe.load_balancing_loss(jnp.asarray(logits), jnp.asarray(chosen), 8)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_parallel_on_one_device_matches_reference(arch, monkeypatch):
    """Expert parallelism on the 1×1 mesh: the port's moe_forward under
    ``activation_rules(rules_for(...), mesh=make_host_mesh())`` takes
    ``_moe_expert_parallel`` (lo = 0, e_local = E), runs its products
    through ``moe_gemm`` and matches the reference's ``moe_forward`` under a
    1×1 jax mesh with its ``activation_rules`` (its ``shard_map`` path) at
    the MoE tolerance, overflow included."""
    from repro.configs.base import SHAPES as REF_SHAPES
    from repro.launch.sharding import rules_for as ref_rules_for
    from repro.models.common import activation_rules as ref_activation_rules

    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import rules_for
    from repro_torch.models.common import activation_rules

    ref_cfg, cfg = _configs(arch)
    ref_p, p = _moe_params(ref_cfg, seed=21)
    x = _leaning_inputs(cfg, ref_p["router"], 3, 40, seed=22)
    assert _overflow(cfg, ref_p["router"], x) > 0
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    ref_rules = ref_rules_for(ref_cfg, REF_SHAPES["prefill_32k"], ref_mesh)
    with ref_mesh, ref_activation_rules(ref_rules, mesh=ref_mesh):
        want = ref_moe.moe_forward(ref_cfg, ref_p, jnp.asarray(x))
    mesh = make_host_mesh(device="cpu")
    rules = rules_for(cfg, SHAPES["prefill_32k"], mesh)
    assert rules == ref_rules and rules["expert"] == "model"
    calls, products = [], []
    real = moe._moe_expert_parallel
    monkeypatch.setattr(moe, "_moe_expert_parallel",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(moe, "moe_gemm", lambda a, w: products.append(a.shape) or moe_gemm(a, w))
    with activation_rules(rules, mesh=mesh):
        got = moe.moe_forward(cfg, p, torch.from_numpy(x))
    assert calls == [1]
    assert len(products) == (3 if "w_gate" in p else 2)
    assert products[0][0] == cfg.moe.num_experts  # e_local = E on one shard
    _close(got, want)
    # Outside the context the local path gives the same layer.
    _close(moe.moe_forward(cfg, p, torch.from_numpy(x)), want)
