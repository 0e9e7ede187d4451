"""The port's LM kernels' plain versions against the reference.

``flash_attention``, ``decode_attention``, ``rglru_scan`` and ``moe_gemm``
in the port run their plain PyTorch versions (``ref.py``) on CPU tensors;
those are held here against the reference's jnp oracles (``attention_ref``,
``decode_attention_ref``, ``rglru_scan_ref``, ``moe_gemm_ref``), its Pallas
kernels in interpret mode and, for attention, its layer functions
(``layers.full_attention`` / ``layers.decode_attention``), over the shape
sweeps of ``tests/test_kernels.py`` and at its tolerances (f32 3e-5, bf16
3e-2; the scan at its own 1e-5).  The port's own layer functions (full,
chunked, decode with and without a window) are held against the reference's
the same way.

Inputs are drawn with numpy and cast to bf16 on each side (both round to
nearest even, so both sides see the same bits).  The CUDA kernels run only
on the card: ``tests/test_torch_cuda.py`` holds them against these plain
versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest

# CI's tier-1 job installs no torch: skip this module there, not fail collection.
torch = pytest.importorskip("torch")

from repro.kernels.decode_attention.decode_attention import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref as ref_decode_oracle
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as ref_flash_oracle
from repro.kernels.moe_gemm.moe_gemm import moe_gemm_pallas
from repro.kernels.moe_gemm.ref import moe_gemm_ref as ref_moe_oracle
from repro.kernels.rglru_scan.ref import rglru_scan_ref as ref_scan_oracle
from repro.kernels.rglru_scan.rglru_scan import rglru_scan_pallas
from repro.models import layers as ref_layers

from repro_torch.kernels import (
    decode_attention,
    flash_attention,
    launch_counts,
    moe_gemm,
    reset_launch_counts,
    rglru_scan,
)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.configs import all_configs
from repro_torch.kernels.flash_attention import kernel_path
from repro_torch.kernels.flash_attention.ops import MAX_HEAD_DIM
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.moe_gemm.ops import kernel_path as moe_kernel_path
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.models.moe import capacity
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.models import layers

TOL = {
    "float32": dict(atol=3e-5, rtol=3e-5),
    "bfloat16": dict(atol=3e-2, rtol=3e-2),
}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(a, b, dtype):
    np.testing.assert_allclose(_np(a), _np(b), **TOL[dtype])


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

FLASH_CASES = [  # tests/test_kernels.py:58-66, plus GLM-4-9B's group size 16
    (1, 256, 4, 2, 64, True, None, "float32"),
    (2, 256, 4, 4, 32, True, None, "float32"),
    (1, 512, 8, 2, 64, True, 128, "float32"),
    (1, 256, 4, 1, 64, False, None, "float32"),
    (1, 256, 8, 8, 128, True, None, "bfloat16"),
    (2, 384, 6, 3, 64, True, None, "float32"),
    (1, 256, 32, 2, 128, True, None, "bfloat16"),
]


def _qkv(b, s, h, kv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    return _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,dtype", FLASH_CASES)
def test_flash_plain_matches_reference(b, s, h, kv, hd, causal, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, s, h, kv, hd, dtype, seed=s + h)
    out = attention_ref(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == TORCH[dtype] and out.shape == (b, s, h, hd)
    _close(out, ref_flash_oracle(jq, jk, jv, causal=causal, window=window), dtype)
    bq = 128 if s % 128 == 0 else 64
    pallas = flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, block_q=bq, block_kv=bq, interpret=True
    )
    _close(out, pallas, dtype)
    _close(out, ref_layers.full_attention(jq, jk, jv, causal=causal, window=window), dtype)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,dtype", FLASH_CASES[:4])
def test_flash_wrapper_on_cpu_is_plain(b, s, h, kv, hd, causal, window, dtype):
    (_, tq), (_, tk), (_, tv) = _qkv(b, s, h, kv, hd, dtype, seed=1)
    reset_launch_counts()
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(out, attention_ref(tq, tk, tv, causal=causal, window=window))
    assert launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize(
    "dtype,hd,path",
    [(torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 256, "wgmma"),
     (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"), (torch.bfloat16, 8, "simt"),
     (torch.bfloat16, 24, "simt"), (torch.bfloat16, 48, "simt"), (torch.bfloat16, 96, "simt"),
     (torch.bfloat16, 192, "simt"), (torch.float32, 16, "simt"), (torch.float32, 64, "simt"),
     (torch.float32, 128, "simt"), (torch.float32, 256, "simt")],
)
def test_flash_kernel_path(dtype, hd, path):
    assert kernel_path(dtype, hd) == path


def test_flash_kernel_path_takes_every_config_to_wgmma():
    # Every full-size config whose head dim the flash kernel takes runs
    # its bf16 prefill through the wgmma body.
    dims = {cfg.resolved_head_dim for cfg in all_configs().values()}
    taken = {hd for hd in dims if hd <= MAX_HEAD_DIM}
    assert taken == {64, 128, 256}
    assert {kernel_path(torch.bfloat16, hd) for hd in taken} == {"wgmma"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 96), (False, None)])
def test_port_full_attention_matches_reference(causal, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 200, 8, 2, 32, dtype, seed=7)
    out = layers.full_attention(tq, tk, tv, causal=causal, window=window)
    ref = ref_layers.full_attention(jq, jk, jv, causal=causal, window=window)
    _close(out, ref, dtype)
    # And the layer's CPU route (the reference's full-versus-chunked choice).
    _close(layers.attention(tq, tk, tv, causal=causal, window=window), ref, dtype)


@pytest.mark.parametrize("window", [None, 100])
def test_port_chunked_attention_matches_reference(window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 256, 4, 2, 32, "float32", seed=3)
    out = layers.chunked_attention(tq, tk, tv, window=window, chunk_q=64, chunk_kv=64)
    ref = ref_layers.chunked_attention(jq, jk, jv, window=window, chunk_q=64, chunk_kv=64)
    _close(out, ref, "float32")
    _close(out, ref_flash_oracle(jq, jk, jv, window=window), "float32")


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE_CASES = [  # tests/test_kernels.py:112-120, plus GLM-4-9B's group size 16
    (3, 8, 2, 64, 512, "float32"),
    (1, 4, 4, 32, 256, "float32"),
    (2, 16, 2, 128, 512, "bfloat16"),
    (1, 2, 1, 64, 1024, "float32"),
    (4, 32, 2, 128, 256, "bfloat16"),
]


def _decode_inputs(b, h, kv, hd, t, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, hd), dtype=np.float32)
    kc = rng.standard_normal((b, t, kv, hd), dtype=np.float32)
    vc = rng.standard_normal((b, t, kv, hd), dtype=np.float32)
    # kv_len in [1, T], as tests/test_kernels.py:122 draws it; 1 and T
    # included where there are rows enough.  (kv_len 0 is not compared:
    # the Pallas kernel and the jnp oracle disagree there.)
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0] = 1
    if b > 1:
        lens[-1] = t
    return _pair(q, dtype), _pair(kc, dtype), _pair(vc, dtype), lens


@pytest.mark.parametrize("b,h,kv,hd,t,dtype", DECODE_CASES)
def test_decode_plain_matches_reference(b, h, kv, hd, t, dtype):
    (jq, tq), (jk, tk), (jv, tv), lens = _decode_inputs(b, h, kv, hd, t, dtype, seed=t + h)
    out = decode_attention_ref(tq, tk, tv, torch.from_numpy(lens))
    assert out.dtype == TORCH[dtype] and out.shape == (b, 1, h, hd)
    jl = jnp.asarray(lens)
    _close(out, ref_decode_oracle(jq, jk, jv, jl), dtype)
    _close(out, decode_attention_pallas(jq, jk, jv, jl, block_kv=128, interpret=True), dtype)
    _close(out, ref_layers.decode_attention(jq, jk, jv, jl), dtype)


@pytest.mark.parametrize("b,h,kv,hd,t,dtype", DECODE_CASES[:2])
def test_decode_wrapper_on_cpu_is_plain(b, h, kv, hd, t, dtype):
    (_, tq), (_, tk), (_, tv), lens = _decode_inputs(b, h, kv, hd, t, dtype, seed=5)
    lens = torch.from_numpy(lens)
    reset_launch_counts()
    out = decode_attention(tq, tk, tv, lens)
    assert torch.equal(out, decode_attention_ref(tq, tk, tv, lens))
    assert launch_counts()["decode_attention"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64])
def test_port_decode_layer_matches_reference(window, dtype):
    (jq, tq), (jk, tk), (jv, tv), lens = _decode_inputs(3, 8, 2, 32, 256, dtype, seed=11)
    out = layers.decode_attention(tq, tk, tv, torch.from_numpy(lens), window=window)
    ref = ref_layers.decode_attention(jq, jk, jv, jnp.asarray(lens), window=window)
    _close(out, ref, dtype)


# The three models' decode shapes: (B, T, KV, G, hd, splits on a 132-SM H100).
DECODE_SHAPES = {
    "glm4_9b": (8, 4096, 2, 16, 128, 8),
    "moonlight": (4, 2560, 16, 1, 128, 2),
    "recurrentgemma_ring": (8, 2048, 1, 10, 256, 8),
}


@pytest.mark.parametrize("shape", DECODE_SHAPES.values(), ids=DECODE_SHAPES)
def test_decode_plan_at_the_models_decode_shapes(shape):
    """The tensor-core body takes all three shapes; at most one wave of one
    block per SM, each split at least one 16-key tile, and at most
    MERGE_BYTES of partials for the merging block to read."""
    from repro_torch.kernels.decode_attention import ops

    b, t, kv, g, hd, splits = shape
    assert ops.kernel_path(torch.bfloat16, g, hd) == "mma"
    nsplit = ops.plan(b, kv, t, 132, "mma", hd, g)
    assert nsplit == splits
    assert b * kv * nsplit <= 132 and nsplit * ops.TILE_KEYS["mma"] <= t
    assert 4 * nsplit * g * hd <= ops.MERGE_BYTES
    assert ops.scratch_floats(b, kv, g, hd, nsplit) == b * kv * nsplit * g * (hd + 2)
    assert ops.scratch_floats(b, kv, g, hd, 1) == 0
    # Short caches and large batches: at least one split, one tile each.
    assert ops.plan(b, kv, 10, 132, "mma", hd, g) == 1
    assert ops.plan(512, kv, t, 132, "mma", hd, g) == 1


@pytest.mark.parametrize(
    "dtype,g,hd,path",
    [(torch.bfloat16, 16, 128, "mma"), (torch.bfloat16, 10, 256, "mma"),
     (torch.bfloat16, 1, 128, "mma"), (torch.bfloat16, 4, 16, "mma"),
     (torch.float32, 16, 128, "simt"), (torch.bfloat16, 32, 128, "simt"),
     (torch.bfloat16, 2, 48, "simt")],
)
def test_decode_kernel_path(dtype, g, hd, path):
    from repro_torch.kernels.decode_attention import ops

    assert ops.kernel_path(dtype, g, hd) == path


@pytest.mark.parametrize("shape", DECODE_SHAPES.values(), ids=DECODE_SHAPES)
def test_decode_wrapper_at_the_models_group_sizes_on_cpu(shape):
    """The models' G and hd (G = 10 at hd 256, G = 1) with int64 kv_len on
    the CPU, over a short cache: the wrapper is the plain version and agrees
    with the reference's oracle and its Pallas kernel (interpret mode)."""
    b, _, kv, g, hd, _ = shape
    t = 96
    (jq, tq), (jk, tk), (jv, tv), lens = _decode_inputs(b, g * kv, kv, hd, t, "float32",
                                                       seed=g + hd)
    lens64 = torch.from_numpy(lens).to(torch.int64)
    reset_launch_counts()
    out = decode_attention(tq, tk, tv, lens64)
    assert launch_counts()["decode_attention"] == 0 and out.shape == (b, 1, g * kv, hd)
    assert torch.equal(out, decode_attention_ref(tq, tk, tv, lens64))
    jl = jnp.asarray(lens)
    _close(out, ref_decode_oracle(jq, jk, jv, jl), "float32")
    _close(out, decode_attention_pallas(jq, jk, jv, jl, block_kv=32, interpret=True), "float32")


@pytest.mark.parametrize("shape", DECODE_SHAPES.values(), ids=DECODE_SHAPES)
def test_decode_wrapper_rejects_bad_arguments_at_the_models_shapes(shape):
    b, _, kv, g, hd, _ = shape
    q = torch.zeros(b, 1, g * kv, hd, dtype=torch.bfloat16)
    k = torch.zeros(b, 32, kv, hd, dtype=torch.bfloat16)
    lens = torch.full((b,), 32, dtype=torch.int64)
    with pytest.raises(TypeError, match="int32 or int64"):
        decode_attention(q, k, k, lens.float())
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention(q, k, k, torch.full((b + 1,), 32))
    with pytest.raises(ValueError, match="one query token"):
        decode_attention(torch.cat([q, q], dim=1), k, k, lens)
    with pytest.raises(TypeError):
        decode_attention(q, k.float(), k.float(), lens)
    with pytest.raises(ValueError):
        decode_attention(q, k[..., :8], k[..., :8], lens)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32))
    with pytest.raises(ValueError):  # past the kernel's largest head dim
        flash_attention(torch.zeros(1, 8, 4, 264), torch.zeros(1, 8, 2, 264),
                        torch.zeros(1, 8, 2, 264))
    with pytest.raises(ValueError):
        flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError):
        decode_attention(q, k, k, torch.ones(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        decode_attention(q[:, :1], k, k, torch.ones(1))


# ---------------------------------------------------------------------------
# rglru scan
# ---------------------------------------------------------------------------

SCAN_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_kernels.py:149
SCAN_CASES = [  # tests/test_kernels.py:138-140: (b, s, w, block_seq, block_width)
    (2, 256, 256, 64, 128),
    (1, 128, 512, 128, 128),
    (3, 512, 128, 256, 128),
]


def _scan_inputs(b, s, w, seed):
    """a ~ U(0.2, 0.999), b ~ 0.1 N(0, 1), h0 ~ N(0, 1), as
    tests/test_kernels.py:143-146 draws them (h0 nonzero)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.999, (b, s, w)).astype(np.float32)
    bb = (0.1 * rng.standard_normal((b, s, w))).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("b,s,w,bs,bw", SCAN_CASES)
def test_rglru_scan_plain_matches_reference(b, s, w, bs, bw):
    a, bb, h0 = _scan_inputs(b, s, w, seed=s + w)
    out = rglru_scan_ref(*map(torch.from_numpy, (a, bb, h0)))
    assert out.dtype == torch.float32 and out.shape == (b, s, w)
    ja, jb, jh = map(jnp.asarray, (a, bb, h0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_scan_oracle(ja, jb, jh)), **SCAN_TOL)
    pallas = rglru_scan_pallas(ja, jb, jh, block_seq=bs, block_width=bw, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **SCAN_TOL)


def test_rglru_scan_plain_keeps_a_dtype_and_f32_carry():
    a, bb, h0 = _scan_inputs(2, 64, 32, seed=1)
    (ja, ta), (jb, tb) = _pair(a, "bfloat16"), _pair(bb, "bfloat16")
    out = rglru_scan_ref(ta, tb, torch.from_numpy(h0))
    assert out.dtype == torch.bfloat16
    _close(out, ref_scan_oracle(ja, jb, jnp.asarray(h0)), "bfloat16")


def test_rglru_scan_wrapper_on_cpu_is_plain():
    a, bb, h0 = map(torch.from_numpy, _scan_inputs(2, 40, 24, seed=2))
    reset_launch_counts()
    assert torch.equal(rglru_scan(a, bb, h0), rglru_scan_ref(a, bb, h0))
    assert launch_counts()["rglru_scan"] == 0


# ---------------------------------------------------------------------------
# moe gemm
# ---------------------------------------------------------------------------

MOE_CASES = [  # tests/test_kernels.py:170-176
    (4, 128, 256, 128, "float32"),
    (8, 64, 128, 256, "float32"),
    (2, 256, 512, 128, "bfloat16"),
]


def _moe_inputs(e, c, d, f, dtype, seed):
    """x ~ N(0, 1), w ~ 0.05 N(0, 1), as tests/test_kernels.py:178-179."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (0.05 * rng.standard_normal((e, d, f))).astype(np.float32)
    return _pair(x, dtype), _pair(w, dtype)


@pytest.mark.parametrize("e,c,d,f,dtype", MOE_CASES)
def test_moe_gemm_plain_matches_reference(e, c, d, f, dtype):
    (jx, tx), (jw, tw) = _moe_inputs(e, c, d, f, dtype, seed=e + c)
    out = moe_gemm_ref(tx, tw)
    assert out.dtype == TORCH[dtype] and out.shape == (e, c, f)
    _close(out, ref_moe_oracle(jx, jw), dtype)
    pallas = moe_gemm_pallas(jx, jw, block_c=64, block_d=128, block_f=64, interpret=True)
    _close(out, pallas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gemm_plain_ragged_matches_reference(dtype):
    """Shapes no tile divides (the decode's 8 rows; d_ff 1,408 = 5.5 x 256
    at Moonlight's width): the Pallas kernel asserts on them, the oracle
    does not."""
    (jx, tx), (jw, tw) = _moe_inputs(3, 5, 72, 44, dtype, seed=9)
    _close(moe_gemm_ref(tx, tw), ref_moe_oracle(jx, jw), dtype)


def test_moe_gemm_wrapper_on_cpu_is_plain():
    (_, tx), (_, tw) = _moe_inputs(2, 8, 16, 24, "float32", seed=3)
    reset_launch_counts()
    assert torch.equal(moe_gemm(tx, tw), moe_gemm_ref(tx, tw))
    assert launch_counts()["moe_gemm"] == 0


@pytest.mark.parametrize(
    "c,d,f,dtype,aligned,path",
    [(960, 2048, 1408, torch.bfloat16, True, "wgmma"), (65, 72, 8, torch.bfloat16, True, "wgmma"),
     (64, 2048, 1408, torch.bfloat16, True, "mma"), (8, 2048, 1408, torch.bfloat16, True, "mma"),
     (960, 2048, 1408, torch.bfloat16, False, "simt"),
     (960, 76, 1408, torch.bfloat16, True, "simt"),
     (960, 2048, 44, torch.bfloat16, True, "simt"), (960, 2048, 1408, torch.float32, True, "simt")],
)
def test_moe_gemm_kernel_path(c, d, f, dtype, aligned, path):
    assert moe_kernel_path(64, c, d, f, dtype, aligned) == path


def test_moe_gemm_kernel_path_of_moonlights_products():
    """Moonlight-16B-A3B's prefill (4 prompts of 2,048 tokens: 960 rows per
    expert) takes the wgmma body for both products; its decode (4 rows) and
    serve (8 rows) steps take mma.sync."""
    cfg = all_configs()["moonshot_v1_16b_a3b"]
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    for rows, path in ((4 * capacity(cfg, 2048), "wgmma"), (4 * capacity(cfg, 1), "mma"),
                       (8 * capacity(cfg, 1), "mma")):
        for dd, ff in ((d, f), (f, d)):
            assert moe_kernel_path(e, rows, dd, ff, torch.bfloat16, True) == path
    assert 4 * capacity(cfg, 2048) == 960


def test_new_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError):
        rglru_scan(a, a, torch.zeros(2, 5))
    with pytest.raises(TypeError):
        rglru_scan(a, a.double(), torch.zeros(2, 4))
    with pytest.raises(ValueError):
        rglru_scan(a[0], a[0], torch.zeros(8, 4))
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        moe_gemm(x, torch.zeros(2, 5, 6))
    with pytest.raises(TypeError):
        moe_gemm(x, torch.zeros(2, 4, 6, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        moe_gemm(x[0], torch.zeros(4, 6))
