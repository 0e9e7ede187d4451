"""The port's roofline counter and dry run, on the CPU.

* The trace against the reference's HLO analysis: the port's traced FLOPs
  of the SMOKE prefill and decode steps of five configs (dense, MoE,
  hybrid, xLSTM, encoder-decoder) against
  ``analyze_hlo(jax.jit(step).lower(...).compile().as_text())`` of the
  reference's same step on one CPU device.  The two count the same dots
  but for a difference that the test asserts exactly, term by term
  (:func:`_stated_difference`; PERF.md names each).
* The counter itself: a hand-built chain with exact FLOPs and bytes
  (views free, a broadcast read once, a folded loop weighted by its trip
  count in the forward and the backward); each kernel's meta arm returns
  the kernel's shape and records its formula, and a CPU tensor still takes
  the plain version.
* The full-size dry run traced on meta tensors for every cell, its
  argument bytes equal to the reference's shape trees; the CLIs on a SMOKE
  cell.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.launch import sharding as ref_shd  # noqa: E402
from repro.launch.roofline import analyze_hlo  # noqa: E402
from repro.models import make_prefill_step as ref_make_prefill_step  # noqa: E402
from repro.models import make_serve_step as ref_make_serve_step  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.base import ATTN, ATTN_MOE, LOCAL_ATTN, MLSTM, RGLRU  # noqa: E402
from repro_torch.kernels import meta as kernel_meta  # noqa: E402
from repro_torch.launch import dryrun, perf_iter, roofline  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.common import loop_steps  # noqa: E402

HLO_ARCHS = ["glm4_9b", "moonshot_v1_16b_a3b", "recurrentgemma_2b", "xlstm_1_3b",
             "whisper_small"]
S, B = 64, 2  # the SMOKE steps' sequence and batch


@pytest.fixture
def small_shape(monkeypatch):
    """A (S, B) cell named "t" in both packages' SHAPES."""
    def make(kind):
        monkeypatch.setitem(base.SHAPES, "t", base.ShapeSpec("t", S, B, kind))
        return ref_base.ShapeSpec("t", S, B, kind)
    return make


def _ref_flops(cfg, shape) -> float:
    params = ref_shd.param_shapes(cfg)
    batch = ref_base.input_specs(cfg, shape)
    if shape.kind == "prefill":
        lowered = jax.jit(ref_make_prefill_step(cfg)).lower(params, batch)
    else:
        lowered = jax.jit(ref_make_serve_step(cfg)).lower(
            params, ref_shd.cache_shapes(cfg, shape), batch["tokens"], batch["positions"])
    return analyze_hlo(lowered.compile().as_text()).flops


def _stated_difference(cfg, kind: str) -> int:
    """Reference HLO FLOPs minus the port's traced FLOPs, term by term.

    Prefill:
    * the port unembeds only the last position (the reference computes
      every position's logits and returns the last): 2·B·(S−1)·d·V;
    * causal flash counts the triangle the kernel computes, the reference's
      CPU attention the full square: 4·B·H·hd·(S·S − pairs) per attention
      layer (pairs under the layer's window);
    * the reference's mLSTM takes each chunk's normalizer ``Σ_u scores``
      as a dot, the port as a sum: 2·B·H·L·S per mLSTM layer (L the chunk);
    * the RG-LRU scan kernel's 2·B·S·W multiply-adds per RG-LRU layer,
      counted by its meta arm, are an elementwise scan in the reference.
    Decode: the reference's mLSTM takes ``n·q`` as a dot, the port as a
    product and a sum: 2·B·H·hd per mLSTM layer.
    """
    d, v, h, hd = cfg.d_model, cfg.vocab_size, cfg.num_heads, cfg.resolved_head_dim
    kinds = list(cfg.pattern) * cfg.cycles + list(cfg.remainder)
    if kind == "decode":
        return sum(2 * B * h * (d // h) for k in kinds if k == MLSTM)
    diff = 2 * B * (S - 1) * d * v
    for k in kinds:
        if k in (ATTN, ATTN_MOE, LOCAL_ATTN):
            window = cfg.local_window if k == LOCAL_ATTN else None
            diff += 4 * B * h * hd * (S * S - kernel_meta.attention_pairs(S, S, True, window))
        elif k == MLSTM:
            diff += 2 * B * h * min(256, S) * S
        elif k == RGLRU:
            diff -= 2 * B * S * (cfg.lru_width or d)
    return diff


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", HLO_ARCHS)
def test_trace_flops_match_analyze_hlo(arch, kind, small_shape):
    ref_shape = small_shape(kind)
    want = _ref_flops(ref_base.get_config(arch, smoke=True), ref_shape)
    low = dryrun.lower_cell(arch, "t", make_host_mesh(device="cpu"), "host", smoke=True)
    cfg = low.cfg
    assert want - low.counts.flops == _stated_difference(cfg, kind)
    if kind == "decode":
        assert abs(low.counts.flops / want - 1) < 0.01
    kinds = set(cfg.pattern) | set(cfg.remainder)
    ops = low.counts.kernel_ops()
    if kind == "prefill":
        assert ("flash_attention" in ops) == bool(kinds & {ATTN, ATTN_MOE, LOCAL_ATTN})
        assert ("rglru_scan" in ops) == (RGLRU in kinds)
    else:
        assert ("decode_attention" in ops) == bool(kinds & {ATTN, ATTN_MOE, LOCAL_ATTN})
    assert ("moe_gemm" in ops) == (ATTN_MOE in kinds)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_counter_exact_on_a_hand_built_chain():
    """mm FLOPs 2·M·N·K; bytes = inputs read + outputs written; views and
    allocations free; a broadcast dim read once; a folded loop weighted by
    its trips in the forward and in its backward."""
    x, w = _meta(4, 8), _meta(8, 16)

    def chain(x, w):
        y = x @ w  # 1024 FLOPs; 4·(32 + 128 + 64) = 896 bytes
        y = y.view(-1).view(4, 16).t().t()  # views: 0
        z = y.expand(3, 4, 16).sum(0)  # reads 64 floats once, writes 64
        e = torch.empty_like(z)  # allocation: 0
        acc = torch.zeros_like(e)  # writes 64 floats
        for _ in loop_steps(5):
            acc = acc + z  # 5 × (64 + 64 read, 64 written)
        return acc

    _, c = roofline.count_ops(chain, x, w)
    assert c.flops == 2 * 4 * 8 * 16
    assert c.bytes == 4 * ((32 + 128 + 64) + (64 + 64) + 64 + 5 * 3 * 64)
    assert c.by_op["add"][0] == 5

    def trained(x, w):
        with torch.enable_grad():
            w = w.detach().requires_grad_()
            h = x @ w  # (4, 16)
            hs = []
            for _ in loop_steps(7):
                hs.append(torch.tanh(h))
            hs *= 7 // len(hs)
            return torch.autograd.grad(torch.stack(hs).sum(), [w])

    _, c = roofline.count_ops(trained, x, w)
    assert c.by_op["tanh"][0] == 7 and c.by_op["tanh_backward"][0] == 7
    assert c.by_op["mm"][0] == 2 and c.flops == 2 * (2 * 4 * 8 * 16)


def test_in_place_scatter_and_gather_count_their_rows():
    cache = _meta(8, 1024, 4)
    new = _meta(8, 4)
    rows, idx = _meta(8, dtype=torch.int64), _meta(8, dtype=torch.int64)
    table = _meta(5000, 64, dtype=torch.bfloat16)
    tokens = _meta(2, 3, dtype=torch.int32)

    def step():
        cache[rows, idx] = new  # index_put_: 2 index reads + 8·4 read and written
        return table[tokens]  # reads the 6 rows it returns

    _, c = roofline.count_ops(step)
    assert c.by_op["index_put_"][2] == 2 * 8 * 8 + 2 * 8 * 4 * 4
    assert c.by_op["index"][2] == 2 * 3 * 4 + 2 * 6 * 64 * 2


def test_kernel_meta_arms_record_their_formulas():
    """Each LM kernel's wrapper on meta tensors: the kernel's output shape
    and dtype, one op recorded with its formula, nothing launched."""
    bf = torch.bfloat16
    q, k, v = _meta(2, 64, 8, 32, dtype=bf), _meta(2, 64, 2, 32, dtype=bf), _meta(2, 64, 2, 32,
                                                                                dtype=bf)
    qd, kc = _meta(2, 1, 8, 32, dtype=bf), _meta(2, 100, 2, 32, dtype=bf)
    a = _meta(2, 64, 48)
    x, w = _meta(4, 10, 16, dtype=bf), _meta(4, 16, 24, dtype=bf)
    kernels.reset_launch_counts()

    def run():
        return (kernels.flash_attention(q, k, v, causal=True),
                kernels.flash_attention(q, k, v, causal=True, window=16),
                kernels.decode_attention(qd, kc, kc, _meta(2, dtype=torch.int32)),
                kernels.rglru_scan(a, a, _meta(2, 48)),
                kernels.moe_gemm(x, w))

    outs, c = roofline.count_ops(run)
    assert [tuple(o.shape) for o in outs] == [(2, 64, 8, 32)] * 2 + [(2, 1, 8, 32), (2, 64, 48),
                                                                     (4, 10, 24)]
    assert [o.dtype for o in outs] == [bf, bf, bf, torch.float32, bf]
    assert all(o.is_meta for o in outs)
    assert c.kernel_ops() == {"flash_attention": 2, "decode_attention": 1, "rglru_scan": 1,
                              "moe_gemm": 1}
    causal = 64 * 65 // 2
    windowed = 16 * 17 // 2 + (64 - 16) * 16
    assert c.by_op["kernel:flash_attention"][1] == 4 * 2 * 8 * 32 * (causal + windowed)
    assert c.by_op["kernel:flash_attention"][2] == 2 * 2 * 2 * (2 * 64 * 8 * 32 + 2 * 64 * 2 * 32)
    assert c.by_op["kernel:decode_attention"][1:] == [4 * 2 * 8 * 32 * 100,
                                                      2 * (2 * 2 * 8 * 32 + 2 * 2 * 100 * 2 * 32)]
    assert c.by_op["kernel:rglru_scan"][1:] == [2 * 2 * 64 * 48, 4 * 3 * 2 * 64 * 48 + 4 * 2 * 48]
    assert c.by_op["kernel:moe_gemm"][1:] == [2 * 4 * 10 * 16 * 24,
                                              2 * (4 * 10 * 16 + 4 * 16 * 24 + 4 * 10 * 24)]
    assert sum(kernels.launch_counts().values()) == 0
    # The backward through a kernel's Function is counted as what it runs on
    # the card: rglru_scan one more launch, moe_gemm one launch for dx.
    def backward():
        with torch.enable_grad():
            ag = a.detach().requires_grad_()
            xg = x.detach().requires_grad_()
            y = kernels.rglru_scan(ag, ag, _meta(2, 48)).sum() + kernels.moe_gemm(xg, w).sum()
            return torch.autograd.grad(y, [ag, xg])

    _, c = roofline.count_ops(backward)
    assert c.kernel_ops() == {"rglru_scan": 2, "moe_gemm": 2}
    # A CPU tensor still takes the plain version (no op recorded).
    _, c = roofline.count_ops(lambda: kernels.rglru_scan(torch.ones(1, 3, 4), torch.ones(1, 3, 4),
                                                         torch.zeros(1, 4)))
    assert c.kernel_ops() == {}


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_full_size_dry_run_traces_every_cell(arch):
    """Every applicable shape of ``arch`` at full size, traced on meta
    tensors with ``device="cpu"``: FLOPs and bytes > 0, argument bytes
    equal to the reference's shape trees (parameters, AdamW state for
    train, inputs, caches for decode), skips with the reference's reasons."""
    mesh = make_host_mesh(device="cpu")
    rows, failures = dryrun.run_all([arch], list(base.SHAPES), [("host", mesh)], out=None,
                                    device="cpu")
    assert failures == 0
    ref_cfg = ref_base.get_config(arch)
    for row in rows:
        ok, reason = ref_base.shape_applicable(ref_cfg, ref_base.SHAPES[row["shape"]])
        if not ok:
            assert row["status"] == "skip" and row["reason"] == reason
            continue
        assert row["status"] == "ok" and row["trace_flops_total"] > 0
        assert row["trace_bytes_total"] > 0 and row["collective_s"] == 0
        shape = ref_base.SHAPES[row["shape"]]
        trees = [ref_shd.param_shapes(ref_cfg), ref_base.input_specs(ref_cfg, shape)]
        if shape.kind == "train":
            trees.append(ref_shd.opt_shapes(ref_cfg, None))
        if shape.kind == "decode":
            trees.append(ref_shd.cache_shapes(ref_cfg, shape))
        want = sum(np.prod(sd.shape) * np.dtype(sd.dtype).itemsize
                   for sd in jax.tree.leaves(trees))
        assert row["memory_analysis"]["argument_bytes"] == want
        assert row["roofline"]["peak_flops"] == 989e12 and row["roofline"]["hbm_bw"] == 3.35e12
        fits = {("recurrentgemma_2b", "decode_32k"), ("recurrentgemma_2b", "long_500k"),
                ("xlstm_1_3b", "decode_32k"), ("xlstm_1_3b", "long_500k")}
        assert row["fits"] == ((arch, row["shape"]) in fits)


def test_dryrun_and_perf_iter_clis_on_a_smoke_cell(tmp_path, capsys):
    """``--run`` runs a fitting decode cell once on the CPU (SMOKE size);
    ``--mesh single`` raises through make_production_mesh; perf_iter
    appends its row and dumps the ten ops that move the most bytes."""
    out = tmp_path / "dry.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--device", "cpu", "--smoke", "--run", "--arch", "xlstm_1_3b", "--shape",
                     "decode_32k", "--out", str(out)])
    assert e.value.code == 0
    (row,) = json.loads(out.read_text())
    run = row["run"]
    assert row["smoke"] and row["fits"] and run["logits_finite"]
    assert run["allocated_bytes"] == row["memory_analysis"]["argument_bytes"]
    assert run["measured_ms"] > 0 and run["launches_per_step"] == {}
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        dryrun.main(["--device", "cpu", "--mesh", "single", "--out", str(out)])
    pi = tmp_path / "pi.json"
    perf_iter.main(["--arch", "glm4_9b", "--shape", "decode_32k", "--device", "cpu", "--smoke",
                    "--variant", "seq_parallel", "--out", str(pi), "--dump-collectives"])
    perf_iter.main(["--arch", "glm4_9b", "--shape", "decode_32k", "--device", "cpu", "--smoke",
                    "--out", str(pi)])
    rows = json.loads(pi.read_text())
    assert [r["variant"] for r in rows] == ["seq_parallel", "baseline"]
    assert rows[0]["trace_flops_total"] == rows[1]["trace_flops_total"] > 0
    printed = capsys.readouterr().out
    assert "kernel:decode_attention" in printed
