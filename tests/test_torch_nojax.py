"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the reference package ``repro``.

Pinned two ways: statically, over every import statement (top level or
nested) in the port's sources and the chip smoke script; and at run time,
by importing the package, running a small Real Job 3 (under ``.typed()``,
under the compiled tier, ``.jit()``, and on a supervised two-worker cluster
with checkpoints, a planted kill and a respawn), Real Jobs 1 (``.typed()``)
and 4 (``.jit()``) with the three baselines on their snapshots, a skew
scenario, the ``Engine`` guard against ``.workers(n)``, fused ticks and a K-tick scan of
the fused superstep (``repro_torch.engine.superstep``), one SMOKE decode
tick of the serve loop for a dense, a hybrid (RG-LRU + windowed attention),
a MoE, the xLSTM and the encoder-decoder (Whisper) config, and one CPU train step (the optimizer, the token
pipeline, the trainer's config), the mesh and dry-run tooling
(``repro_torch.launch.{mesh,sharding,roofline,dryrun,perf_iter}``: one
SMOKE cell traced and run, MoE expert parallelism and ``compressed_psum``
on the 1×1 mesh) in a subprocess where
``import jax`` and ``import repro`` fail.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_has_sources():
    files = _port_files()
    assert len(files) > 20
    assert all(f.exists() for f in files)


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


_SUBPROCESS = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np
import repro_torch
import repro_torch.core, repro_torch.data, repro_torch.engine, repro_torch.kernels
import repro_torch.solver
import repro_torch.configs, repro_torch.models, repro_torch.launch.serve
import repro_torch.models.moe, repro_torch.models.rglru, repro_torch.models.xlstm
import repro_torch.kernels.moe_gemm, repro_torch.kernels.rglru_scan
import repro_torch.engine.superstep
from repro_torch.data import StreamSpec, airline_stream, real_job_3
from repro_torch.engine import Engine, ExecutionConfig
engines = []
for config in (ExecutionConfig.typed(), ExecutionConfig.jit()):
    eng = Engine(real_job_3(keygroups_per_op=8), 3, service_rate=1e9, device="cpu",
                 config=config)
    feed = airline_stream(StreamSpec(rate=60.0, seed=2))
    for _ in range(4):
        k, v, ts = next(feed)
        eng.push_source("airline", k, v, ts)
        eng.tick()
    for _ in range(4):
        eng.tick()
    snap = eng.end_period()
    assert eng.metrics.sink_tuples > 0 and snap.kg_load.sum() > 0
    engines.append(eng)
typed, jit = engines
import repro_torch.core.baselines, repro_torch.workloads
from repro_torch.core.baselines import PotcSimulator, cola_allocate, flux_rebalance
from repro_torch.data import real_job_1, real_job_4, weather_stream, wiki_edit_stream
from repro_torch.workloads import make_scenario, scenario_batches
for job, feeds, config in (
    (real_job_1(keygroups_per_op=8, window_ticks=2.0),
     {"wiki": wiki_edit_stream(StreamSpec(rate=60.0, seed=2))}, ExecutionConfig.typed()),
    (real_job_4(keygroups_per_op=8),
     {"airline": airline_stream(StreamSpec(rate=60.0, seed=2)),
      "weather": weather_stream(StreamSpec(rate=15.0, seed=2))}, ExecutionConfig.jit()),
):
    eng = Engine(job, 3, service_rate=1e9, device="cpu", config=config)
    for _ in range(5):
        for op, feed in feeds.items():
            eng.push_source(op, *next(feed))
        eng.tick()
    for _ in range(6):
        eng.tick()
    snap = eng.end_period()
    assert eng.metrics.sink_tuples > 0
    assert (eng.metrics.jit_calls > 0) == config.use_fn_jit
    assert flux_rebalance(snap, max_migrations=3).num_migrations <= 3
    assert len(cola_allocate(snap).alloc) == snap.num_keygroups
    assert PotcSimulator(snap).step(snap.kg_load)[0].shape == (3,)
assert sum(len(k) for k, _, _ in scenario_batches(make_scenario("flash_crowd"), 20)) > 0
try:
    Engine(real_job_3(keygroups_per_op=8), 3, device="cpu", config=ExecutionConfig.workers(2))
except ValueError as e:
    assert "make_engine" in str(e)
else:
    raise AssertionError("Engine accepted ExecutionConfig.workers(2)")
import os
from repro_torch.engine import CheckpointPolicy, SupervisionPolicy, make_engine
from repro_torch.engine.faults import FaultPlan
cfg = ExecutionConfig.workers(2, checkpoint=CheckpointPolicy(os.environ["CKDIR"], every=1),
                              supervision=SupervisionPolicy())
cluster = make_engine(real_job_3(keygroups_per_op=8), 4, config=cfg, service_rate=1e9,
                      device="cpu", timeout=60.0, faults=FaultPlan.kill_at_period(1, 1))
feed = airline_stream(StreamSpec(rate=60.0, seed=2))
try:
    for _ in range(2):
        for _ in range(3):
            k, v, ts = next(feed)
            cluster.push_source("airline", k, v, ts)
            cluster.tick()
        cluster.end_period()
    for _ in range(4):
        cluster.tick()
    cluster.finalize()
finally:
    cluster.close()
assert [r.gave_up for r in cluster.recoveries] == [False] and cluster.metrics.sink_tuples > 0
assert sorted((life["worker"], life["died"]) for life in cluster.worker_stats) == [
    (0, False), (1, False), (1, True)]
assert sorted(os.listdir(os.environ["CKDIR"]))
assert jit.metrics.jit_calls > 0 and jit.metrics.jit_host_syncs == jit.metrics.jit_calls
assert jit.metrics.sink_tuples == typed.metrics.sink_tuples
assert [list(s) for _, s in jit.store.items()] == [list(s) for _, s in typed.store.items()]
from repro_torch.engine import jitexec as jx
from repro_torch.engine.topology import OperatorSpec, Schema, StateField, StateSchema, Topology
count = StateSchema((StateField("n", "scalar", dtype=np.int64, py=int),))
scalar = Schema(np.dtype(np.float64))
chain = Topology()
chain.add_operator(OperatorSpec("src", None, num_keygroups=8, is_source=True, schema=scalar))
for name, shift in (("mid", 17), ("sink", 0)):
    chain.add_operator(OperatorSpec(
        name, lambda st, k, v, t: (st, (k, v, t)), num_keygroups=8, jit_fusible=True,
        fn_jit=lambda st, kg, s, e, k, v, t, d=shift: (
            {"n": jx.count_runs(st["n"], kg, s, e)}, (k + d, v, t), None),
        jit_key_map=(lambda k: k + 17) if shift else None, state_schema=count,
        schema=scalar, out_schema=scalar, is_sink=name == "sink"))
chain.connect("src", "mid")
chain.connect("mid", "sink")
fused = Engine(chain, 3, service_rate=1e9, device="cpu", config=ExecutionConfig.superstep())
rng = np.random.default_rng(3)
feed = [(rng.integers(0, 1000, 50), rng.random(50), np.zeros(50)) for _ in range(6)]
fused.push_source("src", *feed[0])
for _ in range(4):
    fused.tick()
fused.run_supersteps(feed[1:])
for _ in range(3):
    fused.tick()
assert fused.metrics.sink_tuples == 300 and fused.metrics.jit_host_syncs > 0
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
try:
    Engine(real_job_3(keygroups_per_op=8), 3, device="cuda")
except RuntimeError as e:
    assert "CUDA is not available" in str(e)
else:
    import torch
    assert torch.cuda.is_available()
from repro_torch.configs import get_config
from repro_torch.launch.serve import DecodeWorker
from repro_torch.models import init_params
for arch in ("glm4_9b", "recurrentgemma_2b", "moonshot_v1_16b_a3b", "xlstm_1_3b",
             "whisper_small"):
    cfg = get_config(arch, smoke=True)
    worker = DecodeWorker(0, cfg, init_params(cfg, 0, device="cpu"), 2, device="cpu")
    worker.occupant[0], worker.positions[0], worker.tokens[0, 0] = 0, 5, 1
    n, secs = worker.decode_tick()
    assert n == 1 and secs > 0 and worker.positions[0] == 6
import torch
import repro_torch.optim, repro_torch.data.pipeline, repro_torch.launch.train
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models import make_train_step
from repro_torch.optim import AdamW, cosine_schedule
cfg = repro_torch.launch.train.reduced_config("llama3_2_3b", 64, 2, 512)
params = init_params(cfg, 0, device="cpu")
opt = AdamW(learning_rate=cosine_schedule(1e-3, 2, 10))
batch = TokenPipeline(PipelineConfig(vocab_size=512, seq_len=16, global_batch=4,
                                     num_shards=2)).next_batch()
params, state, metrics = make_train_step(cfg, opt)(
    params, opt.init(params), {k: torch.from_numpy(v) for k, v in batch.items()})
assert int(state.step) == 1 and float(metrics["loss"]) > 0
import contextlib, io
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    run = repro_torch.launch.train.main(
        "--d-model 64 --layers 2 --vocab 512 --steps 4 --spl-steps 2 --batch 4 --seq-len 16 "
        "--num-shards 4 --num-workers 2 --device cpu".split()
        + ["--ckpt-dir", os.path.join(os.environ["CKDIR"], "train")])
assert len(run["periods"]) == 2 and len(run["losses"]) == 4
assert printed.getvalue().splitlines()[-1] == "[train] done"
import json
import repro_torch.launch.mesh, repro_torch.launch.sharding, repro_torch.launch.roofline
import repro_torch.launch.dryrun, repro_torch.launch.perf_iter
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import activation_rules
from repro_torch.optim.compress import compressed_psum
out = os.path.join(os.environ["CKDIR"], "dryrun.json")
with contextlib.redirect_stdout(io.StringIO()):
    try:
        repro_torch.launch.dryrun.main(["--device", "cpu", "--smoke", "--run", "--arch",
                                        "recurrentgemma_2b", "--shape", "decode_32k",
                                        "--out", out])
    except SystemExit as e:
        assert e.code == 0
(row,) = json.load(open(out))
assert row["status"] == "ok" and row["trace_flops_total"] > 0 and row["run"]["logits_finite"]
mesh = make_host_mesh(device="cpu")
moe_cfg = get_config("moonshot_v1_16b_a3b", smoke=True)
rules = repro_torch.launch.sharding.rules_for(
    moe_cfg, repro_torch.configs.base.SHAPES["prefill_32k"], mesh)
from repro_torch.models import moe as port_moe
moe_params = init_params(moe_cfg, 0, device="cpu")["blocks"][0]["moe"]
moe_params = {k: v[0] for k, v in moe_params.items()}
with activation_rules(rules, mesh=mesh):
    y = port_moe.moe_forward(moe_cfg, moe_params, torch.randn(2, 8, moe_cfg.d_model,
                                                              dtype=torch.bfloat16))
    assert compressed_psum(torch.ones(4), "model").tolist() == [1.0] * 4
assert y.shape == (2, 8, moe_cfg.d_model)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("OK", eng.metrics.sink_tuples)
"""


def test_port_runs_with_jax_and_reference_unimportable(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CKDIR"] = str(tmp_path / "ck")
    out = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS],
        env=env,
        cwd=str(ROOT),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")
