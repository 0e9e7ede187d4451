"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the reference package ``repro``.

Pinned two ways: statically, over every import statement (top level or
nested) in the port's sources and the chip smoke script; and at run time,
by importing the package, running a small Real Job 3 (under ``.typed()``,
under the compiled tier, ``.jit()``, and on a supervised two-worker cluster
with checkpoints, a planted kill and a respawn), fused ticks and a K-tick scan of
the fused superstep (``repro_torch.engine.superstep``) and one SMOKE decode
tick of the serve loop for a dense, a hybrid (RG-LRU + windowed attention)
and a MoE config in a subprocess where ``import jax`` and ``import repro``
fail.
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
import repro_torch.models.moe, repro_torch.models.rglru
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
for arch in ("glm4_9b", "recurrentgemma_2b", "moonshot_v1_16b_a3b"):
    cfg = get_config(arch, smoke=True)
    worker = DecodeWorker(0, cfg, init_params(cfg, 0, device="cpu"), 2, device="cpu")
    worker.occupant[0], worker.positions[0], worker.tokens[0, 0] = 0, 5, 1
    n, secs = worker.decode_tick()
    assert n == 1 and secs > 0 and worker.positions[0] == 6
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
