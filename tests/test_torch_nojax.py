"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the reference package ``repro``.

Pinned two ways: statically, over every import statement (top level or
nested) in the port's sources and the chip smoke script; and at run time,
by importing the package and running a small Real Job 3 in a subprocess
where ``import jax`` and ``import repro`` fail.
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
from repro_torch.data import StreamSpec, airline_stream, real_job_3
from repro_torch.engine import Engine
eng = Engine(real_job_3(keygroups_per_op=8), 3, service_rate=1e9, device="cpu")
feed = airline_stream(StreamSpec(rate=60.0, seed=2))
for _ in range(4):
    k, v, ts = next(feed)
    eng.push_source("airline", k, v, ts)
    eng.tick()
for _ in range(4):
    eng.tick()
snap = eng.end_period()
assert eng.metrics.sink_tuples > 0 and snap.kg_load.sum() > 0
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
try:
    Engine(real_job_3(keygroups_per_op=8), 3, device="cuda")
except RuntimeError as e:
    assert "CUDA is not available" in str(e)
else:
    import torch
    assert torch.cuda.is_available()
print("OK", eng.metrics.sink_tuples)
"""


def test_port_runs_with_jax_and_reference_unimportable():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
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
