"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no script under ``tools/`` imports ``jax`` or the
JAX package ``repro``.  The planner ``repro_torch.core`` and the model
configurations (``repro_torch.configs``, ``repro_torch.models.config``),
the Eq. 4 block plans (``repro_torch.kernels.tiling``) and the cost
model (``repro_torch.perf``) are pure Python: importing them pulls in
neither torch nor ``torch.distributed`` nor a kernel build."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

_ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((_ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [_ROOT / "chip_smoke.py"] + sorted((_ROOT / "tools").glob("*.py"))


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(_ROOT)))
def test_no_jax_or_repro_import(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_every_port_module_imports_without_jax():
    src = _ROOT / "src"
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(src / "repro_torch")],
                                              prefix="repro_torch.")]
    code = textwrap.dedent(f"""
        import importlib, sys
        for blocked in ("jax", "jaxlib", "repro"):
            sys.modules[blocked] = None  # any import of them now fails
        for name in {names!r}:
            importlib.import_module(name)
        print(len({names!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) == len(names) >= 12


def test_core_is_pure_python():
    """``repro_torch.core`` (the planner) imports no jax, no repro and no
    torch; its synthesizers import the dist accounting when they run."""
    assert (_ROOT / "src" / "repro_torch" / "core" / "__init__.py") \
        in PORT_FILES
    code = textwrap.dedent("""
        import sys
        for blocked in ("jax", "jaxlib", "repro", "torch"):
            sys.modules[blocked] = None  # any import of them now fails
        import repro_torch.core as core
        p = core.resnet50_layers(64)["res3a_2b"]
        print(core.synthesize(p, 64, 2e5).describe())
    """)
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "grid" in proc.stdout


def test_configs_are_pure_python():
    """The model configurations import without torch: no
    ``torch.distributed``, no kernel build."""
    code = textwrap.dedent("""
        import sys
        for blocked in ("jax", "jaxlib", "repro", "torch"):
            sys.modules[blocked] = None  # any import of them now fails
        import repro_torch.models.config
        from repro_torch.configs import all_configs
        cfgs = all_configs()
        print(len(cfgs), cfgs["llama3_2_1b"].param_count())
    """)
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["10", "1498482688"]


def test_tiling_and_perf_are_pure_python():
    """``repro_torch.kernels.tiling`` and ``repro_torch.perf`` import no
    torch (``perf`` needs numpy; the functions that build its DAGs
    import the dist accounting when they run) and build no kernel: the
    plans, a replay and a fit run with torch blocked."""
    code = textwrap.dedent("""
        import sys
        for blocked in ("jax", "jaxlib", "repro", "torch"):
            sys.modules[blocked] = None  # any import of them now fails
        import repro_torch.perf as perf
        import repro_torch.perf.bench
        from repro_torch.core.problem import resnet50_layers
        from repro_torch.kernels import tiling
        plan = tiling.plan_blocks(resnet50_layers(64)["res3a_2b"])
        recs = [{"kind": "all_gather", "elems": 1000.0 * i, "steps": 1,
                 "wall_ms": 0.1 + 1e-4 * 1000.0 * i} for i in (1, 2, 3)]
        table = perf.fit_collectives(recs, compute_flops_per_ms=1e9)
        dag = perf.StepDag((perf.CommEvent("all_gather", 500.0),), 1e9)
        print(plan.block_bhw, plan.block_k,
              round(perf.replay_ms(dag, table), 6),
              perf.load_calib().provenance["platform"])
    """)
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    env.pop("REPRO_CALIB", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    bhw, k, ms, platform = proc.stdout.split()
    assert int(bhw) > 0 and int(k) > 0 and platform == "cpu"
    assert float(ms) == 1.0 + 0.15
