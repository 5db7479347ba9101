"""Nothing the benchmark runs imports JAX or the JAX package (`repro`),
compared by whole top-level module names; the reference imports nothing
of the program (`repro_torch`) either."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

from eigbench.harness import cell as runner

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{REPO / 'src'}")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_sources_name_no_jax_side_module():
    for path in HERE.rglob("*.py"):
        found = _top_level_imports(path) & JAX_SIDE
        assert not found, f"{path} imports {found}"
    for path in (HERE / "reference").rglob("*.py"):
        names = _top_level_imports(path)
        assert not names & {"repro_torch", "eigbench"}, path


def test_a_run_loads_no_jax_side_module():
    """A whole run at a tiny size on the CPU, the per-layer readers loaded
    too, then the process's modules by whole top-level name."""
    out = _run("""
        import sys, time, torch
        from pathlib import Path
        sys.path[:0] = ["eigbench"]
        from conftest import make_tiny_root
        import tempfile
        from eigbench.harness import cell as runner
        from eigbench.harness.manifest import load_cell, load_metric
        root = make_tiny_root(Path(tempfile.mkdtemp()) / "b", scale=9)
        for name in ("kron21-ks.nev8", "kron21-svd.nsv8"):
            c = load_cell(name, root)
            runner.run_cell(c, 5, 0.1, False, torch.device("cpu"),
                            time.perf_counter())
            for m in c.per_layer:
                load_metric(m, root)
        tops = sorted({m.split(".")[0] for m in sys.modules})
        print(",".join(tops))
    """)
    tops = set(out.split(","))
    assert "repro_torch" in tops and not tops & JAX_SIDE


def test_the_reference_loads_no_program():
    out = _run("""
        import sys
        import eigbench.reference.eigen, eigbench.gen.kronecker
        print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert not set(out.split(",")) & (JAX_SIDE | {"repro_torch"})


def test_banned_modules_compares_whole_names():
    clean = ["torch", "repro_torch", "repro_torch.core", "reprox",
             "jax_like", "eigbench.harness"]
    assert runner.banned_modules(clean) == []
    assert runner.banned_modules(clean + ["repro.core", "jaxlib.xla"]) == [
        "jaxlib", "repro"]
    assert runner.banned_modules(["flax"]) == ["flax"]
