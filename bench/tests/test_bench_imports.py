"""Nothing the benchmark runs reaches JAX or the JAX package, compared by
whole top-level names (``repro_torch`` is not ``repro``), and the
references and yardsticks import nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
INDEPENDENT = ["yardstick.py", "weights.py", "reference"]


def imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_source_of_the_benchmark_imports_jax_or_repro():
    for p in sources():
        assert not set(imports(p)) & FORBIDDEN, p


def test_references_and_yardsticks_import_nothing_of_the_program():
    files = []
    for name in INDEPENDENT:
        p = BENCH / name
        files += list(p.rglob("*.py")) if p.is_dir() else [p]
    for p in files:
        assert "repro_torch" not in set(imports(p)), p
        assert "bench" not in set(imports(p)), p   # nor bench.system


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "import bench.run, bench.serve, bench.train, bench.control\n"
        "import bench.sweep\n"
        "import repro_torch.serving.executor, repro_torch.training.loop\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        f"set({sorted(FORBIDDEN)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_the_run_compares_whole_top_level_names(monkeypatch):
    from bench import run as runmod
    import repro_torch  # noqa: F401
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert runmod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.probe", object())
    assert runmod.forbidden_modules() == ["repro"]
