"""Static rules of the port, read from its sources:

- no module of ``repro_torch`` and no line of ``chip_smoke.py`` imports
  ``jax`` (or ``jaxlib``) or the reference package ``repro``;
- nothing in ``repro_torch`` calls a library attention or
  ``torch.compile``;
- the kernel modules hold no ``try`` — a CUDA tensor launches the kernel
  or raises, nothing gives way to the plain version;
- nothing in ``repro_torch`` or ``chip_smoke.py`` imports ``triton``:
  every kernel is CUDA C++.
"""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(root, line) for root, line in _imported_roots(tree)
           if root in FORBIDDEN_ROOTS]
    assert not bad, f"{path.name} imports {bad}"


def test_port_package_is_not_empty():
    names = {p.relative_to(PORT).as_posix() for p in PORT_FILES}
    assert {"kernels/ops.py", "models/model.py", "serving/pool.py",
            "core/policy_vec.py", "router/router.py", "models/ssm.py",
            "models/rglru.py", "kernels/ssd_scan.py",
            "kernels/rglru_scan.py", "sim/engine.py", "core/simulate.py",
            "scenario/build.py", "scenario/registry.py",
            "premodel/__init__.py", "premodel/quantile.py",
            "premodel/classifier.py", "premodel/conditional.py",
            "fleet/__init__.py", "fleet/spec.py", "fleet/device.py",
            "fleet/frontend.py", "fleet/engine.py", "models/moe.py",
            "serving/batcher.py", "models/api.py",
            "configs/whisper_tiny.py", "configs/internvl2_2b.py",
            "launch/mesh.py", "launch/dryrun.py", "distributed/sharding.py",
            "distributed/policy.py", "distributed/compression.py",
            "distributed/hlo.py", "distributed/shardmap_ops.py",
            "core/gpu_pool.py", "kernels/cost.py",
            "models/templates.py"} <= names
    assert {p.name for p in (PORT / "csrc").glob("*.cu")} == {
        "flash_attention.cu", "decode_attention.cu", "ssd_scan.cu",
        "ssd_scan_bwd.cu", "rglru_scan.cu", "policy_select.cu"}


def test_no_library_attention_or_compile_in_port():
    for path in PORT_FILES:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("scaled_dot_product_attention",
                                         "compile"), \
                    f"{path.name}:{node.lineno} uses {node.attr}"


def test_kernel_modules_have_no_fallback_and_import_triton_lazily():
    for path in sorted((PORT / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), \
            f"{path.name} holds a try statement"
    for path in PORT_FILES + [REPO / "chip_smoke.py"]:
        roots = {r for r, _ in _imported_roots(ast.parse(path.read_text()))}
        assert "triton" not in roots, f"{path.name} imports triton"
