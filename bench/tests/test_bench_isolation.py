"""The benchmark stands apart: nothing under ``bench/`` imports JAX or the
JAX package (``repro``), the plain reference imports nothing of the port
(``repro_torch``), and nothing reads the JAX package's benchmarks or
their committed results."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources():
    return sorted(BENCH.rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _top(name: str) -> str:
    return name.split(".")[0]


def test_top_level_names_compare_whole():
    assert _top("repro_torch.models") == "repro_torch"
    assert _top("repro_torch.models") not in FORBIDDEN
    assert _top("repro.models") in FORBIDDEN


def test_nothing_in_bench_imports_jax_or_the_jax_package():
    found = {(p.name, m) for p in _sources() for m in _imports(p)
             if _top(m) in FORBIDDEN}
    assert not found, found


def test_the_reference_imports_nothing_of_the_port():
    ref = BENCH / "reference"
    found = {(p.name, m) for p in sorted(ref.rglob("*.py"))
             for m in _imports(p) if _top(m) == "repro_torch"}
    assert not found, found
    # and it reaches the rest of the benchmark only for its leaf records
    # and its shared plain pieces
    allowed = {"torch", "bench", "collections", "typing", "math",
               "__future__"}
    assert {_top(m) for p in sorted(ref.rglob("*.py"))
            for m in _imports(p)} <= allowed


def test_nothing_reads_the_jax_packages_benchmarks():
    folder, results = "bench" + "marks", "BENCH" + "_"
    for p in _sources():
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert folder not in text and results not in text, p
