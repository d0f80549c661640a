"""Nothing the harness or the reference loads is JAX, its libraries or the
JAX package (top-level names compared whole: the port's name begins with
the JAX package's); the reference loads nothing of the port."""
import ast
import subprocess
import sys

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "fthmc_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, f"{path}: {mod}"
    for path in sorted((BENCH / "reference").glob("*.py")):
        for mod in _imports(path):
            assert mod.split(".")[0] != "fthmc_tpu_torch", f"{path}: {mod}"


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_loaded_modules():
    """What a run loads (the harness, every driver and reader, the port's
    drivers and kernels' wrappers) and what the reference loads alone."""
    run = _loaded(
        "import sys\n"
        "from benchmark import harness\n"
        "for w in ('fthmc16_flagship', 'hmc64_headline'):\n"
        "    c = harness.Cell(harness.ROOT, w); c.readers()\n"
        "import fthmc_tpu_torch.hmc, fthmc_tpu_torch.weights\n"
        "print(*{m.split('.')[0] for m in sys.modules})\n")
    assert "fthmc_tpu_torch" in run and not run & FORBIDDEN
    ref = _loaded(
        "import sys\n"
        "import benchmark.reference.sampler, benchmark.reference.flow\n"
        "print(*{m.split('.')[0] for m in sys.modules})\n")
    assert not ref & (FORBIDDEN | {"fthmc_tpu_torch"})
