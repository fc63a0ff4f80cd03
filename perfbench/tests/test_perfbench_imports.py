"""Nothing the benchmark runs may load JAX or the JAX package, and the
plain references may not load the program."""

import ast
from pathlib import Path

from perfbench import harness

PERFBENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    bad = {}
    for path in PERFBENCH.rglob("*.py"):
        found = {m for m in _imports(path) if m in harness.BANNED}
        if found:
            bad[str(path.relative_to(PERFBENCH))] = sorted(found)
    assert not bad, bad


def test_references_import_nothing_of_the_program():
    for path in (PERFBENCH / "reference").rglob("*.py"):
        mods = set(_imports(path))
        assert "horovod_tpu_torch" not in mods, path
        assert mods <= {"__future__", "math", "typing", "torch",
                        "perfbench"}, (path, mods)


def test_banned_names_compare_whole_top_level_names():
    assert harness.banned_modules(["horovod_tpu_torch.models", "torch",
                                   "jaxtyping", "flaxen.x"]) == []
    assert harness.banned_modules(["horovod_tpu.common", "jax.numpy",
                                   "optax"]) == ["horovod_tpu", "jax",
                                                 "optax"]
