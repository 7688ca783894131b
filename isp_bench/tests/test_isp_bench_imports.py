"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: tpu_darktable_torch is not tpu_darktable), and the
reference imports nothing of the measured package."""

import ast
from pathlib import Path

import pytest

from isp_bench import spec

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'tpu_darktable'}
SOURCES = sorted(p for p in spec.HERE.rglob('*.py') if '__pycache__' not in p.parts)
REFERENCE = spec.HERE / 'reference'


def _imports(path: Path) -> set[str]:
    """Top-level names of every absolute import in the file (anywhere in it,
    also inside functions)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split('.')[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, 'attr', '') == 'import_module'
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split('.')[0])
    return names


def test_the_scan_sees_every_source():
    rel = {p.relative_to(spec.HERE).as_posix() for p in SOURCES}
    assert {'run.py', 'bench.py', 'check.py', 'reference/isp.py', 'reference/jpeg.py',
            'metrics/feed_lag_ms.rig.py'} <= rel


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_no_jax_and_no_jax_package(path):
    assert not (_imports(path) & FORBIDDEN), path


@pytest.mark.parametrize('path', [p for p in SOURCES if REFERENCE in p.parents],
                         ids=lambda p: p.relative_to(spec.HERE).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert 'tpu_darktable_torch' not in names and 'isp_bench' not in names, path


def test_the_scan_compares_whole_names(tmp_path):
    ok = tmp_path / 'ok.py'
    ok.write_text('import tpu_darktable_torch.ops\nfrom tpu_darktable_torch import jpeg\n')
    bad = tmp_path / 'bad.py'
    bad.write_text('def f():\n    from tpu_darktable.ops import rcd\n')
    assert not (_imports(ok) & FORBIDDEN)
    assert _imports(bad) & FORBIDDEN == {'tpu_darktable'}
