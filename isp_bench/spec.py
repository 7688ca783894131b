"""Where the benchmark finds its parts: BENCHMARK.json at the root of the
checkout, and under isp_bench/ one file for each configuration
(configs/<name>.json), traffic mix (traffic/<name>.json: a mix with
`captures_per_s` is an open loop at that rate, one without a closed loop),
per-layer metric (metrics/<name>.py, a `read(ctx)` that returns a number or
None), hand kernel's work (kernels/<symbol>.json) and cell's limits of the
comparison (limits/<cell>.json, else limits/default.json).  The reference
finds its own stage files, one for each setting its built-in stages do not
cover (reference/routes/, see reference/isp.py).  A new cell,
configuration or metric is a new file and a new entry; nothing here names
one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
OUT = HERE / 'out'


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return _json(CHECKOUT / 'BENCHMARK.json')


def cell(name: str, bench: dict | None = None) -> dict:
    bench = benchmark() if bench is None else bench
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def config(name: str) -> dict:
    return _json(HERE / 'configs' / f'{name}.json')


def traffic(name: str) -> dict:
    return _json(HERE / 'traffic' / f'{name}.json')


def limits(cell_name: str) -> dict:
    path = HERE / 'limits' / f'{cell_name}.json'
    return _json(path if path.is_file() else HERE / 'limits' / 'default.json')


def kernel_work() -> dict[str, dict]:
    """symbol -> its work file, for every file in kernels/."""
    return {p.stem: _json(p) for p in sorted((HERE / 'kernels').glob('*.json'))}


def metric_reader(name: str):
    """The `read` function of metrics/<name>.py (the name may hold dots)."""
    path = HERE / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'isp_bench_metric_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(cell_name: str, kind: str, bench: dict | None = None) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that the cell reports."""
    bench = benchmark() if bench is None else bench
    return [m for m in bench[kind] if cell_name in m.get('workloads', [cell_name])]
