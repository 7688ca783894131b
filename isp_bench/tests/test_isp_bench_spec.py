"""BENCHMARK.json and the files the harness finds by name."""

import json
import re

import pytest

from isp_bench import spec
from isp_bench.readers import least_ms, peaks

BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['isp_bench']
    assert BENCH['command'][1].startswith('isp_bench/')
    assert all(_line(w) for w in BENCH['command'])
    assert isinstance(BENCH['run_seconds'], int) and 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    named = BENCH['configs'] + BENCH['workloads'] + BENCH['end_to_end'] + BENCH['per_layer']
    for entry in named:
        assert NAME.match(entry['name']), entry['name']
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in BENCH[group]]
        assert len(names) == len(set(names))
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for e in BENCH['configs'] + BENCH['workloads']:
        assert _line(e['why'])
    for c in BENCH['configs']:
        assert _line(c['source']) and c['reduced'] == []
    for m in BENCH['per_layer']:
        assert _line(m['layer'])


def test_entry_keys():
    assert all(set(c) == {'name', 'source', 'file', 'reduced', 'why'} for c in BENCH['configs'])
    assert all(set(w) == {'name', 'config', 'traffic', 'chips', 'why'} for w in BENCH['workloads'])
    e2e = {'name', 'unit', 'better', 'bound', 'source'}
    assert all(set(m) - {'workloads'} == e2e for m in BENCH['end_to_end'])
    pl = {'name', 'unit', 'better', 'source', 'layer', 'moves'}
    assert all(set(m) - {'workloads'} == pl for m in BENCH['per_layer'])


def test_bounds_and_sources():
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert {m['name'] for m in BENCH['end_to_end']} >= {'setup_s'}
    for m in BENCH['per_layer']:
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')


def test_cells_configs_and_metrics_agree():
    configs = {c['name'] for c in BENCH['configs']}
    cells = {w['name']: w for w in BENCH['workloads']}
    assert {w['config'] for w in cells.values()} == configs
    pairs = [(w['config'], w['traffic']) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    four = [w for w in cells.values() if w['chips'] == 4]
    assert all(w['chips'] in (1, 4) for w in cells.values())
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells.values():
        e2e = {m['name'] for m in spec.metrics_of(w['name'], 'end_to_end', BENCH)}
        assert 'setup_s' in e2e and len(e2e) >= 2
        per_layer = spec.metrics_of(w['name'], 'per_layer', BENCH)
        assert per_layer, w['name']
        for m in per_layer:
            assert m['moves'] in e2e, (w['name'], m['name'])
        assert spec.config(w['config'])['chips'] == w['chips']
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert set(m.get('workloads', [])) <= set(cells)
    layers = {}
    for m in BENCH['per_layer']:
        layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize('entry', BENCH['configs'], ids=lambda c: c['name'])
def test_every_config_file_loads_by_name(entry):
    cfg = spec.config(entry['name'])
    assert entry['file'] == f"isp_bench/configs/{entry['name']}.json"
    assert cfg['name'] == entry['name'] and cfg['source'] == entry['source']
    assert cfg['reduced'] == entry['reduced']
    cam = cfg['camera']
    assert cam['type'] == 'camera_settings' and len(cam['image_size']) == 2


def test_config_files_are_the_camera_files_verbatim():
    from tpu_darktable_torch.pipeline.camera_settings import CameraSettings

    for entry in BENCH['configs']:
        cam = spec.config(entry['name'])['camera']
        shipped = json.loads((spec.CHECKOUT / 'tpu_darktable_torch' / 'camera_settings'
                              / f"{cam['name']}.json").read_text())
        assert cam == shipped
        CameraSettings.from_dict(cam)


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda w: w['name'])
def test_every_traffic_file_loads_by_name(cell):
    t = spec.traffic(cell['traffic'])
    assert t['entry'] in ('stream', 'batch')
    assert t['pool_frames'] % t['batch_size'] == 0
    assert t['check_calls'] >= 1 and t['warm_batches'] >= 2


@pytest.mark.parametrize('metric', BENCH['per_layer'], ids=lambda m: m['name'])
def test_every_metric_reader_loads_by_name(metric):
    assert callable(spec.metric_reader(metric['name']))


def test_kernel_work_files_and_restated_bounds():
    work = spec.kernel_work()
    assert set(work) == {'rcd_interior_kernel', 'color_smooth_kernel', 'bilateral_fused_kernel'}
    pk = peaks()
    assert pk['fp32_flops_per_s'] == 67e12 and pk['hbm_bytes_per_s'] == 3.35e12
    px = 4096 * 3000
    # the bounds at the published peaks (all three bound by bytes there)
    assert least_ms(work['rcd_interior_kernel'], px, pk) == pytest.approx(16 * px / 3.35e9)
    assert least_ms(work['color_smooth_kernel'], px, pk) == pytest.approx(20 * px / 3.35e9)
    assert least_ms(work['bilateral_fused_kernel'], px, pk) == pytest.approx(8 * px / 3.35e9)


def test_limits_cover_every_cell():
    from isp_bench.check import NUMBERS

    for w in BENCH['workloads']:
        lim = spec.limits(w['name'])
        assert set(NUMBERS) <= set(lim)
        assert lim['jpeg_mismatch'] == 0
