"""Whole runs on the CPU at a small size (the command itself refuses to run
without a card; these drive the rest of it): the result line, and each
fault a cell can have, planted under the timed path, turning `correct`
false."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from isp_bench import bench, check, spec

SMALL = {'image_size': [128, 96]}
SEED = 2**31 + 99


def _run(cell, devices=('cpu',), seconds=1.5, fault=None, traced=False, control=False):
    return bench.run(cell, SEED, seconds, traced, devices=list(devices), camera_override=SMALL,
                     fault=fault, control=control)


@pytest.mark.parametrize('cell', ['artichoke.stream_jpeg', 'beetroot.rig_rate',
                                  'artichoke.batch_device'])
def test_sound_run_is_correct_and_prints_every_key(cell):
    r = _run(cell)
    assert list(r)[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert list(r)[-1] == 'checks'
    assert r['correct'] is True and r['failed'] == 0 and r['attempted'] > 0
    assert set(r['device']) >= {'platform', 'kind', 'count', 'memory_peak_bytes'}
    want = {m['name'] for m in spec.metrics_of(cell, 'end_to_end')}
    assert set(r['metrics']) == want
    for m in r['metrics'].values():
        assert set(m) == {'value', 'unit'}
    assert all(set(row) == {'value', 'limit'} for row in r['checks'].values())
    json.dumps(r)


def test_sound_sharded_run_is_correct():
    # the harness's path for a cell over four cards: the rig over a mesh
    r = _run('beetroot.rig_rate', devices=['cpu'] * 4)
    assert r['correct'] is True


@pytest.mark.parametrize('cell', ['artichoke.stream_jpeg', 'beetroot.rig_rate',
                                  'artichoke.batch_device'])
def test_traced_run_reads_its_per_layer_metrics(cell):
    r = _run(cell, traced=True)
    assert r['correct'] is True
    want = {m['name'] for m in spec.metrics_of(cell, 'per_layer')}
    # on the CPU no CUDA event or device activity exists: what reads them is silent
    assert set(r['metrics']) <= want
    if 'feed_lag_ms.rig' in want:
        assert 'feed_lag_ms.rig' in r['metrics']
    json.dumps(r)


@pytest.mark.parametrize('cell', ['artichoke.stream_jpeg', 'beetroot.rig_rate',
                                  'artichoke.batch_device'])
def test_control_is_not_correct(cell):
    r = _run(cell, control=True)
    assert r['correct'] is True
    ok, rows = check.verdict(r['control'], spec.limits(cell))
    assert ok is False, rows


def _state_unchanged(proc):
    orig = proc.process_batch

    def process_batch(batch):
        b, m = proc.bounds, proc.metrics
        out = orig(batch)
        if b is not None:
            proc.bounds, proc.metrics = b, m
        return out
    proc.process_batch = process_batch


def _half_batch(proc):
    orig = proc.process_batch

    def process_batch(batch):
        b, m = proc.bounds, proc.metrics
        orig(batch[: batch.shape[0] // 2])          # the state from half of the batch
        state = proc.bounds, proc.metrics
        proc.bounds, proc.metrics = b, m
        out = orig(batch)
        proc.bounds, proc.metrics = state
        return out
    proc.process_batch = process_batch


def _answer_altered(proc):
    orig = proc.process_batch

    def process_batch(batch):
        out = orig(batch).clone()
        out[:, 5, 7, 1] += 128
        return out
    proc.process_batch = process_batch


@pytest.mark.parametrize('cell', ['artichoke.stream_jpeg', 'beetroot.rig_rate',
                                  'artichoke.batch_device'])
@pytest.mark.parametrize('fault', [_state_unchanged, _half_batch, _answer_altered],
                         ids=['state_unchanged', 'half_batch', 'answer_altered'])
def test_fault_makes_the_run_incorrect(cell, fault):
    r = _run(cell, fault=fault)
    assert r['correct'] is False, r['checks']


def test_exchange_between_cards_left_out(monkeypatch):
    from tpu_darktable_torch.parallel import mesh

    def gather(tensors, device, dim=0):
        # only the first card's shard arrives; it stands in for the others
        return torch.cat([mesh.put(tensors[0], device)] * len(tensors), dim=dim)
    monkeypatch.setattr(mesh, 'gather', gather)
    r = _run('beetroot.rig_rate', devices=['cpu'] * 4)
    assert r['correct'] is False
    assert r['checks']['bounds_gap']['value'] > r['checks']['bounds_gap']['limit']


@pytest.mark.parametrize('cell,cards', [('artichoke.stream_jpeg', 1), ('beetroot.rig_rate', 4)])
def test_jpeg_byte_altered_where_produced(monkeypatch, cell, cards):
    from tpu_darktable_torch.ops import jpeg

    result = jpeg.PendingJpeg.result

    def altered(self):
        out = result(self).copy()
        out[len(out) // 2] ^= 0x10
        return out
    monkeypatch.setattr(jpeg.PendingJpeg, 'result', altered)
    r = _run(cell, devices=['cpu'] * cards)
    assert r['correct'] is False
    assert r['checks']['jpeg_mismatch']['value'] > 0


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert 'tpu_darktable_torch' in sys.modules
    assert bench.forbidden_modules() == [m for m in bench.forbidden_modules()
                                         if m.split('.')[0] in bench.FORBIDDEN]
    monkeypatch.setitem(sys.modules, 'jaxlib.fake', object())
    assert 'jaxlib.fake' in bench.forbidden_modules()
    assert not any(m.startswith('tpu_darktable_torch') for m in bench.forbidden_modules())


def test_command_without_a_card_or_the_program_prints_no_result(tmp_path):
    shutil.copy(spec.CHECKOUT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(spec.HERE, tmp_path / 'isp_bench',
                    ignore=shutil.ignore_patterns('__pycache__', 'out'))
    for root in (tmp_path, spec.CHECKOUT):
        p = subprocess.run([sys.executable, 'isp_bench/run.py', '--workload',
                            'artichoke.stream_jpeg', '--seed', str(SEED), '--seconds', '1',
                            '--trace', '0'], cwd=root, capture_output=True, text=True,
                           timeout=120, env={'PATH': '/usr/bin:/bin', 'CUDA_VISIBLE_DEVICES': ''})
        assert p.returncode != 0
        assert p.stdout.strip() == ''


def test_reservoir_keeps_the_first_call_and_a_bounded_sample():
    import random

    from isp_bench.drive import Call, Recorder

    rec = Recorder(keep=2, rng=random.Random(1))
    for k in range(50):
        c = Call(k, 2 * k, 2, [0, 1], 0.0, 0.0, None, None, None, None, None, k >= 3)
        rec.calls.append(c)
        if rec.sample(c):
            c.out = np.zeros(1)
    kept = [c.index for c in rec.kept_calls()]
    assert kept[0] == 0 and len(kept) == 3 and all(k >= 3 for k in kept[1:])
