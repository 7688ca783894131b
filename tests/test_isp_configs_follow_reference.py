"""Every configuration of the benchmark (isp_bench/configs/) against the
benchmark's plain reference (isp_bench/reference/), on the CPU at a small
size: the port's ImageProcessor and the reference on the same seeded
frames over three batches, and, for the local-Laplacian camera, the
bfloat16 control that the comparison must reject.  The card runs the same
comparison at the configurations' own sizes (isp_bench/check.py)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from isp_bench import check, scene, spec
from isp_bench.reference.isp import Camera, ReferenceISP, lerp
from tpu_darktable_torch.pipeline.camera_settings import CameraSettings
from tpu_darktable_torch.pipeline.image_processor import ImageProcessor

SIZE = [128, 96]
CONFIGS = sorted(p.stem for p in (Path(spec.HERE) / 'configs').glob('*.json'))


def _camera(name):
    return dict(spec.config(name)['camera'], image_size=SIZE)


@pytest.mark.parametrize('name', CONFIGS)
def test_config_follows_the_reference_on_the_cpu(name):
    """Bounds equal, metrics within 1e-6, uint8 within one count, as the
    reference's own tests hold its routes."""
    cam = _camera(name)
    pool = scene.frame_pool(cam, 4, 2**31 + 17, 'cpu')
    proc = ImageProcessor.from_camera_settings(CameraSettings.from_dict(cam), device='cpu')
    ref = ReferenceISP(Camera.from_dict(cam), 'cpu')
    bounds = torch.zeros(2)
    for k, idx in enumerate([[0, 1], [2, 3], [0, 1]]):
        frames = [torch.from_numpy(pool[i]) for i in idx]
        m_in = proc.metrics
        out = proc.process_batch(torch.stack(frames))
        alpha = ref.alpha(k == 0)
        bounds = lerp(bounds, ref.batch_bounds([ref.sample(ref.front(f)) for f in frames]), alpha)
        u8, m = ref.run_batch(frames, bounds, torch.zeros(5) if m_in is None else m_in, alpha)
        assert torch.equal(proc.bounds, bounds)
        # the CPU's float16 matmuls may sum in another order from one
        # process to the next
        assert (proc.metrics - m).abs().max() <= 1e-6
        for j in range(len(frames)):
            assert (out[j].int() - u8[j].int()).abs().max() <= 1


def _run_cell(cell, seed, **kw):
    """bench.run of a cell on the CPU at SIZE, in a process of its own: the
    harness refuses to run where JAX is loaded, as this test process has."""
    code = ('import json, sys\n'
            f'sys.path.insert(0, {str(spec.CHECKOUT)!r})\n'
            'from isp_bench import bench\n'
            f'r = bench.run({cell!r}, {seed}, 1.5, False, devices=["cpu"], '
            f'camera_override={{"image_size": {SIZE}}}, **{kw!r})\n'
            'print(json.dumps(r))\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=spec.CHECKOUT, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_laplacian_camera_runs_its_route_and_rejects_the_control():
    """The local-Laplacian camera's cell, run whole on the CPU at a small
    size: the reference takes its Laplacian stage file, the run is correct
    and the bfloat16 control in its place is not."""
    cfg = spec.config('artichoke_lap')
    settings = cfg['camera']['image_processing']
    assert settings['enable_laplacian'] is True and set(cfg['assumed']) == {
        'enable_laplacian', 'lap_clarity'}
    assert 'local_contrast' in ReferenceISP(Camera.from_dict(_camera('artichoke_lap')),
                                            'cpu').stages
    r = _run_cell('artichoke_lap.stream_jpeg', 2**31 + 43, control=True)
    assert r['correct'] is True, r['checks']
    ok, rows = check.verdict(r['control'], spec.limits('artichoke_lap.stream_jpeg'))
    assert ok is False, rows
