"""On the card (marked cuda; each test decides inside itself whether a card
is present), at a frame size a test run holds: the control in the program's
place fails each cell's limits while the program passes them, and short
runs of the cells are correct.

    python -m pytest isp_bench/tests/test_isp_bench_card.py -m cuda
"""

import pytest
import torch

from isp_bench import bench, check, spec


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', [w['name'] for w in spec.benchmark()['workloads']])
def test_control_is_not_correct_on_the_card(cell):
    _card()
    r = bench.run(cell, 2**31 + 3, 2.0, False, control=True,
                  camera_override={'image_size': [1024, 768]})
    assert r['correct'], r['checks']
    ok, rows = check.verdict(r['control'], spec.limits(cell))
    assert ok is False, rows


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['artichoke.stream_jpeg', 'beetroot.rig_rate'])
def test_short_run_is_correct_on_the_card(cell):
    _card()
    r = bench.run(cell, 2**31 + 17, 2.0, False, camera_override={'image_size': [1024, 768]})
    assert r['correct'], r['checks']
