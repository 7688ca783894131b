"""The local Laplacian's share of its roofline (percent): the stage's least time at the frame's
geometry over its card ms a frame (`laplacian_card_ms.stream`), by readers.least_ms's rule and
peaks.json's peaks.

The work is what the published algorithm does at the frame's geometry, whatever implements it, so
any later implementation is read against the same count: the remap curve on each gamma copy of
padded level 0, the 5x5 reductions of the seven pyramids (the plain one and the six gamma copies),
the 4x expansion of each of them to every level but the coarsest, and the blend.  The bytes are
the luminance plane read once and written once; the stored pyramids are not counted, since a
fused implementation need not store them."""

from isp_bench import readers
from isp_bench.reference.frozen.ops.laplacian import num_levels_for
from isp_bench.tracer import isp_stage

NUM_GAMMA = 6
# operations an element; the counts follow the plain stage's formulas
OPS = {'curve': 32, 'reduce': 27, 'expand': 6, 'blend': 17}
BYTES_PER_PIXEL = 8
WHY = ('curve: 32 an element of padded level 0 (difference, two selects, the linear branch 4, the '
       'clamped ratio 4, the bezier 10, the branch select 3, the clarity term with its exp 7); '
       'reduce: 27 a coarse pixel (two fine rows of 5 taps, then 5 taps across); expand: 6 a '
       'fine pixel (3- and 2-tap phases on each axis); blend: 17 a fine pixel (bracketing pair '
       'and weight 10, two coefficients, the lerp, the sum with the expansion); '
       'lum in and out, float32 (8 B)')

_card_ms = isp_stage(('bilateral',), 'laplacian')


def work(width: int, height: int) -> dict:
    """Operations and bytes of one frame, with the levels and the pad from
    the frame size as num_levels_for and auto_max_supp give them (the full
    pad, 1 << (levels - 1), for any curve but the identity)."""
    levels = num_levels_for(width, height)
    pad = 1 << (levels - 1)
    bh, bw = height + 2 * pad, width + 2 * pad
    px = [((bh + (1 << l) - 1) >> l) * ((bw + (1 << l) - 1) >> l) for l in range(levels)]
    fine = sum(px[:-1])
    ops = (NUM_GAMMA * px[0] * OPS['curve']
           + (1 + NUM_GAMMA) * sum(px[1:]) * OPS['reduce']
           + (1 + NUM_GAMMA) * fine * OPS['expand']
           + fine * OPS['blend'])
    return {'ops': ops, 'bytes': BYTES_PER_PIXEL * width * height}


def least_ms(width: int, height: int) -> float:
    w = work(width, height)
    per_pixel = {'ops_per_pixel': w['ops'] / (width * height),
                 'bytes_per_pixel': w['bytes'] / (width * height)}
    return readers.least_ms(per_pixel, width * height, readers.peaks())


def _frame_size(ctx):
    """(width, height) of the program's frames, from a kept call's output."""
    for c in ctx.calls:
        out = getattr(c, 'out', None)
        if out is not None and getattr(out, 'ndim', 0) == 4:
            return int(out.shape[2]), int(out.shape[1])
    return None


def read(ctx):
    spent = _card_ms(ctx)
    size = _frame_size(ctx)
    if spent is None or size is None:
        return None
    return 100.0 * least_ms(*size) / spent
