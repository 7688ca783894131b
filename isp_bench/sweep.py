"""Find the highest capture rate an open-loop cell sustains: one set-up,
then one window at each rate, in order.  Prints a JSON line a rate: the
feed lag (how late the executor took each capture) over the first and the
last quarter of the window, and the frame tail.  A rate is sustained where
the lag does not grow over the window.

    python3 isp_bench/sweep.py --workload beetroot.rig_rate --seed 7 \\
        --seconds 15 --rates 0.8,1.0,1.2
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from isp_bench import env  # noqa: E402

env.setup()
from isp_bench import bench, stats  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--rates', required=True)
    args = ap.parse_args(argv)
    s = bench.prepare(args.workload, args.seed)
    batch = s.traffic['batch_size']
    for rate in (float(r) for r in args.rates.split(',')):
        start = len(s.rec.take)
        s.go(seconds=args.seconds, rate=rate)
        firsts = list(range(start, len(s.rec.take), batch))
        lags = [(s.rec.take[i] - s.rec.due[i]) * 1e3 for i in firsts]
        q = max(1, len(lags) // 4)
        lat = [(s.rec.done[i] - s.rec.due[i]) * 1e3 for i in range(start, len(s.rec.take))]
        print(json.dumps({'rate': rate, 'captures': len(firsts), 'lag_first_ms': stats.median(lags[:q]),
                          'lag_last_ms': stats.median(lags[-q:]), 'lag_max_ms': max(lags),
                          'frame_p50_ms': stats.median(lat), 'frame_p95_ms': stats.percentile(lat, 95)}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
