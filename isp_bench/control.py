"""The readings the comparison's limits are set from: for each seed, one
run of the cell (set-up, a short window at the cell's load), the program's
numbers against the reference, and the control's (the reference with every
stage's output rounded to bfloat16, in the program's place, on the same
batches), each beside the cell's limit, with the verdict on each side.  One
JSON line a seed; the exit code is 1 if the program is not correct or the
control is, on any seed.

    python3 isp_bench/control.py --workload artichoke.stream_jpeg \\
        --seeds 11,12,13 --seconds 4
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from isp_bench import env  # noqa: E402

env.setup()
from isp_bench import bench, check, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    args = ap.parse_args(argv)
    limits = spec.limits(args.workload)
    failed = 0
    for seed in (int(x) for x in args.seeds.split(',')):
        r = bench.run(args.workload, seed, args.seconds, False, control=True)
        control_correct, rows = check.verdict(r['control'], limits)
        failed += control_correct or not r['correct']
        print(json.dumps({'workload': args.workload, 'seed': seed, 'correct': r['correct'],
                          'control_correct': control_correct,
                          'program': {k: v['value'] for k, v in r['checks'].items()},
                          'control': rows, 'metrics': r['metrics']}), flush=True)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
