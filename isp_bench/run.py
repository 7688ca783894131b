"""The benchmark's command:

    python3 isp_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds tpu_darktable_torch.  It needs the
cards the cell asks for and exits with 2, printing no result, without them.
The last line of standard output is the result (JSON); the numbers of the
comparison, each with its limit, are the last lines of standard error.
Caches (the port's nvcc builds) live under build/isp_bench/ of the checkout.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from isp_bench import env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    checkout = env.setup()
    from isp_bench import bench, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        print(f"isp_bench: the cell needs {cell['chips']} CUDA device(s); found "
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}', file=sys.stderr)
        return 2
    import tpu_darktable_torch

    if checkout not in Path(tpu_darktable_torch.__file__).resolve().parents:
        print('isp_bench: tpu_darktable_torch is not the checkout\'s', file=sys.stderr)
        return 2
    result = bench.run(args.workload, args.seed, args.seconds, bool(args.trace),
                       t_process=T_PROCESS)
    for name, row in result['checks'].items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
