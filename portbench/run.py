"""The benchmark's command: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Exits non-zero, printing no result,
when the card the cell asks for is missing, when the program cannot be
imported, or when a module of the JAX stack or the JAX package was
loaded by the time the window closed, in this process or in a rank it
started.
"""

import time

T_START = time.perf_counter()    # set-up is timed from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The program's only build cache is its nvcc directory, fixed inside the
# checkout (``build/torch_kernels/``): the first run of a cell in a
# checkout builds the flash kernels there, every later run loads them.
ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    bench = harness.load_benchmark()
    cell = harness.find(bench["workloads"], args.workload, "workload")

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"portbench: cell {args.workload} needs {cell['chips']} "
              f"CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace), "cuda",
                                  T_START)
        found = harness.forbidden_loaded()
    except harness.ForbiddenLoaded as e:
        found = [str(e)]
    if found:
        print(f"portbench: modules of the JAX stack or package loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
