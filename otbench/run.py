"""The port's benchmark: one run of one cell on the card.

    python3 -m otbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison with the
reference read, beside its limit. The same numbers and limits end standard
error. Exits non-zero, printing no result, when torch sees no card or
fewer cards than the cell asks for, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from otbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"otbench: the cell needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)         # one host thread: no idle pool spinning on shared cores
    result, lines = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                device="cuda", t_start=T_START, cell=cell)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
