"""The benchmark of `coma_unet_tpu_torch` on NVIDIA GPUs.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` from the root of a checkout: set-up,
a window of `--seconds` (with `--trace 1`, a traced window of the
traffic's `trace_units`), the check against the plain reference, and, as
the last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checked`, each compared number beside its limit; standard error ends
with the same numbers. Exits 2 without a result where there is no CUDA
device or fewer than the cell asks for, and 3 where a module of JAX or
of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from perfbench import harness

    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for line in result.pop("notes"):
        print(line, file=sys.stderr)
    for name, c in result["checked"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
