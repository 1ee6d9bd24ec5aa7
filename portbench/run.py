"""Run one cell of the benchmark of ``tpu_ann_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is looked up by name in
``BENCHMARK.json``; its files are found by name under ``portbench/`` (see
portbench/README.md). Set-up parts go to standard output as they finish;
the last line of standard output is the result, one JSON object. The
numbers that decide ``correct`` are the last lines of standard error, each
beside its limit. Without enough CUDA devices, or with JAX loaded once the
window has closed, the run exits with a code other than 0 and prints no
result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # build and kernel caches at fixed paths inside the checkout; the
    # port's own nvcc cache is tpu_ann_torch/_build, also inside it
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from portbench.core import device as card, spec

    cell = spec.load_cell(os.path.join(ROOT, "BENCHMARK.json"),
                          args.workload)
    why = card.chips_missing(cell.chips)
    if why:
        print(f"portbench: {why}; no result", file=sys.stderr)
        return 3
    import tpu_ann_torch  # noqa: F401  (fails here in a bare checkout)

    return run(cell, args, torch.device("cuda", 0))


def run(cell, args, device) -> int:
    """The run once the card is there: the result line last on standard
    output, the compared numbers last on standard error."""
    from portbench.core import device as card, session

    result = session.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, T_PROCESS,
                              log=lambda s: print(s, flush=True))
    loaded = card.forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}; "
              f"no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
