"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 portbench/limits.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds <run_seconds> --out <file.jsonl>

For each seed, in one process: the cell's set-up and window as a run makes
them, then the numbers compared for the program (the lower readings). For
each control seed besides: the control, the reference computed in TF32 in
the program's place, one precision below the configuration's float32; the
search faults of ``core/faults.py`` planted under a short loop of two
passes over the pool; and k-means left unchanged, the gain of centroids
drawn from the training rows and never moved (the upper readings). One
JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed, seconds, control, device) -> dict:
    import numpy as np

    from portbench.core import checks, faults, session

    prep = session.prepare(cell, seed, device, trace=False)
    runs, _, _ = session.window(prep, seconds, trace=False)
    out = {"seed": seed, "setup": prep.setup,
           "qps": runs[0].queries_answered / runs[0].window_s}
    fault_runs = {}
    if control:
        nbatch = len(prep.pool) // prep.batch
        for name, plant in faults.SEARCH_FAULTS.items():
            with plant():
                fault_runs[name] = prep.loop.run(
                    prep.call(), prep.pool, prep.batch, rng=prep.rng(2),
                    batches=2 * nbatch,
                    sample=cell.traffic["sample_per_batch"])
    batch_probes = [prep.builder.probes(prep.index, x, prep.nprobe)
                    for x in session.batches(prep)]
    lists = prep.index.list_of_ids(np.arange(len(prep.xb)))
    ncent = len(prep.centroids)
    session.release(prep)
    t = time.perf_counter()
    judged = session.judge(prep, runs)
    out["judge_s"] = time.perf_counter() - t
    out["program"] = judged.numbers
    out["why_wrong"] = why_wrong(prep, judged, np.concatenate(batch_probes),
                                 lists, judged.numbers.pop("wrong_rows"))
    if control:
        ref = prep.reference
        ctrl = ref.IVFFlatL2(judged.xb, judged.cent, tf32=True,
                             rel_tol=0.0).answers(judged.pool, prep.k,
                                                  prep.nprobe)
        n = len(prep.pool)
        cmp = checks.Compared(np.arange(n), ctrl.high_d.cpu().numpy(),
                              ctrl.ivf_i.cpu().numpy().astype(np.float64), n)
        out["control_tf32"] = checks.compare(
            cmp, judged.answers, judged.pool, judged.xb, ref.row_distances)
        out["control_tf32"].pop("wrong_rows")
        out["faults"] = {}
        for name, r in fault_runs.items():
            out["faults"][name] = session.numbers_of(
                prep, [r], judged.answers, judged.xb, judged.pool)
            out["faults"][name].pop("wrong_rows")
        drawn = prep.rng(3).choice(len(prep.xt), ncent, replace=False)
        out["faults"]["kmeans_unchanged"] = {
            "kmeans_gain": ref.kmeans_step_gain(judged.xt,
                                                judged.xt[drawn])}
    session.free(prep.device)
    return out


def why_wrong(prep, judged, prog_probes, prog_lists, rows) -> dict:
    """Where the program departs from the reference's float64 choices:
    queries it probes otherwise, base rows it lists otherwise (and whether
    each is a tie in float32, as ``Answers`` of the reference allows), and
    the answers still wrong."""
    import numpy as np

    ref = prep.reference.IVFFlatL2(judged.xb, judged.cent)
    moved = np.nonzero(prog_lists != ref.assign.cpu().numpy())[0]
    ref_probes = judged.answers.probes.cpu().numpy()
    diff = sum(set(a) != set(b) for a, b in zip(prog_probes, ref_probes))
    return {"wrong": len(np.unique(rows)), "queries_probing_otherwise": diff,
            "rows_listed_otherwise": len(moved),
            "of_them_tied": int(np.isin(moved, ref.tied.cpu().numpy()).sum()),
            "tied_rows": len(ref.tied)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from portbench.core import device as card, spec

    cell = spec.load_cell(os.path.join(ROOT, "BENCHMARK.json"),
                          args.workload)
    why = card.chips_missing(cell.chips)
    if why:
        print(f"limits: {why}", file=sys.stderr)
        return 3
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    with open(args.out, "a") as f:
        for seed in seeds + sorted(control - set(seeds)):
            t = time.perf_counter()
            r = readings(cell, seed, args.seconds, seed in control,
                         torch.device("cuda", 0))
            r["workload"], r["seconds_taken"] = cell.name, \
                time.perf_counter() - t
            r["card"] = [torch.cuda.get_device_name(0), card.power_limit()]
            line = json.dumps(r)
            f.write(line + "\n")
            f.flush()
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
