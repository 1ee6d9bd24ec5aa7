"""Auto-tuning demo (faiss demos/demo_auto_tune.py): explore the
nprobe / efSearch grid of an IVF-HNSW index and print the Pareto front.

    python -m tpu_ann_torch.demos.demo_auto_tune [--device cpu]
"""


def main(device="cuda", d=64, nt=20000, nb=100000, nq=500,
         spec="IVF256_HNSW16,Flat", k=10):
    from ..utils.autotune import IntersectionCriterion, ParameterSpace
    from ..utils.datasets import SyntheticDataset
    from ..utils.factory import index_factory

    ds = SyntheticDataset(d=d, nt=nt, nb=nb, nq=nq, device=device)
    index = index_factory(d, spec, device=device)
    print("training", index)
    index.train(ds.get_train())
    index.add(ds.get_database())

    ps = ParameterSpace()
    ps.initialize(index)
    ps.verbose = True
    crit = IntersectionCriterion(ds.nq, k)
    crit.set_groundtruth(None, ds.get_groundtruth(k))
    ops = ps.explore(index, ds.get_queries(), crit)

    print("\nPareto-optimal operating points:")
    front = ops.optimal_pts()
    for p in front:
        print(f"  {p.key}: recall={p.perf:.4f} t={p.t*1000:.1f}ms")
    assert front, "no operating point"
    return {"points": len(ops.all_pts),
            "front": [(p.key, p.perf, p.t) for p in front],
            "best_recall": max(p.perf for p in front)}


if __name__ == "__main__":
    from . import cli_device

    main(cli_device(__doc__.splitlines()[0]))
