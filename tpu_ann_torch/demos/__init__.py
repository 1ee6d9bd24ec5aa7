"""Runnable demos of tpu_ann_torch — twins of the JAX package's
``demos/``, one module each:

    python -m tpu_ann_torch.demos.demo_custom_invlists [--device cpu]

Each module's ``main(device="cuda", ...)`` takes the demo's sizes as
keyword defaults (the JAX demos' own sizes) and returns the numbers it
prints (recall, reconstruction error, intersection); its asserts are the
demo's checks. Every index lives on ``device``: on the card the IVF
searches go through the hand-written scan kernels.
"""

import argparse


def cli_device(description: str) -> str:
    """The ``--device`` argument of a demo's command line ("cuda" by
    default)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help='where the indexes live: "cuda" (default), '
                         '"cuda:<i>" or "cpu"')
    return ap.parse_args().device
