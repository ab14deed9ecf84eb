"""Print the top kernels of a ``utils/profiling.trace`` capture, or the
difference of two captures by kernel.

Port of the JAX package's ``scripts/trace_ops.py``, with its options:
``summarize_trace`` aggregates by category and by source line; this prints
each kernel (on a capture without device activity, each CPU op) with its ms
a step, its launches, its category and the source line that spent most of
its time, the rows filtered by a category substring (``--cat``), or, with
``--diff``, the change from the first capture to the second by kernel.
Runs on the card unless ``--device cpu`` is given (reading a capture on a
host without a card).

    python -m medical_image_classification_tpu_torch.scripts.trace_ops \\
        LOGDIR [--top 40] [--steps 3] [--cat gemm] [--device cuda]
    python -m medical_image_classification_tpu_torch.scripts.trace_ops \\
        LOGDIR --diff LOGDIR2 [--steps 3 --steps2 3]
"""

from __future__ import annotations

import argparse
import collections

from medical_image_classification_tpu_torch.cli.fusion_train import device_of
from medical_image_classification_tpu_torch.utils import profiling


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("logdir")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--steps2", type=int, default=3)
    p.add_argument("--cat", default="", help="filter: category substring")
    p.add_argument("--diff", default="", help="second logdir to diff against")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_ops(logdir: str, steps: int) -> dict:
    """{kernel name: [ms a step, category, top source, launches]}."""
    ops = collections.defaultdict(lambda: [0.0, "", "", 0])
    src = collections.defaultdict(collections.Counter)
    for r in profiling.attribute(profiling.load_trace(logdir)):
        rec = ops[r["name"]]
        rec[0] += r["us"] / 1e3 / max(steps, 1)
        rec[1] = r["category"]
        rec[3] += 1
        src[r["name"]][r["source"]] += r["us"]
    for name, rec in ops.items():
        rec[2] = src[name].most_common(1)[0][0]
    return dict(ops)


def main(args) -> list:
    """Prints the table; returns its rows."""
    device_of(args)
    ops = load_ops(args.logdir, args.steps)
    if args.diff:
        ops2 = load_ops(args.diff, args.steps2)
        rows = []
        for k in set(ops) | set(ops2):
            a = ops.get(k, [0.0, "", "", 0])
            b = ops2.get(k, [0.0, "", "", 0])
            rows.append((b[0] - a[0], a[0], b[0], a[1] or b[1], k))
        rows.sort(reverse=True)
        print(f"{'delta':>8} {'A ms':>8} {'B ms':>8}  cat / op")
        for d, a, b, cat, k in rows[:args.top]:
            print(f"{d:8.3f} {a:8.3f} {b:8.3f}  [{cat}] {k}")
        ta = sum(v[0] for v in ops.values())
        tb = sum(v[0] for v in ops2.values())
        print(f"\ntotal: A {ta:.2f} ms  B {tb:.2f} ms  delta {tb - ta:.2f}")
        return rows[:args.top]

    rows = sorted(((v[0], v[1], v[2], v[3], k) for k, v in ops.items()),
                  reverse=True)
    total = sum(r[0] for r in rows)
    print(f"total device-op: {total:.2f} ms/step, {len(rows)} distinct ops")
    shown = []
    for ms, cat, src, n, k in rows:
        if args.cat and args.cat not in cat:
            continue
        print(f"{ms:8.3f} ms x{n:<3} [{cat}] {k}   <{src}>")
        shown.append((ms, cat, src, n, k))
        if len(shown) >= args.top:
            break
    return shown


if __name__ == "__main__":
    main(parse_args())
