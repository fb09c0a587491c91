"""Served AML rows/s of two checkouts of the port, in alternating runs.

    python3 tools/torch_serve_ab.py --other DIR [--pairs 5] [--out FILE]

Runs ``chip_smoke.serve_phase`` (the predict CLI at the config of record
over the whole test split, on the card) of ``DIR`` (another checkout, such
as the parent commit's ``git archive``) and of this checkout, each run in a
process of its own, in the order other, this, this, other, other, this, ...
(``--pairs`` runs of each), after one discarded warm-up run of each that
builds its kernels and writes its CSV. Prints one JSON line per run and a
summary line: the median, least and largest of ``rows_per_s_predict``
(test rows over the predict loop's seconds), ``rows_per_s_wall`` and
``predict_s`` for each side, and the change of the medians. Writes the
lines to ``--out`` too. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one serve run in the checkout given as argv[1]; its record is the last line
CHILD = """
import json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
import chip_smoke as cs
from rmm_tpu_torch.ops.build import build_all
build_all()
csv = os.path.join(cs.WORK, "aml.csv")
if not os.path.exists(csv):
    csv = cs.prepare_data()
rec = cs.serve_phase(cs.nvidia_smi(), csv)
print("SERVE_AB " + json.dumps(rec), flush=True)
"""

KEYS = ("rows_per_s_predict", "rows_per_s_wall", "predict_s")


def serve_once(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, root], cwd=root,
                          capture_output=True, text=True, check=False)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("SERVE_AB ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"serve in {root} failed ({proc.returncode}):\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("SERVE_AB "):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--other", required=True)
    p.add_argument("--pairs", type=int, default=5)
    p.add_argument("--out", default=os.path.join(ROOT, "outputs",
                                                 "serve_ab.jsonl"))
    args = p.parse_args(argv)
    sides = {"other": os.path.abspath(args.other), "this": ROOT}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    for side, root in sides.items():
        serve_once(root)   # warm-up: the build, the CSV, the first CUDA init
    runs: dict = {side: [] for side in sides}
    for i in range(args.pairs):
        order = ("other", "this") if i % 2 == 0 else ("this", "other")
        for side in order:
            rec = serve_once(sides[side])
            runs[side].append(rec)
            emit({"run": i, "side": side, "root": sides[side],
                  **{k: rec[k] for k in KEYS}, "rows": rec["rows"],
                  "card": rec["card"]})
    summary = {side: {k: {"median": statistics.median(r[k] for r in recs),
                          "min": min(r[k] for r in recs),
                          "max": max(r[k] for r in recs)} for k in KEYS}
               for side, recs in runs.items()}
    summary["change_of_medians"] = {
        k: summary["this"][k]["median"] / summary["other"][k]["median"] - 1
        for k in KEYS}
    emit({"summary": summary, "pairs": args.pairs})
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
