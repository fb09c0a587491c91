"""``chip_smoke.py``'s ``wide_paths`` phase with two checkouts' kernels.

    python3 tools/torch_wide_ab.py --other DIR [--turns other,self]

Runs the paths at C = 256 (``wide_paths_phase``: ``tabgnn`` at
``--n_hidden 256`` in float32 and bf16, mcm-lp at ``--channels 256`` and
at 128, and Elliptic's cut at ``--n_hidden 256``, whose node tokens take
the direct form) with this checkout's ``rmm_tpu_torch`` and with the one
under ``DIR`` (another commit's package, unpacked there by ``git archive
<commit> rmm_tpu_torch | tar -x -C DIR``), each in its own process (the
two packages share a name), in the order ``--turns``, on this checkout's
``chip_smoke.py`` and data. Each run prints the phase's record; then one
JSON line a run with each pass's median step on the device's clock (ms)
and train rows/s, the side, its package's path and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASSES = ("aml_f32", "aml_bf16", "ssl", "elliptic", "ssl_c128")


def child(root: str, label: str) -> int:
    """One run of the phase with ``root``'s package."""
    import importlib.util

    sys.path.insert(0, root)
    # this checkout's chip_smoke.py, whatever ``root`` holds beside its
    # package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = chip_smoke
    spec.loader.exec_module(chip_smoke)
    from rmm_tpu_torch.ops.build import build_all
    from rmm_tpu_torch.ops import column_attention as ca

    package = os.path.dirname(os.path.dirname(os.path.abspath(ca.__file__)))
    assert os.path.samefile(package, os.path.join(root, "rmm_tpu_torch"))
    build_all()
    card = chip_smoke.nvidia_smi()
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    csv = os.path.join(chip_smoke.WORK, "aml.csv")
    if not os.path.exists(csv):
        csv = chip_smoke.prepare_data()
    rec = chip_smoke.wide_paths_phase(card, csv)
    print(json.dumps({
        "tool": "torch_wide_ab", "side": label, "root": root, "card": card,
        "step_ms_median": {p: rec[p]["step_ms_median"] for p in PASSES},
        "train_rows_per_s": {p: rec[p]["train_rows_per_s"]
                             for p in PASSES}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="the other checkout's root")
    ap.add_argument("--turns", default="other,self")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.label)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    roots = {"self": ROOT, "other": os.path.abspath(args.other)}
    for label in args.turns.split(","):
        if subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--other", args.other, "--child", roots[label],
                           "--label", label]).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
