"""The dry run's records as one markdown table: rank 0's FLOPs, bytes,
collective bytes by kind and argument + temp bytes against one card's 80
GB, a row for each (arch x shape [x fed]) in ``experiments/dryrun_torch/``
with the single mesh's number, then the multi-pod mesh's.

    PYTHONPATH=src python tools/dryrun_table.py [DIR]

Every number is counted by ``repro_torch.launch.dryrun`` on fake tensors
(no card): a prediction of what one rank dispatches, holds and sends.
"""

from __future__ import annotations

import glob
import json
import os
import sys

CARD_BYTES = 80e9                 # one H100's HBM (NVIDIA data sheet)
KINDS = {"all-reduce": "AR", "all-gather": "AG", "reduce-scatter": "RS",
         "all-to-all": "A2A", "collective-permute": "CP"}
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _coll(r) -> str:
    return " ".join(f"{KINDS[k]} {v:.3g}" for k, v in
                    r["collectives"]["bytes"].items() if v) or "0"


def _need(r) -> float:
    m = r["memory"]
    return m["argument_bytes"] + m["temp_bytes"]


def main(outdir: str = "experiments/dryrun_torch") -> None:
    pairs = {}
    for path in glob.glob(os.path.join(outdir, "*.json")):
        with open(path) as f:
            r = json.load(f)
        key = (r["arch"], SHAPES.index(r["shape"]), r["fed"])
        pairs.setdefault(key, {})[r["mesh"]] = r
    print("| arch | shape | step | FLOPs | bytes | collective bytes | "
          "argument + temp GB | fits 80 GB |")
    print("|---|---|---|---|---|---|---|---|")
    for (arch, shape, _), by_mesh in sorted(pairs.items()):
        rs = [by_mesh[m] for m in ("single", "multi") if m in by_mesh]
        step = rs[0]["step_kind"] + (f", accum {rs[0]['accum']}"
                                     if rs[0]["accum"] > 1 else "")
        flops = " / ".join(f"{r['flops_per_device']:.3e}" for r in rs)
        nbytes = " / ".join(f"{r['bytes_accessed_per_device']:.3e}"
                            for r in rs)
        coll = " / ".join(_coll(r) for r in rs)
        mem = " / ".join(f"{r['memory']['argument_bytes'] / 1e9:.2f} + "
                         f"{r['memory']['temp_bytes'] / 1e9:.2f}" for r in rs)
        fits = " / ".join("yes" if _need(r) <= CARD_BYTES else "**no**"
                          for r in rs)
        print(f"| {arch} | {SHAPES[shape]} | {step} | {flops} | {nbytes} | "
              f"{coll} | {mem} | {fits} |")


if __name__ == "__main__":
    main(*sys.argv[1:])
