"""Tables of the dry run's records (twin of ``repro.launch.report``).

  PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]

The roofline table's "fits?" tests a cell's memory per device against its
device model's ``dram_bytes`` (80 GiB for ``gpu_sm90``; the reference
hard-codes a v5e's 16 GiB). The "collective" and "collective B/chip"
columns hold the partitioned count's collective term and bytes per
device ("—" only for a record of an unpartitioned count, whose term is
``None``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.engine.device import get_device
from repro_torch.launch.dryrun import OUTDIR

_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def load(dirname: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(dirname, "*", "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if "arch" in rec:  # the sim cells are another table's
            recs.append(rec)
    recs.sort(key=lambda r: (r["mesh"], r["arch"],
                             _ORDER.get(r["shape"], 9)))
    return recs


def _ms(s) -> str:
    return "—" if s is None else f"{s * 1e3:,.0f} ms"


def roofline_table(recs, mesh: str) -> str:
    rows = ["| arch | shape | fits? | compute | memory | collective | "
            "bound | dominant | MODEL/COUNTED | mem GiB/chip |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            why = r.get("reason") or r.get("error", "")
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                        f"| *{r['status']}: {why[:48]}…* | — | — |")
            continue
        rl = r["roofline"]
        mem = r["memory"]["total_nonalias"]
        cap = get_device(r["device_model"]).dram_bytes
        fits = "?" if not cap else ("✓" if mem <= cap else "✗")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fits} "
            f"| {_ms(rl['compute_s'])} | {_ms(rl['memory_s'])} "
            f"| {_ms(rl['collective_s'])} | {_ms(rl['bound_s'])} "
            f"| {rl['dominant']} | {rl['useful_ratio']:.2f} "
            f"| {mem / 2**30:.1f} |")
    return "\n".join(rows)


def dryrun_table(recs) -> str:
    rows = ["| mesh | arch | shape | status | count | accum | "
            "counted flops (global) | collective B/chip |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok":
            rows.append(f"| {r['mesh']} | {r['arch']} | {r['shape']} | "
                        f"{r['status']} | — | — | — | — |")
            continue
        rl = r["roofline"]
        coll = "—" if rl["coll_bytes"] is None else f"{rl['coll_bytes']:.2e}"
        rows.append(
            f"| {r['mesh']} | {r['arch']} | {r['shape']} | ok "
            f"| {r['count_s']}s | {r.get('accum_steps', '—')} "
            f"| {rl['flops']:.2e} | {coll} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--dir", default=OUTDIR)
    ap.add_argument("--which", default="roofline",
                    choices=["roofline", "dryrun"])
    ap.add_argument("--mesh", default="pod")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.which == "roofline":
        print(roofline_table(recs, args.mesh))
    else:
        print(dryrun_table(recs))


if __name__ == "__main__":
    main()
