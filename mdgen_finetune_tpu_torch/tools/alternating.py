"""Parent against change on one card: end-to-end cells of ``chip_smoke.py``
run from two checkouts in alternating fresh processes.

    python -m mdgen_finetune_tpu_torch.tools.alternating --parent DIR [--change DIR]
        [--cells main_path,sim_1000,...] [--order PCCPPCCP]

``--parent`` and ``--change`` are roots of two checkouts (for example a
``git archive`` of the parent commit and of this one); each run is a fresh
``python3`` in that root that imports the checkout's own ``chip_smoke.py``
and runs the phases of the chosen cells (functions both checkouts have).
Every kernel is built once per checkout first (``_cuda.build_all``, both at
once), so no run pays a build. The order P C C P P C C P puts each tree
first and last equally often, so a drift of the card over the loop (clocks,
temperature) falls on both. Cells and the metric read from each phase's
JSON line:

- ``main_path``: the flagship sampler, ``steps_per_s``;
- ``sim_1000``, ``sim_atlas``, ``interleave_main``, ``no_rope_main``:
  ``frames_per_s``;
- ``train_path``, ``train_merged``, ``train_1000``: ``ms_per_step``, and
  beside it ``<cell>.peak_memory_gb`` (the card's peak allocation);
- ``rtb_main``: ``ms_per_iteration`` (and its peak memory).

Prints the card's name and power limit, one JSON line per run, then one
with each cell's runs and medians for both trees, the change in percent
and the two-sided Mann-Whitney p of the two sets of runs.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CELLS = {"main_path": "steps_per_s", "sim_1000": "frames_per_s", "sim_atlas": "frames_per_s",
         "interleave_main": "frames_per_s", "no_rope_main": "frames_per_s",
         "train_path": "ms_per_step",
         "train_merged": "ms_per_step", "train_1000": "ms_per_step",
         "rtb_main": "ms_per_iteration"}

# what each fresh process runs, in the checkout's root
CHILD = r"""
import sys
import torch
import chip_smoke as cs
cells = sys.argv[1].split(",")
dev = torch.device("cuda")
if "main_path" in cells:
    cs.phase_main_path(dev, cs.flagship_config())
if "sim_1000" in cells:
    cs.phase_sim_1000(dev)
if "sim_atlas" in cells:
    cs.phase_sim_atlas(dev)
if "interleave_main" in cells:
    cs.modular_sample(dev, "interleave_main", cs.modular_config("interleave_ipa"), cs.B, seed=101)
if "no_rope_main" in cells:
    cs.modular_sample(dev, "no_rope_main", cs.modular_config("no_rope"), cs.B, seed=131)
if "train_path" in cells or "train_merged" in cells:
    _, ref, _ = cs.phase_train_path(dev)
    if "train_merged" in cells:
        cs.phase_train_path(dev, "merged", ref)
if "train_1000" in cells:
    cs.phase_train_1000(dev)
if "rtb_main" in cells:
    cs.phase_rtb_cell(dev, "rtb_main", cs.B_RTB, seed=221)
"""


def run(root: Path, cells: list) -> dict:
    """One fresh process in ``root``: the cells' metrics from its JSON lines."""
    out = subprocess.run([sys.executable, "-c", CHILD, ",".join(cells)], cwd=root,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n{out.stderr[-4000:]}")
    got = {}
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            if obj.get("phase") in CELLS:
                got[obj["phase"]] = obj[CELLS[obj["phase"]]]
                if "peak_memory_gb" in obj:
                    got[obj["phase"] + ".peak_memory_gb"] = obj["peak_memory_gb"]
    missing = [c for c in cells if c not in got]
    if missing:
        raise RuntimeError(f"{root}: no line for {missing}")
    return got


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--change", default=Path.cwd(), type=Path)
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--order", default="PCCPPCCP")
    args = ap.parse_args(argv)
    from scipy.stats import mannwhitneyu

    cells = args.cells.split(",")
    unknown = [c for c in cells if c not in CELLS]
    if unknown:
        raise SystemExit(f"unknown cells {unknown}; known: {list(CELLS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"P": args.parent.resolve(), "C": args.change.resolve()}
    build = "from mdgen_finetune_tpu_torch.ops import _cuda; _cuda.build_all()"
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=root) for root in trees.values()]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("a checkout's kernels did not build")
    runs = {"P": [], "C": []}
    for i, tree in enumerate(args.order):
        got = run(trees[tree], cells)
        runs[tree].append(got)
        print(json.dumps({"run": i, "tree": tree, **got}), flush=True)
    summary = {}
    for c in runs["C"][0]:
        p, ch = [r[c] for r in runs["P"]], [r[c] for r in runs["C"]]
        mp, mc = statistics.median(p), statistics.median(ch)
        summary[c] = {"metric": CELLS.get(c, "peak_memory_gb"), "parent": p,
                      "parent_median": mp, "change": ch, "change_median": mc,
                      "change_pct": (mc / mp - 1.0) * 100.0,
                      "mann_whitney_p": mannwhitneyu(p, ch, alternative="two-sided").pvalue
                      if len(set(p + ch)) > 1 else 1.0}
    print(json.dumps({"card": smi, "order": args.order, "cells": summary}), flush=True)


if __name__ == "__main__":
    main()
