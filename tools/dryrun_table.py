#!/usr/bin/env python3
"""A directory of dry-run records as one markdown table, a row a cell and
both meshes in it.

    python3 tools/dryrun_table.py DIR

``DIR`` holds the ``<arch>_<shape>_<single|multi>.json`` records that
``python -m repro_torch.launch.dryrun --out DIR`` writes.  Each row: the
cell, then for (32, 8) and for (2, 32, 8) the seconds traced, the
argument, peak and temporary GB a device (1e9 bytes) and the dominant
roofline term, or the status of a run that is not ``ok``.  The skipped
cells follow by reason, then the errors, and the last line counts the
statuses.
"""
import collections
import json
import sys
from pathlib import Path

MESHES = ("single", "multi")


def cols(rec) -> str:
    if rec is None:
        return "— | | | | "
    if rec["status"] != "ok":
        return f"{rec['status']} | | | | "
    mem = rec["memory"]
    gb = lambda k: f"{mem[k] / 1e9:.3f}"  # noqa: E731
    return (f"{rec['trace_s']} | {gb('argument_bytes')} | "
            f"{gb('peak_bytes')} | {gb('temp_bytes')} | "
            f"{rec['roofline']['dominant']}")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    cells, notes, skips = {}, [], {}
    counts = collections.Counter()
    for path in sorted(Path(args[0]).glob("*.json")):
        rec = json.loads(path.read_text())
        mesh = "multi" if rec["mesh"].count("x") == 2 else "single"
        cells.setdefault((rec["arch"], rec["shape"]), {})[mesh] = rec
        counts[rec["status"]] += 1
        if rec["status"] == "skipped":
            skips.setdefault(rec["why"], set()).add(
                f"{rec['arch']} {rec['shape']}")
        elif rec["status"] != "ok":
            notes.append(f"{rec['arch']} {rec['shape']} {rec['mesh']}: "
                         f"{rec['status']}, " + rec.get("traceback", "")
                         .strip().splitlines()[-1][:160])
    print("| cell | (32, 8) traced s | args GB | peak GB | temp GB | "
          "dominant | (2, 32, 8) traced s | args GB | peak GB | temp GB | "
          "dominant |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for (arch, shape), by_mesh in cells.items():
        if all(by_mesh.get(m, {}).get("status") == "skipped"
               for m in MESHES):
            continue
        print(f"| {arch} {shape} | "
              + " | ".join(cols(by_mesh.get(m)) for m in MESHES) + " |")
    for why, names in skips.items():
        print(f"- skipped ({why}): {', '.join(sorted(names))}")
    for note in notes:
        print(f"- {note}")
    print(f"\n{sum(counts.values())} runs: " + ", ".join(
        f"{n} {s}" for s, n in sorted(counts.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
