#!/usr/bin/env python3
"""Where a dry run's counted peak a device sits.

    python3 tools/dryrun_peak.py ARCH SHAPE [single|multi] [--reduced]
        [--device cuda|cpu] [--set key=value ...]

Runs ``repro_torch.launch.dryrun.run_cell`` with a counter that also
remembers, for each live storage, the shape, dtype and op that made it.
At the peak (taken again whenever the live bytes pass the last record by
1%, so within 1% of the true peak) it keeps the live bytes grouped by that
op, the largest storages and the port's Python frames; every 2,000 ops it
samples the live bytes.  Prints the record's ``memory`` and then these.
Full-size cells take the production meshes (512 fake ranks unless
``REPRO_DRYRUN_DEVICES`` says otherwise); run those on the card's host.
"""
import argparse
import collections
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline.flops import OpCounter  # noqa: E402

SAMPLE = 2000


class PeakProbe(OpCounter):
    def __init__(self, hold=()):
        self.made = {}  # storage key -> (shape, dtype, op)
        self.op, self.n_ops, self.record, self.trail = None, 0, 0, []
        self.at_peak = None
        super().__init__(hold)

    def _track(self, func, args, kwargs, out):
        self.op = str(func)
        self.n_ops += 1
        if self.n_ops % SAMPLE == 0:
            self.trail.append((self.n_ops, self.live_bytes))
        super()._track(func, args, kwargs, out)

    def _add(self, t):
        super()._add(t)
        self.made.setdefault(t.untyped_storage()._cdata,
                             (tuple(t.shape), str(t.dtype), self.op))
        if self.live_bytes > 1.01 * self.record:
            self.record = self.live_bytes
            by_op = collections.Counter()
            for key, n in self._live.items():
                by_op[self.made.get(key, (None, None, "held"))[2]] += n
            top = sorted(self._live.items(), key=lambda kv: -kv[1])[:12]
            self.at_peak = {
                "live_bytes": self.live_bytes, "op": self.op,
                "op_index": self.n_ops, "by_op": by_op.most_common(10),
                "largest": [(n, self.made.get(k)) for k, n in top],
                "frames": [line for line in traceback.format_stack(limit=80)
                           if "repro_torch" in line
                           and "flops.py" not in line]}

    def _free(self, key):
        self.made.pop(key, None)
        super()._free(key)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("mesh", nargs="?", default="single",
                    choices=["single", "multi"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args(argv)
    probes = []

    def counter(hold=()):
        probes.append(PeakProbe(hold))
        return probes[-1]

    dryrun.OpCounter = counter
    t0 = time.perf_counter()
    rec = dryrun.run_cell(args.arch, args.shape, args.mesh == "multi",
                          reduced=args.reduced,
                          overrides=dryrun.parse_overrides(args.set),
                          device=args.device)
    print(f"{args.arch} {args.shape} {rec['mesh']} ({rec['status']}, "
          f"{time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(rec.get('memory', rec.get('why')))}")
    if not probes:
        return 0
    p = probes[0]
    at = p.at_peak
    print(f"peak ~{at['live_bytes'] / 1e9:.3f} GB at op #{at['op_index']} "
          f"of {p.n_ops}: {at['op']}")
    for op, n in at["by_op"]:
        print(f"  made by {op}: {n / 1e9:.3f} GB")
    for n, made in at["largest"]:
        print(f"  {n / 1e9:.3f} GB {made}")
    print("".join(at["frames"]), end="")
    print(f"live GB every {SAMPLE} ops: "
          f"{[round(b / 1e9, 2) for _, b in p.trail]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
