"""Two runs of the port's production dry run side by side: for each
cell, its status in each, whether the per-device argument bytes agree,
the per-device dot FLOPs and wire bytes of each (and the products a
run left to DTensor's propagation, where it left any), and, where the dots
differ and both records carry ``dot_flops_by_site`` (``python -m
repro_torch.launch.dryrun --dot-sites``), the ``SITES`` sites whose dots
differ most.

Typical use: the same tree's records from two torch versions (the card
host's and this CPU's), each made with

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --both-meshes --device cpu --jobs 8 --out <dir>

then

  python tools/dryrun_diff.py <dir A> <dir B>
  python tools/dryrun_diff.py <dir A> <dir B> --table 16x16 [--before C]

``--table`` prints one mesh's cells as a markdown table instead: each
cell's status in A and B, A's per-device dot FLOPs (B's beside them
where they differ) and dominant roofline term, and with ``--before``
(an earlier run of A's kind) how far A's dots moved from it.

Exits 1 when a cell is ok in one run and not in the other, or when the
argument bytes of a cell ok in both differ.  Pure Python: no torch.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

SITES = 3  # sites listed per cell whose dots differ


def load(path: str) -> dict:
    """``{(arch, shape, mesh): record}`` of the records in ``path``."""
    out = {}
    for f in glob.glob(os.path.join(path, "*.json")):
        with open(f) as fh:
            rec = json.load(fh)
        out[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return out


def _args(rec):
    return rec.get("memory_analysis", {}).get("argument_size_in_bytes")


def _wire(rec):
    return rec.get("collectives", {}).get("total_wire_bytes")


def site_diff(a: dict, b: dict) -> list:
    """The ``SITES`` sites whose dot FLOPs differ most between two
    ``dot_flops_by_site`` maps: ``(site, a, b)``."""
    rows = [(s, a.get(s, 0.0), b.get(s, 0.0)) for s in set(a) | set(b)]
    rows = [r for r in rows if r[1] != r[2]]
    rows.sort(key=lambda r: -abs(r[1] - r[2]))
    return rows[:SITES]


def compare(a: dict, b: dict) -> list:
    """One row per cell of either run."""
    rows = []
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key, {}), b.get(key, {})
        row = {"cell": " ".join(key), "status_a": ra.get("status"),
               "status_b": rb.get("status")}
        if row["status_a"] == row["status_b"] == "ok":
            da, db = ra["dot_flops_per_device"], rb["dot_flops_per_device"]
            row.update(args_equal=_args(ra) == _args(rb),
                       argument_bytes=[_args(ra), _args(rb)],
                       dot_flops=[da, db], wire_bytes=[_wire(ra), _wire(rb)],
                       dots_left=[ra.get("dots_left_to_dtensor"),
                                  rb.get("dots_left_to_dtensor")])
            if da != db and "dot_flops_by_site" in ra \
                    and "dot_flops_by_site" in rb:
                row["sites"] = site_diff(ra["dot_flops_by_site"],
                                         rb["dot_flops_by_site"])
        rows.append(row)
    return rows


SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def table(a: dict, b: dict, mesh: str, before: dict = None) -> list:
    """One markdown row per arch of ``mesh``'s cells (see the module
    docstring)."""
    archs = sorted({k[0] for k in set(a) | set(b) if k[2] == mesh})
    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "|---" * (len(SHAPES) + 1) + "|"]
    for arch in archs:
        cells = []
        for shape in SHAPES:
            key = (arch, shape, mesh)
            ra, rb = a.get(key, {}), b.get(key, {})
            sa, sb = ra.get("status", "-"), rb.get("status", "-")
            if "skipped" in (sa, sb):
                cells.append("skip")
                continue
            text = f"{sa}/{sb}"
            if sa == "ok":
                da = ra["dot_flops_per_device"]
                text += f"; {da:.3e}"
                if sb == "ok" and rb["dot_flops_per_device"] != da:
                    text += f" ({rb['dot_flops_per_device']:.3e})"
                text += f"; {ra['dominant'][0]}"
                rc = (before or {}).get(key, {})
                if rc.get("status") == "ok":
                    moved = da / rc["dot_flops_per_device"] - 1
                    if abs(moved) > 0.005:
                        text += f"; {moved * 100:+.1f}%"
                elif before is not None:
                    text += "; new"
            cells.append(text)
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--table", metavar="MESH",
                    help="print this mesh's cells as a markdown table")
    ap.add_argument("--before", help="records of an earlier run of A's "
                    "kind, for --table")
    args = ap.parse_args(argv)
    if args.table:
        print("\n".join(table(load(args.a), load(args.b), args.table,
                              load(args.before) if args.before else None)))
        return 0
    rows = compare(load(args.a), load(args.b))
    bad = 0
    for r in rows:
        if r["status_a"] != r["status_b"] or not r.get("args_equal", True):
            bad += 1
        line = f"{r['cell']:40s} {r['status_a']}/{r['status_b']}"
        if "dot_flops" in r:
            (da, db), (wa, wb) = r["dot_flops"], r["wire_bytes"]
            line += (f"  args {'=' if r['args_equal'] else '!='}"
                     f"  dots {da:.6e} {db:.6e}"
                     f"{'' if da == db else ' *'}  wire {wa:.6e} {wb:.6e}")
            if any(r["dots_left"]):
                line += "  left to DTensor {} {}".format(*r["dots_left"])
        print(line)
        for site, sa, sb in r.get("sites", []):
            print(f"    {sa:.4e} {sb:.4e}  {site}")
    print(f"{len(rows)} cells, {bad} differing in status or arguments")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
