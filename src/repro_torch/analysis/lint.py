"""CLI of the schedule verifier -- the port of ``repro/analysis/lint.py``.

Usage (the cells run on ``prod(grid)`` ranks: one card each, or gloo
processes with ``--device cpu``):

  python -m repro_torch.analysis.lint --device cpu       # full matrix
  python -m repro_torch.analysis.lint --device cpu --report json
  python -m repro_torch.analysis.lint --device cpu \\
        --grids 2,1,1,1,1 1,2,1 --schedules ring2 --skip-train

Grids are comma-separated extents: 5-tuples are conv ``(Pb,Ph,Pw,Pk,
Pc)`` grids, 3-tuples matmul ``(Pm,Pn,Pc)`` grids.  Exit status is
non-zero when any lint pass reports an error.  On a card the memory band
is checked too; on the CPU it is not measured.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_grid(text: str):
    try:
        grid = tuple(int(x) for x in text.split(","))
    except ValueError:
        raise SystemExit(f"bad grid {text!r}: expected comma-separated "
                         f"integers")
    if len(grid) not in (3, 5):
        raise SystemExit(f"bad grid {text!r}: conv grids have 5 extents, "
                         f"matmul grids 3")
    return grid


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Verify the dist schedules' communication and memory "
                    "invariants on the collectives every rank records.")
    p.add_argument("--grids", nargs="*", metavar="G",
                   help="grid tuples, e.g. 2,1,1,2,2 (conv) or 2,2,2 "
                        "(matmul); default: the acceptance matrix")
    p.add_argument("--schedules", nargs="*", metavar="S",
                   choices=("allgather", "ring", "ring2"),
                   help="schedules to verify (default: all three)")
    p.add_argument("--report", choices=("text", "json"), default="text")
    p.add_argument("--device", default=None,
                   help="cuda (default: one card per rank) or cpu (gloo)")
    p.add_argument("--wire-rtol", type=float, default=None,
                   help="wire drift tolerance (default 0.02)")
    p.add_argument("--skip-train", action="store_true",
                   help="forward passes only (no backward cells)")
    p.add_argument("--skip-variants", action="store_true",
                   help="skip the stride/VALID/save_gathered variants")
    p.add_argument("--skip-ast", action="store_true",
                   help="skip the source-level AST lint")
    args = p.parse_args(argv)

    from repro_torch.analysis import astlint, verify

    conv_grids, matmul_grids = [], []
    for g in args.grids or []:
        grid = _parse_grid(g)
        (conv_grids if len(grid) == 5 else matmul_grids).append(grid)
    if not args.grids:
        conv_grids = list(verify.DEFAULT_CONV_GRIDS)
        matmul_grids = list(verify.DEFAULT_MATMUL_GRIDS)

    text = args.report == "text"

    def progress(cell):
        if text:
            status = "ok" if cell.ok else "FAIL"
            wr = ("-" if cell.wire_ratio is None
                  else f"{cell.wire_ratio:.3f}")
            mr = ("-" if cell.mem_ratio is None
                  else f"{cell.mem_ratio:.2f}")
            print(f"{status:4s} {cell.name:44s} wire x{wr:6s} "
                  f"mem x{mr:5s} colls {cell.n_collectives}")
            for f in cell.findings:
                print(f"       {f}")
            sys.stdout.flush()

    reports = verify.run_matrix(
        conv_grids=conv_grids, matmul_grids=matmul_grids,
        schedules=tuple(args.schedules or verify.SCHEDULES),
        include_train=not args.skip_train,
        include_variants=not args.skip_variants,
        wire_rtol=(verify.WIRE_RTOL if args.wire_rtol is None
                   else args.wire_rtol),
        progress=progress, device=args.device)
    summary = verify.summarize(reports)

    ast_findings = []
    if not args.skip_ast:
        ast_findings = astlint.lint_tree(astlint.default_root())
        summary["astlint"] = [vars(f) for f in ast_findings]
        summary["ok"] = summary["ok"] and not ast_findings
        if text:
            for f in ast_findings:
                print(f)

    if text:
        print(f"verify-dist: {summary['n_cells']} cells, "
              f"{summary['n_failed_cells']} failed, "
              f"{summary['n_errors']} schedule error(s), "
              f"{len(ast_findings)} astlint finding(s)")
    else:
        json.dump(summary, sys.stdout, indent=2)
        print()
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
