"""CLI of the port's static plan auditor.

    python -m repro_torch.analysis [--smoke | --full] [--json PATH]
                                   [--smem-tol F] [--no-enumerate]
    python -m repro_torch.analysis --mutants [--json PATH]

The report goes to stdout, or also to PATH with ``--json``. Exit status
0 iff no finding survives (with ``--mutants``: iff every seeded defect
is caught with its expected class and the clean fixtures audit clean).
No kernel runs and no card is needed.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.driver import run_audit, run_mutants, write_report


def print_report(report: dict) -> None:
    c = report["counts"]
    print(f"audit ({report['mode']}): {c['registry']} registry plans, "
          f"{c['candidates']} candidates, {c['launched']} launched, "
          f"{c['audited']} audited ({c['classes']} tile and column "
          f"classes), {c['sid_combos']} sid combos, "
          f"{c['record_roundtrips']} record round trips, unaudited "
          f"{c['unaudited']}, findings {c['findings']}, "
          f"{report['seconds']:.1f} s")
    print("  bodies: " + ", ".join(f"{k} {v}"
                                   for k, v in report["bodies"].items()))
    print("  not ported: " + (", ".join(
        f"{k} {v}" for k, v in report["not_ported"].items()) or "none"))
    print("  bf16 kernels audited: " + (", ".join(
        f"{k} {v}" for k, v in report["bf16_items"].items()) or "none"))
    print("  refused by the planner: " + (", ".join(
        f"{k} {v}" for k, v in report["refused"].items()) or "none"))
    for f in report["findings"]:
        print(f"  [{f['cls']}] {f['plan']}: {f['detail']}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static plan auditor of the port (bounds, coverage, "
        "uninit, phi, shared bytes, keys).")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--smoke", action="store_true",
                      help="audit the smoke extents (default)")
    mode.add_argument("--full", action="store_true",
                      help="audit the main path's (full) extents")
    mode.add_argument("--mutants", action="store_true",
                      help="run the seeded-defect harness instead")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the report to PATH")
    ap.add_argument("--smem-tol", type=float, default=0.0, metavar="F",
                    help="relative tolerance of the shared-bytes check "
                    "(default: byte-equal)")
    ap.add_argument("--no-enumerate", action="store_true",
                    help="skip the tuner's candidate spaces")
    args = ap.parse_args(argv)

    if args.mutants:
        report = run_mutants()
        if args.json:
            write_report(report, args.json)
        for name, r in report["mutants"].items():
            mark = "ok" if r["detected"] else "MISSED"
            print(f"  {mark:6s} {name}: {r['description']} -> "
                  f"{r['classes'] or ['no findings']} (expected "
                  f"{r['expected'] or 'none'})")
        if report["undetected"]:
            print(f"UNDETECTED: {', '.join(report['undetected'])}")
            return 1
        print(f"all {len(report['mutants']) - 1} mutants detected, clean "
              "fixtures clean")
        return 0

    report = run_audit(full=args.full, smem_tol=args.smem_tol,
                       enumerate_candidates=not args.no_enumerate)
    if args.json:
        write_report(report, args.json)
    print_report(report)
    return 1 if report["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
