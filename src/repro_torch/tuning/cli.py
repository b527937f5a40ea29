"""Tuning-cache CLI (port of ``repro.tuning.cli``).

    python -m repro_torch.tuning warm [--full] [--force] [--device cpu]
    python -m repro_torch.tuning show     # dump cached timing tables
    python -m repro_torch.tuning clear    # drop the cache

``warm`` drives every registered shape (``repro_torch.tuning.shapes``)
through the ``"auto"`` call sites — on the card by default, where the
candidates are timed and the winners persist; ``--device cpu`` records
the model's winners under the ``cpu`` backend. Cached shapes are fast
no-ops unless ``--force`` clears the cache first. The cache is
``$REPRO_TORCH_TUNE_CACHE`` or ``~/.cache/repro-torch-tune/``.
"""
from __future__ import annotations

import argparse
import sys
import time


def _cache():
    from repro_torch.tuning.cache import TuningCache

    return TuningCache()


def cmd_warm(args: argparse.Namespace) -> int:
    from repro_torch.tuning import session as sess_mod
    from repro_torch.tuning.shapes import REGISTRY

    cache = _cache()
    if args.force:
        cache.clear()
    print(f"tuning cache: {cache.file}")
    before = set(cache.items())
    measured = sess_mod.MEASURE_COUNT
    for entry in REGISTRY:
        t0 = time.perf_counter()
        try:
            entry.run(args.full, args.device)
        except Exception as e:  # keep warming the rest
            print(f"  {entry.name:40s} FAILED: {type(e).__name__}: {e}")
            continue
        print(f"  {entry.name:40s} ok ({time.perf_counter() - t0:.1f}s)")
    fresh = {
        k: r for k, r in _cache().items().items() if k not in before
    }
    print(
        f"{len(fresh)} new record(s), "
        f"{sess_mod.MEASURE_COUNT - measured} measurement(s) taken"
    )
    show_records(fresh or _cache().items())
    return 0


def show_records(records) -> None:
    """Print each record: its key, winner (block, depth, strategy,
    source) and timing table, the winner marked, failed rows last."""
    from repro_torch.tuning.cache import format_block

    for key in sorted(records):
        rec = records[key]
        print(f"\n{key}")
        depth = f" @f{rec.fuse_steps}" if rec.fuse_steps != 1 else ""
        strat = (
            f" -> {rec.strategy_resolved}" if rec.strategy_resolved else ""
        )
        print(
            f"  best block: {format_block(rec.block)}{depth}{strat}  "
            f"[{rec.source}]"
        )
        winner = rec.winner_label
        for blk, us in sorted(rec.timings_us.items(), key=lambda kv: kv[1]):
            mark = " <-- winner" if blk == winner else ""
            print(f"    {blk:>18s}  {us:12.1f} us{mark}")
        for blk, err in sorted(rec.failed.items()):
            print(f"    {blk:>18s}  FAILED: {err}")


def cmd_show(args: argparse.Namespace) -> int:
    cache = _cache()
    records = cache.items()
    print(f"tuning cache: {cache.file} ({len(records)} record(s))")
    show_records(records)
    return 0


def cmd_clear(args: argparse.Namespace) -> int:
    cache = _cache()
    n = len(cache.items())
    cache.clear()
    print(f"cleared {n} record(s) from {cache.file}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    warm = sub.add_parser("warm", help="pre-tune the registered shapes")
    warm.add_argument("--full", action="store_true",
                      help="the main path's sizes (on the card)")
    warm.add_argument("--force", action="store_true",
                      help="clear the cache first (re-measure everything)")
    warm.add_argument("--device", default=None,
                      help="'cuda' (default: the card) or 'cpu'")
    warm.set_defaults(fn=cmd_warm)
    show = sub.add_parser("show", help="dump cached timing tables")
    show.set_defaults(fn=cmd_show)
    clear = sub.add_parser("clear", help="delete the cache")
    clear.set_defaults(fn=cmd_clear)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
