#!/usr/bin/env python3
"""Build the committed tuning table from two runs of ``chip_smoke.py``'s phase 5.

    python3 tools/default_table.py RUN_A RUN_B [--out src/repro_torch/tune/default_cache.json]

Each RUN directory holds what one ``python3 chip_smoke.py`` on the card
leaves in ``build/``: ``tune_table.json`` (every phase 5 cell's winner, tuned
from an empty cache) and ``chip_smoke.json`` (for the card's name and power
limit). An entry is committed only where both runs tuned the same blocks and
both measured them at least 5% faster than the heuristic (``MIN_SPEEDUP``);
every other shape is left to the wrappers' plans. The committed entry is run
A's, with both runs' speedups and each run's card beside it. Needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.tune.cache import DEFAULT_CACHE_PATH, TuningCache  # noqa: E402

MIN_SPEEDUP = 1.05


def load_run(path: Path) -> tuple[TuningCache, str]:
    table = TuningCache.load(str(path / "tune_table.json"))
    card = json.loads((path / "chip_smoke.json").read_text())["card"]
    return table, card


def merge(a: TuningCache, card_a: str, b: TuningCache, card_b: str) -> TuningCache:
    """The entries both runs agree on and both measured >= MIN_SPEEDUP."""
    out = TuningCache()
    for key, ea in sorted(a.entries.items()):
        eb = b.get(key)
        if eb is None or ea.get("blocks") != eb.get("blocks"):
            continue
        if min(ea.get("speedup", 0.0), eb.get("speedup", 0.0)) < MIN_SPEEDUP:
            continue
        out.put(key, dict(ea, speedups=[ea["speedup"], eb["speedup"]], cards=[card_a, card_b]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_a", type=Path)
    ap.add_argument("run_b", type=Path)
    ap.add_argument("--out", default=DEFAULT_CACHE_PATH)
    args = ap.parse_args(argv)
    (a, card_a), (b, card_b) = load_run(args.run_a), load_run(args.run_b)
    table = merge(a, card_a, b, card_b)
    table.save(args.out)
    for key, entry in table.entries.items():
        print(f"{key}: {entry['blocks']} x{entry['speedups'][0]:.3f} / x{entry['speedups'][1]:.3f} ({card_a})")
    print(f"{len(table)} of {len(a)} entries kept (both runs x{MIN_SPEEDUP} or faster, same blocks) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
