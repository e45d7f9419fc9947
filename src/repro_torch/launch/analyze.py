"""Program-analysis CLI: lint the port's serve/train/fleet stack, gate on it.

Runs the four ``repro_torch.analysis`` passes (donation, recompile
hazards, layout resolution, CUDA kernel geometry) over the entry points
registered in ``repro_torch.analysis.programs`` and emits a JSON findings
report. The donation pass runs the reduced entry points once on
``--device`` (default: the card; without one it raises unless ``--device
cpu`` is given); the other passes touch no device.

The committed baseline (``src/repro_torch/analysis/baseline.json``) holds
the *identities* of tolerated findings: the small-model attention
replication and the train step's params and moments, which come back in
new storage every step. With ``--check`` the exit code is 1 iff the run
produces a finding whose key is NOT in the baseline, so a check fails on
regressions only; resolved baseline entries are reported so the baseline
can be re-tightened.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.analyze                  # report, on the card
    PYTHONPATH=src python -m repro_torch.launch.analyze --check --device cpu
    PYTHONPATH=src python -m repro_torch.launch.analyze --write-baseline --device cpu
    PYTHONPATH=src python -m repro_torch.launch.analyze --passes recompile,kernels
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument(
        "--passes",
        default="donation,recompile,sharding,kernels",
        help="comma-separated subset of passes to run",
    )
    ap.add_argument(
        "--min-bytes", type=int, default=1 << 14,
        help="DON001 per-leaf byte threshold",
    )
    ap.add_argument(
        "--shard-min-bytes", type=int, default=1 << 20,
        help="SHD001 replicated-leaf byte threshold",
    )
    ap.add_argument("--baseline", default=None, help="baseline file to check against")
    ap.add_argument(
        "--check", action="store_true",
        help="exit 1 on any finding not covered by the baseline",
    )
    ap.add_argument(
        "--write-baseline", action="store_true",
        help="write the current findings' keys as the new baseline (the port's own)",
    )
    ap.add_argument("--out", default=None, help="write the full JSON report here")
    ap.add_argument(
        "--device", default=None,
        help="where the donation pass runs its entry points (default: the card)",
    )
    args = ap.parse_args(argv)

    from repro_torch.analysis import analyze_stack, default_baseline_path, load_baseline

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    report = analyze_stack(
        args.arch,
        min_bytes=args.min_bytes,
        shard_min_bytes=args.shard_min_bytes,
        passes=passes,
        device=args.device,
    )

    baseline_path = args.baseline or default_baseline_path()
    if args.write_baseline:
        with open(baseline_path, "w") as f:
            json.dump(report.baseline_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"baseline: wrote {len(report.keys())} keys to {baseline_path}",
              file=sys.stderr)

    text = json.dumps(report.as_dict(), indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)

    for f_ in report.sorted_findings():
        print(f"{f_.severity:5s} {f_.key}: {f_.message}", file=sys.stderr)

    if not args.check:
        return 0
    try:
        baseline = load_baseline(baseline_path)
    except FileNotFoundError:
        baseline = set()
        print(f"check: no baseline at {baseline_path}: all findings are new",
              file=sys.stderr)
    new = report.new_vs_baseline(baseline)
    resolved = report.resolved_vs_baseline(baseline)
    for key in resolved:
        print(f"check: baselined finding no longer fires: {key} "
              "(re-run --write-baseline to tighten)", file=sys.stderr)
    if new:
        print(f"check: {len(new)} NEW finding(s) vs baseline:", file=sys.stderr)
        for f_ in new:
            print(f"  {f_.severity:5s} {f_.key}: {f_.message}", file=sys.stderr)
        return 1
    print(
        f"check: OK, {len(report.findings)} finding(s), all baselined "
        f"({len(baseline)} baseline keys, {len(resolved)} resolved)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
