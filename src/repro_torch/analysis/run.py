"""Plane-contract analyzer of the port (the stage-protocol pass).

    python -m repro_torch.analysis.run                    # the port's tree
    python -m repro_torch.analysis.run --json report.json
    python -m repro_torch.analysis.run --fixture bad_double_d2h
    python -m repro_torch.analysis.run --list-fixtures

Exit status is non-zero iff some finding is not covered by an in-source
``# plane-contract: allow(<rule>) <reason>`` waiver.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import findings as findings_mod
from repro_torch.analysis import stage_protocol
from repro_torch.analysis.fixtures import FIXTURES
from repro_torch.core import plane_contract as pc

REPO_ROOT = Path(__file__).resolve().parents[3]


def analyze(target: pc.AnalysisTarget, repo_root: Path = REPO_ROOT
            ) -> List[findings_mod.Finding]:
    """The stage-protocol pass over one target, waivers applied."""
    found = stage_protocol.run(repo_root, target)
    findings_mod.apply_waivers(found, repo_root)
    return found


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.run",
        description="Static analyzer for the port's serving-plane contract.")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write a JSON report to PATH ('-': stdout)")
    ap.add_argument("--fixture", default=None,
                    help="analyze a planted-violation fixture instead of "
                         "the port's tree")
    ap.add_argument("--list-fixtures", action="store_true")
    args = ap.parse_args(argv)
    if args.list_fixtures:
        for name, (_, rule) in sorted(FIXTURES.items()):
            print(f"{name}: expects {rule or 'no findings'}")
        return 0
    if args.fixture is not None and args.fixture not in FIXTURES:
        ap.error(f"unknown fixture {args.fixture!r} (see --list-fixtures)")
    target = (pc.DEFAULT_TARGET if args.fixture is None
              else FIXTURES[args.fixture][0])
    found = analyze(target)
    print(findings_mod.render_report(found))
    if args.json is not None:
        payload = findings_mod.json_report(found, target.name)
        if args.json == "-":
            print(payload)
        else:
            Path(args.json).write_text(payload + "\n", encoding="utf-8")
    return 1 if any(not f.waived for f in found) else 0


if __name__ == "__main__":
    sys.exit(main())
