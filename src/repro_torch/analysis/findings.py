"""A finding of the plane-contract analyzer, waivers and the reports."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.core import plane_contract as pc


@dataclasses.dataclass
class Finding:
    rule: str
    file: str                       # repo-relative path
    line: int
    message: str
    check: str = "stage-protocol"
    waived: bool = False
    waive_reason: str = ""

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = f" [waived: {self.waive_reason}]" if self.waived else ""
        return (f"{self.file}:{self.line}: {self.rule} ({self.check}): "
                f"{self.message}{tag}")


def apply_waivers(findings: List[Finding], repo_root: Path) -> None:
    """Mark the findings an in-source ``# plane-contract: allow(<rule>)
    <reason>`` comment covers (same line or the line above) as waived."""
    cache: Dict[str, Dict[int, Tuple[str, str]]] = {}
    for f in findings:
        if f.file not in cache:
            cache[f.file] = pc.collect_waivers(
                (repo_root / f.file).read_text(encoding="utf-8"))
        reason = pc.waiver_for(cache[f.file], f.rule, f.line)
        if reason is not None:
            f.waived = True
            f.waive_reason = reason


def render_report(findings: List[Finding]) -> str:
    unwaived = sum(1 for f in findings if not f.waived)
    return "\n".join([f.render() for f in findings] + [
        f"plane-contract: checks=stage-protocol findings={len(findings)} "
        f"unwaived={unwaived}"])


def json_report(findings: List[Finding], target: str) -> str:
    unwaived = sum(1 for f in findings if not f.waived)
    return json.dumps({
        "target": target,
        "checks": ["stage-protocol"],
        "findings": [f.to_dict() for f in findings],
        "counts": {"total": len(findings), "unwaived": unwaived},
        "ok": not unwaived,
    }, indent=2)
