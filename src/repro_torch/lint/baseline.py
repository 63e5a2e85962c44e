"""The committed baseline of the port's lint.

The baseline file (``.reprolint-torch.json`` at the repo root)
grandfathers findings so that a new rule can land before every old
violation is fixed: the lint fails only on findings the baseline does
not cover.  The format is the reference's: a fingerprint -> count map,
a fingerprint hashing (rule, path, normalized line text, comments and
whitespace stripped), so that findings survive line moves and
whitespace- or comment-only edits but come back when the line's
content changes.  The traced tier uses the same format with
message-based fingerprints (an operation has no source line).

Policy: fix a finding or give it a pragma with a why; the baseline is a
ratchet for rolling a rule out, and the committed one is empty.
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.lint import LintReport

BASELINE_NAME = ".reprolint-torch.json"
FORMAT_VERSION = 1


def baseline_path(root: Path | str) -> Path:
    return Path(root) / BASELINE_NAME


def load_baseline(path: Path | str) -> dict[str, int]:
    """Fingerprint -> count map; empty when the file does not exist."""
    path = Path(path)
    if not path.is_file():
        return {}
    data = json.loads(path.read_text())
    if data.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"{path}: unsupported baseline version {data.get('version')!r} "
            f"(this lint writes version {FORMAT_VERSION}; regenerate with "
            f"--write-baseline)")
    counts = data.get("findings", {})
    if not isinstance(counts, dict) or \
            not all(isinstance(v, int) and v > 0 for v in counts.values()):
        raise ValueError(f"{path}: malformed findings map")
    return dict(counts)


def save_baseline(path: Path | str, report: LintReport) -> dict[str, int]:
    """Write the report's live findings as the new baseline."""
    counts: dict[str, int] = {}
    for f in report.findings:
        counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
    payload = {
        "version": FORMAT_VERSION,
        "comment": ("reprolint grandfathered findings of the port: "
                    "fingerprint -> count; regenerate with "
                    "`python -m repro_torch.lint --write-baseline`"),
        "findings": dict(sorted(counts.items())),
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")
    return counts
