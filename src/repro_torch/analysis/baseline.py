"""Committed-baseline support: grandfathered findings, individually justified.

The baseline is a JSON file checked into the repo root.  Entries match
findings on ``(rule, path, symbol)`` — deliberately line-number-free so
unrelated edits to a file do not rot the baseline — and every entry MUST
carry a non-empty ``justification``; the loader rejects entries without
one, so "baseline it and move on" is never silent.

``--update-baseline`` rewrites the file from the current findings with
placeholder justifications that still have to be filled in by hand (the
placeholder fails the next load).
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.analysis.core import Finding

__all__ = ["Baseline", "PLACEHOLDER"]

PLACEHOLDER = "TODO: justify or fix"


@dataclasses.dataclass
class Baseline:
    entries: list[dict]

    @classmethod
    def empty(cls) -> "Baseline":
        return cls(entries=[])

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        if not isinstance(data, dict) or data.get("version") != 1:
            raise ValueError(f"{path}: not a v1 simcheck baseline")
        entries = data.get("entries", [])
        for e in entries:
            missing = {"rule", "path", "symbol"} - e.keys()
            if missing:
                raise ValueError(f"{path}: baseline entry missing {sorted(missing)}")
            just = e.get("justification", "").strip()
            if not just or just == PLACEHOLDER:
                raise ValueError(
                    f"{path}: entry {e['rule']}:{e['path']}:{e['symbol']!r} "
                    "has no justification — every grandfathered finding "
                    "must say why it is allowed to stay"
                )
        return cls(entries=list(entries))

    def save(self, path: str) -> None:
        data = {"version": 1, "entries": self.entries}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=2, sort_keys=True)
            fh.write("\n")

    # -- matching ------------------------------------------------------------
    def _keys(self) -> set[tuple[str, str, str]]:
        return {(e["rule"], e["path"], e["symbol"]) for e in self.entries}

    def split(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[Finding], list[dict]]:
        """-> (new findings, baselined findings, stale entries).

        Stale entries — baseline lines whose finding no longer fires —
        are reported so a fixed violation gets its entry deleted instead
        of lingering as a free pass for a future regression.
        """
        keys = self._keys()
        new = [f for f in findings if f.key() not in keys]
        old = [f for f in findings if f.key() in keys]
        live = {f.key() for f in findings}
        stale = [
            e
            for e in self.entries
            if (e["rule"], e["path"], e["symbol"]) not in live
        ]
        return new, old, stale

    @classmethod
    def from_findings(cls, findings: list[Finding]) -> "Baseline":
        entries = [
            {
                "rule": f.rule,
                "path": f.path,
                "symbol": f.symbol,
                "justification": PLACEHOLDER,
            }
            for f in sorted(findings, key=lambda f: f.key())
        ]
        # dedupe identical keys (same symbol can fire on several lines)
        seen: set[tuple[str, str, str]] = set()
        uniq = []
        for e in entries:
            k = (e["rule"], e["path"], e["symbol"])
            if k not in seen:
                seen.add(k)
                uniq.append(e)
        return cls(entries=uniq)
