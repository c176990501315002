"""SARIF 2.1.0 export for lint results (``lint --sarif FILE``).

SARIF is the interchange format CI platforms (GitHub code scanning,
Azure DevOps, VS Code SARIF viewer) render as inline annotations — one
upload per lint run and every new finding lands on the diff line it
blames, instead of living in a console log nobody scrolls.

Mapping:

- each **rule** in the run becomes a ``tool.driver.rules`` entry
  (id, description, default level);
- each **new finding** becomes a ``results`` entry with its
  ``ruleId``/``level``/``message`` and one physical location
  (``fmda_tpu_torch/<rel>`` relative to ``SRCROOT`` — the repo root);
- **baselined** findings are exported too, with a ``suppressions``
  entry carrying the baseline justification — accepted debt stays
  visible to the scanner without failing the run (SARIF consumers
  treat suppressed results as non-blocking).

Schema stability is load-bearing (CI parses this; the test pins it):
extend, don't rename.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from fmda_tpu_torch.analysis.engine import Finding, LintResult, Rule

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

#: Finding.severity -> SARIF result level
_LEVELS = {"error": "error", "warning": "warning"}


def _result(finding: Finding) -> Dict[str, object]:
    return {
        "ruleId": finding.rule,
        "level": _LEVELS.get(finding.severity, "warning"),
        "message": {"text": finding.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {
                    "uri": f"fmda_tpu_torch/{finding.path}",
                    "uriBaseId": "SRCROOT",
                },
                "region": {"startLine": max(1, int(finding.line))},
            },
        }],
    }


def to_sarif(result: LintResult,
             rules: Sequence[Rule]) -> Dict[str, object]:
    """The full SARIF document for one lint run."""
    results: List[Dict[str, object]] = [_result(f) for f in result.new]
    for f in result.baselined:
        doc = _result(f)
        doc["suppressions"] = [{
            "kind": "external",
            "justification": "grandfathered in "
                             "fmda_tpu_torch/analysis/baseline.json",
        }]
        results.append(doc)
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "fmda-tpu-torch-lint",
                    "rules": [
                        {
                            "id": r.id,
                            "shortDescription": {"text": r.description},
                            "defaultConfiguration": {
                                "level": _LEVELS.get(r.severity, "warning"),
                            },
                        }
                        for r in rules
                    ],
                },
            },
            "results": results,
        }],
    }
