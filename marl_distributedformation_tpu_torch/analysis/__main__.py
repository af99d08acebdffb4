"""graftlint CLI for the port: capture-hygiene static analysis.

Usage:
    python -m marl_distributedformation_tpu_torch.analysis [paths...]
    python -m marl_distributedformation_tpu_torch.analysis --check [paths...]
    python -m marl_distributedformation_tpu_torch.analysis --format sarif

``--check`` exits 1 on any error-severity violation; the default path is
the port's package. Configuration comes from ``[tool.graftlint]`` in the
repository's ``pyproject.toml`` (per-rule severity, exclude list).
Suppression: ``# graftlint: disable=<rule> <reason>`` on the flagged line
or a comment line directly above it.

The lint is pure AST: it imports neither torch nor any module of the
linted tree (the package's ``__init__`` loads nothing here), so a
syntax-broken tree reports ``syntax-error`` instead of crashing.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from marl_distributedformation_tpu_torch.analysis.config import load_config
from marl_distributedformation_tpu_torch.analysis.linter import lint_paths
from marl_distributedformation_tpu_torch.analysis.rules import (
    all_rules,
    rule_names,
)

PACKAGE = Path(__file__).resolve().parent.parent
REPO_ROOT = PACKAGE.parent

_SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)
_SARIF_LEVELS = {"error": "error", "warn": "warning"}


def sarif_report(violations, root: Path) -> dict:
    """The lint result as a SARIF 2.1.0 document: rule metadata in the
    driver, one result per violation with its full message."""
    rules = all_rules()
    rule_index = {r.name: i for i, r in enumerate(rules)}

    def uri(path: str) -> str:
        p = Path(path)
        try:
            p = p.resolve().relative_to(root.resolve())
        except ValueError:
            pass
        return p.as_posix()

    return {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "graftlint",
                        "rules": [
                            {
                                "id": r.name,
                                "shortDescription": {"text": r.description},
                                "defaultConfiguration": {
                                    "level": _SARIF_LEVELS[r.default_severity]
                                },
                            }
                            for r in rules
                        ],
                    }
                },
                "results": [
                    {
                        "ruleId": v.rule,
                        "ruleIndex": rule_index.get(v.rule, -1),
                        "level": _SARIF_LEVELS.get(v.severity, "warning"),
                        "message": {"text": v.message},
                        "locations": [
                            {
                                "physicalLocation": {
                                    "artifactLocation": {"uri": uri(v.path)},
                                    "region": {
                                        "startLine": v.line,
                                        # SARIF columns are 1-based.
                                        "startColumn": v.col + 1,
                                    },
                                }
                            }
                        ],
                    }
                    for v in violations
                ],
            }
        ],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m marl_distributedformation_tpu_torch.analysis",
        description=__doc__.splitlines()[0])
    parser.add_argument(
        "paths",
        nargs="*",
        default=[str(PACKAGE)],
        help="files or directories to lint (default: the port's package)",
    )
    parser.add_argument(
        "--check",
        action="store_true",
        help="exit non-zero if any error-severity violation is found",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print rule names and exit"
    )
    parser.add_argument(
        "--format",
        choices=("text", "sarif"),
        default="text",
        help="output format: human-readable text (default) or SARIF 2.1.0",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for name in rule_names():
            print(name)
        return 0

    config = load_config(REPO_ROOT)
    violations = lint_paths(args.paths, config, root=REPO_ROOT)
    errors = sum(1 for v in violations if v.severity == "error")
    if args.format == "sarif":
        # stdout is the document; the summary goes to stderr.
        json.dump(sarif_report(violations, REPO_ROOT), sys.stdout, indent=2)
        print()
        print(
            f"graftlint: {errors} error(s), "
            f"{len(violations) - errors} warning(s)",
            file=sys.stderr,
        )
    else:
        for v in violations:
            print(v)
        print(
            f"graftlint: {errors} error(s), "
            f"{len(violations) - errors} warning(s) in "
            f"{', '.join(str(p) for p in args.paths)}"
        )
    if args.check and errors:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
