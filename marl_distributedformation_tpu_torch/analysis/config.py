"""graftlint configuration: the ``[tool.graftlint]`` pyproject block.

```toml
[tool.graftlint]
exclude = ["compat/sb3_import.py"]        # repo-root-relative path prefixes

[tool.graftlint.severity]
missing-donate = "warn"                   # per-rule: "error" | "warn" | "off"
```

Severities gate the CLI exit code (``--check`` fails on errors only) and
the tier-1 package scan (zero errors AND zero warns — the repo itself
stays clean; downgrades are for downstream users adopting the linter on
a dirty tree).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

SEVERITIES = ("error", "warn", "off")


@dataclasses.dataclass(frozen=True)
class GraftlintConfig:
    """Resolved linter configuration."""

    severity: Dict[str, str] = dataclasses.field(default_factory=dict)
    exclude: Tuple[str, ...] = ()

    def rule_severity(self, rule_name: str, default: str) -> str:
        sev = self.severity.get(rule_name, default)
        if sev not in SEVERITIES:
            raise ValueError(
                f"[tool.graftlint] severity for {rule_name!r} must be one "
                f"of {SEVERITIES}, got {sev!r}"
            )
        return sev

    def excludes_path(self, path: Path, root: Optional[Path] = None) -> bool:
        """True when ``path`` falls under an excluded prefix (matched on
        the path relative to ``root`` when given, else on the path as
        spelled)."""
        candidates = [str(path)]
        if root is not None:
            try:
                candidates.append(str(path.resolve().relative_to(root.resolve())))
            except ValueError:
                pass
        for pattern in self.exclude:
            for cand in candidates:
                rel = cand.replace("\\", "/")
                if rel == pattern or rel.startswith(pattern.rstrip("/") + "/"):
                    return True
        return False


def _read_toml(path: Path) -> Optional[dict]:
    """Parse TOML, or None when no parser exists on this interpreter
    (py 3.10 without tomli — tomllib is 3.11+ and tomli only ships with
    the dev extras)."""
    try:
        import tomllib  # py >= 3.11
    except ImportError:
        try:
            import tomli as tomllib
        except ImportError:
            return None
    with open(path, "rb") as f:
        return tomllib.load(f)


def load_config(root: Optional[Path] = None) -> GraftlintConfig:
    """Load ``[tool.graftlint]`` from ``{root}/pyproject.toml`` (repo root
    by default). Absent file or block means all-defaults; so does a
    runtime-only py3.10 install with no TOML parser — every rule then
    runs at its built-in default severity, which for this repo is the
    stricter-or-equal direction (the pyproject block only downgrades)."""
    if root is None:
        root = Path(__file__).resolve().parents[2]
    pyproject = Path(root) / "pyproject.toml"
    if not pyproject.is_file():
        return GraftlintConfig()
    parsed = _read_toml(pyproject)
    if parsed is None:
        return GraftlintConfig()
    return config_from_dict(parsed.get("tool", {}).get("graftlint", {}))


def config_from_dict(block: dict) -> GraftlintConfig:
    severity = dict(block.get("severity", {}))
    exclude: Sequence[str] = block.get("exclude", ())
    return GraftlintConfig(severity=severity, exclude=tuple(exclude))
