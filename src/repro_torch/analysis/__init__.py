"""Static contract linter for the repo's standing invariants.

``python -m repro_torch.analysis`` is the gate; tier-1 runs
:func:`run_checks` on the checkout itself (``tests/test_torch_contracts.py``).
See ``README.md`` in this package for the rule list and the suppression
syntax.
"""
from .core import (  # noqa: F401
    ERROR,
    WARNING,
    DEFAULT_PATHS,
    Finding,
    Module,
    Project,
    Report,
    Rule,
    RULES,
    register,
    repo_root,
    run_checks,
)

__all__ = [
    "ERROR", "WARNING", "DEFAULT_PATHS", "Finding", "Module", "Project",
    "Report", "Rule", "RULES", "register", "repo_root", "run_checks",
]
