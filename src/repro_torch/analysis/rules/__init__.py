"""The standing-contract rules.  Importing this package registers every
rule in :data:`repro_torch.analysis.core.RULES`; ``run_checks`` does so
lazily.  To add a rule, create a module here and import it below."""
from . import (  # noqa: F401
    fork_lock,
    frozen_mut,
    loop_block,
    metric_name,
    sweep_loop,
    wire_drift,
)
