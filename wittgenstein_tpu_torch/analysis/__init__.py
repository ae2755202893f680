"""wittgenstein_tpu_torch.analysis — the analysis rules over the port:
the port's copy of `wittgenstein_tpu/analysis` (same rule names, target
names, report schema, CLI arguments and exit codes).

The program rules walk each registered protocol's chunk as the op
recorder (`trace.py`) sees it run at a pinned small config; the source
rules lint the port's host code and its models/core; `smem_budget`
holds the CUDA kernels' shared-memory models.  Budgets ratchet down,
never up.  See analysis/README.md for the rule table and the CLI:

    python -m wittgenstein_tpu_torch.analysis --source
    python -m wittgenstein_tpu_torch.analysis --device cpu [--protocol NAME]
"""

from .framework import (RULES, Finding, Report, Rule, load_budgets,  # noqa
                        register_rule, run_analysis)
from .targets import AnalysisTarget, get_target, target_names  # noqa
