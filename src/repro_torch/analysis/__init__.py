# Execution-analysis layer for the port's serving stack: a runtime
# sanitizer (invariants.py) that validates the cross-module
# allocator/trie/scheduler contract after engine steps, call-site hooks
# (hooks.py) that attribute violations to the exact mutating call at
# sanitize_level="call", and a cross-mode differential harness
# (differential.py), a dispatch sentinel (dispatch.py) that proves
# the step callables keep one argument signature per static shape, and an
# AST lint (lint.py) whose hot-path rules match PyTorch.  Counterparts of
# the reference's modules of the same names.
#
# Module-level imports stay stdlib-only: the lint runs where neither
# torch nor numpy is installed (a CI lint job, a pre-commit hook).
from repro_torch.analysis.differential import (diff_fingerprints,
                                               run_cross_mode,
                                               state_fingerprint)
from repro_torch.analysis.dispatch import DispatchSentinel
from repro_torch.analysis.hooks import CallHooks, install_call_hooks
from repro_torch.analysis.invariants import (CHECKS, InvariantViolation,
                                             KVSanitizer, SANITIZE_LEVELS,
                                             verify_state, verify_subset)

__all__ = [
    "CHECKS", "CallHooks", "DispatchSentinel", "InvariantViolation",
    "KVSanitizer", "SANITIZE_LEVELS", "diff_fingerprints",
    "install_call_hooks", "run_cross_mode", "state_fingerprint",
    "verify_state", "verify_subset",
]
