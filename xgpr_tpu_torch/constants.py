"""Shared constants for model classes.

Copied from xgpr_tpu/constants.py: values mirror the reference xGPR's
behavioral contract (constants/constants.py:1-21) so that a user
switching from xGPR finds the same defaults and limits.
"""

MAX_VARIANCE_RFFS = 4096
MAX_CLOSED_FORM_RFFS = 8192

DEFAULT_KERNEL_SPEC_PARMS = {"matern_nu": 5 / 2, "intercept": True,
                             "averaging": "none"}

DEFAULT_SCORE_IF_PROBLEM = 1e40

DEFAULT_NMLL_PARAMS = {"max_rank": 1024, "preconditioner_mode": "srht_2",
                       "nsamples": 25, "nmll_iter": 500, "nmll_tol": 1e-6}

LARGEST_NMLL_MAX_RANK = 3000
SMALLEST_NMLL_MAX_RANK = 512
