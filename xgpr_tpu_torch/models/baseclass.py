"""Shared model state machine (port of xgpr_tpu/models/baseclass.py).

Kernel initialisation through the registry, the cached engine (the
sharded engines of parallel/ when ``config.should_shard``), the
Nystrom preconditioner build with rank autoselection (and its amortized
form for repeated approximate-NMLL calls, with the rank cached per
dataset), the NMLL preparation steps, and the property setters that
invalidate weights.  ``device`` ("cuda" by default, or "cpu"
by name) replaces xgpr_tpu's ``_resolve_accelerator``: a CUDA request with
no card raises, and nothing quietly runs on the CPU instead.
``double_precision_fht`` (a property as in xgpr_tpu, and a constructor
argument here) builds the kernel with ``double_precision``: float64 draws
and float64 features on any device, through the kernels' float64 bodies
on the card.
"""
import numpy as np

from .. import config, constants
from ..fitting.engine import Engine
from ..kernels import KERNEL_NAME_TO_CLASS
from ..parallel.distributed import global_host_reduce
from ..parallel.sharded import ShardedEngine
from ..parallel.streaming import StreamingShardedEngine
from ..preconditioners.nystrom import NystromPreconditioner, srht_ratio_check
from ..utils.diagnostics import span


class ModelBaseclass:
    """Base class of the regression and classification models."""

    def __init__(self, num_rffs=256, variance_rffs=16, kernel_choice="RBF",
                 device="cuda", kernel_settings=None, verbose=True,
                 random_seed=123, double_precision_fht=False):
        if kernel_settings is None:
            kernel_settings = dict(constants.DEFAULT_KERNEL_SPEC_PARMS)
        if not isinstance(kernel_settings, dict):
            raise RuntimeError("Pass kernel_settings as a dict of option "
                               "name -> value.")
        self._device = config.resolve_device(device)
        self._kernel_choice = None
        self.kernel = None
        self.weights = None
        self.var = None
        # False when ``var`` is a Nystrom preconditioner (Linear kernels,
        # models/regression.py) rather than the exact variance matrix.
        self.exact_var_calculation = True
        self.trainy_mean = 0.0
        self.trainy_std = 1.0
        self.kernel_choice = kernel_choice
        self._num_rffs = num_rffs
        self._variance_rffs = 0
        self.variance_rffs = variance_rffs
        self.kernel_spec_parms = kernel_settings
        self.verbose = verbose
        self.is_regression = True
        # The classifier's (models/classification.py); a regression model
        # keeps n_classes 1 and no gamma.
        self.n_classes = 1
        self.gamma = None
        self._random_seed = random_seed
        self._double_precision_fht = bool(double_precision_fht)
        self._engines = {}
        self._nmll_rank_cache = None

    # ------------------------------------------------------------------
    @staticmethod
    def _dataset_token(dataset):
        """Cache key for a dataset: its never-recycled uid where it has
        one (every built-in dataset does), else id() and shape."""
        get_uid = getattr(dataset, "get_uid", None)
        if get_uid is not None:
            return ("uid", get_uid())
        return ("id", id(dataset), dataset.get_ndatapoints(),
                tuple(dataset.get_xdim()))

    def _engine(self, dataset):
        """Cached engine for the (dataset, kernel) pair; hyperparameters
        flow through feature_params at reduction time, so reuse is safe.
        The key holds ``config.config_epoch()``: a switch of engine mode,
        M sharding, CG mode or stacked limit builds anew.  At most one
        engine is kept, and the stale one is released before its
        replacement is built: a stacked engine pins the dataset on the
        device.

        Under ``config.should_shard()`` the engine is a ShardedEngine if
        this rank's rows fit the stacked limit and a
        StreamingShardedEngine if not; the ranks agree on the larger load
        first (their datasets may differ), since both kinds must be the
        same on every rank.  Otherwise it is the single Engine, stacked
        or streaming by the same limit (the counterpart of xgpr_tpu's
        one-device streaming mesh)."""
        key = (self._dataset_token(dataset), self.kernel.get_uid(),
               config.config_epoch())
        engine = self._engines.get(key)
        if engine is None:
            self._engines = {}
            if config.should_shard():
                load = int(np.prod(dataset.get_xdim())) / \
                    config.stacked_element_limit()
                load = global_host_reduce([load], ["max"])[0]
                kind = ShardedEngine if load < 1.0 \
                    else StreamingShardedEngine
                engine = kind(self.kernel, dataset)
            else:
                engine = Engine(self.kernel, dataset)
            self._engines = {key: engine}
        return engine

    def pre_prediction_checks(self, input_x, sequence_lengths, get_var):
        if self.kernel is None or self.weights is None:
            raise RuntimeError("No fitted weights present; call fit() first.")
        if not self.kernel.validate_new_datapoints(input_x):
            raise RuntimeError("Input array shape does not match the shape "
                               "this model was fitted for.")
        if sequence_lengths is None:
            if input_x.ndim != 2:
                raise RuntimeError("sequence_lengths is required if using a "
                                   "convolution kernel.")
        elif input_x.ndim == 2:
            raise RuntimeError("Fixed-vector kernels take no "
                               "sequence_lengths argument; pass None.")
        elif np.shape(sequence_lengths) != (input_x.shape[0],):
            raise RuntimeError("sequence_lengths needs one entry per row "
                               "of input_x.")
        else:
            # The conv kernels' own contract (lengths in [conv_width, L]),
            # checked once on the host for the whole input.
            require = getattr(self.kernel, "_require_lengths", None)
            if require is not None:
                require(input_x, sequence_lengths)
        if self.weights.shape[0] != self.kernel.get_num_rffs():
            raise RuntimeError(
                f"Fitted weights cover {self.weights.shape[0]} features but "
                f"the kernel now produces {self.kernel.get_num_rffs()}; "
                "refit after changing the feature count.")
        if self.var is None and get_var:
            raise RuntimeError("Variance was requested but suppress_var was "
                               "selected when fitting.")

    def set_hyperparams(self, hyperparams=None, dataset=None, xdim=None):
        """Set hyperparams (log-space), initialising the kernel if needed."""
        if self.kernel is None:
            self._initialize_kernel(dataset, xdim, hyperparams=hyperparams)
        elif hyperparams is not None:
            self.kernel.check_hyperparams(hyperparams)
            self.kernel.set_hyperparams(hyperparams, logspace=True)
        self.weights = None
        self.var = None

    def get_hyperparams(self):
        if self.kernel is None:
            return None
        return self.kernel.get_hyperparams()

    def build_preconditioner(self, dataset, max_rank=512, method="srht"):
        """Build a Nystrom preconditioner; returns (precond, ratio)."""
        self._run_pre_fitting_prep(dataset, max_rank)
        precond = NystromPreconditioner(self._engine(dataset), max_rank,
                                        self.verbose, self.random_seed,
                                        method,
                                        is_regression=self.is_regression)
        return precond, precond.achieved_ratio

    # ------------------------------------------------------------------
    def _initialize_kernel(self, dataset=None, xdim=None, hyperparams=None,
                           bounds=None):
        if dataset is not None:
            input_xdim = dataset.get_xdim()
        elif xdim is not None:
            input_xdim = xdim
        else:
            raise RuntimeError("Kernel construction needs input dimensions: "
                               "pass a dataset or an xdim tuple.")
        self.kernel = KERNEL_NAME_TO_CLASS[self.kernel_choice](
            input_xdim, self.num_rffs, self.random_seed, self._device,
            self.double_precision_fht,
            kernel_spec_parms=self.kernel_spec_parms)
        # Linear sets its feature count itself (D + 1 with an intercept),
        # whatever num_rffs asked for; the check is against that count.
        self._num_rffs = self.kernel.get_num_rffs()
        if self.variance_rffs >= self.num_rffs and self.is_regression:
            raise RuntimeError("variance_rffs cannot reach num_rffs; "
                               "shrink it.")
        if bounds is not None:
            self.kernel.set_bounds(bounds)
        if hyperparams is not None:
            self.kernel.check_hyperparams(hyperparams)
            self.kernel.set_hyperparams(hyperparams, logspace=True)
        self.weights, self.var = None, None
        self._engines = {}
        self._nmll_rank_cache = None

    def _run_pre_nmll_prep(self, dataset, bounds=None):
        if self.kernel is None:
            self._initialize_kernel(dataset, bounds=bounds)
        self.weights, self.var = None, None
        return self.kernel.get_bounds()

    def _run_singlepoint_nmll_prep(self, dataset, exact_method=False):
        if self.kernel is None:
            self._initialize_kernel(dataset)
        self.weights, self.var = None, None
        if self.num_rffs <= 2:
            raise RuntimeError("Tuning with num_rffs <= 2 cannot "
                               "distinguish hyperparameters; raise "
                               "num_rffs.")
        if exact_method and \
                self.kernel.get_num_rffs() > constants.MAX_CLOSED_FORM_RFFS:
            raise RuntimeError(
                f"At most {constants.MAX_CLOSED_FORM_RFFS} rffs can be used "
                "for exact-NMLL tuning; use approximate NMLL instead.")

    def _run_pre_fitting_prep(self, dataset, max_rank=None):
        self.trainy_mean = dataset.get_ymean()
        self.trainy_std = dataset.get_ystd()
        if self.kernel is None:
            self._initialize_kernel(dataset)
        if self.variance_rffs > self.kernel.get_num_rffs():
            raise RuntimeError(
                f"variance_rffs ({self.variance_rffs}) cannot exceed the "
                f"kernel's feature count ({self.kernel.get_num_rffs()}).")
        if max_rank is not None:
            if max_rank < 1:
                raise RuntimeError("Invalid value for max_rank.")
            if max_rank >= self.kernel.get_num_rffs():
                raise RuntimeError("max_rank cannot reach num_rffs.")

    # ------------------------------------------------------------------
    def _autoselect_preconditioner(self, dataset, min_rank=512,
                                   max_rank=3000, increment_size=512,
                                   always_use_srht2=False,
                                   ratio_target=30.):
        """Walk a ladder of candidate ranks, stopping at the first whose
        sampled min-eig / lambda^2 estimate clears ``ratio_target``; if the
        ladder is exhausted, use the largest admissible rank with the
        two-pass srht_2 construction.  Then build the preconditioner.
        Each trial rank is the span ``xgpr/precond.ratio_check``."""
        rank_cap = min(max_rank, self.kernel.get_num_rffs() - 1)
        # The engine's row count: on a sharded engine every rank must take
        # the same ladder.
        n_rows = self._engine(dataset).ndatapoints
        sample_frac = 1.0 if n_rows < 5000 else 0.2
        chosen_rank, method = rank_cap, "srht_2"
        if min_rank >= rank_cap:
            chosen_rank, method = rank_cap, "srht"
        else:
            for candidate in range(min_rank, rank_cap, increment_size):
                with span("xgpr/precond.ratio_check"):
                    est = self._check_rank_ratio(dataset, sample_frac,
                                                 candidate)
                if est <= ratio_target:
                    chosen_rank, method = candidate, "srht"
                    break
        if always_use_srht2:
            method = "srht_2"
        if self.verbose:
            print(f"Preconditioner rank {chosen_rank} ({method}).")
        return NystromPreconditioner(self._engine(dataset), chosen_rank,
                                     self.verbose, self.random_seed, method,
                                     is_regression=self.is_regression)

    def _amortized_nmll_preconditioner(self, dataset, ratio_target=30.):
        """Preconditioner for repeated approximate-NMLL evaluations.

        The first call runs the full rank autoselection (srht_2) and caches
        the rank it chose, keyed on the dataset.  A later call on the same
        dataset builds srht_2 at the cached rank directly, skipping the
        sampled check passes, and grows the rank by 512 (up to the hard
        cap) while the build's own achieved ratio misses the target.  A
        tuner's successive iterates move slowly, so the rank is nearly
        always the same.
        """
        num_rffs = self.kernel.get_num_rffs()
        hard_cap = min(constants.LARGEST_NMLL_MAX_RANK, num_rffs - 1)
        ds_token = self._dataset_token(dataset)
        cached = self._nmll_rank_cache
        if cached is not None and cached[0] != ds_token:
            cached = None
        if cached is None:
            precond = self._autoselect_preconditioner(
                dataset, min_rank=constants.SMALLEST_NMLL_MAX_RANK,
                max_rank=constants.LARGEST_NMLL_MAX_RANK,
                always_use_srht2=True, ratio_target=ratio_target)
            self._nmll_rank_cache = (ds_token, precond.get_rank())
            return precond

        engine = self._engine(dataset)
        rank = min(cached[1], hard_cap)
        precond = NystromPreconditioner(engine, rank, self.verbose,
                                        self.random_seed, "srht_2",
                                        is_regression=self.is_regression)
        while precond.achieved_ratio > ratio_target and rank < hard_cap:
            rank = min(rank + 512, hard_cap)
            precond = NystromPreconditioner(engine, rank, self.verbose,
                                            self.random_seed, "srht_2",
                                            is_regression=self.is_regression)
        self._nmll_rank_cache = (ds_token, rank)
        return precond

    def _check_rank_ratio(self, dataset, sample_frac=0.1, max_rank=512):
        """Sampled ratio estimate.  Caps the rff count at 8192 during the
        check (eigenvalue interlacing)."""
        if sample_frac < 0.01 or sample_frac > 1:
            raise RuntimeError("sample_frac must be in [0.01, 1].")
        num_rffs = self.num_rffs
        capped = min(num_rffs, 8192)
        if capped != num_rffs:
            self.num_rffs = capped
        eig = srht_ratio_check(self._engine(dataset), max_rank,
                               self.random_seed, sample_frac=sample_frac)
        ratio = float(eig.min()) / self.kernel.get_lambda() ** 2
        ratio /= sample_frac
        if capped != num_rffs:
            self.num_rffs = num_rffs
        return ratio

    # ------------------------------------------------------------------
    # properties with weight invalidation
    @property
    def device(self):
        return self._device

    @property
    def kernel_spec_parms(self):
        return self._kernel_spec_parms

    @kernel_spec_parms.setter
    def kernel_spec_parms(self, value):
        if not isinstance(value, dict):
            raise RuntimeError(
                f"kernel_spec_parms expects a dict of kernel settings; "
                f"got {type(value).__name__}.")
        self._kernel_spec_parms = value
        self.kernel = None
        self.weights = None
        self.var = None
        self._engines = {}

    @property
    def kernel_choice(self):
        return self._kernel_choice

    @kernel_choice.setter
    def kernel_choice(self, value):
        if not isinstance(value, str):
            raise RuntimeError("kernel_choice must be a string.")
        if value not in KERNEL_NAME_TO_CLASS:
            raise RuntimeError("kernel_choice does not name a registered "
                               "kernel.")
        self._kernel_choice = value
        self.kernel = None
        self.weights = None
        self.var = None

    @property
    def num_rffs(self):
        return self._num_rffs

    @num_rffs.setter
    def num_rffs(self, value):
        self._num_rffs = value
        if self.kernel is not None:
            # Rebuild the kernel at the new width, keeping its
            # hyperparameters and bounds.
            self._initialize_kernel(
                xdim=self.kernel.get_xdim(),
                hyperparams=self.kernel.get_hyperparams(),
                bounds=self.kernel.get_bounds())
        self.weights = None
        self.var = None

    @property
    def variance_rffs(self):
        return self._variance_rffs

    @variance_rffs.setter
    def variance_rffs(self, value):
        if value > constants.MAX_VARIANCE_RFFS:
            raise RuntimeError(
                f"variance_rffs is capped at {constants.MAX_VARIANCE_RFFS}.")
        # Linear is exempt, as in xgpr_tpu: its variance is a Nystrom
        # preconditioner of that rank, not a block of the feature columns
        # (the fit still refuses a rank above its feature count).
        if self.kernel is not None and value > self.num_rffs and \
                self.kernel_choice != "Linear":
            raise RuntimeError("variance_rffs cannot exceed num_rffs.")
        self._variance_rffs = value
        if self.var is not None:
            self.weights = None
            self.var = None

    @property
    def double_precision_fht(self):
        return self._double_precision_fht

    @double_precision_fht.setter
    def double_precision_fht(self, value):
        """Generate features in float64 (xgpr_tpu/models/baseclass.py:
        487-496).  The kernel holds its draws and projection in one dtype,
        so a built kernel is rebuilt, keeping its hyperparameters and
        bounds; the fitted weights go."""
        self._double_precision_fht = bool(value)
        if self.kernel is not None:
            self._initialize_kernel(
                xdim=self.kernel.get_xdim(),
                hyperparams=self.kernel.get_hyperparams(),
                bounds=self.kernel.get_bounds())

    @property
    def random_seed(self):
        return self._random_seed
