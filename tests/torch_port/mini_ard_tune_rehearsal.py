"""A CPU rehearsal of chip_smoke.py's MiniARD path at a smaller size.

    python -m tests.torch_port.mini_ard_tune_rehearsal [rows] [tune_rffs]

On the first ``rows`` (16,384) training rows of a 65,536 + 4,096-row
draw of slice A's generator (``chip_smoke.tabular_data``, seed 123; its
weights, and so its targets, depend on the draw's size), crude-tunes
MiniARD (split at chip_smoke.ARD_SPLIT) and RBF at ``tune_rffs`` (1024)
RFFs in float64 on the CPU (the port, device="cpu"), refits each at
twice that width and prints the tuned point, the score, the evaluations
and the Spearman on the 4,096 held-out rows.  Its MiniARD Spearman was
the prior for the card's MiniARD Spearman (PERF.md).  About a minute.
"""
import sys
import time

import numpy as np
import torch
from scipy.stats import spearmanr

import chip_smoke as cs
from xgpr_tpu_torch import GPRegression, build_regression_dataset


def main(rows=16384, tune_rffs=1024):
    torch.set_num_threads(2)
    (trx, tr_y), (tex, te_y) = cs.tabular_data(65_536, 4096, cs.N_FEATURES,
                                               seed=cs.SEED)
    dset = build_regression_dataset(trx[:rows], tr_y[:rows],
                                    chunk_size=cs.CHUNK)
    for kernel, settings in (("MiniARD", {"split_points": [cs.ARD_SPLIT]}),
                             ("RBF", None)):
        t0 = time.perf_counter()
        tuner = GPRegression(num_rffs=tune_rffs, kernel_choice=kernel,
                             kernel_settings=settings, device="cpu",
                             verbose=False)
        hparams, n_feval, score = tuner.tune_hyperparams_crude(
            dset, max_bayes_iter=cs.BAYES_ITER)
        model = GPRegression(num_rffs=2 * tune_rffs, variance_rffs=64,
                             kernel_choice=kernel, kernel_settings=settings,
                             device="cpu", verbose=False)
        model.set_hyperparams(hparams, dset)
        model.fit(dset, mode="cg")
        rho = float(spearmanr(model.predict(tex), te_y)[0])
        print(f"{kernel} on {rows} rows: tuned at {tune_rffs} RFFs to "
              f"{np.asarray(hparams)} (score {score}, {n_feval} "
              f"evaluations); refit at {2 * tune_rffs}: held-out Spearman "
              f"{rho:.4f}; {time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
