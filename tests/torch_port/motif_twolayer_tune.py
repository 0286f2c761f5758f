"""Hyperparameters of chip_smoke.py's Conv1dTwoLayer (K4) path.

Not a test: a script, run on the CPU from the root of a checkout,

    python -m tests.torch_port.motif_twolayer_tune

It draws the motif corpus exactly as chip_smoke.py does (the same
function, seed and size, so the same target), tunes xgpr_tpu's
Conv1dTwoLayer (conv_width 9, init_rffs 1024, 1024 RFFs) with
``tune_hyperparams_crude`` on the first 4,000 training rows in float64,
fits it exactly at the tuned values and prints the held-out Spearman on
4,000 of the corpus's held-out rows.  chip_smoke.py pins the printed
hyperparameters and takes that Spearman less 0.05 as its floor.
"""
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import xgpr_tpu  # noqa: E402
from tests.utils.synthetic import spearman  # noqa: E402

N_TUNE, N_HELD = 4000, 4000


def main():
    t0 = time.perf_counter()
    x, y, lens = chip_smoke.motif_corpus(chip_smoke.N_TRAIN +
                                         chip_smoke.N_TEST)
    held = slice(chip_smoke.N_TRAIN, chip_smoke.N_TRAIN + N_HELD)
    trx, tr_y, tr_l = x[:N_TUNE], y[:N_TUNE], lens[:N_TUNE]
    tex, te_y, te_l = x[held], y[held], lens[held]
    print(f"corpus made in {time.perf_counter() - t0:.1f}s", flush=True)
    dset = xgpr_tpu.build_regression_dataset(trx, tr_y, tr_l,
                                             chunk_size=1000)
    model = xgpr_tpu.GPRegression(
        num_rffs=1024, variance_rffs=64, kernel_choice="Conv1dTwoLayer",
        kernel_settings={"conv_width": chip_smoke.MOTIF_W,
                         "init_rffs": chip_smoke.INIT_RFFS},
        verbose=False)
    t0 = time.perf_counter()
    hparams, n_feval, score = model.tune_hyperparams_crude(dset)
    print(f"tuned in {time.perf_counter() - t0:.1f}s, {n_feval} "
          f"evaluations, score {score}", flush=True)
    model.set_hyperparams(hparams, dset)
    model.fit(dset, mode="exact")
    rho = spearman(model.predict(tex, te_l), te_y)
    print(f"hyperparameters (log lambda, log sigma): "
          f"{np.array2string(np.asarray(hparams), precision=7)}")
    print(f"held-out Spearman on {N_HELD} rows: {rho:.4f}")


if __name__ == "__main__":
    main()
