"""The held-out accuracies that set chip_smoke.py's classifier floors.

    python -m tests.torch_port.classifier_floors [rows] [rffs]

Fits GPClassification of both packages in float64 on the CPU (xgpr_tpu
and the port on device="cpu"), on the first ``rows`` (16,384) training
rows of chip_smoke.py's own classifier data at ``rffs`` (1024) RFFs, and
scores the 16,384 held-out rows the card's run scores:

- RBF: ``chip_smoke.classification_data`` at slice A's shape (262,144 +
  16,384 rows x 84 features, 5 classes), CLASS_HPARAMS;
- Conv1dRBF: the motif corpus (``chip_smoke.motif_corpus`` at 262,144 +
  16,384 rows) cut at its quartiles into 4 classes, CONV_CLASS_HPARAMS.

Prints each package's iterations, final objective, accuracy and seconds;
chip_smoke.py's floor is the lower accuracy less 0.01.  Takes a few
minutes and ~3 GB (the corpus).
"""
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import xgpr_tpu  # noqa: E402
import xgpr_tpu_torch  # noqa: E402


def score(name, train, test, kernel, settings, hparams, rffs):
    (x, y, lens), (tex, te_y, tel) = train, test
    accs = []
    for pkg, kw in ((xgpr_tpu, {}), (xgpr_tpu_torch, {"device": "cpu"})):
        dset = pkg.build_classification_dataset(x, y, sequence_lengths=lens,
                                                chunk_size=4096)
        model = pkg.GPClassification(num_rffs=rffs, kernel_choice=kernel,
                                     kernel_settings=settings,
                                     verbose=False, **kw)
        model.set_hyperparams(hparams, dset)
        t0 = time.perf_counter()
        n_iter, hist = model.fit(dset, run_diagnostics=True)
        probs = model.predict(tex, tel) if tel is not None else \
            model.predict(tex)
        acc = float((np.argmax(probs, axis=1) == te_y).mean())
        accs.append(acc)
        print(f"{name} {pkg.__name__}: {x.shape[0]} rows, {rffs} RFFs, "
              f"{n_iter} iterations, objective {hist[-1]:.6f}, held-out "
              f"accuracy {acc:.6f} on {te_y.shape[0]} rows, "
              f"{time.perf_counter() - t0:.1f}s (CPU, float64)", flush=True)
    print(f"{name}: floor {min(accs) - 0.01:.4f}", flush=True)


def main(argv):
    rows = int(argv[0]) if argv else 16_384
    rffs = int(argv[1]) if len(argv) > 1 else 1024
    (trx, tr_y), (tex, te_y) = cs.classification_data(
        cs.N_TRAIN, cs.N_TEST, cs.N_FEATURES, cs.CLASS_N_CLASSES,
        seed=cs.SEED)
    score("RBF", (trx[:rows], tr_y[:rows], None), (tex, te_y, None), "RBF",
          None, cs.CLASS_HPARAMS, rffs)
    x, y, lens = cs.motif_corpus(cs.N_TRAIN + cs.N_TEST)
    cls = cs.quartile_classes(y)
    held = slice(cs.N_TRAIN, cs.N_TRAIN + cs.N_TEST)
    score("Conv1dRBF", (x[:rows], cls[:rows], lens[:rows]),
          (x[held], cls[held], lens[held]), "Conv1dRBF",
          {"conv_width": cs.MOTIF_W}, cs.CONV_CLASS_HPARAMS, rffs)


if __name__ == "__main__":
    main(sys.argv[1:])
