"""Conjugate-direction softmax fitting with a one-pass step-grid line
search (port of xgpr_tpu/fitting/softmax_solver.py).

Minimises the classifier objective -- softmax cross-entropy on random
features plus an L2(lambda^2) ridge that exempts the intercept row --
with Polak-Ribiere-plus conjugate directions and the Nystrom
preconditioner as a metric for the gradient.  Each iteration makes two
dataset passes: ``Engine.classification_loss_grad`` and
``Engine.softmax_linesearch``, which scores the whole geometric step grid
at once (the logits of W + t D are affine in t); the ridge term is a
quadratic in t added in closed form, and the step is chosen on the host
from the (K,) vector of totals.  The grid is re-centred each iteration on
4x the previously accepted step.

The weights, gradient and direction are float64 on the device, like the
CG state (fitting/fused_cg.py); the host reads a few scalars per
iteration.
"""
import numpy as np
import torch

# Relative step grid, descending: 4x the running scale down to 4/2^13.
_STEP_GRID = 2.0 ** np.arange(2.0, -12.0, -1.0)
# Sufficient-decrease slope fraction for accepting a candidate step.
_DECREASE_FRACTION = 1e-4


def _vdot(a, b):
    return float(torch.sum(a * b))


def fit_softmax_ncg(engine, n_classes, preconditioner=None, max_iter=500,
                    tol=1e-4, verbose=False):
    """Fit multinomial-logistic weights on random features.

    Returns (weights (M, n_classes) float64 on the engine's device,
    n_iterations, objective_history).
    """
    lam = engine.kernel.get_lambda()
    num_rffs = engine.kernel.get_num_rffs()
    weights = torch.zeros((num_rffs, n_classes), dtype=torch.float64,
                          device=engine.device)

    grad, objective = engine.classification_loss_grad(weights, lam)
    history = [float(objective)]
    if verbose:
        print(f"Initial objective: {history[0]}", flush=True)

    prev_grad = prev_metric_grad = prev_dir = None
    scale = 1.0
    iteration = 0
    for iteration in range(1, max_iter + 1):
        metric_grad = preconditioner.batch_matvec(grad) \
            if preconditioner is not None else grad

        # Polak-Ribiere-plus mixing of the previous direction; a degenerate
        # denominator or an ascent direction restarts on the
        # (preconditioned) steepest descent.
        direction = -metric_grad
        if prev_grad is not None:
            denom = _vdot(prev_grad, prev_metric_grad)
            if np.isfinite(denom) and denom > 0.0:
                mix = _vdot(metric_grad, grad - prev_grad) / denom
                if mix > 0.0:
                    direction = direction + mix * prev_dir
        slope = _vdot(grad, direction)
        if not np.isfinite(slope) or slope >= 0.0:
            direction = -metric_grad
            slope = _vdot(grad, direction)

        # One dataset pass scores the whole step grid; the ridge term in
        # closed form (intercept row exempt).
        steps = scale * _STEP_GRID
        data_losses = engine.softmax_linesearch(weights, direction, steps,
                                                lam).cpu().numpy()
        w_pen, d_pen = weights[1:, :], direction[1:, :]
        quad_a = _vdot(w_pen, w_pen)
        quad_b = _vdot(w_pen, d_pen)
        quad_c = _vdot(d_pen, d_pen)
        totals = data_losses + 0.5 * lam ** 2 * (
            quad_a + 2.0 * quad_b * steps + quad_c * steps ** 2)

        ceiling = history[-1] + _DECREASE_FRACTION * steps * slope
        acceptable = np.isfinite(totals) & (totals <= ceiling)
        if acceptable.any():
            # The grid is descending, so argmax picks the largest good step.
            pick = int(np.argmax(acceptable))
        else:
            pick = int(np.nanargmin(np.where(np.isfinite(totals), totals,
                                             np.inf)))
            if totals[pick] >= history[-1]:
                # Nothing on the grid improves: drop the conjugate memory
                # and zoom the window in for the next attempt.
                prev_grad = None
                scale = max(float(steps[-1]), 1e-12)
                history.append(history[-1])
                continue
        step = float(steps[pick])
        weights = weights + step * direction

        prev_grad, prev_metric_grad, prev_dir = grad, metric_grad, direction
        grad, objective = engine.classification_loss_grad(weights, lam)
        history.append(float(objective))
        scale = max(step * 4.0, 1e-12)
        if verbose:
            print(f"Iteration {iteration}: objective {history[-1]}, "
                  f"step {step:.3e}", flush=True)
        if abs(history[-1] - history[-2]) < tol * abs(history[-2]):
            break

    return weights, iteration, history
