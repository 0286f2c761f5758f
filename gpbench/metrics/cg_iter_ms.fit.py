"""cg_iter_ms.fit: milliseconds per CG iteration of the traced fits
(``fit_phase_times["cg"]`` over the iterations)."""
from gpbench.harness.readers import completed


def read(run):
    done = [r for r in completed(run.traced) if r.get("cg_iters")]
    iters = sum(r["cg_iters"] for r in done)
    return 1e3 * sum(r["cg_s"] for r in done) / iters if iters else None
