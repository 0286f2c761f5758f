"""slq_passes.nmll: K1's passes over the data per traced NMLL evaluation
at SLQ's right-hand sides (the fit column and the probes): the batched
PCG's matvecs.  Launches at other widths (none today) are left out."""
from gpbench.harness.readers import Launches, completed

_K1 = Launches("k1", __file__)
observe = _K1.observe


def read(run):
    done = completed(run.traced)
    counts = run.notes.get("launches")
    if not done or not counts:
        return None
    rhs = run.config["nmll"]["settings"]["nsamples"] + 1
    n = sum(v for key, v in counts.items() if key[3] == rhs)
    return n / run.basis["chunks"] / len(done) if n else None
