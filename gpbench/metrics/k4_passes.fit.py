"""k4_passes.fit: K4's passes over the training rows per traced fit: its
launches at the chunk's row count over the chunk count (the sketch and
Z^T Z Q passes of the preconditioner, CG's matvecs, the variance's
pass).  Launches at another row count are left out."""
from gpbench.harness.readers import Launches, completed

_K4 = Launches("k4", __file__)
observe = _K4.observe


def read(run):
    done = completed(run.traced)
    counts = run.notes.get("launches")
    if not done or not counts:
        return None
    n = sum(v for key, v in counts.items()
            if key[0] == run.basis["chunk_rows"])
    return n / run.basis["chunks"] / len(done) if n else None
