"""k1_projections.nmll: the projections of a chunk's features that K1
makes a call at SLQ's right-hand sides (the fit column and the probes) in
the traced NMLL evaluations: the program's ``ops/cuda/ztzv.PROJECTIONS``
over its ``ztzv.LAUNCHES`` at that K, both keyed by the launch's shape.
None where the program keeps no such counter, or made no such call."""
import contextlib
from collections import Counter

from gpbench.harness.readers import completed


def _counts():
    from xgpr_tpu_torch.ops.cuda import ztzv
    projections = getattr(ztzv, "PROJECTIONS", None)
    if projections is None:
        return None
    return Counter(ztzv.LAUNCHES), Counter(projections)


@contextlib.contextmanager
def observe(notes):
    before = _counts()
    yield
    after = _counts()
    if before is not None and after is not None:
        notes["launches"] = after[0] - before[0]
        notes["projections"] = after[1] - before[1]


def read(run):
    launches = run.notes.get("launches")
    projections = run.notes.get("projections")
    if not completed(run.traced) or not launches or projections is None:
        return None
    rhs = run.config["nmll"]["settings"]["nsamples"] + 1
    calls = sum(n for key, n in launches.items() if key[3] == rhs)
    made = sum(n for key, n in projections.items() if key[3] == rhs)
    return made / calls if calls else None
