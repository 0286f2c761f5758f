"""precond_rank.fit: the rank of the Nystrom preconditioners the traced
fits built, averaged (one a fit: the configured rank, or the one the
fit's autoselect chose).  Read from each preconditioner's ``get_rank()``
as it is built: in traced runs the name ``NystromPreconditioner`` in
``models/baseclass.py`` (``build_preconditioner`` and the autoselect)
is a subclass that notes it, put back after."""
import contextlib


@contextlib.contextmanager
def observe(notes):
    from xgpr_tpu_torch.models import baseclass
    original = baseclass.NystromPreconditioner
    ranks = notes.setdefault("ranks", [])

    class Noted(original):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            ranks.append(self.get_rank())
    baseclass.NystromPreconditioner = Noted
    try:
        yield
    finally:
        baseclass.NystromPreconditioner = original


def read(run):
    ranks = run.notes.get("ranks")
    return sum(ranks) / len(ranks) if ranks else None
