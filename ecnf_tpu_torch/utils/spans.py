"""Named ranges of the port's layers on the `torch.profiler` timeline.

A span is recorded only while a torch profiler runs (``with
torch.profiler.profile()`` or ``profile.start()``); otherwise `span` costs
one flag read and enters no profiler range.  The ranges are the profiler's
plain host ranges (``_RecordFunctionFast``), not the user annotations of
``torch.profiler.record_function``: with CUDA activity on, the profiler
copies each user annotation onto the device timeline as an event of the
card, which a reader of the trace would count among the card's operations.
A plain range stays on the host; the device operations it launched are
found through their launch calls, which run inside it.
"""
import contextlib
import functools
from typing import Callable

from torch._C._profiler import _RecordFunctionFast as record_function
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a range while a profiler runs."""
    return record_function(name) if _profiler._is_profiler_enabled else _OFF


def traced(name: str, fn: Callable) -> Callable:
    """``fn`` with each call inside `span(name)`."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return call
