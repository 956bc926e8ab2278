"""The device the port runs on, shared by the aligner and the LM code,
and the timing events its kernel launches record around each kernel."""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Tuple

import torch


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: ``None`` means the card, which must
    exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


_local = threading.local()


@contextlib.contextmanager
def kernel_marks(kind: str = "kernel"
                 ) -> Iterator[List[Tuple[object, object]]]:
    """Collect, while the block runs on this thread, a ``(start, end)``
    pair of timing events for each kernel launch that takes
    :func:`launch_marks` of the same ``kind`` (the WFA kernels
    ``"kernel"``, the traceback kernel ``"traceback"``).  The launch records
    them on its stream right before and right after the kernel, so once
    ``end`` has passed, ``start.elapsed_time(end)`` is that kernel's device
    time."""
    prev = getattr(_local, kind, None)
    marks: List[Tuple[object, object]] = []
    setattr(_local, kind, marks)
    try:
        yield marks
    finally:
        setattr(_local, kind, prev)


def launch_marks(stream, kind: str = "kernel") -> Tuple[object, object]:
    """-> the raw ``cudaEvent_t`` handles (start, end) for one launch on
    ``stream``, or ``(None, None)`` where no :func:`kernel_marks` block of
    ``kind`` collects them."""
    marks = getattr(_local, kind, None)
    if marks is None:
        return None, None
    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    for ev in pair:      # creates the event on the stream's card; the
        ev.record(stream)    # launch records it again around the kernel
    marks.append(pair)
    return pair[0].cuda_event, pair[1].cuda_event
