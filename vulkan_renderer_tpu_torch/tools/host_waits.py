"""Host waits in a frame's dispatch, found with PyTorch's sync debug mode.

The Application keeps frames in flight (core/app.py): the host queues
frame n + 1 while the card still works on frame n. Any call in the
dispatch that makes the host wait for the card (a blocking copy from
pageable memory, .item(), a data-dependent shape) serializes the frames.
torch.cuda.set_sync_debug_mode reports such calls: "error" raises at the
first one, "warn" warns at each. tests/test_torch_gpu.py and
tools/frame_spans.py use these on the card.
"""

from __future__ import annotations

import warnings

import torch


def _warm_up(app) -> None:
    """Dispatch and retire one frame: first-use work (kernel libraries,
    cached device constants) is done before the frames that are checked."""
    app.render_frame_sync()


def _retire_all(app) -> None:
    while app._in_flight:
        app._retire()


def dispatch_without_host_wait(app, dispatches: int = 2) -> None:
    """Dispatch `dispatches` frames of `app` (on a CUDA device) under
    sync debug mode "error", then retire them: raises RuntimeError at the
    first synchronizing call."""
    _warm_up(app)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(dispatches):
            app._dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        _retire_all(app)


# The warning sync debug mode "warn" gives at each synchronizing call. The
# mode's own notice on first use ("... does not yet detect all
# synchronizing operations") is none.
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_host_waits(app) -> int:
    """The synchronizing calls in one dispatch of `app` (sync debug mode
    "warn", each of its SYNC_WARNING warnings counted)."""
    _warm_up(app)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            app._dispatch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    _retire_all(app)
    return sum(SYNC_WARNING in str(w.message) for w in caught)
