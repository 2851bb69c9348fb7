"""A kernel's share of its roofline, from the frozen work of the cell
(counts/<cell>.json) and the kernel's device time in the profiled
stretch.

The table of peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet). Float32 outside the tensor cores is 67 TFLOP/s counting a fused
multiply-add as two operations, so 33.5 T operations a second; the
port's kernels are built with --fmad=false, so each counted operation is
one issue. Device memory: 3.35 TB/s. A card set below 700 W runs slower;
the run prints the card's power limit beside these shares.
"""

from __future__ import annotations

FP32_OPS_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(work: dict) -> float:
    """The least time the work can take: the larger of its operations over
    the float32 peak and its bytes (each input read once, each output
    written once) over the memory peak."""
    return max(work["operations"] / FP32_OPS_PER_S,
               work["bytes"] / HBM_BYTES_PER_S)


def kernel_s_per_frame(trace, name: str) -> float:
    """Device seconds a frame in kernels whose name holds `name`."""
    return sum(hi - lo for event, lo, hi in trace.device
               if name in event) / trace.frames


def share(run, kernel: str, name: str):
    """100 x bound / measured time a frame of `kernel` (its key in the
    counts file), whose CUDA function is `name`; None where the cell has
    no frozen work for it or the trace holds no launch of it."""
    work = run.counts.get(kernel)
    if work is None or run.trace is None:
        return None
    seconds = kernel_s_per_frame(run.trace, name)
    if seconds <= 0.0:
        return None
    return 100.0 * bound_s(work) / seconds
