"""The arithmetic of the per-layer metrics, each read from a traced window.

Every function takes the run and the op's side (``"compress"`` or
``"decompress"``) its metric belongs to, and returns ``None`` where the run
has nothing for it: another side, no trace, or no device operation of the
kind it reads.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s
PEAK_HBM_BYTES_S = 3.35e12


def _trace(run, side):
    return run.trace if run.side == side and run.trace is not None and run.done else None


def launches_per_req(run, side):
    """Device kernel launches in the window over the requests completed."""
    tr = _trace(run, side)
    return None if tr is None else len(tr.ops("kernel")) / len(run.done)


def link_gbps(run, side):
    """Bytes of the host-to-device and device-to-host copies over their
    summed durations, in GB/s."""
    tr = _trace(run, side)
    copies = [] if tr is None else [
        op for op in tr.ops("gpu_memcpy") if "HtoD" in op.name or "DtoH" in op.name]
    busy_us = sum(op.end - op.start for op in copies)
    return sum(op.nbytes for op in copies) / busy_us / 1e3 if busy_us > 0 else None


def kernel_roofline(run, side):
    """The least time the requests' bytes need (each request's input and
    output read or written once, at the HBM's peak) over the summed device
    time of all kernels in the window, in %."""
    tr = _trace(run, side)
    kernel_us = 0.0 if tr is None else sum(op.end - op.start for op in tr.ops("kernel"))
    if kernel_us <= 0:
        return None
    need_s = sum(r.nbytes_in + r.nbytes_out for r in run.done) / PEAK_HBM_BYTES_S
    return 100.0 * need_s / (kernel_us * 1e-6)


def device_idle(run, side):
    """The share of the window in which no kernel or copy ran, in %."""
    tr = _trace(run, side)
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
