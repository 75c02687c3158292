"""frame_host_ms_per_req.compress: self time of the entry, scan, join, assemble
and checksum spans per completed request, in ms (frame host layer: the
host's own work on a frame)."""

from lz4bench import spans


def read(run):
    return spans.frame_host_ms_per_req(run, "compress")
