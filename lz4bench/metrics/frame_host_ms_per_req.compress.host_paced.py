"""frame_host_ms_per_req.compress.host_paced: self time of the entry, scan,
join, assemble and checksum spans per completed request, in ms (frame host
layer: the host's own work on a frame), in the write cells whose pace the
host sets (it moves ``compress_mbps.host_paced``)."""

from lz4bench import spans


def read(run):
    return spans.frame_host_ms_per_req(run, "compress")
