"""dispatch_ms_per_req.compress.host_paced: self time of the upload, pin,
launch and fetch spans per completed request, in ms (transfers: staging,
copies and launches enqueued), in the write cells whose pace the host sets
(it moves ``compress_mbps.host_paced``)."""

from lz4bench import spans


def read(run):
    return spans.dispatch_ms_per_req(run, "compress")
