"""dispatch_ms_per_req.decompress: self time of the upload, pin, launch and
fetch spans per completed request, in ms (transfers: staging, copies and
launches enqueued)."""

from lz4bench import spans


def read(run):
    return spans.dispatch_ms_per_req(run, "decompress")
