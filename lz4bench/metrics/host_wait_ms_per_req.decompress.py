"""host_wait_ms_per_req.decompress: self time of the host's waits on the card
(a launch's lengths, a fetch, a staging buffer) per completed request, in ms
(device)."""

from lz4bench import spans


def read(run):
    return spans.host_wait_ms_per_req(run, "decompress")
