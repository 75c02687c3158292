"""host_wait_ms_per_req.compress.host_paced: self time of the host's waits on
the card (a launch's lengths, a fetch, a staging buffer) per completed
request, in ms (device), in the write cells whose pace the host sets (it
moves ``compress_mbps.host_paced``)."""

from lz4bench import spans


def read(run):
    return spans.host_wait_ms_per_req(run, "compress")
