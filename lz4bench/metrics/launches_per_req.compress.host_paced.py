"""launches_per_req.compress.host_paced: device kernel launches per completed
request (frame host layer: how many launches a call makes), in the write
cells whose pace the host sets (it moves ``compress_mbps.host_paced``)."""

from lz4bench import layers


def read(run):
    return layers.launches_per_req(run, "compress")
