"""launches_per_req.compress: device kernel launches per completed request
(frame host layer: how many launches a call makes)."""

from lz4bench import layers


def read(run):
    return layers.launches_per_req(run, "compress")
