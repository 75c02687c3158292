"""link_gbps.decompress: GB/s of the host-device copies while they run
(transfers, ``hostpack.py``)."""

from lz4bench import layers


def read(run):
    return layers.link_gbps(run, "decompress")
