"""link_gbps.compress.host_paced: GB/s of the host-device copies while they run
(transfers, ``hostpack.py``), in the write cells whose pace the host sets
(it moves ``compress_mbps.host_paced``)."""

from lz4bench import layers


def read(run):
    return layers.link_gbps(run, "compress")
