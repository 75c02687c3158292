"""device_idle.compress.host_paced: the share of the traced window in which the
card ran nothing (device), in the write cells whose pace the host sets (it
moves ``compress_mbps.host_paced``)."""

from lz4bench import layers


def read(run):
    return layers.device_idle(run, "compress")
