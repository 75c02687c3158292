"""device_idle.decompress: the share of the traced window in which the card
ran nothing (device)."""

from lz4bench import layers


def read(run):
    return layers.device_idle(run, "decompress")
