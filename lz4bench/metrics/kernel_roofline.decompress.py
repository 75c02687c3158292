"""kernel_roofline.decompress: the kernels' share of the HBM roofline of the
requests' bytes (kernels, ``csrc/*.cu``)."""

from lz4bench import layers


def read(run):
    return layers.kernel_roofline(run, "decompress")
