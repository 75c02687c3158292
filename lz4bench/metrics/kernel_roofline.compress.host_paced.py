"""kernel_roofline.compress.host_paced: the kernels' share of the HBM roofline
of the requests' bytes (kernels, ``csrc/*.cu``), in the write cells whose
pace the host sets (it moves ``compress_mbps.host_paced``)."""

from lz4bench import layers


def read(run):
    return layers.kernel_roofline(run, "compress")
