"""compress_mbps: input bytes of all writes completed in the window over
the window's seconds, host clock, in MB/s (10^6 B/s).  The metric of the
write cells whose pace the device sets; ``compress_mbps.host_paced`` is
the same rate where the host sets it."""


def read(run):
    if run.side != "compress":
        return None
    return sum(r.nbytes_in for r in run.done) / run.window_s / 1e6
