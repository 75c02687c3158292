"""compress_mbps.host_paced: input bytes of all writes completed in the
window over the window's seconds, host clock, in MB/s (10^6 B/s), in the
write cells whose pace the host sets: the same rate as ``compress_mbps``,
under a bound of its own, since the host's speed drifts."""


def read(run):
    if run.side != "compress":
        return None
    return sum(r.nbytes_in for r in run.done) / run.window_s / 1e6
