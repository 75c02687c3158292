"""decompress_mbps: content bytes of all reads completed in the window
over the window's seconds, host clock, in MB/s (10^6 B/s)."""


def read(run):
    if run.side != "decompress":
        return None
    return sum(r.nbytes_out for r in run.done) / run.window_s / 1e6
