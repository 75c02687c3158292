"""stored_ratio: frame bytes over input bytes of all writes completed in
the window (whole passes, so every object counts alike)."""


def read(run):
    if run.side != "compress" or not run.done:
        return None
    return sum(r.nbytes_out for r in run.done) / sum(r.nbytes_in for r in run.done)
