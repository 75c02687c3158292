"""waves_per_req.decompress: ``lz4t.wave`` spans that start in the window
inside an entry span, per completed request (linked waves: wave groups
dispatched, one decoder launch each)."""

from lz4bench import layers, spans


def read(run):
    tr = layers._trace(run, "decompress")
    if tr is None:
        return None
    w0, w1 = tr.window
    entries = [(a, b) for a, b, name in tr.host if name in spans.ENTRIES]
    waves = [a for a, b, name in tr.host
             if name == "lz4t.wave" and w0 <= a < w1 and any(s <= a and b <= e
                                                            for s, e in entries)]
    return len(waves) / len(run.done) if waves else None
