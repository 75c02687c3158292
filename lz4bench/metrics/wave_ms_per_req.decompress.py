"""wave_ms_per_req.decompress: self time of the plan, wave and push spans
per completed request, in ms (linked waves: the host's planning of
``decompress_frames_parallel``'s waves, each wave group's dispatch, and
the carry-over windows' slides).  With the frame host, dispatch and host
wait readers it adds up to the entry spans."""

from lz4bench import layers, spans

WAVES = ("lz4t.plan", "lz4t.wave", "lz4t.push")


def read(run):
    tr = layers._trace(run, "decompress")
    if tr is None:
        return None
    times = spans.self_times(tr)
    if not any(name in times for name in WAVES):
        return None
    return 1e3 * sum(times.get(name, 0.0) for name in WAVES) / len(run.done)
