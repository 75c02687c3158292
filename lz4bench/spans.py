"""The program's own spans in a traced window: the self time of each
``lz4t.*`` span (``lz4tpu_torch.runtime.span``) on the sending thread.

A span's self time is its duration, clipped to the window, less the union
of its child ``lz4t.*`` spans; the torch operators and runtime calls
inside it are its own work and stay in it.  Only spans inside an entry
span count, so the self times of a window add up to its entry spans'
duration.  The three readers split that by layer: the frame host layer,
the transfers and the host's waits on the card.  Each returns ``None``
for another side, without a trace, or where the trace holds no entry span
(a program without these spans).
"""

from __future__ import annotations

from collections import defaultdict

from lz4bench import layers, trace

PREFIX = "lz4t."
ENTRIES = ("lz4t.compress_frame", "lz4t.decompress_frame", "lz4t.decompress_frames")
FRAME_HOST = ENTRIES + ("lz4t.scan", "lz4t.join", "lz4t.assemble", "lz4t.checksum")
DISPATCH = ("lz4t.upload", "lz4t.pin", "lz4t.launch", "lz4t.fetch")
HOST_WAIT = ("lz4t.wait.launch", "lz4t.wait.fetch", "lz4t.wait.staging")


def self_times(tr) -> dict[str, float]:
    """Seconds of self time by name of the ``lz4t.*`` spans of ``tr.host``
    that lie inside an entry span, clipped to the window."""
    w0, w1 = tr.window
    spans = sorted(((max(a, w0), min(b, w1), name) for a, b, name in tr.host
                    if name.startswith(PREFIX) and min(b, w1) > max(a, w0)),
                   key=lambda s: (s[0], -s[1]))
    total = defaultdict(float)
    stack = []  # open spans: [start, end, name, counted, child intervals]

    def close():
        start, end, name, counted, children = stack.pop()
        if counted:
            total[name] += (end - start - trace.union(children)) * 1e-6

    for start, end, name in spans:
        while stack and stack[-1][1] <= start:
            close()
        counted = name in ENTRIES
        if stack:
            stack[-1][4].append((start, min(end, stack[-1][1])))
            counted = counted or stack[-1][3]
        stack.append([start, end, name, counted, []])
    while stack:
        close()
    return dict(total)


def _per_req_ms(run, side, names):
    tr = layers._trace(run, side)
    if tr is None:
        return None
    times = self_times(tr)
    if not any(name in times for name in ENTRIES):
        return None
    return 1e3 * sum(times.get(name, 0.0) for name in names) / len(run.done)


def frame_host_ms_per_req(run, side):
    """Self time of the entry, scan, join, assemble and checksum spans over
    the requests completed, in ms."""
    return _per_req_ms(run, side, FRAME_HOST)


def dispatch_ms_per_req(run, side):
    """Self time of the upload, pin, launch and fetch spans over the
    requests completed, in ms."""
    return _per_req_ms(run, side, DISPATCH)


def host_wait_ms_per_req(run, side):
    """Self time of the spans in which the host waits on the card (a
    launch's lengths, a fetch, a staging buffer's last copy) over the
    requests completed, in ms."""
    return _per_req_ms(run, side, HOST_WAIT)
