"""The port's transport: every copy between the host and a device of the
frame paths (counterpart of ``lz4tpu/hostpack.py``, ``lz4tpu``'s single
packing and transfer path, and of its kernel modules' ``dispatch_*`` /
``collect_*`` split).

* **Staging.**  Each device has a pool of reusable page-locked host
  buffers (plain host buffers on the CPU), grown by doubling and capped at
  ``STAGING_CAP`` kept bytes.  ``take`` hands out a span of one buffer; the
  buffer goes back to the pool only when the span and every view of it
  (``memoryview`` slices, numpy views) are gone, and it is handed out again
  only once the last copy that used it has completed (its event).  So a
  result that still points into a buffer is never overwritten.
* **Upload** (``upload``): byte strings and host arrays are written into one
  staging span with one vectorised copy a part (byte strings each in whole
  16-byte units; a large part cut over ``COPY_THREADS`` threads), sent in
  one asynchronous H2D copy on the device's copy stream, and the padded
  ``(N, W)`` rows the kernels take are built on the device by one scatter
  of units by offsets (or, for ``Rows(..., whole=True)``, laid out whole
  in staging and sent as they are).  The kernel's stream (PyTorch's
  current stream) waits on the copy's event.
* **Handle** (``Handle``): a launch's outputs on the device, with its
  lengths and statuses on their way to the host right after it (an
  asynchronous copy into staging and an event: ``meta()`` waits for it).
  ``collect(lens)`` compacts the rows that are wanted on the device (a
  gather of their units on the copy stream once the launch has ended),
  copies them into one staging span and waits: a ``Fetched`` of
  ``memoryview`` rows over one buffer, no copy a row.

On the CPU (``device="cpu"``, the tests) the same functions run with plain
tensors: no pinning, no streams, no events.  Nothing falls back from the
card to the CPU.

Each upload and fetch is a span (``lz4t.upload``, ``lz4t.fetch``), and so
is each wait on the card (``lz4t.wait.launch``, ``lz4t.wait.fetch``,
``lz4t.wait.staging``) and each new staging buffer (``lz4t.pin``); the
bytes moved and buffers allocated are counted (``runtime.stats()``).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import runtime
from .runtime import round_up

#: staging bytes a device's pool keeps for reuse; a buffer given back past
#: it is freed
STAGING_CAP = 4 << 30
#: the smallest staging buffer; larger ones are powers of two
STAGING_MIN = 1 << 16
#: bytes, and rows, a device gather or scatter moves at once
GATHER = 1 << 26
GATHER_ROWS = 1 << 12
#: alignment of each part of an upload and of each array of a handle's meta
ALIGN = 16
#: threads that write a large upload into staging, and the size from which
#: they share it
COPY_THREADS = 4
COPY_SPLIT = 8 << 20

_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}


class _Buffer:
    """One staging buffer and the event of the last copy that used it."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor):
        self.tensor = tensor
        self.event = None


class _Pool:
    """Reusable staging buffers of one device."""

    def __init__(self, pin: bool):
        self.pin = pin
        self.free = []  # buffers not handed out
        self.free_bytes = 0
        self.back = deque()  # buffers whose last view is gone (appended by finalizers)
        self.lock = threading.Lock()

    def take(self, nbytes: int):
        """(span, buffer): a ctypes array of ``nbytes`` over a buffer that is
        no longer used.  The buffer returns to the pool when the span and
        every view of it are gone."""
        buf = None
        with self.lock:
            while self.back:
                back = self.back.popleft()
                if self.free_bytes + back.tensor.numel() <= STAGING_CAP:
                    self.free.append(back)
                    self.free_bytes += back.tensor.numel()
            fits = [b for b in self.free if b.tensor.numel() >= nbytes]
            if fits:
                buf = min(fits, key=lambda b: b.tensor.numel())
                self.free.remove(buf)
                self.free_bytes -= buf.tensor.numel()
        if buf is None:
            size = max(STAGING_MIN, 1 << max(nbytes - 1, 0).bit_length())
            with runtime.span("lz4t.pin"):
                buf = _Buffer(torch.empty(size, dtype=torch.uint8, pin_memory=self.pin))
            runtime.count(staging_allocs=1, staging_alloc_bytes=size)
        if buf.event is not None:
            if not buf.event.query():  # the copy that last used it is still running
                runtime.count(staging_waits=1)
                with runtime.span("lz4t.wait.staging"):
                    buf.event.synchronize()
            buf.event = None
        span = (ctypes.c_uint8 * nbytes).from_address(buf.tensor.data_ptr())
        weakref.finalize(span, self.back.append, buf)
        return span, buf


class _Device:
    """A device's staging pool and copy stream."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.pool = _Pool(pin=self.cuda)
        self.copy = torch.cuda.Stream(dev) if self.cuda else None

    def current(self):
        """The stream the kernels launch on (PyTorch's current one)."""
        return torch.cuda.current_stream(self.dev) if self.cuda else None

    def on_copy_stream(self):
        return torch.cuda.stream(self.copy) if self.cuda else contextlib.nullcontext()

    def record(self, stream):
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(stream)
        return event

    def hand_over(self, event, tensors):
        """The current stream waits on ``event`` (a copy-stream step) before
        it uses ``tensors``, which were allocated on the copy stream."""
        if self.cuda:
            cur = self.current()
            cur.wait_event(event)
            for t in tensors:
                t.record_stream(cur)


_DEVICES: dict = {}
_DEVICES_LOCK = threading.Lock()


def _device(dev) -> _Device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _DEVICES_LOCK:
        if dev not in _DEVICES:
            _DEVICES[dev] = _Device(dev)
        return _DEVICES[dev]


def _host_array(part) -> np.ndarray:
    """A host array, bytes-like object or CPU tensor as a contiguous array."""
    if isinstance(part, np.ndarray):
        return np.ascontiguousarray(part)
    if isinstance(part, torch.Tensor):
        return np.ascontiguousarray(part.numpy())
    return np.frombuffer(memoryview(part).cast("B"), np.uint8)


#: bytes a device gather moves as one element: rows are laid out in staging
#: in whole units (a row's last unit padded), so a gather's index costs
#: half a byte a byte moved
UNIT = 16
_PADS = [bytes(k) for k in range(UNIT)]


def _units(lens: np.ndarray) -> np.ndarray:
    return (lens + UNIT - 1) // UNIT


def _copy_into(dst: np.ndarray, pieces) -> None:
    """Bytes-like ``pieces`` one after another into ``dst``: one
    concatenate, cut over ``COPY_THREADS`` threads when it is large (numpy
    copies without the interpreter lock)."""
    sizes = np.fromiter(map(len, pieces), np.int64, len(pieces))
    if len(dst) < COPY_SPLIT:
        np.concatenate([np.frombuffer(x, np.uint8) for x in pieces], out=dst)
        return
    ends = np.cumsum(sizes)
    cuts = np.linspace(0, len(dst), COPY_THREADS + 1).astype(np.int64)

    def copy(lo, hi):  # dst[lo:hi] from the pieces that overlap it
        first = int(np.searchsorted(ends, lo, "right"))
        views = []
        for i in range(first, len(pieces)):
            a = int(ends[i] - sizes[i])
            if a >= hi:
                break
            views.append(np.frombuffer(pieces[i], np.uint8)[max(lo - a, 0) : hi - a])
        np.concatenate(views, out=dst[lo:hi])

    for future in [_copy_pool().submit(copy, int(lo), int(hi))
                   for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]:
        future.result()


_POOL = None
_POOL_LOCK = threading.Lock()


def _copy_pool():
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(COPY_THREADS, thread_name_prefix="hostpack")
        return _POOL


def _write_units(dst: np.ndarray, items, lens, align_right: bool) -> None:
    """``items`` into ``dst`` each in whole units, left-aligned in them
    (``align_right``: right-aligned), zero padded: one join for many small
    items, else ``_copy_into``."""
    if not len(dst):
        return
    pads = [_PADS[k] for k in (-lens % UNIT).tolist()]
    pieces = [x for pair in (zip(pads, items) if align_right else zip(items, pads))
              for x in pair]
    if len(dst) < 4096 * len(items):
        dst[:] = np.frombuffer(b"".join(pieces), np.uint8)
    else:
        _copy_into(dst, pieces)


def _unit_chunks(units: np.ndarray):
    """``(a, b, start, size)``: rows ``a:b`` whose units start in one
    stretch of ``GATHER`` bytes and of ``GATHER_ROWS`` rows, their first unit
    and their unit count; so an index's temporaries stay small beside the
    rows they move."""
    ends = np.cumsum(units)
    starts = ends - units
    key = starts * UNIT // GATHER + np.arange(len(units)) // GATHER_ROWS
    cut = [0, *(np.flatnonzero(np.diff(key)) + 1).tolist(), len(units)]
    for a, b in zip(cut[:-1], cut[1:]):
        if b > a and ends[b - 1] > starts[a]:
            yield a, b, int(starts[a]), int(ends[b - 1] - starts[a])


def _unit_index(units_dev, a: int, b: int, size: int, row_units: int, right: bool = False):
    """For each of the ``size`` packed units of rows ``a:b`` (``units_dev``
    a row, one after another), its place among rows of ``row_units`` units:
    the row's first unit there (after the padding of a right-aligned row)
    plus its place in its row.  In ``units_dev``'s integer type."""
    n = units_dev[a:b]
    kind = dict(dtype=n.dtype, device=n.device)
    first = torch.arange(a, b, **kind) * row_units
    if right:
        first += row_units - n
    first -= torch.cumsum(n, 0, dtype=n.dtype) - n
    idx = torch.repeat_interleave(first, n, output_size=size)
    return idx.add_(torch.arange(size, **kind))


def _as_units(t: torch.Tensor) -> torch.Tensor:
    """A contiguous uint8 tensor of whole units as ``(units, 2)`` int64."""
    return t.reshape(-1).view(torch.int64).view(-1, 2)


class Rows:
    """A part of an upload: byte strings that arrive on the device as one
    padded ``(N, W)`` uint8 tensor, each left- (``align_right``: right-)
    aligned in a row zero elsewhere, and their ``(N,)`` int32 lengths.
    ``W`` is the longest rounded up to 16, or ``width`` where larger (a
    multiple of 16).

    ``whole=True`` lays the rows out whole in staging and sends them as
    they are: more bytes over the link, no work on the device.  Its rows
    are left-aligned, and the bytes past each item are not zeroed (they
    are what the staging buffer held)."""

    def __init__(self, items, align_right: bool = False, width: int = 0, whole: bool = False):
        self.items = items
        self.lens = np.fromiter(map(len, items), np.int64, len(items))
        self.units = _units(self.lens)
        self.align_right = align_right
        self.whole = whole
        self.width = max(round_up(int(self.lens.max(initial=0)), UNIT), width)
        if self.width % UNIT:
            raise ValueError(f"hostpack: a row width of {self.width} is not a multiple of {UNIT}")
        if whole and align_right:
            raise ValueError("hostpack: whole rows are left-aligned")

    @property
    def nbytes(self) -> int:
        """Bytes of the items in staging: whole rows, or whole units."""
        return len(self.lens) * self.width if self.whole else UNIT * int(self.units.sum())


def _write_whole_rows(dst: np.ndarray, items, width: int) -> None:
    """``items`` into ``dst`` at the starts of rows of ``width`` bytes,
    the rows cut over ``COPY_THREADS`` threads when they are large."""

    def copy(lo, hi):
        for i in range(lo, hi):
            x = np.frombuffer(items[i], np.uint8)
            dst[i * width : i * width + len(x)] = x

    n = len(items)
    if len(dst) < COPY_SPLIT or n < 2:
        copy(0, n)
        return
    cuts = np.linspace(0, n, min(COPY_THREADS, n) + 1).astype(np.int64)
    for future in [_copy_pool().submit(copy, int(lo), int(hi))
                   for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]:
        future.result()


def _scatter_rows(data, lens, part: Rows):
    """The padded rows of ``part`` from ``data`` (its items in whole units,
    one after another, on the device) and ``lens`` (their int32 lengths
    there): one scatter of units a chunk of rows."""
    rows = torch.zeros((len(part.lens), part.width), dtype=torch.uint8, device=data.device)
    units = (lens.to(torch.int64) + UNIT - 1) // UNIT  # index_copy_ takes int64
    src, dst = _as_units(data), _as_units(rows)
    for a, b, start, size in _unit_chunks(part.units):
        idx = _unit_index(units, a, b, size, part.width // UNIT, part.align_right)
        dst.index_copy_(0, idx, src[start : start + size])
    return rows


@runtime.traced("lz4t.upload")
def upload(dev, *parts):
    """Host ``parts`` to ``dev`` in one staging span and one copy, not
    waited for: a ``Rows`` part gives ``(rows, lens)``, any other part (a
    numpy array, a bytes-like object, a CPU tensor) a tensor of its dtype
    and shape.  The kernels may use the results on the current stream."""
    d = _device(dev)
    plan, total = [], 0
    for part in parts:
        if isinstance(part, Rows):
            lens_at = total + part.nbytes
            plan.append((part, total, lens_at))
            total = round_up(lens_at + 4 * len(part.lens), ALIGN)
        else:
            arr = _host_array(part)
            plan.append((arr, total, None))
            total = round_up(total + arr.nbytes, ALIGN)
    span, buf = d.pool.take(total)
    runtime.count(uploads=1, upload_bytes=total)
    host = np.frombuffer(span, np.uint8)
    for part, at, lens_at in plan:
        if lens_at is None:
            _copy_into(host[at : at + part.nbytes], [part.reshape(-1).view(np.uint8)])
        elif part.whole:
            _write_whole_rows(host[at:lens_at], part.items, part.width)
            host[lens_at : lens_at + 4 * len(part.lens)].view(np.int32)[:] = part.lens
        else:
            _write_units(host[at:lens_at], part.items, part.lens, part.align_right)
            host[lens_at : lens_at + 4 * len(part.lens)].view(np.int32)[:] = part.lens
    results, handed = [], []
    with d.on_copy_stream():
        flat = torch.empty(total, dtype=torch.uint8, device=d.dev)
        flat.copy_(buf.tensor[:total], non_blocking=True)
        for part, at, lens_at in plan:
            if lens_at is None:
                t = flat[at : at + part.nbytes].view(_TORCH_DTYPE[part.dtype]).view(part.shape)
                results.append(t)
                handed.append(t)
            elif part.whole:
                rows = flat[at:lens_at].view(len(part.lens), part.width)
                lens = flat[lens_at : lens_at + 4 * len(part.lens)].view(torch.int32)
                results.append((rows, lens))
                handed += [rows, lens]
            else:
                # a copy, so that ``flat`` (the items' units) is freed once the
                # rows are built, not kept for the launch by a view
                lens = flat[lens_at : lens_at + 4 * len(part.lens)].view(torch.int32).clone()
                rows = _scatter_rows(flat[at:lens_at], lens, part)
                results.append((rows, lens))
                handed += [rows, lens]
        buf.event = d.record(d.copy)
    d.hand_over(buf.event, handed)
    return results


def upload_batch(dev, blocks, prefixes=None):
    """A decode launch's inputs in one copy, as the decoders take them:
    ``(comp, comp_len, prefix, prefix_len)``.  Only a prefix's trailing
    64 KiB is addressable.  ``prefixes`` ``None`` gives an empty ``(1, 0)``
    prefix row; one prefix shared by every block (a dictionary) gives a
    single row that the kernels read with stride 0."""
    from .spec.block import WINDOW_SIZE

    n = len(blocks)
    if prefixes is None:
        (comp, comp_len), = upload(dev, Rows(blocks))
        return (comp, comp_len, torch.zeros((1, 0), dtype=torch.uint8, device=comp.device),
                torch.zeros(n, dtype=torch.int32, device=comp.device))
    prefixes = [bytes(p)[-WINDOW_SIZE:] for p in prefixes]
    if len(prefixes) != n:
        raise ValueError(f"{len(prefixes)} prefixes for {n} blocks")
    shared = n > 0 and all(p == prefixes[0] for p in prefixes)
    (comp, comp_len), (prefix, prefix_len) = upload(
        dev, Rows(blocks), Rows(prefixes[:1] if shared else prefixes, align_right=True))
    if shared:
        prefix_len = torch.full((n,), len(prefixes[0]), dtype=torch.int32, device=comp.device)
    return comp, comp_len, prefix, prefix_len


class Fetched:
    """Rows fetched into one staging span: row ``i`` is a ``memoryview`` of
    ``lens[i]`` bytes at ``offsets[i]`` (each row in whole units), or
    ``None`` where it was not wanted.  The span stays out of the pool while
    a row is referenced."""

    def __init__(self, span, offsets, lens, keep, event):
        self.buffer = memoryview(span).cast("B")
        self.offsets = offsets
        self.lens = lens
        self.keep = keep
        self.event = event

    def wait(self) -> "Fetched":
        if self.event is not None:
            with runtime.span("lz4t.wait.fetch"):
                self.event.synchronize()
            self.event = None
        return self

    def __len__(self) -> int:
        return len(self.lens)

    def __getitem__(self, i):
        if self.keep is not None and not self.keep[i]:
            return None
        o = int(self.offsets[i])
        return self.buffer[o : o + int(self.lens[i])]

    def __iter__(self):
        return (self[i] for i in range(len(self.lens)))


@runtime.traced("lz4t.fetch")
def fetch(out, lens, keep=None, after=None) -> Fetched:
    """Rows ``out[i, :lens[i]]`` of a contiguous ``(N, W)`` uint8 tensor, W
    a multiple of 16 (``lens`` on the host; rows with ``keep`` false are
    left out), compacted on the device in whole units and copied into one
    staging span, on the copy stream once ``after`` (an event of the
    current stream: the launch's end) has passed; not waited for."""
    d = _device(out.device)
    n, width = out.shape
    if width % UNIT or not out.is_contiguous() or out.numel() // UNIT >= 1 << 31:
        raise ValueError(f"hostpack: rows of {width} bytes are not whole units of {UNIT}, "
                         "or too many for 32-bit indices")
    lens = np.asarray(lens, np.int64)
    if keep is not None:
        lens = np.where(keep, lens, 0)
    units = _units(lens)
    offsets = (np.cumsum(units) - units) * UNIT
    units_at = UNIT * int(units.sum())
    span, buf = d.pool.take(units_at + 4 * n)
    runtime.count(fetches=1, fetch_bytes=units_at)
    np.frombuffer(span, np.int32, n, units_at)[:] = units
    with d.on_copy_stream():
        if d.cuda:
            if after is not None:
                d.copy.wait_event(after)
            out.record_stream(d.copy)
        # int32 indices (``out`` holds far fewer than 2**31 units): the
        # temporaries sit beside ``out`` at a decode's peak
        units_dev = torch.empty(n, dtype=torch.int32, device=d.dev)
        units_dev.copy_(buf.tensor[units_at : units_at + 4 * n].view(torch.int32),
                        non_blocking=True)
        src, dst = _as_units(out), _as_units(buf.tensor[:units_at])
        for a, b, start, size in _unit_chunks(units):
            idx = _unit_index(units_dev, a, b, size, width // UNIT)
            dst[start : start + size].copy_(src.index_select(0, idx), non_blocking=True)
        buf.event = d.record(d.copy)
    return Fetched(span, offsets, lens, keep, buf.event)


class Handle:
    """One launch in flight (the counterpart of ``lz4tpu``'s
    ``dispatch_*`` results): its output rows on the device and its ``meta``
    tensors (lengths, statuses) copied into staging right after it on the
    current stream, with an event.  ``meta()`` waits for them;
    ``collect(lens)`` fetches the rows and waits."""

    def __init__(self, out, *meta):
        self.out = out
        d = _device(out.device)
        sizes = [round_up(m.numel() * m.element_size(), ALIGN) for m in meta]
        span, buf = d.pool.take(sum(sizes))
        self._meta, at = [], 0
        for m, size in zip(meta, sizes):
            nbytes = m.numel() * m.element_size()
            buf.tensor[at : at + nbytes].view(m.dtype).copy_(m.reshape(-1), non_blocking=True)
            self._meta.append(np.frombuffer(span, np.dtype(str(m.dtype).split(".")[-1]),
                                            m.numel(), at).reshape(tuple(m.shape)))
            at += size
        self.ready = buf.event = d.record(d.current())

    def meta(self):
        """The meta tensors as host arrays, once their copy has completed."""
        if self.ready is not None:
            with runtime.span("lz4t.wait.launch"):
                self.ready.synchronize()
        return self._meta

    def collect(self, lens, keep=None) -> Fetched:
        """The rows ``out[i, :lens[i]]`` (``fetch``), once they are in
        staging; the output rows are let go."""
        fetched = fetch(self.out, lens, keep, after=self.ready)
        self.out = None
        return fetched.wait()
