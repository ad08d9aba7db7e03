"""Host-side ring buffers with sequence semantics (the port's own copy of
``caltech_bifrost_dsp_tpu/runtime/ring.py``, same behaviour).

The reference connects its 13 per-pipeline threads with Bifrost rings in
system / pinned / GPU memory (reference: lwa352-pipeline.py:147-160; C++
core characterized in SURVEY.md section 2.2).  Here the on-device stages
are one fused step, so rings survive only at the host edges:

- the capture staging ring between the ingest thread and the device feeder,
- the deep trigger-history ring backing TriggeredDump,
- output queues between the device and the packetizer threads.

Semantics kept from Bifrost: a ring carries *sequences* (time_tag + JSON
header + contiguous data stream); writers reserve spans and commit them;
readers block ("guaranteed" mode backpressure, reference:
block_base.py:38-40) or skip; late readers can open the earliest sequence
still resident (reference: triggered_dump_block.py:218).  Ring capacity is
rounded to a power of two like Bifrost's allocator
(reference: copy_block.py:113-114).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field

import numpy as np


def _round_up_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


@dataclass
class _Alloc:
    """One backed reservation: ``pad`` bytes were wasted at the wrap
    edge before ``off`` (Bifrost pads ringlets the same way)."""
    off: int
    nbyte: int
    pad: int
    freed: bool = False


@dataclass
class Sequence:
    """One sequence: a header plus an ordered FIFO of data spans.

    ``spans`` is a deque consumed from the front by the (single)
    reader — consumed entries are REMOVED, not tombstoned, so a
    months-long unbroken capture sequence holds only the in-flight
    spans, never an ever-growing list."""
    time_tag: int
    header: dict
    seq_id: int
    ring: "Ring"
    closed: bool = False
    spans: deque = field(default_factory=deque)  # retained span payloads
    start_byte: int = 0
    nbyte: int = 0


class Ring:
    """A bounded FIFO of sequences of numpy spans.

    Two storage modes:

    - **heap spans** (default): spans are retained numpy blocks with a
      total-byte budget; blocking writes apply backpressure exactly like
      guaranteed-mode reads.
    - **backed** (``backing=True``): one preallocated contiguous buffer
      — Bifrost's actual ring model (copy_block.py:113-114).  Writers
      ``reserve_span``/``commit_span`` directly into it (the source
      fills the ring memory in place: zero intermediate copies), and
      readers hand spans back with ``release_span`` when the device has
      consumed them.  Consecutive reservations are byte-adjacent, so a
      whole accumulation window read back-to-back is ONE contiguous
      view (``contiguous_view``) — no per-window ``np.concatenate``.

    The deep trigger-history variant (:class:`HistoryRing`) keeps the
    byte-addressed circular semantics needed for dumps.
    """

    def __init__(self, name: str, nbyte_budget: int = 1 << 28,
                 backing: bool = False):
        self.name = name
        self.nbyte_budget = (int(nbyte_budget) if backing
                             else _round_up_pow2(nbyte_budget))
        self._backing = (np.zeros(self.nbyte_budget, np.uint8)
                         if backing else None)
        if self._backing is not None:
            # pre-fault: np.zeros maps lazily; taking the page faults at
            # ingest time stalls the first windows long enough to
            # overflow the capture socket buffer at production rate
            self._backing[::4096] = 0
        self._base_ptr = (self._backing.__array_interface__["data"][0]
                          if backing else 0)
        self._allocs: deque[_Alloc] = deque()
        self._by_off: dict[int, _Alloc] = {}
        self._head = 0   # next free byte in the backing buffer
        self._live = 0   # bytes (incl. wrap pads) reserved, not yet freed
        self._lock = threading.Condition()
        # consumed-and-closed sequences are pruned from the FRONT (a
        # 24/7 stream must not accumulate one Sequence per resync
        # forever); _seq_base counts pruned entries so the reader's
        # absolute index stays valid
        self._sequences: deque[Sequence] = deque()
        self._seq_base = 0
        self._nbyte = 0
        self._seq_counter = 0
        self._shutdown = False

    # -- writer API ----------------------------------------------------------

    def begin_sequence(self, time_tag: int, header: dict) -> Sequence:
        with self._lock:
            seq = Sequence(time_tag=time_tag, header=dict(header),
                           seq_id=self._seq_counter, ring=self)
            self._seq_counter += 1
            self._sequences.append(seq)
            self._lock.notify_all()
            return seq

    def write_span(self, seq: Sequence, data: np.ndarray,
                   blocking: bool = True, timeout: float | None = None
                   ) -> bool:
        """Append a span; blocks while over budget (backpressure)."""
        nbyte = data.nbytes
        if nbyte > self.nbyte_budget:
            # fail fast: the backpressure predicate could never become
            # true and a blocking caller would hang forever
            raise ValueError(
                f"span of {nbyte} B exceeds ring {self.name} budget "
                f"{self.nbyte_budget} B")
        with self._lock:
            if blocking:
                ok = self._lock.wait_for(
                    lambda: self._shutdown
                    or self._nbyte + nbyte <= self.nbyte_budget,
                    timeout=timeout)
                if not ok or self._shutdown:
                    return False
            elif self._nbyte + nbyte > self.nbyte_budget:
                return False
            # own the span's memory: sources like the native capture
            # engine hand out views of rotating buffers that will be
            # overwritten a few gulps later
            if data.flags.c_contiguous and data.flags.owndata:
                seq.spans.append(data)
            else:
                seq.spans.append(np.array(data))
            seq.nbyte += nbyte
            self._nbyte += nbyte
            self._lock.notify_all()
            return True

    # -- backed (contiguous) writer API --------------------------------------

    @property
    def backed(self) -> bool:
        return self._backing is not None

    @property
    def backing(self) -> np.ndarray | None:
        """The backing buffer (None for heap spans)."""
        return self._backing

    def _span_off(self, data: np.ndarray):
        """Byte offset of ``data`` inside the backing buffer, or None if
        it is a heap span (works on reshaped/retyped views)."""
        if self._backing is None:
            return None
        off = data.__array_interface__["data"][0] - self._base_ptr
        return off if 0 <= off < self.nbyte_budget else None

    def reserve_span(self, nbyte: int, timeout: float | None = None):
        """Claim ``nbyte`` contiguous bytes of the backing buffer for the
        caller to fill in place; blocks (backpressure) while the reader
        still owns too much of the ring.  Returns a uint8 view, or None
        on timeout/shutdown.  Publish with :meth:`commit_span`, or hand
        back an unused reservation with :meth:`release_span`."""
        if self._backing is None:
            raise ValueError(f"ring {self.name} has no backing buffer")
        if nbyte > self.nbyte_budget // 2:
            raise ValueError("reservation larger than half the ring")
        with self._lock:
            def fits():
                pad = (self.nbyte_budget - self._head
                       if self._head + nbyte > self.nbyte_budget else 0)
                return self._live + pad + nbyte <= self.nbyte_budget
            ok = self._lock.wait_for(
                lambda: self._shutdown or fits(), timeout=timeout)
            if not ok or self._shutdown:
                return None
            pad = (self.nbyte_budget - self._head
                   if self._head + nbyte > self.nbyte_budget else 0)
            if pad:
                self._head = 0
            a = _Alloc(self._head, nbyte, pad)
            self._allocs.append(a)
            self._by_off[a.off] = a
            self._head += nbyte
            if self._head == self.nbyte_budget:
                self._head = 0
            self._live += pad + nbyte
            return self._backing[a.off:a.off + nbyte]

    @property
    def held_nbyte(self) -> int:
        """Bytes of the backing buffer reserved and not yet released
        (wrap pads included)."""
        return self._live

    def commit_span(self, seq: Sequence, data: np.ndarray) -> None:
        """Publish a filled reservation (any view of it) as a span of
        ``seq``.  No byte-budget accounting: the backing allocator IS
        the budget for backed spans."""
        with self._lock:
            seq.spans.append(data)
            seq.nbyte += data.nbytes
            self._lock.notify_all()

    def release_span(self, data: np.ndarray) -> None:
        """Reader hands a backed span's memory back to the writer.  Out-
        of-order releases (skipped gulps, partial windows) are held until
        the FIFO head frees.  No-op for heap spans.

        Contract: release each span EXACTLY once.  The freed-check below
        only catches a double release while the allocation is still
        resident; once the FIFO head advances and the writer re-reserves
        the same byte offset, a stale second release would free the NEW
        allocation out from under its owner (spans are identified by
        byte offset — a view cannot carry an allocation generation)."""
        off = self._span_off(data)
        if off is None:
            return
        with self._lock:
            a = self._by_off.get(off)
            if a is None or a.freed:
                return
            a.freed = True
            while self._allocs and self._allocs[0].freed:
                a0 = self._allocs.popleft()
                del self._by_off[a0.off]
                self._live -= a0.pad + a0.nbyte
            self._lock.notify_all()

    def contiguous_view(self, spans) -> np.ndarray | None:
        """If ``spans`` are byte-adjacent in the backing buffer, return
        ONE flat uint8 view covering all of them (zero-copy window
        assembly); else None (wrap edge or heap spans — caller copies)."""
        if self._backing is None or not spans:
            return None
        off0 = self._span_off(spans[0])
        if off0 is None:
            return None
        p = off0
        for sp in spans:
            if self._span_off(sp) != p:
                return None
            p += sp.nbytes
        if p > self.nbyte_budget:
            return None
        return self._backing[off0:p]

    def end_sequence(self, seq: Sequence) -> None:
        with self._lock:
            seq.closed = True
            self._lock.notify_all()

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()

    # -- reader API ----------------------------------------------------------

    def read(self, timeout: float | None = None):
        """Generator over sequences as they appear (guaranteed mode)."""
        idx = 0
        while True:
            with self._lock:
                # prune fully-consumed, closed, already-yielded
                # sequences from the front
                while (self._sequences and self._seq_base < idx
                       and self._sequences[0].closed
                       and not self._sequences[0].spans):
                    self._sequences.popleft()
                    self._seq_base += 1

                def _avail():
                    return self._seq_base + len(self._sequences) > idx

                ok = self._lock.wait_for(
                    lambda: self._shutdown or _avail(), timeout=timeout)
                if not ok or (self._shutdown and not _avail()):
                    return
                seq = self._sequences[idx - self._seq_base]
            idx += 1
            yield seq

    def read_spans(self, seq: Sequence, timeout: float | None = None):
        """Generator over a sequence's spans, blocking until closed.

        Consumed spans are released from the byte budget (single-reader
        accounting; multi-reader fan-out uses one Ring per consumer, the
        fused-XLA analog of the reference's multi-reader gpu_input_ring,
        lwa352-pipeline.py:232,279).
        """
        while True:
            with self._lock:
                ok = self._lock.wait_for(
                    lambda: self._shutdown or seq.closed or seq.spans,
                    timeout=timeout)
                if not ok:
                    return
                if not seq.spans:
                    if seq.closed or self._shutdown:
                        return
                    continue
                span = seq.spans.popleft()  # consume-and-release
                if self._span_off(span) is None:
                    # heap span: budget frees at hand-off (the reader got
                    # a private array).  Backed spans free only at
                    # release_span, once the device has consumed them.
                    self._nbyte -= span.nbytes
                self._lock.notify_all()
            yield span


class HistoryRing:
    """Deep byte-addressed circular history buffer.

    Backs the triggered-dump path: the reference keeps an N-GB pinned-host
    ring of raw capture data and, on an operator trigger, walks it from the
    earliest resident position to disk
    (reference: lwa352-pipeline.py:204-213; triggered_dump_block.py:218-298).
    """

    def __init__(self, nbyte: int, frame_nbyte: int):
        if nbyte % frame_nbyte:
            nbyte -= nbyte % frame_nbyte
        self.frame_nbyte = frame_nbyte
        self.nframe = nbyte // frame_nbyte
        if self.nframe < 1:
            raise ValueError("history ring smaller than one frame")
        self.buf = np.zeros((self.nframe, frame_nbyte), dtype=np.uint8)
        self._lock = threading.Lock()
        self.head = 0            # next frame slot to write
        self.count = 0           # total frames ever written
        self.header: dict = {}   # sequence header of the current stream
        self.frame0_seq = 0      # spectra index of the first frame written

    def set_header(self, header: dict, frame0_seq: int) -> None:
        with self._lock:
            self.header = dict(header)
            self.frame0_seq = frame0_seq

    def push(self, frame: np.ndarray) -> None:
        data = frame.reshape(-1).view(np.uint8)
        if data.nbytes != self.frame_nbyte:
            raise ValueError("frame size mismatch")
        with self._lock:
            self.buf[self.head] = data
            self.head = (self.head + 1) % self.nframe
            self.count += 1

    def earliest(self) -> int:
        """Index (in frames-ever-written) of the earliest resident frame
        (the ``open_earliest_sequence`` analog)."""
        with self._lock:
            return max(0, self.count - self.nframe)

    def snapshot(self, start_frame: int, nframe: int) -> np.ndarray:
        """Copy ``nframe`` frames beginning at absolute frame index
        ``start_frame`` (must be resident)."""
        with self._lock:
            if start_frame < max(0, self.count - self.nframe) \
                    or start_frame + nframe > self.count:
                raise IndexError("requested frames not resident")
            idx = (start_frame + np.arange(nframe)) % self.nframe
            return self.buf[idx].copy()
