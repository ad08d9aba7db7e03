"""Integration arming / boundary state machine (the port's own copy of
``caltech_bifrost_dsp_tpu/runtime/arming.py``, same behaviour).

Host-side replica of the reference correlator's runtime-control semantics
(reference: blocks/corr_block.py:392-428 and blocks/corr_acc_block.py:240-292):

- ``start_time`` commands arm an integration start at an absolute spectra
  index; the special value ``-1`` means "start at the next boundary".
- ``acc_len = 0`` is the stop condition.
- While armed-but-not-started the block spins ("waiting").
- After an upstream sequence break (packet loss / timestamp jump), a
  previously-running integrator re-arms itself at
  ``last_start + (missed_accs + margin) * acc_len`` — the system's core
  recovery invariant (SURVEY.md section 5) — with margin 10 for the fast
  correlator (corr_block.py:366) and 2 for the long accumulator
  (corr_acc_block.py:228).

The state machine is deliberately pure-Python and gulp-quantized: it makes
no device calls, so the fused XLA step stays control-flow free.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class Action(Enum):
    SKIP = "skip"          # not started yet (waiting) or stopped
    START = "start"        # first gulp of a new accumulation *sequence*
    ACCUMULATE = "acc"     # mid-accumulation gulp
    DUMP = "dump"          # final gulp of an accumulation (emit product)


@dataclass
class GulpDecision:
    action: Action
    is_first: bool = False   # first gulp of the current accumulation
    new_sequence: bool = False
    state: str = "waiting"
    seq0: int = 0            # start spectra index of the open accumulation run
    acc_len: int = 0


class IntegrationController:
    """Arming + boundary bookkeeping for one integrator.

    Args:
      granularity: time quantum per input gulp (ntime_gulp for the fast
        correlator, upstream acc_len for the slow accumulator).
      acc_len: initial accumulation length (multiple of granularity).
      start_time: initial armed start (``0`` + autostart semantics of the
        reference's ``autostartat``; ``-1`` starts on the next boundary;
        ``None`` leaves the integrator unarmed).
      recover_margin: accumulations of slack applied on sequence-break
        recovery (10 = Corr, 2 = CorrAcc).
      next_boundary_start: if True, ``start_time == -1`` resolves to the
        next multiple of acc_len (Corr semantics, corr_block.py:397-398);
        if False it resolves to the current gulp (CorrAcc semantics,
        corr_acc_block.py:243-246).
    """

    def __init__(self, granularity: int, acc_len: int,
                 start_time: int | None = 0, recover_margin: int = 10,
                 next_boundary_start: bool = True):
        if acc_len % granularity:
            raise ValueError("acc_len must be a multiple of granularity")
        self.granularity = granularity
        self.recover_margin = recover_margin
        self.next_boundary_start = next_boundary_start
        self._pending = (start_time, acc_len)
        self.update_pending = start_time is not None
        self.acc_len = acc_len
        self.start_time = start_time if start_time is not None else 0
        self.started = False
        self.first = 0
        self.last = 0
        self.state = "starting"

    # -- control-plane side ---------------------------------------------------

    def command(self, start_time: int | None = None,
                acc_len: int | None = None) -> None:
        """Stage a new (start_time, acc_len); applied at the next gulp
        boundary (the pending->active protocol, block_base.py:296-365)."""
        st = self._pending[0] if start_time is None else start_time
        al = self._pending[1] if acc_len is None else acc_len
        if al is not None and al % self.granularity:
            raise ValueError("acc_len must be a multiple of granularity")
        if st is not None and st != -1 and st % self.granularity:
            raise ValueError("start_time must be -1 or a multiple of "
                             "granularity")
        self._pending = (st, al)
        self.update_pending = True

    # -- data-plane side ------------------------------------------------------

    def on_sequence_start(self, seq0: int) -> None:
        """Upstream sequence break: realign if we were running
        (corr_block.py:360-372 / corr_acc_block.py:220-236)."""
        if self.started and self.acc_len > 0:
            last_start_time = self.start_time
            missed_accs = (seq0 - last_start_time) // self.acc_len
            self.start_time = (last_start_time
                               + (missed_accs + self.recover_margin)
                               * self.acc_len)
            self.started = False
            self.state = "recovering"

    def on_gulp(self, t: int) -> GulpDecision:
        """Decide what to do with the gulp whose first spectra index is t."""
        if self.update_pending:
            st, al = self._pending
            self.acc_len = al
            if st == -1:
                if self.next_boundary_start and al:
                    self.start_time = t - (t % al) + al
                else:
                    self.start_time = t
            elif st is not None:
                self.start_time = st
            self.started = False
            self.update_pending = False

        new_sequence = False
        if self.acc_len and t == self.start_time:
            self.started = True
            self.first = self.start_time
            self.last = self.first + self.acc_len - self.granularity
            new_sequence = True

        if not self.started:
            self.state = ("waiting_start_missed"
                          if self.acc_len and t > self.start_time
                          else "waiting")
            return GulpDecision(Action.SKIP, state=self.state)

        if self.acc_len == 0:
            self.started = False
            self.state = "stopped"
            return GulpDecision(Action.SKIP, state=self.state)

        self.state = "running"
        is_first = t == self.first
        if t == self.last:
            dec = GulpDecision(Action.DUMP, is_first=is_first,
                               new_sequence=new_sequence, state=self.state,
                               seq0=self.first, acc_len=self.acc_len)
            self.first = self.last + self.granularity
            self.last = self.first + self.acc_len - self.granularity
            return dec
        action = Action.START if new_sequence else Action.ACCUMULATE
        return GulpDecision(action, is_first=is_first,
                            new_sequence=new_sequence, state=self.state,
                            seq0=self.first, acc_len=self.acc_len)
