"""Share of the measured window the driver's compute thread spent at its
own work: the process laps of the program's ``perf_compute`` counter
(read at the window's start and end; a lap runs from the batch's
``mark_reserve`` to ``mark_process``: the upload's copy into pinned
memory, the wait for the other pinned buffer's H2D, the step's launches
and the products' hand-off), less the time the hand-off blocked in
``out_queue.put`` waiting for the output thread (the harness's
``compute.put`` spans that ended in the window, the laps they close)."""

UNIT = "%"
LAYER = "driver compute thread"
MOVES = "realtime_factor"
SOURCE = "program_counter"


def read(r):
    if r.compute_process_s is None or r.seconds <= 0:
        return None
    put_s = sum(b - a for label, a, b, _ in r.spans
                if label == "compute.put" and r.t0_ns <= b < r.t1_ns) / 1e9
    return 100.0 * (r.compute_process_s - put_s) / r.seconds
