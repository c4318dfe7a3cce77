"""Stalled-step failure detector for wedged device clients.

The failure mode this guards against: the device client wedges with every
thread parked in futex/poll — no exception, no timeout, zero CPU.
In-process recovery is impossible: the blocked XLA call never returns and
the process holds the device while making no progress. The only working
remedy is killing the PROCESS (which frees the device) and relaunching
with ``continue_run`` (step checkpoints + deterministic-reader resume make
the relaunch exact up to the last save). Whether this failure can happen on
the GPU is open (ROADMAP D3).

``StallWatchdog`` automates the detection half in-process: a daemon thread
that calls a hard abort (``os._exit`` — a normal exception cannot unwind
threads stuck in a native futex wait) with a DISTINCT exit code when
``feed()`` has not been called within ``timeout_s``. A supervisor keyed on
that exit code supplies the relaunch half.

No reference analog (single-GPU TF2 script, SURVEY.md §5 lists no failure
detection); this is rebuild-added infrastructure for the long unattended
training runs the rebuild targets.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from .logging import log_print

# distinct from Python's 1 (exception) and shells' 124 (timeout(1)) /
# 128+N (signal) so supervisors can key retry behavior on "stall" exactly
STALL_EXIT_CODE = 17


class StallWatchdog:
    """Hard-exits the process when ``feed()`` stops being called.

    Usage::

        wd = StallWatchdog(timeout_s=900, label="train")
        wd.start()                 # arm (covers first compile via timeout)
        for step in ...:
            wd.feed()              # any forward progress
            ...
        wd.stop()                  # disarm (also via context manager)

    The poll thread is a daemon: it never blocks interpreter exit, and
    ``stop()`` is idempotent. ``on_stall`` is injectable for tests; the
    default logs loudly and ``os._exit(STALL_EXIT_CODE)``s.
    """

    def __init__(self, timeout_s: float, label: str = "train",
                 on_stall: Optional[Callable[[float], None]] = None,
                 first_timeout_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        # grace window before the FIRST feed(): the first iteration of a
        # jitted driver includes the compile, which produces no progress
        # signal. After the first feed the normal timeout applies.
        self.first_timeout_s = (float(first_timeout_s) if first_timeout_s
                                else self.timeout_s)
        self.label = label
        self._on_stall = on_stall or self._default_on_stall
        self._last = time.monotonic()
        self._fed_once = False
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _default_on_stall(self, stalled_for: float) -> None:
        log_print(
            f"WATCHDOG: no {self.label} progress for {stalled_for:.0f}s "
            f"(timeout {self.timeout_s:.0f}s) — device client presumed "
            f"wedged; hard-exiting {STALL_EXIT_CODE} for supervisor restart")
        os._exit(STALL_EXIT_CODE)

    def start(self) -> "StallWatchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name=f"stall-watchdog-{self.label}",
            daemon=True)
        self._thread.start()
        return self

    def feed(self) -> None:
        self._last = time.monotonic()
        self._fed_once = True

    def stop(self) -> None:
        self._stop_evt.set()

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        # poll fast enough to fire within ~1.25x the timeout, slow enough
        # to cost nothing (the wedge takes minutes to matter)
        poll = min(self.timeout_s / 4.0, 10.0)
        while not self._stop_evt.wait(poll):
            stalled_for = time.monotonic() - self._last
            limit = self.timeout_s if self._fed_once else self.first_timeout_s
            if stalled_for > limit:
                self._on_stall(stalled_for)
                return


def rss_gb() -> float:
    """Current process VmRSS in GB (0.0 where /proc is unavailable).

    Feeds the trainer's host-RSS relaunch guard (CTCParams.rss_relaunch_gb):
    a host-memory leak in a long run is survived by saving and relaunching
    before the OOM killer chooses for the process."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1e6  # kB → GB
    except (OSError, ValueError, IndexError):
        pass
    return 0.0
