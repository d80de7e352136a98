"""Settings for every pytest run in the repository, loaded before ``tests/conftest.py``.

One OpenMP thread for torch in every test process and its children. The
suite runs six workers on the host's cores; an op whose team of threads
waits at a barrier for threads that other processes hold stalls for whole
time slices (on 8 cores, ``tests/test_torch_apps.py`` took 28 s alone and
1061 s in a full run of six workers).

A wall-clock limit on each of a test's setup, call and teardown: a
backstop against hangs, not a budget. A phase that runs past it fails by
name, so its worker moves on and the run reaches its end.
"""

import os
import signal
import threading

import pytest

os.environ["OMP_NUM_THREADS"] = "1"

#: Seconds each of a test's setup, call and teardown may run.
TEST_LIMIT_S = 600


def limit_phase(phase, limit_s=TEST_LIMIT_S):
    """A hookwrapper for ``pytest_runtest_<phase>`` that fails the phase if
    it runs past ``limit_s`` seconds of wall clock.

    SIGALRM interrupts a blocking wait (a selector, a lock, a child's
    wait), and ``subprocess.run`` kills its child as the failure passes
    through it. Only the main thread gets signals, so elsewhere, and where
    SIGALRM does not exist, the hook arms nothing.
    """

    @pytest.hookimpl(hookwrapper=True)
    def hook(item):
        if (not hasattr(signal, "SIGALRM")
                or threading.current_thread() is not threading.main_thread()):
            yield
            return

        def on_alarm(signum, frame):
            pytest.fail(f"{item.nodeid}: {phase} ran past {limit_s} s",
                        pytrace=False)

        old = signal.signal(signal.SIGALRM, on_alarm)
        signal.setitimer(signal.ITIMER_REAL, limit_s)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)

    return hook


pytest_runtest_setup = limit_phase("setup")
pytest_runtest_call = limit_phase("call")
pytest_runtest_teardown = limit_phase("teardown")
