"""A time limit on each phase of every test under ``tests/``.

Set-up (module and session fixtures that the test is the first to need
included), the call and tear-down each get ``TEST_TIME_LIMIT_S``. Past it,
every thread's stack goes to stderr and the phase fails, so a hung test
costs the limit and names itself instead of cutting the whole run. A test
stuck in C code, where no signal handler runs, has its process dump every
stack and exit ``HARD_STOP_GRACE_S`` later; xdist then reports the test as
crashed.

The repository's root ``conftest.py`` loads this plugin.
"""
import contextlib
import faulthandler
import os
import signal

import pytest

# Twice the slowest test under the suite's 6 xdist workers (150 s, an x64
# step compile of test_sharded_queue.py).
TEST_TIME_LIMIT_S = 300
HARD_STOP_GRACE_S = 60
# Only tests under this directory are limited.
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the body if it runs past ``seconds``, after dumping every
    thread's stack to stderr."""
    def expire(signum, frame):
        faulthandler.dump_traceback(file=2, all_threads=True)
        pytest.fail(f"ran past its time limit of {seconds} s "
                    "(stacks dumped to stderr)", pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    faulthandler.dump_traceback_later(seconds + HARD_STOP_GRACE_S,
                                      exit=True, file=2)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def _limit(item):
    if os.path.commonpath([str(item.path), TESTS_DIR]) != TESTS_DIR:
        return contextlib.nullcontext()
    return time_limit(TEST_TIME_LIMIT_S)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _limit(item):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _limit(item):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _limit(item):
        yield
