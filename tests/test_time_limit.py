"""The per-test time limit of tests/time_limit.py. It holds this suite's
own tests; and on a small suite run in a pytest subprocess with a 1 s
limit, each phase that runs past it fails with every thread's stack on
stderr, and a test that no signal reaches ends its process."""
import os
import re
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from tests import time_limit
from tests.conftest import REPO_ROOT

CONFTEST = f"""
import os
import sys

sys.path.insert(0, {REPO_ROOT!r})
pytest_plugins = ("tests.time_limit",)


def pytest_configure(config):
    from tests import time_limit
    time_limit.TEST_TIME_LIMIT_S = 1
    time_limit.HARD_STOP_GRACE_S = 2
    time_limit.TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
"""

SUITE = """
import signal
import time

import pytest


@pytest.fixture(scope="module")
def slow_module_fixture():
    time.sleep(30)
    yield


@pytest.fixture
def slow_teardown():
    yield
    time.sleep(30)


def test_inside_its_limit():
    time.sleep(0.05)


def test_body_past_its_limit():
    time.sleep(30)


def test_module_fixture_past_its_limit(slow_module_fixture):
    pass


def test_teardown_past_its_limit(slow_teardown):
    pass


def test_after_the_others():
    time.sleep(0.5)
"""

STUCK = """
import signal
import time


def test_no_signal_reaches():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(30)
"""


def test_this_test_runs_under_the_limit():
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= time_limit.TEST_TIME_LIMIT_S


def _run(tmp_path, suite):
    (tmp_path / "conftest.py").write_text(CONFTEST)
    (tmp_path / "test_suite.py").write_text(textwrap.dedent(suite))
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-s", "-rA", "-p", "no:cacheprovider",
         "-p", "no:randomly", str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "COLUMNS": "200", "PYTHONDONTWRITEBYTECODE": "1"})
    return proc, time.monotonic() - start


@pytest.fixture(scope="module")
def limited_run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("limited"), SUITE)


def test_a_body_past_its_limit_fails_and_dumps_its_stack(limited_run):
    proc, seconds = limited_run
    assert re.search(r"^FAILED .*::test_body_past_its_limit - Failed: ran past "
                     r"its time limit of 1 s", proc.stdout, re.M), proc.stdout
    assert re.search(r"line \d+ in test_body_past_its_limit", proc.stderr)
    assert seconds < 60


def test_a_module_fixture_past_its_limit_fails_its_test(limited_run):
    proc, _ = limited_run
    assert re.search(r"^ERROR .*::test_module_fixture_past_its_limit - Failed: "
                     r"ran past its time limit of 1 s", proc.stdout, re.M), \
        proc.stdout
    assert re.search(r"line \d+ in slow_module_fixture", proc.stderr)


def test_a_teardown_past_its_limit_fails_its_test(limited_run):
    proc, _ = limited_run
    assert re.search(r"^ERROR .*::test_teardown_past_its_limit - Failed: "
                     r"ran past its time limit of 1 s", proc.stdout, re.M), \
        proc.stdout
    assert re.search(r"line \d+ in slow_teardown", proc.stderr)


def test_tests_inside_their_limit_pass(limited_run):
    proc, _ = limited_run
    for name in ("test_inside_its_limit", "test_after_the_others"):
        assert re.search(rf"^PASSED .*::{name}$", proc.stdout, re.M), \
            proc.stdout
    assert "1 failed, 3 passed, 2 errors" in proc.stdout, proc.stdout


def test_a_test_no_signal_reaches_ends_its_process(tmp_path):
    proc, seconds = _run(tmp_path, STUCK)
    assert proc.returncode != 0
    assert seconds < 20
    assert "Timeout (0:00:03)!" in proc.stderr, proc.stderr
    assert re.search(r"line \d+ in test_no_signal_reaches", proc.stderr)
