"""A run leaves no process behind: the judging's decoders are waited for,
and run.main stops and waits for any child that is still there."""

import subprocess
import sys

from benchmark.run import children, stop_children
from benchmark.tests.tiny import tiny_run


def test_a_run_leaves_no_child_process():
    _, out = tiny_run("ai", seconds=0.5)
    assert out["correct"]
    assert children() == []


def test_stop_children_ends_a_child_that_was_left():
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(600)"])
    assert p.pid in children()
    stop_children(grace=2.0)
    assert p.pid not in children()
    assert p.poll() is not None
