import numpy as np

from multithreading_string_matching.utils.report import format_report, BANNER, OOPS
from multithreading_string_matching.utils.timing import PhaseTimer


def test_compat_format():
    out = format_report([b"http", b"xml", b"zzz"], np.array([5, 2, 0]), 1.25)
    lines = out.split("\n")
    assert lines[0] == BANNER
    assert lines[1] == "http: 5 times!"
    assert lines[2] == "xml: 2 times!"          # zero-count patterns omitted
    assert lines[3] == "Elapsed time = 1.250000 seconds"


def test_duplicates_each_get_a_line():
    out = format_report([b"ack", b"ack"], np.array([3, 3]))
    assert out.count("ack: 3 times!") == 2


def test_live_extras():
    out = format_report([b"a"], np.array([0]), sniffed=17, oops_line=True)
    # Byte-exact reproduction of live_openmp_task.c:229+233: two blank
    # lines, "%d packet sniffed" (sic — no plural s), one blank line, then
    # the banner.
    assert out.startswith("\n\n17 packet sniffed\n\n" + BANNER)
    assert out.split("\n")[-1] == OOPS


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("scan"):
        pass
    with t.phase("scan"):
        pass
    assert "scan=" in t.summary()
    assert t.phases["scan"] >= 0
