"""The guard of the port's gloo test worlds (`torch_port_parallel_worker.py`):
a job that raises on one rank ends the world within seconds and every
later job reports that first error; ranks whose collectives part (here a
same-sized all-reduce issued as [3, 2] on one rank and [2, 3] on the
other, which gloo pairs without an error) stop the world at that job, and
the error names the first collective where they differ. Two 2-rank worlds,
spawned together for the module."""

import hashlib
import pathlib
import sys
import time

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from torch_port_parallel_worker import job, parted, start_world  # noqa: E402


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("guard")
    t0 = time.monotonic()
    waits = {
        "failed": start_world(root / "failed", 2, [("fail_between", dict(fail_rank=1)),
                                                   ("in_step", {})]),
        "parted": start_world(root / "parted", 2, [("in_step", {}),
                                                   ("out_of_step", dict(odd_rank=1)),
                                                   ("fail_between", dict(fail_rank=-1))]),
    }
    out = {name: wait() for name, wait in waits.items()}
    out["seconds"] = time.monotonic() - t0
    return out


def test_failed_job_returns_the_failing_rank_traceback(worlds):
    res = worlds["failed"]
    assert res.first_error.startswith("job 'fail_between' failed first, on rank 1:")
    assert "Traceback" in res.first_error and "planted failure on rank 1" in res.first_error
    with pytest.raises(AssertionError, match="planted failure on rank 1"):
        job(res, "fail_between")


def test_jobs_after_a_failure_report_the_first_error(worlds):
    res = worlds["failed"]
    for r in range(2):
        assert res[r]["in_step"] == {"error": res.first_error}
    with pytest.raises(AssertionError, match="planted failure on rank 1"):
        job(res, "in_step")


def test_world_ends_within_seconds_of_the_failure(worlds):
    """Rank 0 waits inside its second all-reduce when rank 1 raises: it
    ends on rank 1's failure file, not on gloo's 300 s timeout."""
    assert worlds["failed"].seconds_after_failure < 15
    assert worlds["seconds"] < 120


def test_out_of_step_collectives_stop_the_world_at_their_job(worlds):
    res = worlds["parted"]
    assert [r["done"] for r in job(res, "in_step")] == [True, True]
    assert "job 'out_of_step' failed first" in res.first_error
    assert ("they part at collective #1: rank 0: all_reduce(tensor=float32[2, 3]);"
            in res.first_error)
    assert "rank 1: all_reduce(tensor=float32[3, 2])" in res.first_error
    for name in ("out_of_step", "fail_between"):
        with pytest.raises(AssertionError, match="the ranks' collectives parted"):
            job(res, name)
    assert res.seconds_after_failure < 15


def test_parted_names_the_first_differing_collective():
    """`parted` on made-up logs: ranks of one group must agree; ranks of
    another group may issue anything else; a missing group counts as none
    issued."""
    empty = hashlib.sha256().hexdigest()
    same = {(0, 1): (2, "a"), (0, 1, 2, 3): (1, "b")}
    assert parted([same, same, {(2, 3): (5, "c"), (0, 1, 2, 3): (1, "b")},
                   {(2, 3): (5, "c"), (0, 1, 2, 3): (1, "b")}]) is None
    logs = [{(0, 1): (2, "a")}, {(0, 1): (3, "x")}]
    seqs = [{(0, 1): ["all_reduce(f32)", "barrier()"]},
            {(0, 1): ["all_reduce(f32)", "barrier()", "broadcast(f32)"]}]
    assert parted(logs, seqs) == (
        "group [0, 1]: rank 0 issued 2 collectives (sha256 a), rank 1 issued 3 collectives "
        "(sha256 x); they part at collective #2: rank 0: (none); rank 1: broadcast(f32)")
    assert parted([{(0, 1): (1, "a")}, {}]) == (
        f"group [0, 1]: rank 0 issued 1 collectives (sha256 a), rank 1 issued 0 collectives "
        f"(sha256 {empty[:12]})")
