"""The hang guardian's two-process drills on the port
(tests/test_guardian.py's acceptance runs, tests/_torch_guardian_worker.py
over gloo, launched by the port's CollectiveController): a stalled
collective ends the job with a stall dump that blames the rank that never
arrived, and a crashed rank's peer aborts with the original error, the
controller relaunches and the resumed run's losses equal an
uninterrupted run's bit for bit, with the guardian armed and off."""
import json
import os
import sys

from paddle_tpu_torch.distributed.launch.context import Context, parse_args
from paddle_tpu_torch.distributed.launch.controller import \
    CollectiveController

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_guardian_worker.py")


def _run_controller(tmp_path, sub, max_restart, env_extra, monkeypatch,
                    *worker_args):
    out = tmp_path / sub
    out.mkdir()
    logs = tmp_path / f"{sub}_logs"
    # the workers inherit os.environ: their dumps stay in tmp
    monkeypatch.setenv("FLAGS_flight_recorder_path",
                       str(out / "flightrec.json"))
    monkeypatch.setenv("FLAGS_stall_dump_path", str(out / "stall.json"))
    for key, val in env_extra.items():
        monkeypatch.setenv(key, val)
    args = parse_args(["--nproc_per_node", "2",
                       "--max_restart", str(max_restart),
                       "--log_dir", str(logs),
                       WORKER, str(out), *worker_args])
    code = CollectiveController(Context(args=args)).run()
    return code, out, logs


def _check_stall_dump():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from check_telemetry import check_stall_dump
    finally:
        sys.path.pop(0)
    return check_stall_dump


def test_collective_delay_stall_dump(tmp_path, monkeypatch):
    """A stalled collective ends the job with the blamed op and rank in
    under 2x the timeout, with a schema-valid stall dump holding every
    thread's stack."""
    stall = tmp_path / "stall.json"
    code, out, logs = _run_controller(
        tmp_path, "delay", 0, {
            "FLAGS_collective_timeout_s": "3",
            "FLAGS_stall_dump_path": str(stall),
            "FLAGS_fault_inject":
                "collective_delay:op=all_reduce,at_seq=6,"
                "delay_s=120,rank=1",
            "PADDLE_GUARDIAN_TERM_GRACE_S": "5",
        }, monkeypatch)
    assert code != 0
    dump = tmp_path / "stall.rank0.json"
    assert dump.exists()
    assert _check_stall_dump()(str(dump)) == []
    data = json.load(open(dump))
    assert data["stall"]["op"] == "all_reduce"
    assert data["stall"]["seq"] == 6
    assert data["stall"]["missing_ranks"] == [1]
    assert data["stall"]["waited_s"] < 2 * data["stall"]["timeout_s"]
    text = "".join(open(logs / f"worker.{r}.log").read() for r in (0, 1))
    assert "CollectiveTimeoutError" in text
    assert "all_reduce" in text


def test_rank_crash_relaunch_resume_matches_uninterrupted(
        tmp_path, monkeypatch):
    """Rank 1 crashes mid-step; rank 0 aborts its blocked collective with
    rank 1's original error and exits for the relaunch; the controller
    restarts the job, it resumes from the checkpoint, and the losses equal
    an uninterrupted run's bit for bit, which equal a run with the
    guardian off."""
    code, clean_out, _ = _run_controller(
        tmp_path, "clean", 0, {"FLAGS_fault_inject": ""}, monkeypatch)
    assert code == 0
    code, off_out, _ = _run_controller(
        tmp_path, "off", 0, {"FLAGS_fault_inject": ""}, monkeypatch, "off")
    assert code == 0
    code, out, logs = _run_controller(
        tmp_path, "crash", 2, {
            "FLAGS_collective_timeout_s": "3",
            "FLAGS_fault_inject":
                f"rank_crash:at_seq=18,rank=1,"
                f"once_file={tmp_path}/crashed_once",
            "PADDLE_GUARDIAN_TERM_GRACE_S": "5",
            "PADDLE_GUARDIAN_PEER_GRACE_S": "20",
        }, monkeypatch)
    assert code == 0
    assert (tmp_path / "crashed_once").exists()
    for rank in (0, 1):
        clean = json.load(open(clean_out / f"losses.{rank}.json"))
        assert json.load(open(off_out / f"losses.{rank}.json")) == clean
        crashed = json.load(open(out / f"losses.{rank}.json"))
        assert crashed == clean
        assert len(crashed) == 6
    # two incarnations: from step 0, then resumed at step 3
    starts = [int(x) for x in
              open(out / "incarnations.0.log").read().split()]
    assert starts == [0, 3]
    # the healthy rank saw the ORIGINAL error, not a generic timeout
    log0 = open(logs / "worker.0.log").read()
    assert "PeerFailureError" in log0
    assert "InjectedFault" in log0
