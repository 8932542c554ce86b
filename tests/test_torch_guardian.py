"""The port's hang and failure guardian (paddle_tpu_torch/distributed/
watchdog.py, host_collectives.py, the choke point of collective.py and the
collective fault points of utils/fault_injection.py) against the JAX
package's on the CPU: tests/test_guardian.py's unit cases under their
names, the records of the error trap crossing between the two packages
through one `FileKVStore` directory in both directions, every ported fault
spec parsed to JAX's dict, and the collectives with the guardian off,
armed and on the host lane on 4 gloo ranks.  The two-process drills are in
tests/test_torch_guardian_drills.py."""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import watchdog as jwd
from paddle_tpu.distributed.collective import _np_reduce as jax_np_reduce
from paddle_tpu.distributed.store import FileKVStore as JaxFileKVStore
from paddle_tpu.utils import fault_injection as jfi

from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import watchdog as wd
from paddle_tpu_torch.distributed.store import FileKVStore
from paddle_tpu_torch.utils import fault_injection as fi
from paddle_tpu_torch.utils.flags import get_flags, set_flags

from _torch_dist_worker import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARDIAN_FLAGS = (
    "FLAGS_collective_timeout_s", "FLAGS_collective_hard_abort",
    "FLAGS_stall_dump_path", "FLAGS_desync_check_every",
    "FLAGS_fault_inject", "FLAGS_flight_recorder_path")


@pytest.fixture
def guardian(tmp_path):
    """A clean watchdog, the flags restored after, dumps in tmp."""
    saved = get_flags(list(_GUARDIAN_FLAGS))
    set_flags({"FLAGS_flight_recorder_path": str(tmp_path / "fr.json"),
               "FLAGS_stall_dump_path": str(tmp_path / "stall.json")})
    wd.reset()
    yield wd
    wd.reset()
    set_flags(saved)


class _FakeGroup:
    def __init__(self, gid=0, ranks=(0, 1)):
        self.id = gid
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)


def _check_stall_dump():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from check_telemetry import check_stall_dump
    finally:
        sys.path.pop(0)
    return check_stall_dump


# ---------------------------------------------------------------------------
# fault-injection grammar
# ---------------------------------------------------------------------------


def test_collective_fault_points_parse_and_validate():
    spec = fi.parse("collective_delay:op=all_reduce,at_seq=6,"
                    "delay_s=1.5,rank=1;rank_crash:at_seq=3,rank=0,"
                    "once_file=/tmp/x")
    assert spec["collective_delay"]["delay_s"] == 1.5
    assert spec["collective_delay"]["op"] == "all_reduce"
    assert spec["rank_crash"]["once_file"] == "/tmp/x"
    for bad in ("collective_delay:nope=1", "rank_crash:at_seq=xyz"):
        with pytest.raises(fi.FaultSpecError):
            fi.parse(bad)


@pytest.mark.parametrize("spec", [
    "collective_delay:op=all_reduce,at_seq=6,delay_s=1.5,rank=1,"
    "once_file=/tmp/o",
    "rank_crash:op=barrier,at_seq=3,rank=0,exit=9,mode=raise,"
    "once_file=/tmp/x",
    "step:crash_at=3,exit=7,rank=1,once_file=/tmp/s",
    "step:sigterm_at=5,rank=0",
    "ckpt_write:after_bytes=128,mode=raise,file=state,exit=3",
    "bad_batch:at_step=2,rank=1,mode=nan,scale=2.0,count=1;"
    "loss_spike:at_step=1,scale=1e6,count=2;"
    "grad_bitflip:rank=1,value=1e30,param=2,count=6",
    "rpc_drop:to=w1,count=2,once_file=/tmp/r;rpc_delay:to=w,delay_s=0.5;"
    "rpc_slow:delay_s=0.1,count=1;engine_slow:to=r0,delay_s=0.2",
    "data_slow:delay_s=0.5,every=2,count=3;data_corrupt:at_sample=4,"
    "every=3,count=1",
])
def test_ported_fault_specs_parse_to_jax_dict(spec):
    got = fi.parse(spec)
    want = jfi.parse(spec)
    assert got == want
    for point, params in got.items():
        for key, val in params.items():
            assert type(val) is type(want[point][key])


@pytest.mark.parametrize("point", ["peer_snap_drop", "buddy_crash"])
def test_hot_spare_fault_points_stay_refused(point):
    jfi.parse(f"{point}:at_step=1")          # JAX has them
    with pytest.raises(fi.FaultSpecError, match="ROADMAP A8"):
        fi.parse(f"{point}:at_step=1")


def test_step_point_crash_rank_and_once_file(tmp_path):
    """JAX's ``check_step`` semantics in a child: ``rank`` filters,
    ``once_file`` fires once, ``crash_at`` exits with ``exit``."""
    once = tmp_path / "once"
    code = (
        "import os, sys\n"
        "from paddle_tpu_torch.utils import fault_injection as fi\n"
        "from paddle_tpu_torch.utils.flags import set_flags\n"
        f"set_flags({{'FLAGS_fault_inject': 'step:crash_at=2,exit=9,"
        f"rank=1,once_file={once}'}})\n"
        "for s in range(4):\n"
        "    fi.check_step(s)\n"
        "    print('step', s, flush=True)\n")

    def start(rank):
        env = dict(os.environ, PYTHONPATH=REPO, PADDLE_TRAINER_ID=rank)
        return subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def result(p):
        out, err = p.communicate(timeout=60)
        return p.returncode, out.split(), err

    other, first = start("0"), start("1")
    code0, out0, err0 = result(other)
    assert code0 == 0 and out0.count("step") == 4, err0
    code1, out1, err1 = result(first)
    assert code1 == 9 and out1 == ["step", "0", "step", "1"], err1
    assert once.exists()
    code2, out2, err2 = result(start("1"))
    assert code2 == 0 and out2.count("step") == 4, err2


# ---------------------------------------------------------------------------
# FileKVStore + ErrorTrap, and the records across the packages
# ---------------------------------------------------------------------------


def test_file_kv_store_roundtrip(tmp_path):
    st = FileKVStore(str(tmp_path))
    st.set("job/error/0", b"payload")
    assert st.get("job/error/0") == b"payload"
    assert st.get("missing", b"d") == b"d"
    assert st.add("cnt", 2) == 2 and st.add("cnt", 3) == 5
    assert st.list_prefix("job/error/") == {"job/error/0": b"payload"}
    st.delete_key("job/error/0")
    assert st.list_prefix("job/error/") == {}


def test_error_trap_report_peers_clear(tmp_path):
    st = FileKVStore(str(tmp_path))
    t0 = wd.ErrorTrap(st, job="j", rank=0)
    t1 = wd.ErrorTrap(st, job="j", rank=1)
    try:
        raise ValueError("boom at step 3")
    except ValueError as e:
        t1.report(e, op="all_reduce", seq=7)
    assert t1.peers() == []          # its own record is not a peer's
    (rec,) = t0.peers()
    assert rec["rank"] == 1 and rec["type"] == "ValueError"
    assert rec["op"] == "all_reduce" and rec["seq"] == 7
    assert "boom at step 3" in rec["traceback"]
    t0.record_arrival(0, 5, "all_reduce")
    assert t1.arrivals(0) == {0: (5, "all_reduce")}
    t0.clear()
    assert t0.peers() == [] and t1.arrivals(0) == {}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_error_trap_records_cross_the_packages(tmp_path, writer):
    """An error record and an arrival one written by either package are
    read by the other through one directory, field for field; either
    package's ``clear`` drops the other's records."""
    jax_side = (JaxFileKVStore, jwd.ErrorTrap)
    port_side = (FileKVStore, wd.ErrorTrap)
    w_store, w_trap = jax_side if writer == "jax" else port_side
    r_store, r_trap = port_side if writer == "jax" else jax_side
    wt = w_trap(w_store(str(tmp_path)), job="j", rank=1)
    rt = r_trap(r_store(str(tmp_path)), job="j", rank=0)
    try:
        raise RuntimeError("rank 1 exploded")
    except RuntimeError as e:
        wt.report(e, op="all_gather", seq=4)
    wt.record_arrival(3, 9, "broadcast")
    (rec,) = rt.peers()
    assert {k: rec[k] for k in ("rank", "type", "message", "op", "seq")} \
        == {"rank": 1, "type": "RuntimeError", "message": "rank 1 exploded",
            "op": "all_gather", "seq": 4}
    assert "rank 1 exploded" in rec["traceback"]
    assert rt.arrivals(3) == {1: (9, "broadcast")}
    # the port's watchdog turns the other package's record into its error
    mine = wd.CollectiveWatchdog(wd.ErrorTrap(FileKVStore(str(tmp_path)),
                                              job="j", rank=0))
    theirs = jwd.CollectiveWatchdog(jwd.ErrorTrap(
        JaxFileKVStore(str(tmp_path)), job="j", rank=0))
    a = mine._peer_error(mine.trap.peers())
    b = theirs._peer_error(theirs.trap.peers())
    assert str(a) == str(b) and (a.rank, a.original_type) == \
        (b.rank, b.original_type)
    rt.clear()
    assert wt.peers() == [] and w_trap(w_store(str(tmp_path)), job="j",
                                       rank=0).arrivals(3) == {}


def test_stall_dump_path_matches_jax(guardian, tmp_path):
    jflags = __import__("paddle_tpu.utils.flags", fromlist=["x"])
    saved = jflags.get_flags(["FLAGS_stall_dump_path"])
    try:
        for p in (str(tmp_path / "stall.json"), str(tmp_path / "s")):
            set_flags({"FLAGS_stall_dump_path": p})
            jflags.set_flags({"FLAGS_stall_dump_path": p})
            for rank in (0, 3):
                assert wd.stall_dump_path(rank) == jwd.stall_dump_path(rank)
    finally:
        jflags.set_flags(saved)


# ---------------------------------------------------------------------------
# the collective watchdog
# ---------------------------------------------------------------------------


def test_watchdog_zero_overhead_when_off(guardian):
    set_flags({"FLAGS_collective_timeout_s": 0.0,
               "FLAGS_fault_inject": ""})
    assert wd.begin("all_reduce", _FakeGroup()) is None
    wd.end(None)                     # the no-ops take the None token
    wd.preflight(None)
    assert wd.translate(None, KeyError("x")).args == ("x",)
    assert wd._WATCHDOG is None      # nothing was built


def test_watchdog_times_out_blocked_collective(guardian, tmp_path):
    set_flags({"FLAGS_collective_timeout_s": 0.3,
               "FLAGS_collective_hard_abort": False})
    wd.configure(store=FileKVStore(str(tmp_path / "kv")), job="j", rank=0)
    caught = {}

    def blocked():
        tok = wd.begin("all_reduce", _FakeGroup(gid=3))
        try:
            wd.preflight(tok)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                time.sleep(0.01)
        except BaseException as e:
            caught["exc"] = wd.translate(tok, e)
        finally:
            wd.end(tok)

    t = threading.Thread(target=blocked)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "the watchdog never aborted the stalled thread"
    exc = caught["exc"]
    assert isinstance(exc, wd.CollectiveTimeoutError)
    assert exc.op == "all_reduce" and exc.seq == 0
    assert exc.missing_ranks == [1]      # rank 1 never wrote an arrival
    assert exc.waited_s >= 0.3
    dump_path = wd.stall_dump_path()
    assert dump_path.endswith(".rank0.json")
    assert _check_stall_dump()(dump_path) == []
    data = json.load(open(dump_path))
    assert data["stall"]["missing_ranks"] == [1]
    assert any("blocked" in "".join(th["stack"])
               for th in data["stall"]["threads"])


def test_watchdog_peer_error_aborts_before_timeout(guardian, tmp_path):
    set_flags({"FLAGS_collective_timeout_s": 30.0,
               "FLAGS_collective_hard_abort": False})
    store = FileKVStore(str(tmp_path))
    wd.configure(store=store, job="j", rank=0)
    wd.ErrorTrap(store, job="j", rank=1).report(
        RuntimeError("rank 1 exploded"), op="all_gather", seq=4)
    tok = wd.begin("all_reduce", _FakeGroup())
    with pytest.raises(wd.PeerFailureError) as ei:
        wd.preflight(tok)            # fail fast, no timeout wait
    wd.end(tok)
    assert ei.value.rank == 1
    assert ei.value.original_type == "RuntimeError"
    assert "rank 1 exploded" in str(ei.value)


def test_desync_detector_blames_mismatched_op(guardian, tmp_path):
    set_flags({"FLAGS_collective_timeout_s": 0.0,
               "FLAGS_desync_check_every": 1})
    store = FileKVStore(str(tmp_path))
    wd.configure(store=store, job="j", rank=0)
    # rank 1 recorded a DIFFERENT op at the same (group, seq)
    wd.ErrorTrap(store, job="j", rank=1).record_arrival(5, 0, "all_gather")
    tok = wd.begin("all_reduce", _FakeGroup(gid=5))
    with pytest.raises(wd.DesyncError, match="all_gather") as ei:
        wd.preflight(tok)
    wd.end(tok)
    assert "'all_reduce'" in str(ei.value)


def test_watchdog_hard_aborts_c_blocked_thread(tmp_path):
    """A thread inside one C call cannot take the asynchronous exception:
    the watchdog hard-exits with its abort code, the dump written."""
    code = (
        "import threading, time\n"
        "from paddle_tpu_torch.distributed import watchdog as wd\n"
        "class G:\n"
        "    id = 0\n"
        "    ranks = [0, 1]\n"
        "def blocked():\n"
        "    tok = wd.begin('all_reduce', G)\n"
        "    try:\n"
        "        wd.preflight(tok)\n"
        "        time.sleep(120)   # ONE C call: the raise cannot land\n"
        "    finally:\n"
        "        wd.end(tok)\n"
        "t = threading.Thread(target=blocked)\n"
        "t.start()\n"
        "t.join()\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               FLAGS_collective_timeout_s="0.5",
               FLAGS_stall_dump_path=str(tmp_path / "stall.json"),
               FLAGS_flight_recorder_path=str(tmp_path / "fr.json"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == wd.GUARDIAN_ABORT_EXIT_CODE, r.stderr[-2000:]
    assert "hard-aborting" in r.stderr
    assert os.path.exists(str(tmp_path / "stall.rank0.json"))


class _Event:
    """A CUDA event's ``query`` surface, completed by the test."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_returned_entry_stays_in_flight_until_its_event(guardian,
                                                        tmp_path):
    """A call that returned at its enqueue stays in flight until its
    event completes; stalled, it goes to the hard abort with no
    asynchronous exception (the caller left the op)."""
    set_flags({"FLAGS_collective_timeout_s": 0.4,
               "FLAGS_collective_hard_abort": False})
    w = wd.configure(store=FileKVStore(str(tmp_path)), job="j", rank=0)
    ev = _Event()
    tok = wd.begin("all_reduce", _FakeGroup())
    wd.preflight(tok)
    wd.end(tok, ev)
    assert w.in_flight() == [("all_reduce", 0)]
    ev.done = True
    deadline = time.monotonic() + 5
    while w.in_flight() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert w.in_flight() == [] and w.recent()[-1]["seq"] == 0
    stuck = _Event()
    tok = wd.begin("all_reduce", _FakeGroup())
    wd.preflight(tok)
    wd.end(tok, stuck)
    entry = tok[2]
    deadline = time.monotonic() + 5
    while entry.exc is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert isinstance(entry.exc, wd.CollectiveTimeoutError)
    assert entry.exc.seq == 1 and entry.kill_at is not None
    assert entry.exit_code == wd.GUARDIAN_ABORT_EXIT_CODE
    assert _check_stall_dump()(wd.stall_dump_path()) == []


def test_backend_error_after_a_peer_failure_is_translated(guardian,
                                                          tmp_path):
    """A backend error out of the op (gloo's socket saw the dead peer's
    connection close) becomes the peer's `PeerFailureError` when the trap
    holds its record, with a stall dump; without a record it stays."""
    store = FileKVStore(str(tmp_path))
    wd.configure(store=store, job="j", rank=0)
    tok = wd.begin("all_reduce", _FakeGroup())
    wd.preflight(tok)
    plain = RuntimeError("Connection reset by peer")
    assert wd.translate(tok, plain) is plain
    wd.ErrorTrap(store, job="j", rank=1).report(
        fi.InjectedFault("rank_crash: injected"), op="all_reduce", seq=0)
    rich = wd.translate(tok, plain)
    wd.end(tok)
    assert isinstance(rich, wd.PeerFailureError) and rich.rank == 1
    assert rich.original_type == "InjectedFault"
    data = json.load(open(wd.stall_dump_path()))
    assert data["stall"]["peer_errors"][0]["type"] == "InjectedFault"


def test_rank_crash_raise_mode_reports_and_raises(guardian, tmp_path):
    store = FileKVStore(str(tmp_path))
    wd.configure(store=store, job="j", rank=0)
    set_flags({"FLAGS_fault_inject":
               "rank_crash:op=broadcast,at_seq=1,mode=raise"})
    g = _FakeGroup()
    tok = wd.begin("broadcast", g)
    wd.preflight(tok)                # seq 0: no fire
    wd.end(tok)
    tok = wd.begin("broadcast", g)
    with pytest.raises(fi.InjectedFault, match="seq 1"):
        wd.preflight(tok)
    wd.end(tok)
    (rec,) = wd.ErrorTrap(store, job="j", rank=1).peers()
    assert rec["type"] == "InjectedFault" and rec["seq"] == 1


# ---------------------------------------------------------------------------
# the host lane
# ---------------------------------------------------------------------------


def test_host_gather_stacks_in_group_order(tmp_path):
    from paddle_tpu_torch.distributed.host_collectives import HostCollectives
    hc = HostCollectives(FileKVStore(str(tmp_path)), job="j")
    group = _FakeGroup(gid=0, ranks=(0,))   # a single member: no wait
    out = hc.gather(group, np.array([1.0, 2.0], np.float32))
    np.testing.assert_array_equal(out, [[1.0, 2.0]])
    out = hc.gather(group, np.array([3.0], np.float32))
    np.testing.assert_array_equal(out, [[3.0]])
    assert hc._seq[0] == 2


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_np_reduce_matches_jax(op, dtype):
    st = np.array([[1, 2], [3, 5]], dtype)
    got, want = C._np_reduce(op, st), jax_np_reduce(op, st)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


_GUARDED = {}


@pytest.fixture(scope="module")
def guarded(tmp_path_factory):
    """Each of 4 gloo ranks' `case_collectives` results with the guardian
    off, armed, and on the host lane (run once)."""
    if not _GUARDED:
        d = tmp_path_factory.mktemp("guarded")
        _GUARDED["outs"] = run_ranks(4, "guarded_collectives", d,
                                     {"guard_dir": str(d / "guard")})
    return _GUARDED["outs"]


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, torch.dtype) or not isinstance(a, str):
        return a == b
    return ("is not a member" in a) == ("is not a member" in b)


@pytest.mark.parametrize("lane", ["armed", "host"])
def test_collectives_guarded_and_host_lane_equal_off(guarded, lane):
    """Every collective's result on every rank is the guardian-off
    result bit for bit: armed (the choke point, arrival records, the
    desync check on every call) and on the host lane (the store-mediated
    gather)."""
    for res in guarded:
        for key, want in res["off"].items():
            if key in ("calls", "bytes"):
                continue
            assert _equal(res[lane][key], want), (lane, key)


def test_guarded_collectives_retire_every_entry(guarded):
    """Off, ``begin`` returned None; armed, every call of group 0 took one
    seq (16 on each rank), the p2p calls took their pair's, and nothing
    stayed in flight; the host lane wrote its contributions under
    ``{job}/hc/`` (the two newest seqs a group kept)."""
    pairs = {}
    for r, res in enumerate(guarded):
        assert res["off_token"] is None
        assert res["armed_seq"][0] == 16
        assert res["armed_in_flight"] == []
        assert res["host_keys"] > 0
        for gid, n in res["armed_seq"].items():
            if isinstance(gid, str):
                pairs.setdefault(gid, []).append(n)
    # both ends of a link counted the same calls
    assert pairs and all(len(v) == 2 and v[0] == v[1]
                         for v in pairs.values())


def test_one_stall_a_process_for_its_oldest_collective(guardian, tmp_path):
    """Several calls in flight time out together (NCCL queued them all):
    the process stalls once, for the oldest, and the trap keeps that
    call's record."""
    set_flags({"FLAGS_collective_timeout_s": 0.3,
               "FLAGS_collective_hard_abort": False})
    store = FileKVStore(str(tmp_path))
    wd.configure(store=store, job="j", rank=0)
    toks = []
    for _ in range(3):
        tok = wd.begin("all_reduce", _FakeGroup())
        wd.preflight(tok)
        wd.end(tok, _Event())
        toks.append(tok)
    deadline = time.monotonic() + 5
    while toks[0][2].exc is None and time.monotonic() < deadline:
        time.sleep(0.02)
    time.sleep(1.0)                  # more polls: nothing else stalls
    assert [t[2].exc is not None for t in toks] == [True, False, False]
    (rec,) = wd.ErrorTrap(store, job="j", rank=1).peers()
    assert (rec["type"], rec["seq"]) == ("CollectiveTimeoutError", 0)


def test_excepthook_reports_the_prepared_error(tmp_path):
    """An asynchronously raised bare error that surfaced outside the choke
    point reaches the trap (and the log) as the rich instance the
    watchdog prepared: the peer's original error (a child, whose hook
    exits 101)."""
    code = (
        "import time\n"
        "from paddle_tpu_torch.distributed import watchdog as wd\n"
        "from paddle_tpu_torch.distributed.store import FileKVStore\n"
        "class G:\n"
        "    id = 0\n"
        "    ranks = [0, 1]\n"
        f"store = FileKVStore({str(tmp_path)!r})\n"
        "wd.configure(store=store, job='j', rank=0)\n"
        "tok = wd.begin('all_reduce', G)\n"
        "wd.preflight(tok)\n"
        "wd.ErrorTrap(store, job='j', rank=1).report(\n"
        "    RuntimeError('rank 1 exploded'), op='all_reduce', seq=0)\n"
        "while True:      # outside the choke point: the raise lands here\n"
        "    time.sleep(0.01)\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               FLAGS_collective_hard_abort="0",
               FLAGS_stall_dump_path=str(tmp_path / "stall.json"),
               FLAGS_flight_recorder_path=str(tmp_path / "fr.json"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == wd.ELASTIC_EXIT_CODE, r.stderr[-2000:]
    assert "rank 1 exploded" in r.stderr.split("Traceback")[-1]
    (rec,) = [json.loads(v) for k, v in FileKVStore(str(tmp_path))
              .list_prefix("j/error/0").items()]
    assert rec["type"] == "PeerFailureError"
    assert "rank 1 exploded" in rec["message"]
