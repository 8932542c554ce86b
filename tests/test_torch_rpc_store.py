"""The port's fleet transports against the JAX package's: the TCP store
(``paddle_tpu_torch/csrc/tcp_store.cpp`` built by g++, `TCPStore`,
`FileKVStore`, `TCPElasticStore`, `Master`), each package's client
against the other's server; the rpc plane (`init_rpc` across processes,
`RpcServer`, the raw-bytes `Blob` path, connect retries, the trace
envelope); the retry schedules and the rpc fault points (tests/
test_tcp_store.py, test_rpc.py and the transport cases of test_fleet.py,
test_disagg.py and test_gray_failure.py, run on the port)."""
import multiprocessing as mp
import pickle
import random
import socket
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed.store import FileKVStore as JaxFileKVStore
from paddle_tpu.distributed.store import TCPStore as JaxTCPStore
from paddle_tpu.utils import fault_injection as jfi
from paddle_tpu.utils import retry as jretry
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.distributed.rpc import rpc as rpc_mod
from paddle_tpu_torch.distributed.store import (FileKVStore, Master,
                                                TCPElasticStore, TCPStore)
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.utils import fault_injection as fi
from paddle_tpu_torch.utils import retry
from paddle_tpu_torch.utils.flags import set_flags


@pytest.fixture()
def store():
    s = TCPStore(is_master=True)
    yield s
    s.close()


def test_set_get_delete(store):
    assert store.get("missing") is None
    store.set("k", b"hello")
    assert store.get("k") == b"hello"
    store.set("k", "world")
    assert store.get("k") == b"world"
    store.delete_key("k")
    assert store.get("k") is None


def test_add_counter(store):
    assert store.add("ctr", 1) == 1
    assert store.add("ctr", 5) == 6
    assert store.add("ctr", 0) == 6


def test_wait_blocks_until_set(store):
    def setter():
        time.sleep(0.3)
        s2 = TCPStore(port=store.port)
        s2.set("later", b"v")
        s2.close()

    t = threading.Thread(target=setter)
    t.start()
    t0 = time.time()
    got = store.wait("later", timeout=10)
    t.join()
    assert got == b"v"
    assert time.time() - t0 >= 0.2


def test_wait_timeout(store):
    with pytest.raises(TimeoutError):
        store.wait("never", timeout=0.3)


def test_list_prefix_large_values_and_growth(store):
    store.set("a/1", b"x" * 100_000)
    store.set("a/2", b"y")
    store.set("b/1", b"z")
    out = store.list_prefix("a/")
    assert set(out) == {"a/1", "a/2"}
    assert out["a/1"] == b"x" * 100_000
    store.set("big", b"y" * 300_000)
    assert store.get("big") == b"y" * 300_000


@pytest.mark.parametrize("server", ["port", "jax"])
def test_store_clients_interoperate_with_both_servers(server):
    """The port's copy of csrc/tcp_store.cpp speaks the JAX server's
    protocol: each package's client reads what the other wrote, on
    either package's server (set, add, list, stamp, wait)."""
    master = (TCPStore if server == "port" else JaxTCPStore)(
        is_master=True)
    ours = TCPStore("127.0.0.1", master.port)
    theirs = JaxTCPStore("127.0.0.1", master.port)
    try:
        ours.set("fleet.a", b"1")
        theirs.set("fleet.b", "2")
        assert theirs.get("fleet.a") == b"1" and ours.get("fleet.b") == b"2"
        assert ours.add("gen", 2) == 2 and theirs.add("gen", 3) == 5
        assert ours.list_prefix("fleet.") == theirs.list_prefix("fleet.")
        ours.stamp("node.x")
        assert abs(theirs.server_now() - ours.server_now()) < 5
        assert len(theirs.get("node.x")) == 8
        theirs.set("ready", b"go")
        assert ours.wait("ready", timeout=5) == b"go"
        theirs.delete_key("fleet.a")
        assert ours.get("fleet.a") is None
    finally:
        ours.close()
        theirs.close()
        master.close()


def test_file_store_reads_jax_file_store(tmp_path):
    """`FileKVStore` keeps the JAX package's file layout: each package
    reads the other's keys, counters and prefix listings."""
    ours, theirs = FileKVStore(str(tmp_path)), JaxFileKVStore(str(tmp_path))
    ours.set("job/error/0", b"boom")
    theirs.set("job/error/1", "bang")
    assert ours.add("ctr", 2) == 2 and theirs.add("ctr", 1) == 3
    assert ours.list_prefix("job/") == theirs.list_prefix("job/") == {
        "job/error/0": b"boom", "job/error/1": b"bang"}
    theirs.delete_key("job/error/0")
    assert ours.get("job/error/0") is None


def _node_main(endpoint, rank, nnodes, q):
    m = Master(endpoint, rank, nnodes, timeout=30)
    q.put((rank, m.sync_endpoints(f"10.0.0.{rank}:900{rank}")))
    m.close()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_master_rendezvous_across_processes():
    endpoint = f"127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_node_main, args=(endpoint, r, 3, q))
             for r in range(3)]
    for p in procs:
        p.start()
    results = [q.get(timeout=90) for _ in range(3)]
    for p in procs:
        p.join(timeout=30)
    expect = [f"10.0.0.{r}:900{r}" for r in range(3)]
    assert all(eps == expect for _, eps in results)


def test_elastic_adapter_liveness(store):
    es = TCPElasticStore(store, ttl=1)
    es.register("n0")
    es.register("n1")
    assert es.alive_nodes() == ["n0", "n1"]
    es.deregister("n1")
    assert es.alive_nodes() == ["n0"]
    time.sleep(1.2)          # ttl expiry without heartbeat
    assert es.alive_nodes() == []
    es.heartbeat("n0")
    assert es.alive_nodes() == ["n0"]


@pytest.mark.parametrize("kind", ["tcp", "file"])
def test_elastic_store_expiry_reap_reregister(kind, tmp_path):
    master = None
    if kind == "tcp":
        master = TCPStore(is_master=True)
        store = TCPStore("127.0.0.1", master.port)
    else:
        store = FileKVStore(str(tmp_path))
    try:
        es = TCPElasticStore(store, ttl=0.4)
        es.register("n1")
        es.register("n2")
        assert es.alive_nodes() == ["n1", "n2"]
        assert es.expired_nodes() == []
        time.sleep(0.6)
        es.heartbeat("n2")                   # n1 flaps, n2 stays fresh
        assert es.alive_nodes() == ["n2"]
        assert es.expired_nodes() == ["n1"]
        assert es.is_registered("n1")        # key lingers until reaped
        assert es.reap() == ["n1"]
        assert es.is_registered("n1") is False
        es.register("n1")                    # explicit rejoin
        assert es.alive_nodes() == ["n1", "n2"]
    finally:
        if master is not None:
            store.close()
            master.close()


# ------------------------------------------------------------------ rpc
def _worker_main(master, q):
    from paddle_tpu_torch.distributed import rpc as wrpc
    wrpc.init_rpc("worker1", rank=1, world_size=2, master_endpoint=master)
    q.get(timeout=60)
    wrpc.shutdown()


def _double(x):
    return 2 * x


def _boom():
    raise ValueError("remote failure")


def test_rpc_cross_process():
    master = f"127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_worker_main, args=(master, q))
    proc.start()
    try:
        rpc.init_rpc("master", rank=0, world_size=2, master_endpoint=master)
        for _ in range(300):
            if "worker1" in {w.name for w in rpc.get_all_worker_infos()}:
                break
            time.sleep(0.2)
        assert {"master", "worker1"} <= \
            {w.name for w in rpc.get_all_worker_infos()}
        assert rpc.rpc_sync("worker1", _double, args=(21,)) == 42
        assert rpc.rpc_async("worker1", _double, args=(5,)) \
            .result(timeout=30) == 10
        with pytest.raises(ValueError, match="remote failure"):
            rpc.rpc_sync("worker1", _boom)
        assert rpc.get_worker_info("worker1").rank == 1
        assert rpc.get_current_worker_info().name == "master"
    finally:
        q.put("done")
        proc.join(timeout=30)
        rpc.shutdown()
    assert proc.exitcode == 0


def _blob_probe(small, blob, big_bytes):
    assert isinstance(blob, rpc.Blob), type(blob)
    assert isinstance(big_bytes, rpc.Blob), type(big_bytes)
    arr = np.frombuffer(blob.data, np.float32)
    return {"nbytes": len(blob), "sum": float(arr.sum()),
            "big_head": big_bytes.tobytes()[:4], "small": small}


def test_rpc_raw_bytes_fast_path_roundtrip_and_no_copy():
    """Bytes in == bytes out over the raw path; the send side writes from
    the caller's own buffer; large bytes-like args are promoted past
    RAW_THRESHOLD, small ones stay in the pickled header."""
    srv = rpc.RpcServer("blob-probe")
    try:
        arr = np.arange(50000, dtype=np.float32)
        big = b"\x01\x02\x03\x04" * (rpc.RAW_THRESHOLD // 4 + 1)
        sent = []
        orig = rpc_mod._send_blob

        def spy(conn, blob):
            sent.append(blob)
            return orig(conn, blob)

        rpc_mod._send_blob = spy
        try:
            out = rpc.rpc_sync("blob-probe", _blob_probe,
                               args=(b"tiny", rpc.Blob(arr), big))
        finally:
            rpc_mod._send_blob = orig
        assert out == {"nbytes": arr.nbytes, "sum": float(arr.sum()),
                       "big_head": b"\x01\x02\x03\x04", "small": b"tiny"}
        assert len(sent) == 2 and sent[0].data.obj is arr
        with pytest.raises(TypeError, match="raw-bytes fast path"):
            pickle.dumps(rpc.Blob(arr))
        with pytest.raises(ValueError, match="contiguous"):
            rpc.Blob(np.ones((8, 8), np.float32)[:, ::2])
    finally:
        srv.close()


def test_rpc_shutdown_idempotent_and_connect_retry():
    rpc.shutdown()
    rpc.shutdown()
    rpc.connect_worker("ghost", "127.0.0.1", _free_port())
    try:
        t0 = time.monotonic()
        with pytest.raises(ConnectionError, match="ghost"):
            rpc.rpc_sync("ghost", sorted, args=([3, 1],))
        assert time.monotonic() - t0 < 10
    finally:
        rpc.forget_worker(name="ghost")
    with pytest.raises(ValueError, match="unknown worker"):
        rpc.rpc_sync("ghost", sorted, args=([],))


def test_rpc_server_close_releases_port():
    srv = rpc.RpcServer("porttest")
    port = srv.info.port
    srv.close()
    srv.close()                              # idempotent
    deadline = time.monotonic() + 5
    while True:
        try:
            s = socket.socket()
            s.bind(("127.0.0.1", port))
            s.close()
            break
        except OSError:
            assert time.monotonic() < deadline, "port never released"
            time.sleep(0.1)


def _current_trace():
    ctx = tracing.current()
    return None if ctx is None else ctx.trace_id


def test_rpc_envelope_carries_the_trace_context(tmp_path):
    """With tracing armed the caller's context rides the call envelope
    (both the plain and the raw-bytes call), so the callee's spans join
    the caller's trace; off, the envelope carries nothing."""
    srv = rpc.RpcServer("trace-probe")
    try:
        assert rpc.rpc_sync("trace-probe", _current_trace) is None
        set_flags({"FLAGS_trace_dir": str(tmp_path)})
        tracing.reset()
        root = tracing.start_span("router.request")
        with tracing.bind(root.ctx):
            got = rpc.rpc_sync("trace-probe", _current_trace)
            got_async = rpc.rpc_async("trace-probe", _current_trace) \
                .result(timeout=30)
        root.end()
        assert got == got_async == root.ctx.trace_id
    finally:
        set_flags({"FLAGS_trace_dir": ""})
        tracing.reset()
        srv.close()


# --------------------------------------------------- retry, fault points
def test_retry_schedules_match_jax():
    """The decorrelated schedule draws the same delays as JAX's from the
    same generator; the exponential one stays within its jitter band."""
    a = list(retry.decorrelated_delays(0.05, 2.0, tries=12,
                                       rng=random.Random(7)))
    b = list(jretry.decorrelated_delays(0.05, 2.0, tries=12,
                                        rng=random.Random(7)))
    assert a == b and all(0.05 <= d <= 2.0 for d in a)
    for n, d in enumerate(retry.backoff_delays(0.05, 2.0, 1.0, 0.25,
                                               tries=8)):
        mid = min(1.0, 0.05 * 2.0 ** n)
        assert 0.75 * mid <= d <= 1.25 * mid
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionRefusedError("not yet")
        return "up"
    assert retry.retry_call(flaky, tries=5, retry_on=(ConnectionError,),
                            sleep=lambda s: None) == "up"
    assert len(calls) == 3


@pytest.mark.parametrize("spec", [
    "rpc_drop:to=rep-1,count=2",
    "rpc_delay:to=slowpoke,delay_s=0.2,count=1",
    "rpc_slow:to=rep-0,delay_s=0.25,count=3;"
    "engine_slow:to=rep-1,delay_s=0.5,count=8",
    "rpc_drop:once_file=/tmp/x",
])
def test_rpc_fault_specs_parse_as_jax(spec):
    assert fi.parse(spec) == jfi.parse(spec)


@pytest.mark.parametrize("bad", ["rpc_slow:delay_s=abc",
                                 "engine_slow:nope=1", "rpc_drop:count"])
def test_rpc_fault_specs_reject_malformed_as_jax(bad):
    with pytest.raises(fi.FaultSpecError):
        fi.parse(bad)
    with pytest.raises(jfi.FaultSpecError):
        jfi.parse(bad)


def test_check_rpc_fires_as_jax(tmp_path):
    """`check_rpc` answers the same sequence of calls as JAX's: target
    filter, count budget, the delay points' sleep, once_file."""
    once = tmp_path / "once"
    spec = (f"rpc_drop:to=rep-1,count=2;rpc_slow:to=rep-0,delay_s=0.05,"
            f"count=2;rpc_delay:once_file={once}")
    calls = [("rpc_drop", "rep-1"), ("rpc_drop", "rep-0"),
             ("rpc_drop", "rep-1"), ("rpc_drop", "rep-1"),
             ("rpc_slow", "rep-1"), ("rpc_slow", "rep-0"),
             ("rpc_slow", "rep-0"), ("rpc_slow", "rep-0"),
             ("rpc_delay", "any"), ("engine_slow", "rep-0")]
    answers = {}
    for name, mod in (("port", fi), ("jax", jfi)):
        if once.exists():
            once.unlink()
        set_flags({"FLAGS_fault_inject": spec})
        from paddle_tpu.utils.flags import set_flags as jax_set_flags
        jax_set_flags({"FLAGS_fault_inject": spec})
        try:
            got = []
            for point, worker in calls:
                t0 = time.monotonic()
                fired = mod.check_rpc(point, worker)
                got.append((fired, time.monotonic() - t0 >= 0.04))
            answers[name] = got
        finally:
            set_flags({"FLAGS_fault_inject": ""})
            jax_set_flags({"FLAGS_fault_inject": ""})
    assert answers["port"] == answers["jax"]
    assert [f for f, _ in answers["port"][:4]] == [True, False, True, False]
    assert [s for _, s in answers["port"][4:8]] == [False, True, True, False]


def test_rpc_drop_fails_the_connect_and_rpc_slow_counts_against_timeout():
    srv = rpc.RpcServer("rep-x")
    try:
        set_flags({"FLAGS_fault_inject": "rpc_drop:to=rep-x,count=1"})
        with pytest.raises(ConnectionError, match="injected"):
            rpc.rpc_sync("rep-x", _double, args=(1,))
        assert rpc.rpc_sync("rep-x", _double, args=(2,)) == 4
        set_flags({"FLAGS_fault_inject":
                   "rpc_slow:to=rep-x,delay_s=0.6,count=1"})
        with pytest.raises(TimeoutError, match="rep-x"):
            # 0.6 s of injected stall leave 0.2 s of the 0.8 s budget
            rpc.rpc_sync("rep-x", time.sleep, args=(1.0,), timeout=0.8)
    finally:
        set_flags({"FLAGS_fault_inject": ""})
        srv.close()
