"""The port's multi-pod launcher and elastic scale-in/out over its TCP
store (paddle_tpu_torch/distributed/launch/master.py and the elastic
controller): tests/test_launch_elastic.py's five cases under their
names, with its pod and fault workers (plain Python, no framework)."""
import os
import threading
import time

from paddle_tpu_torch.distributed.launch.context import (Context,
                                                         free_port,
                                                         parse_args)
from paddle_tpu_torch.distributed.launch.controller import \
    ElasticCollectiveController

WORKER = os.path.join(os.path.dirname(__file__), "_pod_worker.py")
FAULT_WORKER = os.path.join(os.path.dirname(__file__), "_fault_worker.py")


def _pod(endpoint, pod_id, host, outdir, nnodes, park="-", job="j",
         quiet=0.5):
    args = parse_args([
        "--master", endpoint, "--nnodes", nnodes,
        "--node_rank", "0" if host else "1",
        "--pod_id", pod_id, "--job_id", job,
        "--nproc_per_node", "1", "--elastic_quiet", str(quiet),
        "--elastic_timeout", "15",
        WORKER, str(outdir), park])
    return ElasticCollectiveController(Context(args=args))


def _run_in_thread(ctrl, out):
    def target():
        out[ctrl.kv.pod_id] = ctrl.run()
    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t


def _wait_for(path, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            return True
        time.sleep(0.1)
    return False


def test_two_pod_launch_rendezvous_ranks(tmp_path):
    # two pods meet through the store; the workers' ranks follow the
    # committed membership's order, not the static node_rank
    ep = f"127.0.0.1:{free_port()}"
    codes = {}
    a = _pod(ep, "a", True, tmp_path, "2", job="two")
    b = _pod(ep, "b", False, tmp_path, "2", job="two")
    ta = _run_in_thread(a, codes)
    time.sleep(0.3)
    tb = _run_in_thread(b, codes)
    ta.join(60)
    tb.join(60)
    assert codes == {"a": 0, "b": 0}
    assert (tmp_path / "w2.r0").exists()      # pod a: rank 0
    assert (tmp_path / "w2.r1").exists()      # pod b: rank 1
    assert not (tmp_path / "w1.r0").exists()  # never committed alone


def test_scale_out_joiner_triggers_rebuild(tmp_path):
    # pod a starts alone (range 1:2) and its worker parks; pod b joining
    # rebuilds the rendezvous: a's worker restarts in world 2
    ep = f"127.0.0.1:{free_port()}"
    codes = {}
    a = _pod(ep, "a", True, tmp_path, "1:2", park="1", job="so")
    ta = _run_in_thread(a, codes)
    assert _wait_for(tmp_path / "w1.r0"), "the solo rendezvous never "\
        "committed"
    b = _pod(ep, "b", False, tmp_path, "1:2", park="-", job="so")
    tb = _run_in_thread(b, codes)
    ta.join(60)
    tb.join(60)
    assert codes == {"a": 0, "b": 0}
    assert (tmp_path / "w2.r0").exists()      # a restarted into world 2
    assert (tmp_path / "w2.r1").exists()      # b joined as rank 1


def test_scale_in_dead_pod_triggers_rebuild(tmp_path):
    # two pods commit world 2 (a's worker parks); b then dies without
    # deregistering: its heartbeat expires and a rebuilds to world 1
    from paddle_tpu_torch.distributed.launch.master import KVMaster

    ep = f"127.0.0.1:{free_port()}"
    codes = {}
    # quiet=3.0 >> b's join delay: the first commit holds BOTH pods
    a = _pod(ep, "a", True, tmp_path, "1:2", park="2", job="si",
             quiet=3.0)
    a.kv._hb.ttl = 1.5
    ta = _run_in_thread(a, codes)
    time.sleep(0.3)
    kvb = KVMaster(ep, "b", np=1, is_host=False, job_id="si", ttl=1.5,
                   timeout=30)
    kvb.start_heartbeat(interval=0.3)
    r, pods, idx = kvb.rendezvous(1, 2, quiet=0.5)
    assert [p["id"] for p in pods] == ["a", "b"] and idx == 1
    assert _wait_for(tmp_path / "w2.r0"), "the world-2 rendezvous missing"
    kvb._stop.set()                  # b dies: its key expires by TTL
    ta.join(60)
    kvb.store.close()
    assert codes == {"a": 0}
    assert (tmp_path / "w1.r0").exists()      # a rebuilt down to world 1


def test_rendezvous_assigns_contiguous_ranks_multi_proc(tmp_path):
    # pods with different nproc_per_node: contiguous rank blocks in
    # pod-id order, PADDLE_TRAINERS_NUM the global worker count
    ep = f"127.0.0.1:{free_port()}"
    codes = {}
    args_a = parse_args([
        "--master", ep, "--nnodes", "2", "--node_rank", "0",
        "--pod_id", "a", "--job_id", "mp", "--nproc_per_node", "2",
        "--elastic_timeout", "15", WORKER, str(tmp_path), "-"])
    args_b = parse_args([
        "--master", ep, "--nnodes", "2", "--node_rank", "1",
        "--pod_id", "b", "--job_id", "mp", "--nproc_per_node", "1",
        "--elastic_timeout", "15", WORKER, str(tmp_path), "-"])
    a = ElasticCollectiveController(Context(args=args_a))
    b = ElasticCollectiveController(Context(args=args_b))
    ta = _run_in_thread(a, codes)
    tb = _run_in_thread(b, codes)
    ta.join(60)
    tb.join(60)
    assert codes == {"a": 0, "b": 0}
    for r in range(3):
        assert (tmp_path / f"w3.r{r}").exists(), r


def test_fault_tolerance_level_relaunches_crashed_worker(tmp_path,
                                                         monkeypatch):
    """PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL above 0 (the reference's
    spelling, elastic manager.py:178): a worker that crashes with an
    ordinary code is relaunched; level 0 keeps failing fast."""
    monkeypatch.setenv("PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL", "1")
    ep = f"127.0.0.1:{free_port()}"
    args = parse_args([
        "--master", ep, "--nnodes", "1", "--node_rank", "0",
        "--pod_id", "p0", "--job_id", "ft", "--nproc_per_node", "1",
        "--elastic_quiet", "0.2", "--elastic_timeout", "15",
        "--max_restart", "3",
        FAULT_WORKER, str(tmp_path)])
    rc = ElasticCollectiveController(Context(args=args)).run()
    assert rc == 0
    assert (tmp_path / "ok.0").exists()

    monkeypatch.setenv("PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL", "0")
    out2 = tmp_path / "lvl0"
    out2.mkdir()
    ep2 = f"127.0.0.1:{free_port()}"
    args2 = parse_args([
        "--master", ep2, "--nnodes", "1", "--node_rank", "0",
        "--pod_id", "p0", "--job_id", "ft0", "--nproc_per_node", "1",
        "--elastic_quiet", "0.2", "--elastic_timeout", "15",
        "--max_restart", "3",
        FAULT_WORKER, str(out2)])
    rc2 = ElasticCollectiveController(Context(args=args2)).run()
    assert rc2 == 3
    assert not (out2 / "ok.0").exists()
