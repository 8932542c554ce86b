"""Does torch.profiler keep every kernel of the CUDA graph replays in its
active window?  chip_smoke.py's `profile_replays` holds the kernels of 5
profiled replays equal to the graph's recorded launches, and sleeps
`PROFILE_EDGE_S` at the window's edges.  This script replays a graph of
32 x (a bf16 2048^3 matmul, an add, a mul) 5 times in the active window,
``--windows`` times with no idle time at the edges and as many with
``--gap`` seconds, alternating, and prints for each how many windows
counted another number of kernels than 5 x 96.

    python3 scripts/profile_window_check.py [--windows 20] [--gap 0.1]

Needs a CUDA card."""
import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule


def kernels_in_window(graph, gap, n=5):
    """Kernels the profiler kept from ``n`` replays of ``graph`` in its
    active window, after one warm-up replay, ``gap`` s idle at each edge."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        for reps in (1, n):
            time.sleep(gap)
            for _ in range(reps):
                graph.replay()
            torch.cuda.synchronize()
            time.sleep(gap)
            prof.step()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=20)
    ap.add_argument("--gap", type=float, default=0.1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    a = torch.randn(2048, 2048, device=dev, dtype=torch.bfloat16)
    b = torch.randn(2048, 2048, device=dev, dtype=torch.bfloat16)
    x = torch.zeros(4096, device=dev)

    def body():
        for _ in range(32):
            a @ b
            x.add_(1.0)
            x.mul_(0.5)

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        body()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    g.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        g.replay()
    torch.cuda.synchronize()
    print(f"{torch.cuda.get_device_name(0)}: one replay "
          f"{(time.perf_counter() - t0) * 100:.3f} ms", flush=True)
    want = 5 * 96
    for gap in (0.0, args.gap, 0.0, args.gap):
        counts = [kernels_in_window(g, gap) for _ in range(args.windows)]
        off = [c for c in counts if c != want]
        print(f"gap {gap} s: {len(off)} of {len(counts)} windows off "
              f"(want {want}; got {sorted(set(counts))})", flush=True)


if __name__ == "__main__":
    main()
