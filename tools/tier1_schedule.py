#!/usr/bin/env python3
"""Where Tier-1's wall goes under ``pytest -n 6 --dist loadfile``.

Three uses.  As a pytest plugin it writes, per xdist worker, the start and
end time of every test, with the count of JAX backend compiles the worker
has made so far (``jax.monitoring``'s backend-compile duration events), to
``$TIER1_TRACE/<worker>.jsonl`` and the collection order to
``$TIER1_TRACE/collection.txt``:

    TIER1_TRACE=out PYTHONPATH=tools python -m pytest tests/ ... \\
        -n 6 --dist loadfile -p tier1_schedule

``report out`` prints each worker's files in the order it ran them (start,
end, summed test seconds, tests, JAX backend compiles, seconds of JAX's
compile pipeline: tracing, lowering and backend compile) and the
worker-seconds and compiles of the port's files (``tests/test_torch_*.py``)
and of the rest:

    python3 tools/tier1_schedule.py report out

``simulate out [FILE=FACTOR ...]`` replays xdist's ``loadfile`` scheduler
(files queued by test count, largest first; a worker takes the next file
when two or fewer of its tests are left) on the traced per-test seconds,
each file's scaled by its FACTOR (``port`` scales every port file), and
prints when the last test would end, in seconds after the first started:

    python3 tools/tier1_schedule.py simulate out port=0.5
"""

import collections
import glob
import heapq
import json
import os
import sys
import time

# -- the pytest plugin ---------------------------------------------------------

_out = None
_compiles = [0, 0.0]     # JAX backend compiles, seconds of JAX's compile
BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
# the compile pipeline's stages: tracing, lowering, backend compile
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration",
                  BACKEND_COMPILE_EVENT)


def _count_compile(event, duration, **kwargs):
    if event == BACKEND_COMPILE_EVENT:
        _compiles[0] += 1
    if event in COMPILE_EVENTS:
        _compiles[1] += duration


def _trace_file():
    global _out
    if _out is None:
        folder = os.environ["TIER1_TRACE"]
        os.makedirs(folder, exist_ok=True)
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        _out = open(os.path.join(folder, f"{worker}.jsonl"), "a", buffering=1)
        import jax.monitoring
        jax.monitoring.register_event_duration_secs_listener(_count_compile)
    return _out


def _event(ev, nodeid):
    _trace_file().write(json.dumps({
        "ev": ev, "id": nodeid, "t": time.time(), "compiles": _compiles[0],
        "compile_s": round(_compiles[1], 3)}) + "\n")


def pytest_runtest_logstart(nodeid, location):
    _event("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _event("end", nodeid)


def pytest_collection_finish(session):
    if os.environ.get("PYTEST_XDIST_WORKER", "gw0") == "gw0":
        folder = os.environ["TIER1_TRACE"]
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "collection.txt"), "w") as f:
            f.writelines(item.nodeid + "\n" for item in session.items)


# -- the analysis --------------------------------------------------------------


def _file(nodeid):
    return nodeid.split("::")[0]


def _is_port(path):
    return os.path.basename(path).startswith("test_torch_")


def load(folder, compiles=False):
    """{nodeid: (worker, start, seconds)}, times from the first start; a
    test cut before its end counts from its start to the last event.  With
    ``compiles``, {nodeid: JAX backend compiles made from the test's start
    to its end} (0 for a test cut before its end); with ``compiles`` =
    ``"seconds"``, the seconds of JAX's compile pipeline instead."""
    events = {}
    for path in glob.glob(os.path.join(folder, "gw*.jsonl")):
        worker = os.path.basename(path)[:-len(".jsonl")]
        for line in open(path):
            e = json.loads(line)
            if "id" not in e:
                continue
            v = events.setdefault(e["id"], {"w": worker})
            v[e["ev"]] = e["t"]
            v["c_" + e["ev"]] = e.get("compile_s" if compiles == "seconds"
                                      else "compiles", 0)
    if compiles:
        return {k: v.get("c_end", v.get("c_start", 0)) - v.get("c_start", 0)
                for k, v in events.items()}
    t0 = min(v["start"] for v in events.values())
    last = max(max(v.get("start", 0), v.get("end", 0))
               for v in events.values())
    return {k: (v["w"], v["start"] - t0, v.get("end", last) - v["start"])
            for k, v in events.items() if "start" in v}


def report(folder):
    tests = load(folder)
    made = load(folder, compiles=True)
    spent = load(folder, compiles="seconds")
    files = {}
    for nodeid, (worker, start, secs) in tests.items():
        f = files.setdefault(_file(nodeid),
                             [worker, start, 0.0, 0.0, 0, 0, 0.0])
        f[1] = min(f[1], start)
        f[2] = max(f[2], start + secs)
        f[3] += secs
        f[4] += 1
        f[5] += made.get(nodeid, 0)
        f[6] += spent.get(nodeid, 0.0)
    by_worker = collections.defaultdict(list)
    for name, (worker, start, end, secs, n, c, cs) in files.items():
        by_worker[worker].append((start, end, secs, n, c, cs, name))
    for worker in sorted(by_worker):
        rows = sorted(by_worker[worker])
        print(f"{worker}: busy {sum(r[2] for r in rows):.1f} s, last end "
              f"{rows[-1][1]:.1f} s")
        for start, end, secs, n, c, cs, name in rows:
            print(f"  {start:8.1f} {end:8.1f} {secs:8.1f} {n:4d} {c:5d} "
                  f"{cs:7.1f}  {name}")
    port = sum(f[3] for name, f in files.items() if _is_port(name))
    total = sum(f[3] for f in files.values())
    port_c = sum(f[5] for name, f in files.items() if _is_port(name))
    print(json.dumps({"tests": len(tests), "worker_seconds": round(total, 1),
                      "port_files": round(port, 1),
                      "other_files": round(total - port, 1),
                      "port_compiles": port_c,
                      "port_compile_seconds": round(sum(
                          f[6] for name, f in files.items()
                          if _is_port(name)), 1),
                      "other_compiles": sum(f[5] for f in files.values())
                      - port_c,
                      "last_end": round(max(f[2] for f in files.values()),
                                        1)}))


def simulate(folder, factors, workers=6):
    tests = load(folder)
    order = [line.strip() for line in
             open(os.path.join(folder, "collection.txt")) if line.strip()]
    units = {}
    for nodeid in order:
        units.setdefault(_file(nodeid), []).append(nodeid)
    queue = collections.deque(sorted(units, key=lambda u: -len(units[u])))

    def seconds(nodeid):
        name = _file(nodeid)
        scale = factors.get(name, factors.get("port", 1.0)
                            if _is_port(name) else 1.0)
        return tests.get(nodeid, (None, 0.0, 0.0))[2] * scale

    pending = {w: collections.deque() for w in range(workers)}

    def take(w):
        if queue:
            pending[w].extend(units[queue.popleft()])

    for w in range(workers):
        take(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            take(w)
    clock = [(0.0, w) for w in range(workers)]
    end = 0.0
    while clock:
        now, w = heapq.heappop(clock)
        if len(pending[w]) <= 2:
            take(w)
        if not pending[w]:
            end = max(end, now)
            continue
        heapq.heappush(clock, (now + seconds(pending[w].popleft()), w))
    return end


def main():
    what, folder = sys.argv[1], sys.argv[2]
    if what == "report":
        report(folder)
    elif what == "simulate":
        factors = {k: float(v) for k, v in
                   (a.split("=") for a in sys.argv[3:])}
        print(f"{simulate(folder, factors):.1f}")
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
