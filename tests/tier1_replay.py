"""Replay of the tier-1 run's schedule from its junit file (a tool, not a
test module).

The tier-1 command runs pytest-xdist with ``-n 6 --dist loadfile``: every
test file is one unit, and the units are handed out in descending order of
their number of tests, files with equal counts in collection order (the
default ``--loadscope-reorder``).  Each worker starts with one unit, takes a
second at once, and takes the next whenever at most two of its tests are
left.  This script replays that schedule with each test's junit time and
prints the predicted wall time (without collection), each worker's end and
the files that end the run, and every port file's dispatch rank and time.

    python tests/tier1_replay.py RUN.xml [BEFORE.xml] [--workers 6]

With a second junit file it also prints each port file's time there and the
difference, and the serial sums of both.
"""

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def file_times(path):
    """{test file: [seconds of each test]} in the junit file's order."""
    files = collections.OrderedDict()
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname").split(".")
        files.setdefault("/".join(parts[:2]) + ".py", []).append(float(case.get("time") or 0.0))
    return files


def dispatch_order(files):
    """xdist's loadfile order: more tests first, then collection order (by name)."""
    return sorted(sorted(files), key=lambda f: -len(files[f]))


def replay(files, workers=6):
    """-> (wall seconds, [(end, [files]) per worker])."""
    queue = collections.deque(dispatch_order(files))
    nodes = [{"pending": collections.deque(), "files": [], "t": 0.0} for _ in range(workers)]

    def give(node):
        if queue:
            f = queue.popleft()
            node["pending"].extend(files[f])
            node["files"].append(f)

    for node in nodes:
        give(node)
    for node in nodes:
        if len(node["pending"]) <= 2:
            give(node)
    events = []
    for i, node in enumerate(nodes):
        if node["pending"]:
            heapq.heappush(events, (node["pending"].popleft(), i))
    while events:
        t, i = heapq.heappop(events)
        node = nodes[i]
        node["t"] = t
        if len(node["pending"]) <= 2:
            give(node)
        if node["pending"]:
            heapq.heappush(events, (t + node["pending"].popleft(), i))
    return max(n["t"] for n in nodes), [(n["t"], n["files"]) for n in nodes]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("run")
    ap.add_argument("before", nargs="?")
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args()
    files = file_times(args.run)
    before = file_times(args.before) if args.before else {}
    wall, nodes = replay(files, args.workers)
    serial = sum(sum(v) for v in files.values())
    port = sum(sum(v) for f, v in files.items() if "test_torch_" in f)
    print(f"replayed wall {wall:.1f} s (collection not included); serial {serial:.1f} s, the port's files {port:.1f}")
    if before:
        b_serial = sum(sum(v) for v in before.values())
        b_port = sum(sum(v) for f, v in before.items() if "test_torch_" in f)
        print(f"before: replayed wall {replay(before, args.workers)[0]:.1f} s; serial {b_serial:.1f} s, "
              f"the port's files {b_port:.1f}")
    for i, (end, fs) in sorted(enumerate(nodes), key=lambda x: -x[1][0]):
        print(f"worker {i} ends at {end:.1f} s; its last files: " + ", ".join(
            f"{f.split('/')[-1]} ({sum(files[f]):.1f} s)" for f in fs[-3:]))
    for rank, f in enumerate(dispatch_order(files), 1):
        if "test_torch_" in f:
            was = f"  before {sum(before[f]):7.1f}  diff {sum(files[f]) - sum(before[f]):+7.1f}" if f in before else ""
            print(f"{rank:4d} {f.split('/')[-1]:45s} {len(files[f]):3d} tests {sum(files[f]):7.1f} s{was}")
    for f in sorted(set(before) - set(files)):
        if "test_torch_" in f:
            print(f"   - {f.split('/')[-1]:45s} gone (before {sum(before[f]):.1f} s)")


if __name__ == "__main__":
    main()
