"""Replay pytest-xdist's ``--dist loadfile`` schedule from a junit XML.

Usage:

    python tools/loadfile_schedule_sim.py <junit.xml> [workers]

Reads each test's time from a junit XML of the tier-1 command (ROADMAP
"Tier-1 verify") and replays how pytest-xdist 3.8 hands out test files
(``LoadScopeScheduling``, which ``--dist loadfile`` uses): the files are
queued by their number of tests, most first (ties in collection order);
each worker takes one file, and takes the next queued file whenever no
more than two of its own tests are pending. Prints each worker's files
with their start time and summed time, the summed time of all files and
the predicted wall (collection and start-up excluded). A file whose few
tests are long therefore starts late when the files queued before it
leave every worker busy.
"""

import collections
import heapq
import sys
import xml.etree.ElementTree as ET


def load(path):
    """Each file's test times, in report order (a file's tests run in
    collection order on one worker)."""
    files = collections.OrderedDict()
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("classname").replace(".", "/") + ".py"
        files.setdefault(name, []).append(float(case.get("time", 0)))
    return files


def simulate(files, workers=6):
    """``(wall, chains)``: the predicted wall and, per worker, its
    ``(file, start, summed time)`` in order."""
    queue = collections.deque(sorted(sorted(files),
                                     key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]
    chains = [[] for _ in range(workers)]
    started = {}

    def assign(w):
        if queue:
            name = queue.popleft()
            chains[w].append(name)
            pending[w].extend((name, t) for t in files[name])

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            assign(w)
    clock = [(0.0, w) for w in range(workers)]
    end = [0.0] * workers
    while clock:
        now, w = heapq.heappop(clock)
        if not pending[w]:
            continue
        name, t = pending[w].popleft()
        started.setdefault(name, now)
        end[w] = now + t
        if len(pending[w]) <= 2:
            assign(w)
        heapq.heappush(clock, (end[w], w))
    return max(end), [[(f, started[f], sum(files[f])) for f in chain]
                      for chain in chains]


def main():
    files = load(sys.argv[1])
    workers = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    wall, chains = simulate(files, workers)
    for w, chain in enumerate(chains):
        print(f"gw{w}: " + ", ".join(
            f"{f.split('/')[-1][:-3]} @{start:.0f} +{t:.0f}"
            for f, start, t in chain))
    total = sum(sum(v) for v in files.values())
    print(f"summed {total:.0f} s over {len(files)} files; predicted wall"
          f" {wall:.0f} s on {workers} workers")


if __name__ == "__main__":
    main()
