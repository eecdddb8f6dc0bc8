"""Replay pytest-xdist's ``--dist loadfile`` schedule from a junit XML.

Usage:

    python tools/loadfile_schedule_sim.py <junit.xml> [workers]
        [--regroup mapping.json]

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

``--regroup`` replays a regrouping of the tests into other files before
it is written: ``mapping.json`` maps test ids to new file names, e.g.
``{"tests/test_a.py::test_x": "tests/test_a_x.py"}``. An id without its
parameters (``file::test``) moves every case of that test. A moved test
keeps its junit time; a new file's tests run in their report order, and
files are queued as above, ties in the order of their paths (pytest
collects a directory's files sorted by name). The last lines print the
files queued last (the tail) and each file over 5 s with more than 7
tests. ``tools/loadfile_regroup.json`` is the split of the port's large
test files into files of 7 tests or fewer, keyed by the ids they had
before it.
"""

import argparse
import collections
import heapq
import json
import xml.etree.ElementTree as ET


def load(path, regroup=None):
    """Each file's test times, in report order (a file's tests run in
    collection order on one worker); ``regroup`` maps a test id (or
    ``file::test``, every case of it) to the file it moves to."""
    regroup = regroup or {}
    files = collections.OrderedDict()
    for case in ET.parse(path).getroot().iter("testcase"):
        name = case.get("classname").replace(".", "/") + ".py"
        test_id = f"{name}::{case.get('name')}"
        name = regroup.get(test_id,
                           regroup.get(test_id.split("[")[0], name))
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("junit")
    parser.add_argument("workers", nargs="?", type=int, default=6)
    parser.add_argument("--regroup", help="JSON map of test ids to files")
    args = parser.parse_args()
    regroup = None
    if args.regroup:
        with open(args.regroup) as f:
            regroup = json.load(f)
    files = load(args.junit, regroup)
    wall, chains = simulate(files, args.workers)
    for w, chain in enumerate(chains):
        print(f"gw{w}: " + ", ".join(
            f"{f.split('/')[-1][:-3]} @{start:.0f} +{t:.0f}"
            for f, start, t in chain))
    total = sum(sum(v) for v in files.values())
    print(f"summed {total:.0f} s over {len(files)} files; predicted wall"
          f" {wall:.0f} s on {args.workers} workers")
    starts = sorted((start, f, t) for chain in chains
                    for f, start, t in chain)
    print("queued last: " + ", ".join(
        f"{f.split('/')[-1][:-3]} @{start:.0f} +{t:.0f}"
        for start, f, t in starts[-6:]))
    crowded = [f"{f.split('/')[-1][:-3]} ({len(v)} tests, {sum(v):.0f} s)"
               for f, v in files.items() if sum(v) > 5 and len(v) > 7]
    print("over 5 s with more than 7 tests: " + (", ".join(crowded)
                                                 or "none"))


if __name__ == "__main__":
    main()
