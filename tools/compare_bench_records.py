#!/usr/bin/env python3
"""Compare two bench records field for field, clock fields masked.

    PYTHONPATH=src python3 tools/compare_bench_records.py A.json B.json [A.json B.json ...]

For each pair (say a port record ``benchmarks_torch/BENCH_federation.json``
against the reference's ``BENCH_federation.json``), drops
``benchmarks_torch.common.CLOCK_FIELDS`` (the provenance, the host, the obs
artifact paths and every field that reads a clock, as the parity tests
mask them), then prints how many of the remaining leaves are equal and
each one that differs or is present on one side only.  Exits 1 if any
pair differs.  Run from the repository's root.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks_torch.common import CLOCK_FIELDS  # noqa: E402


def leaves(doc, path=()):
    """(path, value) of every unmasked leaf of ``doc``."""
    if isinstance(doc, dict):
        for k in sorted(doc):
            if k not in CLOCK_FIELDS:
                yield from leaves(doc[k], path + (k,))
    elif isinstance(doc, list) and doc and isinstance(doc[0], dict):
        for i, v in enumerate(doc):
            yield from leaves(v, path + (str(i),))
    else:
        yield path, doc


def compare(a_path: str, b_path: str) -> bool:
    with open(a_path) as f:
        a = dict(leaves(json.load(f)))
    with open(b_path) as f:
        b = dict(leaves(json.load(f)))
    same = [p for p in a if p in b and a[p] == b[p]]
    diff = [p for p in a if p in b and a[p] != b[p]]
    only = sorted(set(a) ^ set(b))
    print(f"{a_path} vs {b_path}: {len(same)} of {len(set(a) | set(b))} "
          f"fields equal")
    for p in diff:
        print(f"  {'/'.join(p)}: {a[p]!r} vs {b[p]!r}")
    for p in only:
        side = a_path if p in a else b_path
        print(f"  {'/'.join(p)}: only in {side}")
    return not diff and not only


def main(argv: list[str]) -> int:
    if not argv or len(argv) % 2:
        print(__doc__.splitlines()[2].strip(), file=sys.stderr)
        return 2
    ok = [compare(argv[i], argv[i + 1]) for i in range(0, len(argv), 2)]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
