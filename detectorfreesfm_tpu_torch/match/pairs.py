"""Image-pair construction (a copy of the JAX package's match/pairs.py).

Capability match for the reference's src/construct_pairs/ (construct_pairs.py:11,
pairs_exhaustive.py:5, pairs_from_img_index.py:9): exhaustive C(n,2) pairs for
unordered sets, or a sliding index window for sequential captures. Pure host
logic; order is deterministic (lexicographic in index), unlike the reference's
shuffled Ray chunks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def exhaustive_pairs(names: Sequence[str]) -> List[Tuple[str, str]]:
    """All C(n,2) pairs, (i < j) in the given order."""
    return [
        (names[i], names[j])
        for i in range(len(names))
        for j in range(i + 1, len(names))
    ]


def sequential_pairs(
    names: Sequence[str], window: int = 10, loop: bool = False
) -> List[Tuple[str, str]]:
    """Index-window pairs for ordered captures: (i, i+1..i+window)."""
    n = len(names)
    out = []
    for i in range(n):
        for d in range(1, window + 1):
            j = i + d
            if j < n:
                out.append((names[i], names[j]))
            elif loop and (j % n) != i and (names[j % n], names[i]) not in out:
                out.append((names[i], names[j % n]))
    return out


def write_pairs_txt(path: str, pairs: Sequence[Tuple[str, str]]) -> None:
    with open(path, "w") as f:
        for a, b in pairs:
            f.write(f"{a} {b}\n")


def read_pairs_txt(path: str) -> List[Tuple[str, str]]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.append((parts[0], parts[1]))
    return out
