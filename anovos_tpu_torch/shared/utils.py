"""List and path helpers (the port's own copy of the parts of
``anovos_tpu/shared/utils.py`` it uses)."""

from __future__ import annotations

from typing import Callable, Iterable, List, Sequence, Union


def parse_cols(
    list_of_cols: Union[str, Sequence[str]],
    all_cols: Sequence[str],
    drop_cols: Union[str, Sequence[str], None] = None,
) -> List[str]:
    """Resolve the ``list_of_cols`` convention: a list, a pipe-delimited
    string (``"c1|c2"``) or ``"all"``; then remove ``drop_cols`` (same
    formats), keeping first occurrences in order."""
    if list_of_cols is None:
        list_of_cols = "all"
    if isinstance(list_of_cols, str):
        if list_of_cols.strip().lower() == "all":
            cols = list(all_cols)
        else:
            cols = [c.strip() for c in list_of_cols.split("|") if c.strip()]
    else:
        cols = list(list_of_cols)
    if drop_cols is None:
        drop_cols = []
    if isinstance(drop_cols, str):
        drop_cols = [c.strip() for c in drop_cols.split("|") if c.strip()]
    dropset = set(drop_cols)
    out, seen = [], set()
    for c in cols:
        if c not in dropset and c not in seen:
            seen.add(c)
            out.append(c)
    return out


def pairwise_reduce(op: Callable, items: Iterable):
    """Balanced tree reduce of ``items`` with ``op``."""
    items = list(items)
    if not items:
        raise ValueError("pairwise_reduce of empty sequence")
    while len(items) > 1:
        nxt = [op(items[i], items[i + 1]) for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def ends_with(string: str, end_str: str = "/") -> str:
    """``string`` with a trailing ``end_str``."""
    return string if string.endswith(end_str) else string + end_str
