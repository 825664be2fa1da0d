"""List, path and frame helpers (the port's own copy of
``anovos_tpu/shared/utils.py``).  ``attributeType_segregation`` and
``get_dtype`` take a port Table or a pandas frame; ``flatten_dataframe``
and ``transpose_dataframe`` reshape stats frames on the host (a Table
through ``to_pandas``)."""

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


def output_to_local(path: str) -> str:
    """``dbfs:/...`` → ``/dbfs/...``; any other path unchanged."""
    if path.startswith("dbfs:"):
        return "/dbfs" + path[len("dbfs:"):]
    return path


def path_ak8s_modify(path: str) -> str:
    """``wasbs://<container>@<account>/<path>`` →
    ``https://<account>/<container>/<path>``; any other path unchanged."""
    if path.startswith("wasbs://"):
        rest = path[len("wasbs://"):]
        container, _, tail = rest.partition("@")
        account, _, blob_path = tail.partition("/")
        return f"https://{account}/{container}/{blob_path}"
    return path


def attributeType_segregation(idf):
    """(num_cols, cat_cols, other_cols) of a Table or a pandas frame."""
    if hasattr(idf, "attribute_type_segregation"):
        return idf.attribute_type_segregation()
    num, cat, other = [], [], []
    for c in idf.columns:
        kind = idf[c].dtype.kind
        (num if kind in "ifu" else cat if kind in "OUSb" else other).append(c)
    return num, cat, other


def get_dtype(idf, col: str) -> str:
    """Dtype name of one column: the Table's Spark-style name, or the
    pandas dtype's."""
    if hasattr(idf, "dtypes") and callable(idf.dtypes):
        return dict(idf.dtypes())[col]
    return str(idf[col].dtype)


def flatten_dataframe(idf, fixed_cols):
    """Every column not in ``fixed_cols`` melted into key/value rows."""
    import pandas as pd

    pdf = idf.to_pandas() if hasattr(idf, "to_pandas") else idf
    return pd.melt(
        pdf,
        id_vars=list(fixed_cols),
        value_vars=[c for c in pdf.columns if c not in set(fixed_cols)],
        var_name="key",
        value_name="value",
    )


def transpose_dataframe(idf, fixed_col):
    """The values of ``fixed_col`` become the header row.  All-NaN
    attributes stay as null rows, and the rows keep the source column
    order (not pivot_table's alphabetical one)."""
    pdf = idf.to_pandas() if hasattr(idf, "to_pandas") else idf
    flat = flatten_dataframe(pdf, fixed_cols=[fixed_col])
    key_order = [c for c in pdf.columns if c != fixed_col]
    return (
        flat.pivot_table(index="key", columns=fixed_col, values="value", aggfunc="first", dropna=False)
        .reindex(key_order)
        .reset_index()
        .rename_axis(None, axis=1)
    )
