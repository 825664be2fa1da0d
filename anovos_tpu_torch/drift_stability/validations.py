"""Validation helpers and CV→SI scoring (the port's own copy of
``anovos_tpu/drift_stability/validations.py``)."""

from __future__ import annotations

from functools import partial, wraps
from typing import List, Optional


def check_list_of_columns(
    func=None,
    columns: str = "list_of_cols",
    target_idx: int = 1,
    target: str = "idf_target",
    drop: str = "drop_cols",
):
    """Decorator resolving ``list_of_cols``/"all"/pipe-strings minus
    ``drop_cols`` against the target Table before the wrapped function runs
    (reference validations.py:8-68)."""
    if func is None:
        return partial(
            check_list_of_columns, columns=columns, target_idx=target_idx, target=target, drop=drop
        )

    import inspect

    sig = inspect.signature(func)

    param_names = list(sig.parameters)
    has_varargs = any(
        p.kind == inspect.Parameter.VAR_POSITIONAL for p in sig.parameters.values()
    )

    @wraps(func)
    def validate(*args, **kwargs):
        # bind positionals to their parameter names so a positionally-passed
        # column list is validated instead of colliding with the kwarg write
        # (*args functions can't round-trip through bind → left as-is)
        if not has_varargs:
            try:
                bound = sig.bind_partial(*args, **kwargs)
                args, kwargs = (), dict(bound.arguments)
                for p in sig.parameters.values():  # re-flatten a packed **kwargs
                    if p.kind == inspect.Parameter.VAR_KEYWORD and p.name in kwargs:
                        kwargs.update(kwargs.pop(p.name))
            except TypeError:
                pass  # signature mismatch: let func raise its own error
        idf_target = kwargs.get(target, None)
        if idf_target is None and len(args) > target_idx:
            idf_target = args[target_idx]
        if idf_target is None and target_idx < len(param_names):
            # bound under its real parameter name, which may differ from
            # the decorator's `target` label — fall back to position
            idf_target = kwargs.get(param_names[target_idx])
        cols_raw = kwargs.get(columns, "all")
        if isinstance(cols_raw, str):
            if cols_raw == "all":
                num_cols, cat_cols, _ = idf_target.attribute_type_segregation()
                cols = num_cols + cat_cols
            else:
                cols = [x.strip() for x in cols_raw.split("|")]
        elif isinstance(cols_raw, list):
            cols = cols_raw
        else:
            raise TypeError(
                f"'{columns}' must be either a string or a list of strings. Received {type(cols_raw)}."
            )
        drops_raw = kwargs.get(drop, [])
        if drops_raw is None:
            drops_raw = []
        if isinstance(drops_raw, str):
            drops = [x.strip() for x in drops_raw.split("|")]
        elif isinstance(drops_raw, list):
            drops = drops_raw
        else:
            raise TypeError(
                f"'{drop}' must be either a string or a list of strings. Received {type(drops_raw)}."
            )
        final_cols = list(set(e for e in cols if e not in drops))
        if not final_cols:
            raise ValueError(
                f"Empty set of columns is given. Columns to select: {cols}, columns to drop: {drops}."
            )
        missing = [x for x in final_cols if x not in idf_target.col_names]
        if missing:
            raise ValueError(f"Not all columns are in the input dataframe. Missing columns: {set(missing)}")
        kwargs[columns] = final_cols
        kwargs[drop] = []
        return func(*args, **kwargs)

    return validate


def check_distance_method(method_type: str) -> List[str]:
    """Normalize method_type (reference validations.py:71-94): a name, a
    pipe-list, or "all"."""
    all_methods = ["PSI", "HD", "JSD", "KS"]
    if isinstance(method_type, str):
        methods = all_methods if method_type == "all" else [m.strip() for m in method_type.split("|")]
    else:
        methods = list(method_type)
    bad = [m for m in methods if m not in all_methods]
    if bad:
        raise TypeError(f"Invalid input for method_type: {bad}")
    return methods


def compute_score(value: Optional[float], method_type: str, cv_thresholds=(0.03, 0.1, 0.2, 0.5)):
    """Map |CV| (or SD for binary) to a 0..4 stability score
    (reference validations.py:97-126)."""
    if value is None or value != value:  # None or NaN
        return None
    if method_type == "cv":
        cv = abs(value)
        for i, thresh in enumerate(cv_thresholds):
            if cv < thresh:
                return float([4, 3, 2, 1, 0][i])
        return 0.0
    if method_type == "sd":
        sd = value
        if sd <= 0.005:
            return 4.0
        if sd <= 0.01:
            return round(-100 * sd + 4.5, 1)
        if sd <= 0.05:
            return round(-50 * sd + 4, 1)
        if sd <= 0.1:
            return round(-30 * sd + 3, 1)
        return 0.0
    raise TypeError("method_type must be either 'cv' or 'sd'.")


def compute_si(metric_weightages: dict):
    """Weighted stability index factory (reference validations.py:129-150)."""

    def compute_si_(attr_type, mean_stddev, mean_cv, stddev_cv, kurtosis_cv):
        if attr_type == "Binary":
            mean_si = compute_score(mean_stddev, "sd")
            return [mean_si, None, None, mean_si]
        mean_si = compute_score(mean_cv, "cv")
        stddev_si = compute_score(stddev_cv, "cv")
        kurtosis_si = compute_score(kurtosis_cv, "cv")
        if mean_si is None or stddev_si is None or kurtosis_si is None:
            si = None
        else:
            si = round(
                mean_si * metric_weightages.get("mean", 0)
                + stddev_si * metric_weightages.get("stddev", 0)
                + kurtosis_si * metric_weightages.get("kurtosis", 0),
                4,
            )
        return [mean_si, stddev_si, kurtosis_si, si]

    return compute_si_


def check_metric_weightages(metric_weightages: dict) -> None:
    if (
        round(
            metric_weightages.get("mean", 0)
            + metric_weightages.get("stddev", 0)
            + metric_weightages.get("kurtosis", 0),
            3,
        )
        != 1
    ):
        raise ValueError(
            "Invalid input for metric weightages. Either metric name is incorrect or "
            "sum of metric weightages is not 1.0."
        )


def check_threshold(threshold) -> None:
    if (threshold < 0) or (threshold > 4):
        raise ValueError("Invalid input for metric threshold. It must be a number between 0 and 4.")
