"""The port's ``expression_parser`` guard: the AST whitelist blocks the
same eval escapes as the JAX package's (``tests/test_expression_security.py``,
case for case), and the same legitimate expressions work."""

import pandas as pd
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401


@pytest.fixture()
def t():
    from anovos_tpu_torch.shared.table import Table

    return Table.from_pandas(pd.DataFrame({"x": [1.0, 2.0, 3.0]}), device="cpu")


@pytest.mark.parametrize(
    "expr",
    [
        "__import__('os').system('id')",
        "().__class__.__mro__",           # dunder chain escape
        "x.__class__",
        "(lambda: 1)()",
        "[y for y in [1]]",
        "open('/etc/passwd')",
        "exec('pwn=1')",
        "getattr(x, 'shape')",
        "'a' + 'b'",                      # non-numeric constants
        "log(x, base=2)",                 # keyword smuggling
        "x + 9**9**9**9",                 # constant bignum bomb
        "x + 1e300",                      # oversized constant
        "(x, x)",                         # tuple → shape-corrupt column
        "x and x",                        # tensor truthiness is ambiguous
        "x.exp()",                        # tensor method call
        "{'a': x}",                       # container
        "y",                              # unknown identifier
    ],
)
def test_escapes_blocked(t, expr):
    from anovos_tpu_torch.data_transformer.transformers import expression_parser

    with pytest.raises(ValueError):
        expression_parser(t, [expr])


def test_legitimate_expressions_work(t):
    from anovos_tpu_torch.data_transformer.transformers import expression_parser

    out = expression_parser(t, "log(x) + 1.5|sqrt(x) * 2").to_pandas()
    assert "log(x) + 1.5" in out.columns and "sqrt(x) * 2" in out.columns
    out2 = expression_parser(t, ["x > 1.5"]).to_pandas()
    assert out2["x > 1.5"].tolist() == [0.0, 1.0, 1.0]
    out3 = expression_parser(t, ["(x > 1.5) & (x < 2.5)"]).to_pandas()
    assert out3["(x > 1.5) & (x < 2.5)"].tolist() == [0.0, 1.0, 0.0]
    out4 = expression_parser(t, ["2 ** x"]).to_pandas()
    assert out4["2 ** x"].tolist() == [2.0, 4.0, 8.0]
