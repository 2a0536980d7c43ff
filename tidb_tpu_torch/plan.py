"""The plan pieces the port's executors read, under the reference's names
(tidb_tpu/plan/plans.py:152 Join, :102 SortItem, :113 WindowFuncDesc;
tidb_tpu/expression/expression.py:52 Column, :153 Constant;
tidb_tpu/expression/aggregation.py:27 AggFunctionMode and the aggregate
function's name, args, mode and distinct). The port has no planner: these
are built by the caller, or carried from the reference's plan
(tidb_tpu_torch.carry). A row is evaluated only for a Column (its datum)
or a Constant (its value): the port has no row expression evaluator.
"""

from __future__ import annotations

import enum

from tidb_tpu_torch.types.datum import NULL, Datum
from tidb_tpu_torch.types.field_type import FieldType


class Column:
    """A column of an executor row: its offset and its type."""

    def __init__(self, index: int, ret_type: FieldType | None = None):
        self.index = index
        self.ret_type = ret_type

    def eval(self, row) -> Datum:
        return row[self.index]

    def __repr__(self):
        return f"Column({self.index})"


class Constant:
    def __init__(self, value: Datum):
        self.value = value

    def eval(self, row) -> Datum:
        return self.value

    def __repr__(self):
        return f"Constant({self.value!r})"


class Residual:
    """An expression the port cannot evaluate (it has no row expression
    evaluator yet): kept so that a plan holding one is refused, never
    answered without it."""

    def __init__(self, text: str):
        self.text = text

    def eval(self, row):
        from tidb_tpu_torch.ops.exprc import Unsupported
        raise Unsupported(f"{self.text} needs the row expression evaluator")

    def __repr__(self):
        return f"Residual({self.text})"


class Join:
    INNER, LEFT_OUTER, RIGHT_OUTER, SEMI, LEFT_OUTER_SEMI = range(5)

    def __init__(self, join_type: int):
        self.join_type = join_type
        self.eq_conditions: list = []      # (left Column, right Column)
        self.left_conditions: list = []
        self.right_conditions: list = []
        self.other_conditions: list = []


class AggFunctionMode(enum.IntEnum):
    COMPLETE = 0   # raw rows in, final value out
    FINAL = 1      # partial rows in, final value out


class AggFunc:
    """One aggregate function of a HashAgg: `name` (count, sum, avg, min,
    max, first_row, ...), its argument expressions, its mode, DISTINCT,
    and `empty`, its result over no row (0 for count, else NULL)."""

    def __init__(self, name: str, args: list,
                 mode: AggFunctionMode = AggFunctionMode.COMPLETE,
                 distinct: bool = False, empty: Datum | None = None):
        self.name = name
        self.args = args
        self.mode = mode
        self.distinct = distinct
        if empty is None:
            empty = Datum.i64(0) if name == "count" else NULL
        self.empty = empty


class SortItem:
    """One ORDER BY item: an expression and its direction."""

    __slots__ = ("expr", "desc")

    def __init__(self, expr, desc: bool = False):
        self.expr = expr
        self.desc = desc

    def __repr__(self):
        return f"{self.expr!r}{' desc' if self.desc else ''}"


class WindowFuncDesc:
    """One window call: its name, argument expressions, PARTITION BY
    expressions and ORDER BY SortItems, over the child's columns. The
    frame is MySQL's default: the whole partition, or with ORDER BY RANGE
    UNBOUNDED PRECEDING .. the current row's last peer."""

    __slots__ = ("name", "args", "partition_by", "order_by")

    def __init__(self, name: str, args: list, partition_by: list,
                 order_by: list):
        self.name = name
        self.args = args
        self.partition_by = partition_by
        self.order_by = order_by

    def __repr__(self):
        return (f"{self.name}({self.args!r}) over(partition:"
                f"{self.partition_by!r} order:{self.order_by!r})")
