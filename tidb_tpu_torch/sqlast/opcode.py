"""Operator codes of the coprocessor protocol (copy of
tidb_tpu/sqlast/opcode.py; the values are the wire contract)."""

from __future__ import annotations

import enum


class Op(enum.IntEnum):
    # logic
    AndAnd = 1
    OrOr = 2
    Not = 3
    Xor = 4
    # comparison
    EQ = 10
    NE = 11
    LT = 12
    LE = 13
    GT = 14
    GE = 15
    NullEQ = 16     # <=>
    # arithmetic
    Plus = 20
    Minus = 21
    Mul = 22
    Div = 23
    IntDiv = 24
    Mod = 25
    # bit
    BitAnd = 30
    BitOr = 31
    BitXor = 32
    LeftShift = 33
    RightShift = 34
    BitNeg = 35
    # unary
    UnaryNot = 40
    UnaryMinus = 41
    UnaryPlus = 42

    def sql(self) -> str:
        return _SQL[self]


_SQL = {
    Op.AndAnd: "AND", Op.OrOr: "OR", Op.Not: "NOT", Op.Xor: "XOR",
    Op.EQ: "=", Op.NE: "!=", Op.LT: "<", Op.LE: "<=", Op.GT: ">", Op.GE: ">=",
    Op.NullEQ: "<=>",
    Op.Plus: "+", Op.Minus: "-", Op.Mul: "*", Op.Div: "/", Op.IntDiv: "DIV",
    Op.Mod: "%",
    Op.BitAnd: "&", Op.BitOr: "|", Op.BitXor: "^", Op.LeftShift: "<<",
    Op.RightShift: ">>", Op.BitNeg: "~",
    Op.UnaryNot: "NOT", Op.UnaryMinus: "-", Op.UnaryPlus: "+",
}
