"""Composable element-wise operators — port of ``raft_tpu/core/
operators.py`` (reference ``core/operators.hpp``: ``sq_op``, ``add_op``,
``key_op``...), the lambda vocabulary the linalg map/reduce entries take.
Each is a plain callable over tensors (or Python numbers, which the
tensor-valued ones take as 0-d CPU tensors).
"""

from __future__ import annotations

import torch

__all__ = [
    "identity_op", "void_op", "sq_op", "abs_op", "sqrt_op", "nz_op",
    "add_op", "sub_op", "mul_op", "div_op", "div_checkzero_op",
    "pow_op", "min_op", "max_op", "mod_op", "equal_op", "notequal_op",
    "greater_op", "less_op", "greater_or_equal_op", "less_or_equal_op",
    "const_op", "plug_const_op", "add_const_op", "sub_const_op",
    "mul_const_op", "div_const_op", "pow_const_op",
    "key_op", "value_op", "compose_op", "map_args_op",
]


def _t(x):
    return torch.as_tensor(x)


def identity_op(x, *_):
    return x


def void_op(*_):
    return None


def sq_op(x, *_):
    return x * x


def abs_op(x, *_):
    return torch.abs(_t(x))


def sqrt_op(x, *_):
    return torch.sqrt(_t(x))


def nz_op(x, *_):
    """1 where nonzero else 0 (``nz_op``)."""
    x = _t(x)
    return (x != 0).to(x.dtype)


def add_op(a, b):
    return a + b


def sub_op(a, b):
    return a - b


def mul_op(a, b):
    return a * b


def div_op(a, b):
    return a / b


def div_checkzero_op(a, b):
    """a / b, 0 where b == 0 (``div_checkzero_op``)."""
    b = _t(b)
    safe = a / torch.where(b == 0, torch.ones_like(b), b)
    return torch.where(b == 0, torch.zeros_like(safe), safe)


def pow_op(a, b):
    return torch.pow(_t(a), b)


def min_op(a, b):
    return torch.minimum(_t(a), _t(b))


def max_op(a, b):
    return torch.maximum(_t(a), _t(b))


def mod_op(a, b):
    """Floor modulo, the sign of ``b`` (``jnp.mod``)."""
    return torch.remainder(_t(a), b)


def equal_op(a, b):
    return a == b


def notequal_op(a, b):
    return a != b


def greater_op(a, b):
    return a > b


def less_op(a, b):
    return a < b


def greater_or_equal_op(a, b):
    return a >= b


def less_or_equal_op(a, b):
    return a <= b


def key_op(kvp, *_):
    """First element of a (key, value) pair (``argmin_op``/``key_op``)."""
    return kvp[0]


def value_op(kvp, *_):
    return kvp[1]


def const_op(value):
    """Ignore inputs, return ``value`` (``const_op``)."""
    return lambda *_: value


def plug_const_op(value, op, side: str = "right"):
    """Bind one operand of a binary op (``plug_const_op``)."""
    if side == "right":
        return lambda x, *_: op(x, value)
    return lambda x, *_: op(value, x)


def add_const_op(value):
    return plug_const_op(value, add_op)


def sub_const_op(value):
    return plug_const_op(value, sub_op)


def mul_const_op(value):
    return plug_const_op(value, mul_op)


def div_const_op(value):
    return plug_const_op(value, div_op)


def pow_const_op(value):
    return plug_const_op(value, pow_op)


def compose_op(*ops):
    """Apply ops innermost-last: ``compose_op(f, g)(x) == f(g(x))``
    (``compose_op``)."""

    def composed(*args):
        out = ops[-1](*args)
        for op in reversed(ops[:-1]):
            out = op(out)
        return out

    return composed


def map_args_op(op, *arg_ops):
    """Feed each argument through its own unary op before ``op``
    (``map_args_op``)."""

    def mapped(*args):
        return op(*(f(a) for f, a in zip(arg_ops, args)))

    return mapped
