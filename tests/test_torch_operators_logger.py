"""The port's ``core.operators`` and ``core.logger`` against the JAX
package's on the CPU: ``TestOperators`` mirrors ``tests/test_core.py``'s
and runs every operator of both packages on the same inputs (results
equal to float32 rounding); ``TestLogger`` holds the level vocabulary,
the callback sink and the trace-vector dump to the JAX package's."""

from __future__ import annotations

import importlib
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import operators as jop
from raft_tpu_torch import core as tcore
from raft_tpu_torch.core import operators as top

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

# the modules (both packages' ``core.logger`` names the Logger object)
jlog = importlib.import_module("raft_tpu.core.logger")
tlog = importlib.import_module("raft_tpu_torch.core.logger")

UNARY = ("identity_op", "sq_op", "abs_op", "sqrt_op", "nz_op")
BINARY = ("add_op", "sub_op", "mul_op", "div_op", "div_checkzero_op",
          "pow_op", "min_op", "max_op", "mod_op", "equal_op", "notequal_op",
          "greater_op", "less_op", "greater_or_equal_op",
          "less_or_equal_op")
CONST = ("add_const_op", "sub_const_op", "mul_const_op", "div_const_op",
         "pow_const_op")


def _inputs():
    rng = np.random.default_rng(0)
    a = rng.integers(-4, 5, 32).astype(np.float32)
    b = rng.integers(-4, 5, 32).astype(np.float32)
    b[:4] = 0.0
    return a, b


def _eq(got, want):
    np.testing.assert_allclose(np.asarray(got.numpy(), np.float64),
                               np.asarray(want, np.float64), rtol=1e-6,
                               atol=0, equal_nan=True)


class TestOperators:
    """core/operators.hpp functor vocabulary."""

    def test_basic_ops(self):
        x = torch.tensor(-3.0)
        assert float(top.sq_op(x)) == 9.0
        assert float(top.abs_op(x)) == 3.0
        assert float(top.nz_op(torch.tensor(0.0))) == 0.0
        assert float(top.compose_op(top.sqrt_op, top.sq_op)(x)) == 3.0
        assert float(top.div_checkzero_op(torch.tensor(4.0),
                                          torch.tensor(0.0))) == 0
        assert float(top.plug_const_op(2.0, top.pow_op)(torch.tensor(3.0))
                     ) == 9.0
        assert top.key_op((1, 2.5)) == 1 and top.value_op((1, 2.5)) == 2.5
        add3 = top.map_args_op(top.add_op, top.sq_op, top.identity_op)
        assert float(add3(torch.tensor(2.0), torch.tensor(1.0))) == 5.0
        assert top.void_op(1, 2) is None and top.const_op(7)(1, 2) == 7
        assert set(top.__all__) == set(jop.__all__)

    @pytest.mark.parametrize("name", UNARY)
    def test_unary(self, name):
        a, _ = _inputs()
        a = np.abs(a) if name == "sqrt_op" else a
        _eq(getattr(top, name)(torch.from_numpy(a)),
            getattr(jop, name)(jnp.asarray(a)))

    @pytest.mark.parametrize("name", BINARY)
    def test_binary(self, name):
        a, b = _inputs()
        if name == "pow_op":
            a = np.abs(a)
        if name in ("div_op", "mod_op"):
            b = np.where(b == 0, 3.0, b).astype(np.float32)
        _eq(getattr(top, name)(torch.from_numpy(a), torch.from_numpy(b)),
            getattr(jop, name)(jnp.asarray(a), jnp.asarray(b)))

    @pytest.mark.parametrize("name", CONST)
    def test_const(self, name):
        a, _ = _inputs()
        a = np.abs(a) + 1
        _eq(getattr(top, name)(2.0)(torch.from_numpy(a)),
            getattr(jop, name)(2.0)(jnp.asarray(a)))
        _eq(top.plug_const_op(2.0, top.sub_op, side="left")(
            torch.from_numpy(a)),
            jop.plug_const_op(2.0, jop.sub_op, side="left")(jnp.asarray(a)))

    def test_exported_from_core(self):
        assert tcore.operators is top
        assert tcore.LogLevel is tlog.LogLevel
        assert tcore.logger is tlog.logger


class TestLogger:
    def test_levels(self):
        assert [int(v) for v in tlog.LogLevel] == \
            [int(v) for v in jlog.LogLevel]
        assert {int(k): v for k, v in tlog._LEVEL_TO_PY.items()} == \
            {int(k): v for k, v in jlog._LEVEL_TO_PY.items()}
        old = tlog.logger.level
        try:
            for lvl in tlog.LogLevel:
                tlog.set_level(lvl)
                jold = jlog.logger.level
                jlog.set_level(int(lvl))
                assert int(tlog.get_level()) == int(jlog.get_level())
                jlog.logger.setLevel(jold)
        finally:
            tlog.logger.setLevel(old)
        # the port's logger is its own
        assert tlog.logger.name == "raft_tpu_torch"

    def test_callback_and_trace_vec(self):
        seen, jseen = [], []
        old = tlog.logger.level
        jold = jlog.logger.level
        tlog.set_callback(lambda lvl, msg: seen.append((lvl, msg)))
        jlog.set_callback(lambda lvl, msg: jseen.append((lvl, msg)))
        try:
            tlog.set_level(tlog.LogLevel.TRACE)
            jlog.set_level(jlog.LogLevel.TRACE)
            for mod in (tlog, jlog):
                mod.trace("t %d", 1)
                mod.debug("d")
                mod.info("i %s", "x")
                mod.warn("w")
                mod.error("e")
            v = np.linspace(0, 1, 40, dtype=np.float32)
            tlog.trace_vec("v", torch.from_numpy(v), limit=5)
            jlog.trace_vec("v", jnp.asarray(v), limit=5)
            assert seen == jseen and len(seen) == 6
            tlog.set_level(tlog.LogLevel.WARN)
            tlog.trace_vec("v", torch.from_numpy(v))   # below the level
            assert len(seen) == 6
        finally:
            tlog.set_callback(None)
            jlog.set_callback(None)
            tlog.logger.setLevel(old)
            jlog.logger.setLevel(jold)
        assert logging.getLogger("raft_tpu_torch") is tlog.logger
