"""raft_tpu_torch.fleet against the JAX package's ``tests/test_fleet.py``
(each of its test functions has a counterpart of the same name here) and
against ``raft_tpu.fleet`` itself.

Parity: :func:`plan_fleet` and :class:`FleetPlanner` tables serialize to
the JAX tables' bytes on the same signals (the fixture aggregators of the
two packages); :func:`placement_deltas` are equal; :func:`merge_fanout`
equals the JAX merge on the f32 and bf16 wires (ids exact, distances to
the bit); the router's decisions and answers on the device-free harness
equal the JAX router's, request by request.

The JAX ``TestRebalanceZeroRecompile::test_deltas_apply_with_zero_compiles``
does not pass on the reference side, so its case runs here on a port
tiered replica held to itself: planner deltas applied through
``tiered.apply_plan(..., executor=)`` add no executor entry after warmup,
and the served results stay bit-identical through the move.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import raft_tpu.fleet as jfleet
import tests.test_federation as jfed
import tests.test_torch_federation as tfed
from raft_tpu_torch import Resources
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.executor import SearchExecutor
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.fleet import (
    FleetPlanConfig,
    FleetPlanner,
    QueryRouter,
    ReplicaUnavailable,
    RouterConfig,
    RoutingTable,
    make_fleet,
    merge_fanout,
    placement_deltas,
    plan_fleet,
    route_payload_model,
)
from raft_tpu_torch.fleet import planner as planner_mod
from raft_tpu_torch.fleet import router as router_mod
from raft_tpu_torch.neighbors import ivf_flat, tiered
from raft_tpu_torch.neighbors.tiered import TieredSearchParams, build_tiered
from raft_tpu_torch.serving.harness import ManualClock

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

RES = Resources(device="cpu", seed=0)


def reset_fleet_metrics():
    for prefix in ("fleet.route.", "fleet.plan."):
        tracing.reset_counters(prefix)
        tracing.reset_gauges(prefix)


def full_table(replicas, n_lists, version=1, owners_alternate=True,
               generations=()):
    """Every replica hot for every list (owners round-robin) — the
    all-covered steering scenario."""
    names = sorted(replicas)
    assigns = []
    for lid in range(n_lists):
        order = names[lid % len(names):] + names[:lid % len(names)] \
            if owners_alternate else names
        assigns.append(tuple(order))
    return RoutingTable(version=version, label="ivf:0",
                        assignments=tuple(assigns),
                        counts=tuple([1] * n_lists),
                        generations=tuple(generations))


def _same(got, want):
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))


class TestRoutingTable:
    def test_round_trip_and_canonical_bytes(self):
        t = full_table(["r0", "r1"], 8, generations=(("r0", 3),))
        doc = json.loads(t.to_bytes().decode())
        back = RoutingTable.from_json(doc)
        assert back == t
        assert back.to_bytes() == t.to_bytes()
        assert t.generation_of("r0") == 3
        assert t.generation_of("r1") is None
        # the JAX table of the same content has the same bytes, and each
        # package parses the other's
        j = jfleet.RoutingTable.from_json(doc)
        assert j.to_bytes() == t.to_bytes()
        assert RoutingTable.from_json(j.to_json()) == t

    def test_unknown_format_refused(self):
        with pytest.raises(RaftError, match="format"):
            RoutingTable.from_json({"format": "bogus/9"})

    def test_covering_and_owners(self):
        t = RoutingTable(
            version=1, label="ivf:0",
            assignments=(("r0", "r1"), ("r1",), ("r0",)),
            counts=(5, 3, 1))
        assert t.owners() == ("r0", "r1", "r0")
        assert t.covering([0]) == ("r0", "r1")
        assert t.covering([0, 1]) == ("r1",)
        assert t.covering([0, 1, 2]) == ()
        assert t.covering([0], healthy=lambda n: n == "r0") == ("r0",)
        assert t.hot_lists("r1").tolist() == [0, 1]

    def test_cold_owned_is_not_hot_and_never_covered(self):
        t = RoutingTable(
            version=1, label="ivf:0",
            assignments=(("r0",), ("r0",)), counts=(9, 1),
            cold_owned=(1,))
        assert t.hot_lists("r0").tolist() == [0]
        assert t.covering([1]) == ()
        assert t.owner(1) == "r0"  # fan-out still has an owner
        assert RoutingTable.from_json(t.to_json()) == t

    def test_diff(self):
        a = RoutingTable(version=1, label="ivf:0",
                         assignments=(("r0",), ("r0",), ("r1",)),
                         counts=(1, 1, 1))
        b = RoutingTable(version=2, label="ivf:0",
                         assignments=(("r0",), ("r1",), ("r1",)),
                         counts=(1, 1, 1))
        assert b.diff(a) == {"r0": {"gain": [], "lose": [1]},
                             "r1": {"gain": [1], "lose": []}}
        assert b.diff(None)["r1"] == {"gain": [1, 2], "lose": []}


def _both_plans(counts, headroom, **kw):
    """(port table, JAX table) of the same signals and config."""
    cfg = kw.pop("config", None)
    t = plan_fleet(counts, headroom, config=cfg, **kw)
    j = jfleet.plan_fleet(counts, headroom, config=(
        None if cfg is None
        else jfleet.FleetPlanConfig(**dataclasses.asdict(cfg))), **kw)
    assert t.to_bytes() == j.to_bytes()
    return t


class TestPlanner:
    def headroom(self, n=4, room=1e6):
        return {f"r{i}": room for i in range(n)}

    def test_pure_and_byte_identical(self):
        counts = (np.arange(32)[::-1] ** 3).astype(np.int64)
        cfg = FleetPlanConfig(fallback_slots=12)
        a = _both_plans(counts, self.headroom(), label="ivf:0", version=5,
                        config=cfg)
        # same inputs, different dict insertion order
        rev = dict(reversed(list(self.headroom().items())))
        b = plan_fleet(list(counts), rev, label="ivf:0",
                       version=5, config=cfg)
        assert a.to_bytes() == b.to_bytes()

    def test_long_tail_owned_exactly_once(self):
        counts = np.ones(32, np.int64)
        t = _both_plans(counts, self.headroom(),
                        config=FleetPlanConfig(fallback_slots=8))
        assert all(len(names) == 1 for names in t.assignments)
        assert t.replicated_lists() == 0
        # ownership balances over the fleet
        sizes = [t.hot_lists(f"r{i}").size for i in range(4)]
        assert sizes == [8, 8, 8, 8]

    def test_hot_lists_replicate_by_traffic(self):
        counts = np.ones(32, np.int64)
        counts[3] = 10_000  # way past hot_share_ratio x uniform
        t = _both_plans(counts, self.headroom(),
                        config=FleetPlanConfig(fallback_slots=16))
        assert len(t.assignments[3]) == 4  # capped at fleet size
        assert t.replicated_lists() == 1
        tail = [lid for lid in range(32) if lid != 3]
        assert all(len(t.assignments[lid]) == 1 for lid in tail)

    def test_headroom_caps_capacity(self):
        counts = np.arange(16, 0, -1).astype(np.int64)
        # r1 reports half the headroom -> half the hot slots
        t = _both_plans(counts, {"r0": 8e6, "r1": 4e6},
                        config=FleetPlanConfig(list_bytes=10 ** 6,
                                               safety_fraction=0.0))
        assert t.hot_lists("r0").size == 8
        assert t.hot_lists("r1").size == 4
        # capacity exhausted -> the 4 coldest lists are cold-owned,
        # still owned exactly once
        assert len(t.cold_owned) == 4
        assert all(len(t.assignments[lid]) == 1 for lid in t.cold_owned)

    def test_unreported_headroom_falls_back(self):
        counts = np.ones(8, np.int64)
        t = _both_plans(counts, {"r0": None, "r1": None},
                        config=FleetPlanConfig(list_bytes=10 ** 6,
                                               fallback_slots=4))
        assert t.hot_lists("r0").size + t.hot_lists("r1").size == 8

    def test_placement_deltas_pair_and_stage(self):
        counts = np.zeros(8, np.int64)
        counts[[4, 5, 6]] = (30, 20, 10)
        t = _both_plans(counts, {"r0": None},
                        config=FleetPlanConfig(fallback_slots=3))
        assert t.hot_lists("r0").tolist() == [4, 5, 6]
        deltas = placement_deltas(
            t, {"r0": [0, 1, 4]}, max_swaps=2)
        d = deltas["r0"]
        # gains hottest-first (5 before 6), losses coldest-first,
        # pairs truncated to max_swaps, stage carries the full gain
        assert d.promotions == (5, 6)
        assert d.demotions == (0, 1)
        assert d.stage == (5, 6)
        assert d.width == 2
        one = placement_deltas(t, {"r0": [0, 1, 4]}, max_swaps=1)
        assert one["r0"].promotions == (5,)
        assert one["r0"].stage == (5, 6)

    def test_planner_versions_only_on_change(self):
        reset_fleet_metrics()
        agg = tfed.fixture_aggregator()
        agg.scrape()
        p = FleetPlanner(agg, label="ivf:0",
                         config=FleetPlanConfig(fallback_slots=4))
        t1 = p.plan()
        assert t1.version == 1
        t2 = p.plan()
        assert t2.version == 1  # steady fleet, no bump
        assert t2.to_bytes() == t1.to_bytes()
        assert tracing.get_counter(planner_mod.PLAN_BUILDS) == 2
        assert tracing.get_counter(planner_mod.PLAN_CHANGED) == 1
        # typed accessors, not dict parsing: the plane really is the
        # fixture sum (r0: 50/10 + r1 + r2 contributions)
        plane = agg.merged_probe_plane("ivf:0")
        assert sum(plane.counts) == sum(t1.counts)
        # the JAX planner over the JAX aggregator of the same fixtures
        jagg = jfed.fixture_aggregator()
        jagg.scrape()
        jt = jfleet.FleetPlanner(jagg, label="ivf:0",
                                 config=jfleet.FleetPlanConfig(
                                     fallback_slots=4)).plan()
        assert jt.to_bytes() == t1.to_bytes()

    def test_plan_generations_pin(self):
        counts = np.ones(4, np.int64)
        t = _both_plans(counts, {"r0": None}, generations={"r0": 7})
        assert t.generation_of("r0") == 7


class TestMergeWire:
    def test_f32_merge_of_disjoint_parts_is_exact(self):
        h = make_fleet(1)
        q = h.make_queries(6)
        lids = h.resolve_probes(q)
        ref_d, ref_i = h.solo(q, 10)
        half = len(lids) // 2
        parts = [h.executor.scan_lists(q, lids[:half], 10),
                 h.executor.scan_lists(q, lids[half:], 10)]
        d, i = merge_fanout(parts, 10, wire_dtype="f32")
        assert np.array_equal(np.asarray(d), ref_d)
        assert np.array_equal(np.asarray(i), ref_i)

    def test_payload_model_accounting(self):
        f32 = route_payload_model(64, 10, 4, "f32")
        bf16 = route_payload_model(64, 10, 4, "bf16")
        assert f32["merge_bytes"] == 4 * 64 * 10 * 8
        assert bf16["merge_bytes"] == 4 * 64 * 10 * 6
        assert bf16["per_leg_bytes"] == 64 * 10 * 6
        assert f32["wire_dtype"] == "f32"
        assert f32 == jfleet.route_payload_model(64, 10, 4, "f32")
        assert bf16 == jfleet.route_payload_model(64, 10, 4, "bf16")
        with pytest.raises(RaftError, match="wire_dtype"):
            route_payload_model(1, 1, 1, "f16")

    def test_bf16_recall_floor_at_four_replicas(self):
        h = make_fleet(4)
        t = plan_fleet(np.ones(h.executor.n_lists, np.int64),
                       {n: None for n in h.replicas}, label="ivf:0",
                       version=1)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock,
                        config=RouterConfig(merge_wire_dtype="bf16"))
        assert r.apply_table(t)
        hits = total = 0
        for start in range(0, 512, 16):
            q = h.make_queries(16, start)
            ref_d, ref_i = h.solo(q, 10)
            d, i, dec = r.route(q, 10)
            assert dec.mode == "fanout"
            # ids stay exact int32 whatever the distance wire
            assert np.asarray(i).dtype == np.int32
            for row in range(q.shape[0]):
                hits += len(set(ref_i[row].tolist())
                            & set(np.asarray(i)[row].tolist()))
                total += 10
        assert hits / total >= 0.99


class TestMergeParity:
    """:func:`merge_fanout` against the JAX merge on the same legs."""

    @pytest.mark.parametrize("wire", ["f32", "bf16"])
    @pytest.mark.parametrize("select_min", [True, False])
    def test_equals_jax_on_both_wires(self, wire, select_min):
        h = make_fleet(1, n_lists=48, list_size=6)
        q = h.make_queries(20, 7)
        parts = [h.executor.scan_lists(q, lids, 12)
                 for lids in ((0, 5, 9), (1, 2, 47), (30,), (11, 12, 13))]
        if not select_min:
            parts = [(-d, i) for d, i in parts]
        wd, wi = jfleet.merge_fanout(parts, 12, wire_dtype=wire,
                                     select_min=select_min)
        gd, gi = merge_fanout(parts, 12, wire_dtype=wire,
                              select_min=select_min)
        assert gi.dtype == torch.int32 and gd.dtype == torch.float32
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))

    @pytest.mark.parametrize("wire", ["f32", "bf16"])
    def test_tensor_parts_stay_on_their_device_and_merge_alike(self, wire):
        rng = np.random.default_rng(4)
        parts = [(np.sort(rng.integers(0, 40, (9, 8)).astype(np.float32)
                          + rng.random((9, 8)).astype(np.float32), axis=1),
                  rng.integers(0, 500, (9, 8)).astype(np.int32))
                 for _ in range(3)]
        parts[1][0][:, -2:] = np.inf
        parts[1][1][:, -2:] = -1
        want = merge_fanout(parts, 8, wire_dtype=wire)
        tens = [(torch.as_tensor(d), torch.as_tensor(i)) for d, i in parts]
        got = merge_fanout(tens, 8, wire_dtype=wire)
        assert got[0].device == tens[0][0].device
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        jd, ji = jfleet.merge_fanout(parts, 8, wire_dtype=wire)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jd))


class TestRouter:
    def setup_method(self):
        reset_fleet_metrics()

    def test_steered_bit_identical_to_solo(self):
        h = make_fleet(3)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        assert r.apply_table(
            full_table(h.replicas, h.executor.n_lists))
        for start in (0, 40, 90):
            q = h.make_queries(8, start)
            ref_d, ref_i = h.solo(q, 10)
            d, i, dec = r.route(q, 10)
            assert dec.mode == "steer"
            assert np.array_equal(np.asarray(d), ref_d)
            assert np.array_equal(np.asarray(i), ref_i)
        # steer load-balances deterministically over coverage
        seen = {r.route(h.make_queries(4), 10)[2].replica
                for _ in range(3)}
        assert len(seen) == 3

    def test_fanout_f32_bit_identical_to_solo(self):
        h = make_fleet(4)
        t = plan_fleet(np.ones(h.executor.n_lists, np.int64),
                       {n: None for n in h.replicas}, label="ivf:0",
                       version=1)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        assert r.apply_table(t)
        for start in (0, 16, 200):
            for rep in h.replicas.values():
                rep.calls.clear()
            q = h.make_queries(12, start)
            ref_d, ref_i = h.solo(q, 10)
            d, i, dec = r.route(q, 10)
            assert dec.mode == "fanout"
            assert dec.fallback == "uncovered"
            assert dec.legs > 1
            assert np.array_equal(np.asarray(d), ref_d)
            assert np.array_equal(np.asarray(i), ref_i)
            # each probed list scanned exactly once across the legs
            scanned = []
            for rep in h.replicas.values():
                for _, lists in rep.calls:
                    scanned.extend(lists)
            assert len(scanned) == len(set(scanned))

    def test_single_replica_passthrough(self):
        h = make_fleet(1)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        q = h.make_queries(5)
        ref_d, ref_i = h.solo(q, 10)
        d, i, dec = r.route(q, 10)  # no table needed, no fan-out
        assert dec.mode == "passthrough"
        assert dec.replica == "r0"
        assert np.array_equal(np.asarray(d), ref_d)
        assert np.array_equal(np.asarray(i), ref_i)

    def test_no_table_fans_out_bit_identical(self):
        h = make_fleet(3)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        q = h.make_queries(6)
        ref_d, ref_i = h.solo(q, 10)
        d, i, dec = r.route(q, 10)
        assert dec.mode == "fanout" and dec.fallback == "no_table"
        assert np.array_equal(np.asarray(d), ref_d)
        assert np.array_equal(np.asarray(i), ref_i)

    def test_generation_skew_falls_back_bit_identical(self):
        h = make_fleet(2)
        # the table pins generations; r0 then rebalances (gen bump)
        t = full_table(h.replicas, h.executor.n_lists,
                       generations=(("r0", 0), ("r1", 0)))
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        assert r.apply_table(t)
        h.replicas["r0"].generation = 1
        h.replicas["r1"].generation = 1
        q = h.make_queries(6)
        ref_d, ref_i = h.solo(q, 10)
        c0 = tracing.get_counter(router_mod.ROUTE_SKEW)
        d, i, dec = r.route(q, 10)
        assert dec.mode == "fanout"
        assert dec.fallback == "generation_skew"
        assert tracing.get_counter(router_mod.ROUTE_SKEW) == c0 + 1
        assert np.array_equal(np.asarray(d), ref_d)
        assert np.array_equal(np.asarray(i), ref_i)
        # matching generations steer again
        h.replicas["r0"].generation = 0
        h.replicas["r1"].generation = 0
        assert r.route(q, 10)[2].mode == "steer"

    def test_inflight_death_retries_on_survivor(self):
        h = make_fleet(2)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        assert r.apply_table(
            full_table(h.replicas, h.executor.n_lists))
        q = h.make_queries(6)
        ref_d, ref_i = h.solo(q, 10)
        first = r.route(q, 10)[2].replica  # deterministic pick
        other = "r1" if first == "r0" else "r0"
        h.replicas[other].fail_results(1)  # dies mid-flight next
        c0 = tracing.get_counter(router_mod.ROUTE_RETRIES)
        d, i, dec = r.route(q, 10)
        assert dec.mode == "fanout" and dec.fallback == "retry"
        assert tracing.get_counter(router_mod.ROUTE_RETRIES) == c0 + 1
        assert np.array_equal(np.asarray(d), ref_d)
        assert np.array_equal(np.asarray(i), ref_i)
        # the dead replica stays avoided until a fresh table arrives
        assert r.route(q, 10)[2].replica == first

    def test_fanout_leg_death_retries_on_survivor(self):
        h = make_fleet(3)
        t = plan_fleet(np.ones(h.executor.n_lists, np.int64),
                       {n: None for n in h.replicas}, label="ivf:0",
                       version=1)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        assert r.apply_table(t)
        q = h.make_queries(6)
        ref_d, ref_i = h.solo(q, 10)
        h.replicas["r1"].fail_results(1)
        d, i, dec = r.route(q, 10)
        assert dec.mode == "fanout"
        assert np.array_equal(np.asarray(d), ref_d)
        assert np.array_equal(np.asarray(i), ref_i)

    def test_whole_fleet_dead_is_typed(self):
        h = make_fleet(2)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        for rep in h.replicas.values():
            rep.kill()
        with pytest.raises(ReplicaUnavailable):
            r.route(h.make_queries(2), 5)

    def test_health_gate_excludes_stale_replicas(self):
        h = make_fleet(2)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock,
                        health=lambda: {"r0": False})
        assert r.apply_table(
            full_table(h.replicas, h.executor.n_lists))
        q = h.make_queries(4)
        for _ in range(3):  # never steered to the unhealthy replica
            d, i, dec = r.route(q, 10)
            assert dec.replica == "r1"
        assert h.replicas["r0"].calls == []

    def test_stale_table_refused(self):
        h = make_fleet(2)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        t5 = full_table(h.replicas, h.executor.n_lists, version=5)
        assert r.apply_table(t5)
        assert not r.apply_table(
            full_table(h.replicas, h.executor.n_lists, version=5))
        assert not r.apply_table(
            full_table(h.replicas, h.executor.n_lists, version=4))
        assert r.table.version == 5
        assert r.apply_table(
            full_table(h.replicas, h.executor.n_lists, version=6))

    def test_gauges_publish(self):
        reset_fleet_metrics()
        tracing.reset_gauges("fleet.route.")
        h = make_fleet(2)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        assert r.apply_table(
            full_table(h.replicas, h.executor.n_lists, version=3))
        h.clock.advance(2.5)
        r.route(h.make_queries(4), 10)
        r.publish_gauges()
        g = tracing.gauges()
        assert g["fleet.route.coverage_rate"] == 1.0
        assert g["fleet.route.fanout_fraction"] == 0.0
        assert g["fleet.route.table_version"] == 3.0
        assert g["fleet.route.table_age_s"] == 2.5
        assert g["fleet.route.replica.r0.steered"] \
            + g["fleet.route.replica.r1.steered"] == 1.0


def _jax_full_table(replicas, n_lists, **kw):
    return jfleet.RoutingTable.from_json(
        full_table(replicas, n_lists, **kw).to_json())


class TestRouterParity:
    """The port router and the JAX router over twin harnesses: the same
    decision and the same answer, request by request, through steering,
    fan-out, skew, in-flight death and a dead fleet."""

    @pytest.mark.parametrize("wire", ["f32", "bf16"])
    def test_decisions_and_answers_equal_jax(self, wire):
        h, jh = make_fleet(4), jfleet.make_fleet(4)
        counts = np.ones(h.executor.n_lists, np.int64)
        counts[list(h.resolve_probes(h.make_queries(2)))] = 5_000
        table = plan_fleet(counts, {n: None for n in h.replicas},
                           label="ivf:0", version=1,
                           generations={"r2": 0})
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock,
                        config=RouterConfig(merge_wire_dtype=wire))
        jr = jfleet.QueryRouter(jh.replicas, resolve_probes=jh.resolve_probes,
                                clock=jh.clock,
                                config=jfleet.RouterConfig(
                                    merge_wire_dtype=wire))
        assert r.apply_table(table)
        assert jr.apply_table(table.to_json())
        script = [(0, 2), (0, 2), (9, 4), (100, 8), (0, 2), (33, 3)]
        for step, (start, rows) in enumerate(script):
            if step == 3:       # r2 rebalances: skew
                h.replicas["r2"].generation = jh.replicas["r2"].generation = 1
            if step == 4:       # a leg dies in flight
                h.replicas["r1"].fail_results(1)
                jh.replicas["r1"].fail_results(1)
            q = h.make_queries(rows, start)
            d, i, dec = r.route(q, 10)
            jd, ji, jdec = jr.route(q, 10)
            assert dataclasses.asdict(dec) == dataclasses.asdict(jdec)
            _same((d, i), (jd, ji))
        assert r.snapshot() == jr.snapshot()
        for rep in list(h.replicas.values()) + list(jh.replicas.values()):
            rep.kill()
        with pytest.raises(ReplicaUnavailable):
            r.route(h.make_queries(2), 5)
        with pytest.raises(jfleet.ReplicaUnavailable):
            jr.route(jh.make_queries(2), 5)


class TestRouteExporter:
    def test_route_json_push_and_metrics(self):
        from raft_tpu_torch.serving import MetricsExporter

        h = make_fleet(2)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        exporter = MetricsExporter(route=r)
        port = exporter.start()
        base = f"http://127.0.0.1:{port}"
        try:
            # no table yet -> 404, like every unarmed endpoint
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + "/route.json")
            assert e.value.code == 404
            t = full_table(h.replicas, h.executor.n_lists, version=2)
            req = urllib.request.Request(
                base + "/push?route=1",
                data=t.to_bytes(), method="POST")
            with urllib.request.urlopen(req) as resp:
                assert json.load(resp) == {"applied": True}
            doc = json.load(
                urllib.request.urlopen(base + "/route.json"))
            assert doc["version"] == 2
            assert RoutingTable.from_json(doc) == t
            # duplicate push is stale -> 409 (idempotent channel)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(
                    base + "/push?route=1", data=t.to_bytes(),
                    method="POST"))
            assert e.value.code == 409
            # garbage -> 400, typed
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(
                    base + "/push?route=1", data=b'{"format":"x"}',
                    method="POST"))
            assert e.value.code == 400
            r.route(h.make_queries(4), 10)
            text = urllib.request.urlopen(
                base + "/metrics").read().decode()
            assert "# HELP fleet_route_coverage_rate" in text
            assert 'fleet_route_replica_steered{replica="r0"}' \
                in text or \
                'fleet_route_replica_steered{replica="r1"}' in text
        finally:
            exporter.close()

    def test_route_push_without_router_404(self):
        from raft_tpu_torch.serving import MetricsExporter

        exporter = MetricsExporter()
        port = exporter.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/push?route=1",
                    data=b"{}", method="POST"))
            assert e.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/route.json")
            assert e.value.code == 404
        finally:
            exporter.close()


class TestRebalanceZeroRecompile:
    """Planner deltas ride the fixed-width swap contract: rebalancing a
    live tiered replica adds no executor entry after warmup, and serving
    results stay bit-identical through the move."""

    def test_deltas_apply_with_zero_compiles(self):
        rng = np.random.default_rng(21)
        x = rng.standard_normal((2048, 32)).astype(np.float32)
        q = rng.standard_normal((16, 32)).astype(np.float32)
        flat = ivf_flat.build(
            RES, ivf_flat.IvfFlatIndexParams(n_lists=32,
                                             kmeans_n_iters=6), x)
        t = build_tiered(flat, hot_fraction=0.5)
        width = 4
        cfg = FleetPlanConfig(fallback_slots=int(t.hot_lists.size),
                              max_swaps=width)
        p = TieredSearchParams(n_probes=8)
        ex = SearchExecutor(RES)
        ex.warmup(t, buckets=(16,), k=10, params=p)
        d_ref, i_ref = ex.search(t, q, 10, params=p)
        # tiered is bit-identical to the all-device index
        want = ivf_flat.search(RES, ivf_flat.IvfFlatSearchParams(n_probes=8),
                               flat, q, 10)
        assert torch.equal(d_ref, want[0]) and torch.equal(i_ref, want[1])

        def epoch(counts):
            table = plan_fleet(counts, {"r0": None}, label="ivf:0",
                               version=1, config=cfg)
            delta = placement_deltas(
                table, {"r0": t.hot_lists.tolist()},
                max_swaps=width)["r0"]
            jtable = jfleet.plan_fleet(
                counts, {"r0": None}, label="ivf:0", version=1,
                config=jfleet.FleetPlanConfig(**dataclasses.asdict(cfg)))
            assert dataclasses.asdict(delta) == dataclasses.asdict(
                jfleet.placement_deltas(jtable, {"r0": t.hot_lists.tolist()},
                                        max_swaps=width)["r0"])
            return tiered.apply_plan(
                t, list(delta.promotions), list(delta.demotions),
                width=width, executor=ex)

        # one epoch first, then demand silence
        counts = np.zeros(32, np.int64)
        counts[np.asarray(t.cold_lists[:2])] = (100, 90)
        epoch(counts)
        ex.search(t, q, 10, params=p)
        c0 = ex.stats.compile_count
        g0 = t.generation
        for hot_lid in (3, 11, 27):
            counts = np.zeros(32, np.int64)
            counts[hot_lid] = 1000
            ex.search(t, q, 10, params=p)
            epoch(counts)
            d2, i2 = ex.search(t, q, 10, params=p)
            # the planner's target went hot on the replica
            assert hot_lid in t.hot_lists
            assert torch.equal(d2, d_ref) and torch.equal(i2, i_ref)
        assert ex.stats.compile_count - c0 == 0, \
            "fleet rebalance must not add an executor entry"
        assert t.generation > g0

    def test_stage_hints_feed_prefetcher_shape(self):
        """The delta's stage hint is promotions-compatible: ordered
        hottest-first, a superset of the paired promotions."""
        counts = np.zeros(16, np.int64)
        counts[[8, 9, 10, 11]] = (40, 30, 20, 10)
        table = plan_fleet(counts, {"r0": None},
                           config=FleetPlanConfig(fallback_slots=4))
        d = placement_deltas(table, {"r0": [0, 1, 2, 3]},
                             max_swaps=2)["r0"]
        assert d.stage[:len(d.promotions)] == d.promotions
        assert set(d.promotions) <= set(d.stage)
        assert d.stage == (8, 9, 10, 11)


class TestPlannerRouterLoop:
    """Planner -> table -> router, converging under skewed traffic:
    covered hot traffic steers, the tail fans out, and a re-plan
    under the same signals is a no-op (stable version)."""

    def test_skewed_traffic_steers_after_replan(self):
        h = make_fleet(2, n_probes=2)
        nl = h.executor.n_lists
        # traffic concentrated on the lists queries 0..1 probe
        hot = sorted(h.resolve_probes(h.make_queries(2)))
        counts = np.ones(nl, np.int64)
        counts[hot] = 50_000
        t = _both_plans(counts, {n: None for n in h.replicas},
                        label="ivf:0", version=1,
                        config=FleetPlanConfig(fallback_slots=nl))
        # hot lists replicated fleet-wide -> hot queries covered
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        assert r.apply_table(t)
        q_hot = h.make_queries(2)
        ref = h.solo(q_hot, 10)
        d, i, dec = r.route(q_hot, 10)
        assert dec.mode == "steer"
        assert np.array_equal(np.asarray(d), ref[0])
        assert np.array_equal(np.asarray(i), ref[1])
        # tail traffic fans out, still exact
        q_tail = h.make_queries(4, start=9)
        ref = h.solo(q_tail, 10)
        d, i, dec = r.route(q_tail, 10)
        assert np.array_equal(np.asarray(d), ref[0])
        assert np.array_equal(np.asarray(i), ref[1])
        # same signals -> byte-identical re-plan (no version bump
        # needed; stale push refused)
        t2 = plan_fleet(counts, {n: None for n in h.replicas},
                        label="ivf:0", version=1,
                        config=FleetPlanConfig(fallback_slots=nl))
        assert t2.to_bytes() == t.to_bytes()
        assert not r.apply_table(t2)


class TestTypedAccessors:
    """The planner-facing FleetAggregator surface."""

    def test_merged_probe_plane_matches_fixture_sum(self):
        reset_fleet_metrics()
        agg = tfed.fixture_aggregator()
        agg.scrape()
        view = agg.merged_probe_plane("ivf:0")
        want = None
        for name in ("r0", "r1", "r2"):
            plane = tfed.load_replica(name)["federation"][
                "probe_planes"].get("ivf:0")
            if plane is None:
                continue
            want = plane if want is None else \
                [a + b for a, b in zip(want, plane)]
        assert list(view.counts) == want
        assert view.stale_replicas == ()
        assert agg.probe_plane_labels() == ("ivf:0",)
        with pytest.raises(LookupError):
            agg.merged_probe_plane("nope:0")

    def test_staleness_metadata(self):
        reset_fleet_metrics()
        clock = ManualClock()
        agg = tfed.fixture_aggregator(clock=clock)
        agg.scrape()
        assert all(h.healthy for h in agg.replica_headroom())
        clock.advance(agg.config.staleness_s + 1.0)
        views = agg.replica_headroom()
        assert all(not h.healthy for h in views)
        # stale -> no headroom evidence, but age is reported
        assert all(h.headroom_bytes is None for h in views)
        assert all(h.age_s > agg.config.staleness_s for h in views)
        # the plane keeps stale last-known contributions, flagged
        plane = agg.merged_probe_plane("ivf:0")
        assert set(plane.stale_replicas) == set(plane.replicas)
        assert agg.replica_health() == {
            "r0": False, "r1": False, "r2": False}

    def test_headroom_values_are_typed(self):
        reset_fleet_metrics()
        agg = tfed.fixture_aggregator()
        agg.scrape()
        by_name = {h.name: h for h in agg.replica_headroom()}
        assert by_name["r0"].headroom_bytes == 2_000_000.0
        assert by_name["r0"].push is False
        assert sorted(by_name) == ["r0", "r1", "r2"]


class TestFleetHarness:
    def test_engine_is_deterministic_and_tie_ranked(self):
        h = make_fleet(1)
        q = h.make_queries(4)
        a = h.executor.scan_lists(q, [0, 1, 2], 6)
        b = h.executor.scan_lists(q, [0, 1, 2], 6)
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[1], b[1])
        # the JAX harness's engine gives the same blocks
        j = jfleet.make_fleet(1).executor.scan_lists(q, [0, 1, 2], 6)
        assert np.array_equal(a[0], j[0]) and np.array_equal(a[1], j[1])
        # distances ascend, ids valid, padding contract
        d, i = h.executor.scan_lists(q, [0], 10)
        assert (np.diff(d[:, :8], axis=1) >= 0).all()
        assert (i[:, 8:] == -1).all() and np.isinf(d[:, 8:]).all()

    def test_replica_scripting(self):
        h = make_fleet(2)
        rep = h.replicas["r0"]
        handle = rep.submit(h.make_queries(2), 5, lists=(0, 1))
        rep.kill()
        with pytest.raises(ReplicaUnavailable):
            handle.result()  # lazy: death lands on the in-flight leg
        rep.revive()
        d, i = rep.submit(h.make_queries(2), 5, lists=(0, 1)).result()
        assert d.shape == (2, 5)

    def test_router_rejects_empty_fleet(self):
        with pytest.raises(RaftError):
            QueryRouter({}, resolve_probes=lambda q: (0,))

    def test_decision_is_frozen_evidence(self):
        h = make_fleet(2)
        r = QueryRouter(h.replicas, resolve_probes=h.resolve_probes,
                        clock=h.clock)
        dec = r.route(h.make_queries(2), 5)[2]
        with pytest.raises(dataclasses.FrozenInstanceError):
            dec.mode = "steer"


def test_package_exports_the_jax_names():
    import raft_tpu_torch.fleet as tfleet

    assert tfleet.__all__ == jfleet.__all__
    assert all(hasattr(tfleet, n) for n in tfleet.__all__)
