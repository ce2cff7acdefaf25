"""The port's cross-match engine held against the JAX reference's.

Both engines get the same catalog and trace: the reference makes them,
and the port receives them as plain arrays (``catalog_from_arrays``,
``queries_from_records``).  Decision logs must be identical (the
reference's golden-trace encoder is duck-typed, so it reads the port's
outcomes too); per-query results must agree under the join contract of
``test_torch_kernels_cuda``.  The two cross-match goldens replay
bit-identically through the port's engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import replay  # noqa: E402
from repro import crossmatch as jcm  # noqa: E402
from repro_torch import crossmatch as tcm  # noqa: E402
from repro_torch.core import sfc as tsfc  # noqa: E402
from repro_torch.core.workload import Query  # noqa: E402
from test_torch_kernels_cuda import DOT_TOL  # noqa: E402

OBJECTS_PER_BUCKET, LEVEL = 200, 7


@pytest.fixture(scope="module")
def catalogs():
    """The reference's ``test_crossmatch_engine`` catalog, and the port's
    built from its arrays."""
    ref = jcm.make_catalog(
        n_objects=8_000, objects_per_bucket=OBJECTS_PER_BUCKET,
        htm_level=LEVEL, seed=5,
    )
    port = tcm.catalog_from_arrays(
        ref.positions, ref.mags, OBJECTS_PER_BUCKET, LEVEL
    )
    return ref, port


def _records(trace):
    return [dataclasses.asdict(q) for q in trace]


def _trace(ref_cat, n=16, seed=13, predicates=False):
    trace = jcm.make_trace(
        ref_cat, jcm.TraceConfig(n_queries=n, arrival_rate=2.0,
                                 objects_median=60, seed=seed),
    )
    if predicates:
        rng = np.random.default_rng(seed)
        for q in trace:
            q.meta["radius"] = float(rng.choice([2e-3, 4e-3, 8e-3]))
            q.meta["mag_cut"] = float(rng.choice([23.0, 24.0, 25.0]))
    return trace


def _run(engine, queries):
    rec = replay.TraceRecorder()
    engine.loop.add_round_tap(rec)
    results = engine.run(queries)
    return rec.entries, results


def _rows(cat, results):
    """{(query, bucket, probe): (match_obj, best_dot, n_cand)}."""
    bucket_of = np.empty(cat.n_objects, np.int64)
    for b in range(cat.n_buckets):
        bucket_of[cat.partitioner.object_slice(b)] = b
    out = {}
    for qid, groups in results.items():
        for r in groups:
            for p, mo, d, c in zip(r.probe_idx, r.match_obj, r.best_dot,
                                   r.n_candidates):
                key = (int(qid), int(bucket_of[mo]), int(p))
                assert key not in out
                out[key] = (int(mo), np.float32(d), int(c))
    return out


def assert_results_close(cat, trace, got, want, radius=4e-3):
    """Per-query results agree under the join contract: best_dot within
    ``DOT_TOL``; match_obj equal unless its dot ties the other's within
    ``DOT_TOL``; n_cand equal unless a pair lies within ``DOT_TOL`` of the
    query's threshold (cos of its own radius, else ``radius``).  A row on
    one side only needs a tie (the mag cut then reads another object) or
    a pair at the threshold."""
    assert set(got) == set(want)
    g, w = _rows(cat, got), _rows(cat, want)
    qmap = {q.query_id: q for q in trace}
    for key in set(g) | set(w):
        a, b = g.get(key), w.get(key)
        if a == b:
            continue
        qid, bucket, p = key
        pos = cat.store.read(bucket)["positions"].astype(np.float32)
        probe = qmap[qid].payload["positions"][p].astype(np.float32)
        d = pos.astype(np.float64) @ probe.astype(np.float64)
        top = d.max()
        tie = (np.abs(d - top) <= DOT_TOL).sum() > 1
        thr = np.float32(np.cos(qmap[qid].meta.get("radius", radius)))
        near = (np.abs(d - np.float64(thr)) <= DOT_TOL).any()
        if a is None or b is None:
            assert tie or near, (key, a, b)
            continue
        assert a[0] == b[0] or tie, (key, a, b)
        assert a[2] == b[2] or near, (key, a, b)
        assert abs(float(a[1]) - float(b[1])) <= DOT_TOL, (key, a, b)


def _flatten(results):
    return {
        qid: {(int(p), int(m)) for r in groups
              for p, m in zip(r.probe_idx, r.match_obj)}
        for qid, groups in results.items()
    }


class TestStateCarriedAcross:
    def test_catalog_from_arrays_matches_reference(self, catalogs):
        ref, port = catalogs
        assert port.n_buckets == ref.n_buckets
        np.testing.assert_array_equal(port.htm, ref.htm)
        np.testing.assert_array_equal(port.partitioner.order, ref.partitioner.order)
        for b in (0, ref.n_buckets // 2, ref.n_buckets - 1):
            r, t = ref.store.read(b), port.store.read(b)
            for k in ("positions", "mags", "htm"):
                np.testing.assert_array_equal(t[k], r[k])

    @pytest.mark.parametrize("seed", [0, 1])
    def test_buckets_for_range_matches_reference(self, catalogs, seed):
        """The intake's per-range lookup (a bisect over the boundaries)
        gives the reference's numpy answer at every boundary key, one
        either side of it, the key space's ends and random ranges."""
        ref, port = catalogs
        bounds = [int(k) for k in ref.partitioner._boundary_keys]
        top = int(ref.partitioner.sorted_keys[-1])
        rng = np.random.default_rng(seed)
        keys = sorted({0, top, top + 1, 2**63, *bounds,
                       *(b - 1 for b in bounds if b), *(b + 1 for b in bounds),
                       *(int(k) for k in rng.integers(0, top + 2, 64))})
        for k in keys:
            want = int(ref.partitioner.bucket_of_keys(np.array([k]))[0])
            assert port.partitioner._bucket_of_key(k) == want, k
        for _ in range(256):
            lo, hi = sorted(int(k) for k in rng.choice(keys, 2))
            np.testing.assert_array_equal(
                port.partitioner.buckets_for_range(lo, hi),
                ref.partitioner.buckets_for_range(lo, hi))
        for q in _trace(ref, n=8, seed=seed):
            for lo, hi in zip(q.keys_lo, q.keys_hi):
                np.testing.assert_array_equal(
                    port.partitioner.buckets_for_range(int(lo), int(hi)),
                    ref.partitioner.buckets_for_range(int(lo), int(hi)))

    def test_queries_from_records_copies(self, catalogs):
        ref, _ = catalogs
        trace = _trace(ref, n=4)
        qs = tcm.queries_from_records(_records(trace))
        assert all(isinstance(q, Query) for q in qs)
        for q, r in zip(qs, trace):
            assert (q.query_id, q.arrival_time, q.meta) == (
                r.query_id, r.arrival_time, r.meta
            )
            np.testing.assert_array_equal(q.keys_lo, r.keys_lo)
            np.testing.assert_array_equal(q.payload["positions"],
                                          r.payload["positions"])
            q.meta["radius"] = 1.0
            assert "radius" not in r.meta


ENGINE_CASES = [
    dict(fuse_k=1),
    dict(fuse_k=3),
    dict(fuse_k=1, shared_plan=True, share_width=2),
    dict(fuse_k=3, shared_plan=True, share_width=2),
]


class TestEngineAgainstReference:
    @pytest.mark.parametrize("kw", ENGINE_CASES, ids=str)
    @pytest.mark.parametrize("predicates", [False, True])
    def test_decisions_and_results(self, catalogs, kw, predicates):
        ref_cat, port_cat = catalogs
        trace = _trace(ref_cat, predicates=predicates)
        j_log, j_res = _run(
            jcm.CrossMatchEngine(ref_cat, match_radius_rad=4e-3, **kw), trace
        )
        t_log, t_res = _run(
            tcm.CrossMatchEngine(port_cat, match_radius_rad=4e-3,
                                 device="cpu", **kw),
            tcm.queries_from_records(_records(trace)),
        )
        assert not replay.diff_traces(j_log, t_log)
        assert_results_close(port_cat, trace, t_res, j_res)

    def test_self_probes_all_match(self, catalogs):
        _, cat = catalogs
        pos = cat.positions[:512]
        ids = tsfc.htm_id(pos, level=cat.level)
        shift = np.uint64(4)
        anc = ids >> shift
        q = Query(0, 0.0, anc << shift, ((anc + np.uint64(1)) << shift) - np.uint64(1),
                  payload={"positions": pos})
        eng = tcm.CrossMatchEngine(cat, match_radius_rad=1e-3, device="cpu")
        eng.submit(q)
        while eng.step() is not None:
            pass
        got = np.concatenate([r.probe_idx for r in eng.results[0]])
        assert len(np.unique(got)) == 512

    @pytest.mark.parametrize("n_shards", [1, 2, 4])
    def test_sharded(self, catalogs, n_shards):
        ref_cat, port_cat = catalogs
        trace = _trace(ref_cat, n=20, seed=9)
        j = jcm.ShardedCrossMatch(ref_cat, n_shards, match_radius_rad=4e-3)
        t = tcm.ShardedCrossMatch(port_cat, n_shards, match_radius_rad=4e-3,
                                  device="cpu")
        j_res = j.run(trace)
        t_res = t.run(tcm.queries_from_records(_records(trace)))
        assert all(isinstance(e, tcm.CrossMatchEngine) for e in t.engines)
        assert_results_close(port_cat, trace, t_res, j_res)
        assert t.summary()["n_batches"] == j.summary()["n_batches"]

    def test_sharded_matches_single_engine(self, catalogs):
        _, cat = catalogs
        trace = tcm.make_trace(cat, tcm.TraceConfig(
            n_queries=16, arrival_rate=2.0, objects_median=60, seed=13))
        one = tcm.CrossMatchEngine(cat, match_radius_rad=4e-3, device="cpu")
        four = tcm.ShardedCrossMatch(cat, 4, match_radius_rad=4e-3, device="cpu")
        assert _flatten(one.run(trace)) == _flatten(four.run(
            tcm.make_trace(cat, tcm.TraceConfig(
                n_queries=16, arrival_rate=2.0, objects_median=60, seed=13))
        ))


def _port_crossmatch_scenario(name):
    """``replay.crossmatch_scenario`` with the port's engine: the same
    catalog, trace and engine arguments (tests/replay.py)."""
    catalog = tcm.make_catalog(
        n_objects=2_000, objects_per_bucket=100, htm_level=6, seed=17
    )
    trace = tcm.make_trace(
        catalog,
        tcm.TraceConfig(n_queries=14, arrival_rate=2.0, objects_median=40, seed=19),
    )
    if name == "crossmatch_fused":
        eng = tcm.CrossMatchEngine(
            catalog, match_radius_rad=4e-3, fuse_k=3, device="cpu"
        )
    else:
        rng = np.random.default_rng(5)
        for q in trace:
            q.meta["radius"] = float(rng.choice([2e-3, 4e-3, 8e-3]))
            q.meta["mag_cut"] = float(rng.choice([23.0, 24.0, 25.0]))
        eng = tcm.CrossMatchEngine(
            catalog, match_radius_rad=4e-3, fuse_k=2,
            shared_plan=True, share_width=2, device="cpu",
        )
    rec = replay.TraceRecorder()
    eng.loop.add_round_tap(rec)
    eng.run(trace)
    return rec.entries


@pytest.mark.parametrize("name", ["crossmatch_fused", "crossmatch_sharedplan"])
def test_golden_replays_through_port(name):
    expect = replay.load_trace(replay.GOLDEN_DIR / f"{name}.json")
    divergence = replay.diff_traces(expect, _port_crossmatch_scenario(name))
    assert not divergence, "\n".join(divergence)
