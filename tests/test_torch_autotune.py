"""The port's empirical autotuner (``repro_torch.core.autotune``) against the
JAX package's (``repro.core.autotune``) on the CPU.

* lookups: ``measured_us``, ``best_backend``, ``best_chunks`` and
  ``ops_covered`` equal JAX's over a seeded grid of queries (both tiers,
  ``island_only``, legacy rows, ``b1``, ties, the 4x edge);
* coordinates: ``island_key``, ``_gemm_case``'s (m, n, k) and operand
  layouts, ``island_sweep_cases`` (fused excluded on the CPU);
* dispatch: ``auto_gemm_backend``, ``gemm_chunk_schedule``,
  ``a2a_chunk_schedule`` and ``psum``'s auto on (4,), both at H100_SXM,
  each package with its own live fingerprint on the same rows;
* JAX's own autotune tests, where they apply: calibration, persistence, the
  warnings and fallbacks, staleness, the CLI.
"""

import dataclasses
import json
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.core.comms as jcomms  # noqa: E402
from repro import compat  # noqa: E402
from repro.core import autotune as JA  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core.comms import CommContext as JCtx  # noqa: E402
from repro_torch import autotune as cli  # noqa: E402
from repro_torch.core import autotune as TA  # noqa: E402
from repro_torch.core import comms as tcomms  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core.comms import CommContext as TCtx  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402

torch.set_num_threads(1)

N = 4
MLP_KEY = TA.island_key("mlp", "matmul_all_reduce", 2)
ATTN_KEY = TA.island_key("attn_out", "matmul_all_reduce", 2)
A2A_KEY = TA.island_key("attn_ulysses", "all_to_all", 2)


@pytest.fixture(autouse=True)
def _fresh_caches():
    JA.clear_caches()
    TA.clear_caches()
    yield
    JA.clear_caches()
    TA.clear_caches()


@pytest.fixture(scope="module")
def tmesh4():
    return VirtualMesh((N,), ("x",))


@pytest.fixture(scope="module")
def table(tmesh4):
    """One real (tiny-grid) calibration of 4 virtual ranks on the CPU."""
    return TA.calibrate(tmesh4, grid="tiny", reps=1)


def _corr(**kw):
    out = {"ici_bandwidth": 1e8, "remote_sync_s": 1e-4,
           "gemm_efficiency": 1e-4, "kernel_launch_s": 1e-5}
    out.update(kw)
    return out


def _synthetic(fingerprint, rows, **corr):
    return TA.CalibrationTable(fingerprint=fingerprint,
                               corrections=_corr(**corr), measurements=rows)


def _rows(op, us_by_backend, m, n, k, axis_size=N):
    return [{"op": op, "backend": be, "axis_size": axis_size,
             "m": m, "n": n, "k": k, "us": us}
            for be, us in us_by_backend.items()]


def _pair(rows, jmesh, tmesh, **corr):
    """The same rows as a JAX table and a port table, each stamped with its
    own package's live fingerprint at H100_SXM."""
    jt = JA.CalibrationTable(
        fingerprint=JA.live_fingerprint("h100_sxm", jmesh),
        corrections=_corr(**corr), measurements=rows)
    tt = TA.CalibrationTable(
        fingerprint=TA.live_fingerprint("h100_sxm", tmesh),
        corrections=_corr(**corr), measurements=rows)
    return jt, tt


# ---------------------------------------------------------------------------
# Lookups: exact equality with JAX
# ---------------------------------------------------------------------------

_PTS = ((64, 16, 8), (256, 64, 16), (1024, 256, 64), (128, 128, 64),
        (512, 128, 64))
_OPS = {"all_gather_matmul": ("bulk", "ring", "ring_bidir", "fused"),
        "matmul_all_reduce": ("bulk", "ring", "fused"),
        "psum": ("bulk", "ring"), "all_to_all": ("bulk", "chunked")}
_ISLANDS = (None, MLP_KEY, ATTN_KEY)


def _seeded_rows(seed: int) -> list[dict]:
    """Rows over both tiers with holes, legacy rows (no dtype), b1/b2/b4
    rows, chunk variants and many ties (four distinct times)."""
    rng = np.random.RandomState(seed)
    rows = []
    for op, backends in _OPS.items():
        for pt in _PTS:
            for isl in _ISLANDS:
                for be in backends:
                    if rng.rand() < 0.25:
                        continue
                    counts = (1,) if be == "bulk" else (1, 2, 4)
                    for c in counts:
                        if c > 1 and rng.rand() < 0.4:
                            continue
                        row = {"op": op, "backend": be,
                               "axis_size": int(rng.choice([2, 4, 4])),
                               "m": pt[0], "n": pt[1], "k": pt[2],
                               "us": float(rng.choice([10.0, 20.0, 30.0,
                                                       40.0]))}
                        db = int(rng.choice([0, 1, 2, 2, 4]))
                        if db:
                            row["dtype_bytes"] = db
                        if c != 1 or rng.rand() < 0.5:
                            row["n_chunks"] = c
                        if isl is not None:
                            row["island"] = isl
                        rows.append(row)
    return rows


def _queries(seed: int, n: int):
    rng = np.random.RandomState(seed + 100)
    scales = (0.25, 0.2499, 0.5, 1.0, 1.0, 2.0, 4.0, 4.01, 8.0)
    for _ in range(n):
        op = str(rng.choice(list(_OPS)))
        pt = _PTS[rng.randint(len(_PTS))]
        m, nn, k = (max(1, int(round(v * float(rng.choice(scales)))))
                    for v in pt)
        yield dict(
            op=op, backend=str(rng.choice(_OPS[op])), m=m, n=nn, k=k,
            axis_size=[None, 2, 4][rng.randint(3)],
            dtype_bytes=[None, 1, 2, 4][rng.randint(4)],
            island=[None, MLP_KEY, ATTN_KEY, "other|psum|b4"][rng.randint(4)],
            island_only=bool(rng.rand() < 0.3),
            allowed=tuple(b for b in _OPS[op] if rng.rand() < 0.75),
            max_ratio=[4.0, 4.0, 1.01, 2.0][rng.randint(4)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookups_equal_jax(seed):
    rows = _seeded_rows(seed)
    fj = JA.Fingerprint("h100_sxm", "0", "cpu", "cpu", 4)
    ft = TA.Fingerprint("h100_sxm", "0", "cpu", "cpu", 4)
    jt = JA.CalibrationTable(fingerprint=fj, corrections={},
                             measurements=rows)
    tt = TA.CalibrationTable(fingerprint=ft, corrections={},
                             measurements=rows)
    assert tt.ops_covered() == jt.ops_covered()
    hits = {"us": 0, "be": 0, "c": 0}
    for q in _queries(seed, 600):
        kw = dict(axis_size=q["axis_size"], dtype_bytes=q["dtype_bytes"],
                  island=q["island"], max_ratio=q["max_ratio"])
        args = (q["op"], q["backend"], q["m"], q["n"], q["k"])
        want = jt.measured_us(*args, island_only=q["island_only"], **kw)
        assert tt.measured_us(*args, island_only=q["island_only"],
                              **kw) == want, q
        hits["us"] += want is not None
        shape = (q["m"], q["n"], q["k"])
        want = jt.best_backend(q["op"], *shape, allowed=q["allowed"], **kw)
        assert tt.best_backend(q["op"], *shape, allowed=q["allowed"],
                               **kw) == want, q
        hits["be"] += want is not None
        want = jt.best_chunks(*args, **kw)
        assert tt.best_chunks(*args, **kw) == want, q
        hits["c"] += want is not None
    # the grid exercises hits and misses of every lookup
    assert all(20 < v < 590 for v in hits.values()), hits


def test_four_x_edge_and_legacy_rows():
    """A point exactly 4x away is used, 4.01x is refused; a legacy row
    (no dtype) serves b2 and b4 queries, never b1 — in both packages."""
    rows = _rows("matmul_all_reduce", {"bulk": 10.0, "ring": 5.0}, 64, 64, 64)
    for r in rows:
        r.pop("dtype_bytes", None)
    fj = JA.Fingerprint("h100_sxm", "0", "cpu", "cpu", 4)
    ft = TA.Fingerprint("h100_sxm", "0", "cpu", "cpu", 4)
    for t in (JA.CalibrationTable(fj, {}, rows),
              TA.CalibrationTable(ft, {}, rows)):
        q = dict(allowed=("bulk", "ring"), axis_size=N)
        assert t.best_backend("matmul_all_reduce", 256, 64, 64, **q) == "ring"
        assert t.best_backend("matmul_all_reduce", 16, 64, 64, **q) == "ring"
        assert t.best_backend("matmul_all_reduce", 257, 64, 64, **q) is None
        assert t.measured_us("matmul_all_reduce", "ring", 257, 64, 64) is None
        for db, want in ((2, "ring"), (4, "ring"), (1, None)):
            assert t.best_backend("matmul_all_reduce", 64, 64, 64,
                                  dtype_bytes=db, **q) == want


def test_constants_and_keys_equal_jax():
    assert TA.GRIDS == JA.GRIDS
    assert TA.GEMM_OPS == JA.GEMM_OPS and TA.DEFAULT_OPS == JA.DEFAULT_OPS
    assert TA.ISLAND_CHUNK_SWEEP == JA.ISLAND_CHUNK_SWEEP
    assert TA.ISLAND_FUSED_CHUNK_SWEEP == JA.ISLAND_FUSED_CHUNK_SWEEP
    assert TA.STALE_AFTER_DAYS == JA.STALE_AFTER_DAYS
    for name in ("mlp", "attn_out", "moe_dispatch"):
        for op in ("matmul_all_reduce", "all_to_all", "psum"):
            for db in (1, 2, 4):
                assert TA.island_key(name, op, db) == \
                    JA.island_key(name, op, db)
    # the port's schema is its own: neither package reads the other's
    assert TA.SCHEMA != JA.SCHEMA


# ---------------------------------------------------------------------------
# Coordinates and sweep cases
# ---------------------------------------------------------------------------

def _local(shape, spec, n_dev):
    return tuple(d // n_dev if (i < len(spec) and spec[i] == "x") else d
                 for i, d in enumerate(shape))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_gemm_case_coordinates_and_layout(n_dev):
    for op in TA.GEMM_OPS:
        for nsz in sorted(set(TA.GRIDS["small"] + TA.GRIDS["full"][:2])):
            (jx, jw), (jxs, jws), _, jmnk = JA._gemm_case(op, nsz, n_dev)
            (x, w), mnk = TA._gemm_case(op, nsz, n_dev)
            assert mnk == jmnk, (op, nsz)
            # stacked (R, *local): the layout JAX's in_specs give each rank
            assert tuple(x.shape) == (n_dev, *_local(jx.shape, jxs, n_dev))
            assert tuple(w.shape) == (n_dev, *_local(jw.shape, jws, n_dev))
            assert x.dtype == w.dtype == torch.bfloat16


def test_island_sweep_cases_equal_jax(mesh4):
    jctx = JCtx(axis_name="x", mesh=mesh4)
    tctx = TCtx("x", mesh=VirtualMesh((N,), ("x",)))
    n_cases = 0
    for op in TA.GEMM_OPS:
        for m in (1, 2, 7, 8, 64, 96):
            for db in (1, 2, 4):
                for n_dev in (2, 3, 4):
                    jsw = JA.IslandSweep("i", op, m, 16, 8, dtype_bytes=db)
                    tsw = TA.IslandSweep("i", op, m, 16, 8, dtype_bytes=db)
                    want = JA.island_sweep_cases(
                        jsw, n_dev, jctx.available_backends(op))
                    got = TA.island_sweep_cases(
                        tsw, n_dev, tctx.available_backends(op),
                        device="cpu")
                    assert got == want, (op, m, db, n_dev)
                    assert all(be != "fused" for be, _ in got)
                    n_cases += len(got)
                    # on a CUDA device the full-precision sweep adds fused
                    cuda = TA.island_sweep_cases(
                        tsw, n_dev, tctx.available_backends(op),
                        device="cuda")
                    fused = [c for be, c in cuda if be == "fused"]
                    assert fused == ([] if db == 1 else
                                     list(TA.ISLAND_FUSED_CHUNK_SWEEP))
    assert n_cases > 100


def test_a2a_coords_equal_jax():
    for shape, sa, ca in (((8, 4, 16, 16), 1, 2), ((4, 16, 96, 64), 0, 0),
                          ((1, 32, 2048, 64), 1, 2)):
        assert TCtx.a2a_coords(shape, sa, ca) == JCtx.a2a_coords(shape, sa,
                                                                 ca)


# ---------------------------------------------------------------------------
# Dispatch: the measured tiers of CommContext against JAX's, at H100_SXM
# ---------------------------------------------------------------------------

def _dispatch_rows():
    rows = []
    rows += _rows("matmul_reduce_scatter", {"bulk": 1000.0, "ring": 100.0},
                  64, 16, 8)
    rows += _rows("matmul_reduce_scatter", {"bulk": 50.0, "ring": 500.0},
                  8192, 8192, 8192)
    rows += _rows("all_gather_matmul",
                  {"bulk": 900.0, "ring": 500.0, "ring_bidir": 100.0,
                   "fused": 50.0}, 512, 128, 128)
    for c, us in ((1, 100.0), (2, 40.0), (4, 60.0)):
        rows.append({"op": "matmul_all_reduce", "backend": "ring",
                     "axis_size": N, "m": 256, "n": 64, "k": 16,
                     "dtype_bytes": 2, "n_chunks": c, "island": MLP_KEY,
                     "us": us})
    rows.append({"op": "matmul_all_reduce", "backend": "bulk",
                 "axis_size": N, "m": 256, "n": 64, "k": 16,
                 "dtype_bytes": 2, "n_chunks": 1, "island": MLP_KEY,
                 "us": 70.0})
    for be, db, us in (("bulk", 1, 300.0), ("ring", 1, 200.0),
                       ("ring", 2, 900.0)):
        rows.append({"op": "matmul_all_reduce", "backend": be,
                     "axis_size": N, "m": 1024, "n": 256, "k": 64,
                     "dtype_bytes": db, "n_chunks": 1, "us": us})
    m, n, k = TCtx.a2a_coords((8, 4, 16, 16), 1, 2)
    for be, c, us in (("bulk", 1, 500.0), ("chunked", 2, 100.0),
                      ("chunked", 4, 300.0)):
        rows.append({"op": "all_to_all", "backend": be, "axis_size": N,
                     "m": m, "n": n, "k": k, "dtype_bytes": 2, "n_chunks": c,
                     "island": A2A_KEY, "us": us})
    m, n, k = TCtx.a2a_coords((4, 4, 32, 16), 0, 0)
    for be, c, us in (("bulk", 1, 50.0), ("chunked", 2, 100.0)):
        rows.append({"op": "all_to_all", "backend": be, "axis_size": N,
                     "m": m, "n": n, "k": k, "dtype_bytes": 2, "n_chunks": c,
                     "us": us})
    return rows


def _ctx_pair(mesh4, tmesh4, jt, tt, **kw):
    return (JCtx(axis_name="x", mesh=mesh4, hw=jcm.H100_SXM,
                 calibration=jt, **kw),
            TCtx("x", mesh=tmesh4, hw=tcm.H100_SXM, calibration=tt, **kw))


def _sched(s):
    return (s.n_chunks, s.chunk_dim, s.reason, s.source)


@pytest.mark.parametrize("policy", ["measured", "auto", "analytic"])
def test_gemm_dispatch_equals_jax(mesh4, tmesh4, policy):
    jt, tt = _pair(_dispatch_rows(), mesh4, tmesh4)
    shapes = [(64, 16, 8), (8192, 8192, 8192), (512, 128, 128),
              (256, 64, 16), (1024, 256, 64), (100, 60, 30), (40, 16, 8)]
    n_measured = 0
    for isl in (None, MLP_KEY, ATTN_KEY):
        jctx, tctx = _ctx_pair(mesh4, tmesh4, jt, tt, policy=policy,
                               island=isl)
        if policy != "analytic":
            assert tctx.active_calibration() is tt
            assert jctx.active_calibration() is jt
        assert dataclasses.asdict(tctx.effective_hw()) == \
            dataclasses.asdict(jctx.effective_hw())
        for op in TA.GEMM_OPS:
            for shape in shapes:
                for fused_ok in (False, True):
                    for bidir_ok in (False, True):
                        for wire in (None, "int8"):
                            kw = dict(fused_ok=fused_ok, bidir_ok=bidir_ok,
                                      wire=wire)
                            assert tctx.auto_gemm_backend(op, *shape, **kw) \
                                == jctx.auto_gemm_backend(op, *shape, **kw)
                for be in ("bulk", "ring", "ring_bidir", "fused"):
                    for wire in (None, "int8"):
                        for chunk_dim in (None, "n"):
                            kw = dict(backend=be, wire=wire,
                                      chunk_dim=chunk_dim)
                            got = tctx.gemm_chunk_schedule(op, *shape, **kw)
                            want = jctx.gemm_chunk_schedule(op, *shape, **kw)
                            assert _sched(got) == _sched(want), (op, shape,
                                                                 kw)
                            n_measured += got.source == "measured"
    if policy == "analytic":
        assert n_measured == 0
    else:
        assert n_measured > 0
    # the measured tier really decides: ring where the analytic says bulk
    if policy != "analytic":
        jctx, tctx = _ctx_pair(mesh4, tmesh4, jt, tt, policy=policy)
        assert tctx.auto_gemm_backend("matmul_reduce_scatter", 64, 16, 8) \
            == "ring"


@pytest.mark.parametrize("policy", ["measured", "analytic"])
def test_a2a_dispatch_equals_jax(mesh4, tmesh4, policy):
    jt, tt = _pair(_dispatch_rows(), mesh4, tmesh4)
    sources = set()
    for isl in (None, A2A_KEY):
        jctx, tctx = _ctx_pair(mesh4, tmesh4, jt, tt, policy=policy,
                               island=isl)
        for shape, sa, ca in (((8, 4, 16, 16), 1, 2), ((4, 4, 32, 16), 0, 0),
                              ((1, 32, 2048, 64), 1, 2), ((8, 4, 1, 1), 1, 2),
                              ((2, 8, 64, 64), 1, 2)):
            for db in (2, 4):
                for dc in (0.0, 1e-3):
                    kw = dict(dtype_bytes=db, downstream_compute_s=dc)
                    got = tctx.a2a_chunk_schedule(shape, sa, ca, **kw)
                    want = jctx.a2a_chunk_schedule(shape, sa, ca, **kw)
                    assert _sched(got) == _sched(want), (isl, shape, kw)
                    sources.add(got.source)
    assert sources == ({"analytic", "measured"} if policy == "measured"
                       else {"analytic"})


def test_psum_auto_equals_jax(mesh4, tmesh4, monkeypatch):
    """psum's auto backend (bulk or ring) under each table, payload dtype
    and shape: the same decision in both packages."""
    jcalls, tcalls = [], []
    jorig, torig = jcomms.pk_psum_ring, tcomms.pk_psum_ring
    monkeypatch.setattr(jcomms, "pk_psum_ring",
                        lambda *a, **k: jcalls.append(1) or jorig(*a, **k))
    monkeypatch.setattr(tcomms, "pk_psum_ring",
                        lambda *a, **k: tcalls.append(1) or torig(*a, **k))
    tables = {
        "ring": _rows("psum", {"bulk": 999.0, "ring": 1.0}, N, 64, 1),
        "bulk": _rows("psum", {"bulk": 1.0, "ring": 999.0}, N, 64, 1),
        "none": [],
    }
    decided = set()
    for name, rows in tables.items():
        jt, tt = _pair(rows, mesh4, tmesh4)
        jctx, tctx = _ctx_pair(mesh4, tmesh4, jt, tt, policy="measured")
        for dt in ("float32", "bfloat16"):
            for lead in (N, 3):
                jcalls.clear()
                tcalls.clear()
                x = np.ones((N, lead, 64), np.float32)
                compat.shard_map(
                    lambda v: jctx.psum(v[0])[None], mesh=mesh4,
                    in_specs=JP("x"), out_specs=JP("x"),
                    check_vma=False)(jnp.asarray(x, getattr(jnp, dt)))
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    tctx.psum(torch.from_numpy(x).to(getattr(torch, dt)))
                assert bool(tcalls) == bool(jcalls), (name, dt, lead)
                decided.add(bool(tcalls))
    assert decided == {True, False}


# ---------------------------------------------------------------------------
# Calibration and persistence (JAX's tests, for the port)
# ---------------------------------------------------------------------------

def test_calibrate_covers_registered_backends(table, tmesh4):
    cov = table.ops_covered()
    for op in TA.DEFAULT_OPS:
        assert cov.get(op), f"no measurements for {op}"
    backends = {(r["op"], r["backend"]) for r in table.measurements}
    assert ("all_gather_matmul", "bulk") in backends
    assert ("all_gather_matmul", "ring") in backends
    assert ("all_gather_matmul", "ring_bidir") in backends
    assert ("psum", "ring") in backends
    # the CPU runs the fused kernels' plain versions: never timed
    assert not any(be == "fused" for _, be in backends)
    for key in ("ici_bandwidth", "remote_sync_s", "gemm_efficiency",
                "kernel_launch_s"):
        assert table.corrections[key] > 0, key
    live = TA.live_fingerprint("h100_sxm", tmesh4)
    assert table.fingerprint.compatible(live, strict=True)
    assert table.fingerprint.backend == "cpu"
    assert table.fingerprint.device_kind == "cpu"
    assert table.fingerprint.torch_version == torch.__version__


def test_round_trip_through_json(table, tmp_path, tmesh4):
    path = table.save(tmp_path / "cal.json")
    loaded = TA.CalibrationTable.load(path)
    assert loaded.to_json() == table.to_json()
    assert json.loads(path.read_text())["schema"] == TA.SCHEMA
    for cal in (loaded, str(path)):
        ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=cal)
        active = ctx.active_calibration()
        assert active is not None
        assert active.corrections == table.corrections
        hw = ctx.effective_hw()
        assert hw.ici_bandwidth == pytest.approx(
            table.corrections["ici_bandwidth"])
        assert hw.gemm_efficiency < 1.0
        assert hw is not ctx.hw


def test_rejects_foreign_and_jax_schema(tmp_path, mesh4, tmesh4):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"schema": "something-else/v9"}))
    with pytest.raises(ValueError, match="repro_torch-autotune"):
        TA.CalibrationTable.load(p)
    # a JAX table is refused, not misread (ROADMAP C2) — and vice versa
    jt, tt = _pair(_rows("psum", {"bulk": 1.0, "ring": 2.0}, N, 64, 1),
                   mesh4, tmesh4)
    jpath = jt.save(tmp_path / "jax.json")
    tpath = tt.save(tmp_path / "port.json")
    with pytest.raises(ValueError, match="repro_torch-autotune"):
        TA.CalibrationTable.load(jpath)
    with pytest.raises(ValueError, match="repro-autotune"):
        JA.CalibrationTable.load(tpath)
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=str(jpath))
    with pytest.warns(UserWarning, match="could not be loaded"):
        assert ctx.active_calibration() is None
    # the cache files never collide
    assert TA.cache_path(tt.fingerprint).name.startswith("autotune-torch-")
    assert TA.cache_path(tt.fingerprint) != JA.cache_path(jt.fingerprint)


def test_measured_us_refuses_far_extrapolation(table):
    row = next(r for r in table.measurements if r["op"] == "psum")
    near = table.measured_us("psum", row["backend"], row["m"], row["n"],
                             row["k"])
    assert near == pytest.approx(row["us"])
    far = table.measured_us("psum", row["backend"], row["m"] * 100,
                            row["n"] * 100, max(row["k"] * 100, 1))
    assert far is None


def test_calibration_rows_match_dispatch_coordinates(tmesh4, table):
    for op in TA.GEMM_OPS:
        r = next(r for r in table.measurements if r["op"] == op)
        assert table.best_backend(op, r["m"], r["n"], r["k"],
                                  allowed=("bulk", "ring"),
                                  axis_size=N) is not None, op
    nsz = 128
    measured = {r["backend"]: r["us"] for r in table.measurements
                if r["op"] == "all_gather_matmul" and r["m"] == nsz}
    assert measured
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=table)
    assert ctx.auto_gemm_backend("all_gather_matmul", nsz, nsz // 4,
                                 nsz // 4) == min(measured, key=measured.get)
    # an AG call of (R, 32, 32) row shards dispatches at that point too
    x = torch.randn(N, nsz // N, nsz // 4)
    w = torch.randn(N, nsz // 4, nsz // 4)
    out = ctx.all_gather_matmul(x, w)
    assert out.shape == (N, nsz, nsz // 4)


def test_measured_policy_overrides_analytic_choice(tmesh4):
    live = TA.live_fingerprint("h100_sxm", tmesh4)
    analytic = TCtx("x", mesh=tmesh4)
    t = _synthetic(live, _rows("matmul_reduce_scatter",
                               {"bulk": 1000.0, "ring": 100.0}, 64, 16, 8))
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=t)
    assert analytic.auto_gemm_backend("matmul_reduce_scatter", 64, 16, 8) \
        == "bulk"
    assert ctx.auto_gemm_backend("matmul_reduce_scatter", 64, 16, 8) == "ring"
    big = 8192
    t2 = _synthetic(live, _rows("matmul_reduce_scatter",
                                {"bulk": 50.0, "ring": 500.0}, big, big, big))
    ctx2 = TCtx("x", mesh=tmesh4, policy="measured", calibration=t2)
    assert analytic.auto_gemm_backend("matmul_reduce_scatter", big, big,
                                      big) == "ring"
    assert ctx2.auto_gemm_backend("matmul_reduce_scatter", big, big,
                                  big) == "bulk"


def test_measured_dispatch_respects_feasibility(tmesh4):
    live = TA.live_fingerprint("h100_sxm", tmesh4)
    rows = _rows("all_gather_matmul",
                 {"bulk": 900.0, "ring": 500.0, "ring_bidir": 100.0,
                  "fused": 10.0}, 512, 128, 128)
    ctx = TCtx("x", mesh=tmesh4, policy="measured",
               calibration=_synthetic(live, rows))
    assert ctx.auto_gemm_backend("all_gather_matmul", 512, 128, 128) \
        == "ring_bidir"
    assert ctx.auto_gemm_backend("all_gather_matmul", 512, 128, 128,
                                 bidir_ok=False) == "ring"
    assert ctx.auto_gemm_backend("all_gather_matmul", 512, 128, 128,
                                 fused_ok=True) == "fused"


def test_measured_needs_two_backends(tmesh4):
    live = TA.live_fingerprint("h100_sxm", tmesh4)
    t = _synthetic(live, _rows("matmul_reduce_scatter", {"ring": 1.0},
                               64, 16, 8))
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=t)
    assert ctx.auto_gemm_backend("matmul_reduce_scatter", 64, 16, 8) == "bulk"


def test_measured_psum_dispatch(tmesh4, monkeypatch):
    """With ring measured 999x faster, an f32 payload — which the analytic
    rule sends to bulk — runs the ring."""
    live = TA.live_fingerprint("h100_sxm", tmesh4)
    t = _synthetic(live, _rows("psum", {"bulk": 999.0, "ring": 1.0},
                               N, 64, 1))
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=t)
    calls = []
    orig = tcomms.pk_psum_ring
    monkeypatch.setattr(tcomms, "pk_psum_ring",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x = torch.randn(N, N, 64)
    out = ctx.psum(x)
    assert calls, "measured policy did not route psum to the ring"
    torch.testing.assert_close(out, x.sum(0, keepdim=True).expand_as(x))


# ---------------------------------------------------------------------------
# Island-keyed dispatch (calibrate --per-island)
# ---------------------------------------------------------------------------

def _island_table(live):
    rows = _rows("matmul_all_reduce", {"bulk": 10.0, "ring": 100.0},
                 256, 64, 16)
    mlp = _rows("matmul_all_reduce", {"bulk": 100.0, "ring": 10.0},
                256, 64, 16)
    for r in mlp:
        r["island"] = MLP_KEY
    attn = _rows("matmul_all_reduce", {"bulk": 5.0, "ring": 500.0},
                 256, 64, 16)
    for r in attn:
        r["island"] = ATTN_KEY
    return _synthetic(live, rows + mlp + attn)


def test_island_keyed_rows_beat_global(tmesh4):
    t = _island_table(TA.live_fingerprint("h100_sxm", tmesh4))
    mk = dict(mesh=tmesh4, policy="measured", calibration=t)
    assert TCtx("x", **mk).auto_gemm_backend(
        "matmul_all_reduce", 256, 64, 16) == "bulk"
    assert TCtx("x", island=MLP_KEY, **mk).auto_gemm_backend(
        "matmul_all_reduce", 256, 64, 16) == "ring"
    assert TCtx("x", island=ATTN_KEY, **mk).auto_gemm_backend(
        "matmul_all_reduce", 256, 64, 16) == "bulk"
    other = TCtx("x", island=TA.island_key("decode", "psum", 4), **mk)
    assert other.auto_gemm_backend("matmul_all_reduce", 256, 64, 16) \
        == "bulk"


def test_island_rows_never_leak_across_islands(tmesh4):
    live = TA.live_fingerprint("h100_sxm", tmesh4)
    mlp = _rows("matmul_all_reduce", {"bulk": 100.0, "ring": 10.0},
                256, 64, 16)
    for r in mlp:
        r["island"] = MLP_KEY
    t = _synthetic(live, mlp)
    attn = TCtx("x", mesh=tmesh4, policy="measured", calibration=t,
                island=ATTN_KEY)
    assert attn.auto_gemm_backend("matmul_all_reduce", 256, 64, 16) == "bulk"
    assert t.best_backend("matmul_all_reduce", 256, 64, 16,
                          allowed=("bulk", "ring"), axis_size=N,
                          island=ATTN_KEY) is None


def test_best_chunks_measured(tmesh4):
    live = TA.live_fingerprint("h100_sxm", tmesh4)
    rows = [{"op": "matmul_reduce_scatter", "backend": "ring",
             "axis_size": N, "m": 256, "n": 64, "k": 16, "n_chunks": c,
             "us": us} for c, us in ((1, 100.0), (2, 40.0), (4, 60.0))]
    t = _synthetic(live, rows)
    assert t.best_chunks("matmul_reduce_scatter", "ring", 256, 64, 16,
                         axis_size=N) == 2
    assert _synthetic(live, rows[:1]).best_chunks(
        "matmul_reduce_scatter", "ring", 256, 64, 16, axis_size=N) is None
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=t)
    sched = ctx.gemm_chunk_schedule("matmul_reduce_scatter", 256, 64, 16,
                                    backend="ring")
    assert sched.n_chunks == 2 and sched.source == "measured"


def test_per_island_calibrate_sweeps_and_dispatches(tmesh4):
    sweeps = (TA.IslandSweep(island=MLP_KEY, op="matmul_all_reduce",
                             m=8 * N, n=16, k=8),)
    table = TA.calibrate(tmesh4, grid="tiny", reps=1, islands=sweeps)
    tagged = [r for r in table.measurements if r.get("island") == MLP_KEY]
    assert {r["backend"] for r in tagged} == {"bulk", "ring"}
    assert {r["n_chunks"] for r in tagged if r["backend"] == "ring"} \
        == set(TA.ISLAND_CHUNK_SWEEP)
    assert all((r["m"], r["n"], r["k"]) == (8 * N, 16, 8) for r in tagged)
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=table,
               island=MLP_KEY)
    best = min(((r["backend"], r["us"]) for r in tagged),
               key=lambda be_us: be_us[1])[0]
    assert ctx.auto_gemm_backend("matmul_all_reduce", 8 * N, 16, 8) == best


def test_per_island_calibrate_dtype_axis(tmesh4):
    sweeps = [TA.IslandSweep(island=MLP_KEY, op="matmul_all_reduce",
                             m=8 * N, n=16, k=8)]
    sweeps += cli.int8_island_sweeps(sweeps)
    b1_key = TA.island_key("mlp", "matmul_all_reduce", 1)
    assert [sw.island for sw in sweeps] == [MLP_KEY, b1_key]
    table = TA.calibrate(tmesh4, grid="tiny", reps=1, islands=tuple(sweeps),
                         dtypes=(2, 1))
    for key, want_b in ((MLP_KEY, 2), (b1_key, 1)):
        rows = [r for r in table.measurements if r.get("island") == key]
        assert rows, key
        assert all(r["dtype_bytes"] == want_b for r in rows)
        assert {r["backend"] for r in rows} >= {"bulk", "ring"}
    grid_b1 = [r for r in table.measurements
               if r.get("dtype_bytes") == 1 and not r.get("island")]
    assert grid_b1 and not any(r["backend"] == "fused" for r in grid_b1)


def test_measured_us_island_dtype_precedence(tmesh4):
    live = TA.live_fingerprint("h100_sxm", tmesh4)
    b1_key = TA.island_key("mlp", "matmul_all_reduce", 1)
    rows = [{"op": "matmul_all_reduce", "backend": "ring", "axis_size": N,
             "m": 256, "n": 64, "k": 16, "dtype_bytes": db, "n_chunks": 1,
             "island": key, "us": us}
            for key, db, us in ((MLP_KEY, 2, 10.0), (b1_key, 1, 99.0))]
    t = _synthetic(live, rows)
    q = dict(axis_size=N)
    assert t.measured_us("matmul_all_reduce", "ring", 256, 64, 16,
                         dtype_bytes=2, island=MLP_KEY, **q) == 10.0
    assert t.measured_us("matmul_all_reduce", "ring", 256, 64, 16,
                         dtype_bytes=1, island=b1_key, **q) == 99.0
    assert t.measured_us("matmul_all_reduce", "ring", 256, 64, 16,
                         dtype_bytes=1, island=MLP_KEY, island_only=True,
                         **q) is None


def test_best_backend_compares_only_shared_grid_points(tmesh4):
    fp = TA.live_fingerprint("h100_sxm", tmesh4)
    rows = [
        {"op": "matmul_all_reduce", "backend": "bulk", "axis_size": N,
         "m": 128, "n": 128, "k": 64, "us": 50.0},
        {"op": "matmul_all_reduce", "backend": "ring", "axis_size": N,
         "m": 128, "n": 128, "k": 64, "us": 60.0},
        {"op": "matmul_all_reduce", "backend": "bulk", "axis_size": N,
         "m": 512, "n": 128, "k": 64, "us": 3000.0},
    ]
    t = _synthetic(fp, rows)
    q = dict(allowed=("bulk", "ring"), axis_size=N)
    assert t.best_backend("matmul_all_reduce", 512, 128, 64, **q) == "bulk"
    assert t.best_backend("matmul_all_reduce", 128, 128, 64, **q) == "bulk"
    t1 = _synthetic(fp, [r for r in rows if r["backend"] == "bulk"])
    assert t1.best_backend("matmul_all_reduce", 128, 128, 64, **q) is None


# ---------------------------------------------------------------------------
# all-to-all island sweep and measured a2a dispatch
# ---------------------------------------------------------------------------

def _a2a_sweep():
    shape = (8, 4, 16, 16)
    m, n, k = TCtx.a2a_coords(shape, 1, 2)
    return TA.IslandSweep(island=A2A_KEY, op="all_to_all", m=m, n=n, k=k,
                          dtype_bytes=2, shape=shape, split_axis=1,
                          concat_axis=2)


def test_calibrate_sweeps_a2a_islands(tmesh4):
    table = TA.calibrate(tmesh4, grid="tiny", reps=1, islands=[_a2a_sweep()])
    rows = [r for r in table.measurements
            if r["op"] == "all_to_all" and r.get("island")]
    backends = {(r["backend"], r["n_chunks"]) for r in rows}
    assert ("bulk", 1) in backends
    assert any(be == "chunked" and c > 1 for be, c in backends)
    sw = _a2a_sweep()
    for r in rows:
        assert (r["m"], r["n"], r["k"]) == (sw.m, sw.n, sw.k)
        assert r["island"] == sw.island


def test_a2a_chunk_schedule_measured_dispatch(tmesh4, tmp_path):
    sw = _a2a_sweep()
    fp = TA.live_fingerprint("h100_sxm", tmesh4)

    def r(be, c, us):
        return {"op": "all_to_all", "backend": be, "axis_size": N,
                "m": sw.m, "n": sw.n, "k": sw.k, "dtype_bytes": 2,
                "n_chunks": c, "island": sw.island, "us": us}

    table = _synthetic(fp, [r("bulk", 1, 500.0), r("chunked", 2, 100.0),
                            r("chunked", 4, 300.0)])
    path = table.save(tmp_path / "a2a.json")
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=str(path),
               island=sw.island)
    sched = ctx.a2a_chunk_schedule(sw.shape, 1, 2)
    assert sched.source == "measured" and sched.n_chunks == 2
    table2 = _synthetic(fp, [r("bulk", 1, 50.0), r("chunked", 2, 100.0)])
    path2 = table2.save(tmp_path / "a2a2.json")
    ctx2 = dataclasses.replace(ctx, calibration=str(path2))
    sched2 = ctx2.a2a_chunk_schedule(sw.shape, 1, 2)
    assert sched2.source == "measured" and sched2.n_chunks == 1
    ctx3 = TCtx("x", mesh=tmesh4)
    assert ctx3.a2a_chunk_schedule(sw.shape, 1, 2).source == "analytic"


# ---------------------------------------------------------------------------
# Graceful fallback
# ---------------------------------------------------------------------------

def test_measured_without_table_warns_and_falls_back(tmesh4, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(TA, "_SEED_DIR", tmp_path / "no-seeds")
    TA.clear_caches()
    ctx = TCtx("x", mesh=tmesh4, policy="measured")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert ctx.active_calibration() is None
        be = ctx.auto_gemm_backend("matmul_reduce_scatter", 16, 12, 32)
    assert be == TCtx("x", mesh=tmesh4).auto_gemm_backend(
        "matmul_reduce_scatter", 16, 12, 32)
    msgs = [str(w.message) for w in rec]
    assert sum("falling back to analytic" in m for m in msgs) == 1
    assert any("repro_torch.autotune calibrate" in m for m in msgs)


def test_unreadable_explicit_path_warns_and_falls_back(tmesh4, tmp_path):
    ctx = TCtx("x", mesh=tmesh4, policy="measured",
               calibration=str(tmp_path / "missing.json"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert ctx.active_calibration() is None
    assert any("could not be loaded" in str(w.message) for w in rec)


def test_fingerprint_mismatch_falls_back(tmesh4, table):
    """A card's table on a CPU mesh (or another card's) is not used."""
    foreign = dataclasses.replace(table.fingerprint, backend="cuda",
                                  device_kind="NVIDIA H100 80GB HBM3")
    t = TA.CalibrationTable(fingerprint=foreign,
                            corrections=dict(table.corrections),
                            measurements=list(table.measurements))
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=t)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert ctx.active_calibration() is None
        assert ctx.effective_hw() is ctx.hw
    assert any("does not match" in str(w.message) for w in rec)
    auto_ctx = TCtx("x", mesh=tmesh4, policy="auto", calibration=t)
    TA.clear_caches()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert auto_ctx.active_calibration() is None
    assert any("does not match" in str(w.message) for w in rec)
    # another torch major.minor is another table; the exact version and
    # the rank count only under strict
    other = dataclasses.replace(table.fingerprint, torch_version="1.0.0")
    assert not other.compatible(table.fingerprint)
    patch = dataclasses.replace(
        table.fingerprint,
        torch_version=TA.Fingerprint._torch_mm(torch.__version__) + ".99",
        n_devices=8)
    assert patch.compatible(table.fingerprint)
    assert not patch.compatible(table.fingerprint, strict=True)


def test_auto_policy_silent_on_implicit_miss(tmesh4, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(TA, "_SEED_DIR", tmp_path / "no-seeds")
    TA.clear_caches()
    ctx = TCtx("x", mesh=tmesh4, policy="auto")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert ctx.active_calibration() is None
    assert not rec


def test_unknown_policy_rejected(tmesh4):
    ctx = TCtx("x", mesh=tmesh4, policy="vibes")
    with pytest.raises(ValueError, match="unknown comm policy"):
        ctx.active_calibration()


def test_auto_policy_finds_cached_table(tmesh4, table, tmp_path,
                                        monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    TA.clear_caches()
    marked = TA.CalibrationTable(
        fingerprint=table.fingerprint,
        corrections={**table.corrections, "gemm_efficiency": 0.123},
        measurements=[], notes="from-the-cache")
    marked.save(TA.cache_path(table.fingerprint))
    ctx = TCtx("x", mesh=tmesh4, policy="auto")
    active = ctx.active_calibration()
    assert active is not None and active.notes == "from-the-cache"
    assert ctx.effective_hw().gemm_efficiency == pytest.approx(0.123)
    # the JAX package's cache lookup never sees the port's file
    jlive = JA.live_fingerprint("h100_sxm")
    assert not JA.cache_path(jlive).exists()


def test_cpu_find_table_skips_the_h100_seed(tmp_path, monkeypatch):
    """The shipped seed was measured on the card: a CPU process never
    resolves it (no CPU test depends on it resolving)."""
    seed = TA._SEED_DIR / "h100_sxm.json"
    assert seed.is_file()
    t = TA.CalibrationTable.load(seed)
    assert t.fingerprint.backend == "cuda" and t.fingerprint.hw == "h100_sxm"
    assert "NVIDIA H100" in t.fingerprint.device_kind
    assert "python -m repro_torch.autotune calibrate" in t.notes
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "empty"))
    TA.clear_caches()
    assert TA.find_table("h100_sxm", device="cpu") is None
    ctx = TCtx("x", mesh=VirtualMesh((N,), ("x",)), policy="auto")
    assert ctx.active_calibration() is None


def test_analytic_policy_ignores_tables(tmesh4, table):
    ctx = TCtx("x", mesh=tmesh4, policy="analytic", calibration=table)
    assert ctx.active_calibration() is None
    assert ctx.effective_hw() is ctx.hw


# ---------------------------------------------------------------------------
# Staleness
# ---------------------------------------------------------------------------

def test_table_age_days_parses_created(table):
    t = dataclasses.replace(table, created="2020-01-01T00:00:00")
    assert TA.table_age_days(t) > 365
    assert TA.table_age_days(
        dataclasses.replace(table, created="not-a-date")) is None
    assert TA.table_age_days(dataclasses.replace(table, created="")) is None


def test_staleness_flags_old_table(table):
    old = dataclasses.replace(table, created="2020-01-01T00:00:00")
    msgs = TA.staleness(old, probe=False)
    assert len(msgs) == 1 and "days old" in msgs[0]


def test_staleness_fresh_table_quiet(table):
    fresh = dataclasses.replace(table,
                                created=time.strftime("%Y-%m-%dT%H:%M:%S"))
    assert TA.staleness(fresh, probe=False) == []


def test_staleness_spot_probe_catches_drift(table, monkeypatch):
    seen = []
    monkeypatch.setattr(TA, "_measure_launch",
                        lambda reps, dev: seen.append(dev) or 1e-5)
    monkeypatch.setattr(TA, "_measure_gemm_efficiency",
                        lambda hw, reps, dev: 1e-4)
    fresh = dict(created=time.strftime("%Y-%m-%dT%H:%M:%S"))
    drifted = TA.CalibrationTable(
        fingerprint=table.fingerprint,
        corrections={**table.corrections, "kernel_launch_s": 1e4,
                     "gemm_efficiency": 1e9}, **fresh)
    msgs = TA.staleness(drifted, reps=1)
    assert any("kernel_launch_s drifted" in m for m in msgs)
    assert any("gemm_efficiency drifted" in m for m in msgs)
    assert seen == [torch.device("cpu")]   # the table's device kind
    steady = TA.CalibrationTable(
        fingerprint=table.fingerprint,
        corrections={**table.corrections, "kernel_launch_s": 1.2e-5,
                     "gemm_efficiency": 0.9e-4}, **fresh)
    assert TA.staleness(steady, reps=1) == []


def test_staleness_real_probe_runs_on_the_cpu(table):
    fresh = dataclasses.replace(table,
                                created=time.strftime("%Y-%m-%dT%H:%M:%S"))
    msgs = TA.staleness(fresh, reps=1, drift_threshold=1e9)
    assert msgs == []


def test_measured_policy_warns_once_on_stale_table(tmesh4, table):
    stale = dataclasses.replace(table, created="2020-01-01T00:00:00")
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=stale)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert ctx.active_calibration() is stale
        assert ctx.active_calibration() is stale
    assert len([w for w in rec if "days old" in str(w.message)]) == 1


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_check_stale_and_fresh(table, tmp_path, capsys):
    old = dataclasses.replace(table, created="2020-01-01T00:00:00")
    p_old = old.save(tmp_path / "old.json")
    assert cli.main(["check", str(p_old), "--no-probe"]) == 1
    assert "STALE" in capsys.readouterr().err
    fresh = dataclasses.replace(table,
                                created=time.strftime("%Y-%m-%dT%H:%M:%S"))
    p_fresh = fresh.save(tmp_path / "fresh.json")
    assert cli.main(["check", str(p_fresh), "--no-probe"]) == 0
    assert "within threshold" in capsys.readouterr().out
    assert cli.main(["check", str(p_fresh), "--reps", "1", "--drift",
                     "1e9"]) == 0
    assert "looks fresh" in capsys.readouterr().out


def test_cli_show_and_diff(table, tmp_path, capsys):
    a = table.save(tmp_path / "a.json")
    b = TA.CalibrationTable(
        fingerprint=table.fingerprint,
        corrections={**table.corrections,
                     "ici_bandwidth": table.corrections["ici_bandwidth"] * 2},
        measurements=list(table.measurements)).save(tmp_path / "b.json")
    assert cli.main(["show", str(a)]) == 0
    out = capsys.readouterr().out
    assert "fingerprint:" in out and "ici_bandwidth" in out
    assert f"torch={torch.__version__}" in out
    assert cli.main(["diff", str(a), str(b)]) == 0
    out = capsys.readouterr().out
    assert "+100.0%" in out and "shared grid points" in out
    assert cli.main(["diff", str(a)]) == 0
    assert "analytic h100_sxm" in capsys.readouterr().out


def test_cli_diff_refuses_incompatible(table, tmp_path, capsys):
    a = table.save(tmp_path / "a.json")
    b = TA.CalibrationTable(
        fingerprint=dataclasses.replace(table.fingerprint, backend="cuda"),
        corrections=dict(table.corrections)).save(tmp_path / "b.json")
    assert cli.main(["diff", str(a), str(b)]) == 1
    assert "incompatible" in capsys.readouterr().err


def test_cli_calibrate_writes_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    assert cli.main(["calibrate", "--grid", "tiny", "--reps", "1",
                     "--device", "cpu", "--devices", "2"]) == 0
    TA.clear_caches()
    t = TA.find_table("h100_sxm", device="cpu")
    assert t is not None and t.fingerprint.n_devices == 2
    assert t.ops_covered() and t.corrections["ici_bandwidth"] > 0
    out = tmp_path / "fresh.json"
    assert cli.main(["calibrate", "--grid", "tiny", "--reps", "1",
                     "--device", "cpu", "--out", str(out), "--per-island",
                     "--arch", "tinyllama-1.1b", "--reduced", "--batch", "4",
                     "--seq", "16", "--phase", "prefill", "--dtype",
                     "both"]) == 0
    t = TA.CalibrationTable.load(out)
    keys = {r["island"] for r in t.measurements if r.get("island")}
    assert keys == {"mlp|matmul_all_reduce|b2", "mlp|matmul_all_reduce|b1",
                    "attn_out|matmul_all_reduce|b2",
                    "attn_out|matmul_all_reduce|b1"}
    assert "island-keyed rows" in capsys.readouterr().out
    # show with no path resolves the cached table of this device
    assert cli.main(["show"]) == 0
    assert "devices=2" in capsys.readouterr().out


def test_cli_show_without_table(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(TA, "_SEED_DIR", tmp_path / "no-seeds")
    TA.clear_caches()
    assert cli.main(["show"]) == 1
    assert "no calibration table found" in capsys.readouterr().err
    assert cli.main(["check"]) == 1


def test_calibrate_needs_a_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.calibrate(grid="tiny", reps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["calibrate", "--grid", "tiny"])
    t = TA.calibrate(grid=(64,), reps=1, device="cpu")
    assert t.fingerprint.n_devices == 4 and t.fingerprint.backend == "cpu"


# ---------------------------------------------------------------------------
# No silent skips on the card; memoized resolution and lookups
# ---------------------------------------------------------------------------

def _boom(*_):
    raise RuntimeError("the kernel did not launch")


def test_failing_row_raises_on_cuda_and_is_skipped_on_cpu():
    logged = []
    assert TA._time_row(_boom, reps=1, device="cpu", log=logged.append,
                        label="mlp/fused/c=2") is None
    assert logged == ["  mlp/fused/c=2: SKIPPED (RuntimeError: the kernel "
                      "did not launch)"]
    with pytest.raises(RuntimeError, match="mlp/fused/c=2 failed on cuda"):
        TA._time_row(_boom, reps=1, device="cuda", log=logged.append,
                     label="mlp/fused/c=2")
    assert len(logged) == 1


class _FailingCtx:
    """A context whose kernel-backed backends (fused, chunked a2a) raise."""

    def available_backends(self, op):
        return tcomms.OP_BACKENDS[op]

    def matmul_all_reduce(self, x, w, *, backend, n_chunks, wire):
        if backend == "fused":
            _boom()
        return x

    def all_to_all(self, x, *, split_axis, concat_axis, backend, n_chunks):
        if backend == "chunked":
            _boom()
        return x


@pytest.mark.parametrize("sweep", ["gemm", "a2a"])
def test_island_sweeps_stop_on_a_failing_kernel_on_cuda(tmesh4, monkeypatch,
                                                        sweep):
    """A fused or chunked row that raises on a CUDA device stops the sweep;
    on the CPU it is left out, as JAX leaves it out."""
    sw = (TA.IslandSweep(island=MLP_KEY, op="matmul_all_reduce", m=8 * N,
                         n=16, k=8) if sweep == "gemm" else _a2a_sweep())
    rows = TA._sweep_islands(_FailingCtx(), tmesh4, "x", [sw], 1,
                             lambda *_: None)
    assert rows and all(r["backend"] in ("bulk", "ring") for r in rows)
    monkeypatch.setattr(TA, "_device_type", lambda device: "cuda")
    with pytest.raises(RuntimeError, match=r"/(fused|chunked)/c=\d+ failed"):
        TA._sweep_islands(_FailingCtx(), tmesh4, "x", [sw], 1,
                          lambda *_: None)


def test_a2a_sweep_cases_are_the_rows_calibrate_times(tmesh4):
    sw = _a2a_sweep()
    table = TA.calibrate(tmesh4, grid="tiny", reps=1, islands=[sw])
    got = [(r["backend"], r["n_chunks"]) for r in table.measurements
           if r.get("island") == sw.island]
    assert got == TA.a2a_sweep_cases(sw, N)
    assert got[0] == ("bulk", 1) and len(got) > 1
    bad = dataclasses.replace(sw, shape=(8, 6, 16, 16))   # 6 heads over 4
    assert TA.a2a_sweep_cases(bad, N) == []


def test_device_seconds_is_wall_time_on_the_cpu():
    a = torch.ones((64, 64))
    assert TA._device_seconds(torch.matmul, a, a, reps=1, device="cpu") > 0
    eff = TA._measure_gemm_efficiency(tcm.H100_SXM, 1, "cpu")
    assert 0 < eff < 1


def test_lookups_are_memoized_and_see_appended_rows(tmesh4, monkeypatch):
    live = TA.live_fingerprint("h100_sxm", tmesh4)
    t = _synthetic(live, _rows("matmul_all_reduce",
                               {"bulk": 100.0, "ring": 10.0}, 256, 64, 16))
    scans = []
    rows_for = TA.CalibrationTable._rows_for
    monkeypatch.setattr(TA.CalibrationTable, "_rows_for",
                        lambda self, *a, **kw: scans.append(a)
                        or rows_for(self, *a, **kw))
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=t)
    for _ in range(5):
        assert ctx.auto_gemm_backend("matmul_all_reduce", 256, 64, 16) \
            == "ring"
    assert len(scans) == 1
    assert t.spec(tcm.H100_SXM) is ctx.effective_hw()
    t.measurements += _rows("matmul_all_reduce", {"bulk": 1.0}, 256, 64, 16)
    assert ctx.auto_gemm_backend("matmul_all_reduce", 256, 64, 16) == "bulk"
    assert len(scans) == 2


def test_resolution_is_memoized_until_clear_caches(tmesh4, table,
                                                   monkeypatch):
    checks = []
    usable = TA._usable
    monkeypatch.setattr(TA, "_usable",
                        lambda *a: checks.append(a) or usable(*a))
    ctx = TCtx("x", mesh=tmesh4, policy="measured", calibration=table)
    for _ in range(3):
        ctx.auto_gemm_backend("matmul_all_reduce", 256, 64, 16)
        ctx.gemm_chunk_schedule("matmul_all_reduce", 256, 64, 16,
                                backend="ring")
    assert len(checks) == 1
    assert TCtx("x", mesh=tmesh4, policy="auto",
                calibration=table).active_calibration() is table
    assert len(checks) == 2                 # another policy, another verdict
    TA.clear_caches()
    assert ctx.active_calibration() is table
    assert len(checks) == 3
