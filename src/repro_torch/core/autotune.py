"""Empirical autotuner: measured correction factors for the §3.1.1 cost model.

The twin of ``repro/core/autotune.py`` on virtual ranks. The analytic
decomposition

    T_kernel = T_launch + max(T_comp, T_mem, T_comm) + T_non_overlap + T_sync

prices every schedule from data-sheet constants (``core/costmodel.py``);
this module closes the loop: it **micro-benchmarks every comm backend on
the live mesh**, fits the measurements back into per-``HardwareSpec``
correction factors and keeps them, with the raw rows, as a versioned JSON
*calibration table* that ``CommContext(policy="measured")`` dispatches
from.

Three layers, as in the JAX package:

``calibrate(mesh=...)``
    Runs the micro-benchmarks (link latency/bandwidth sweep, local GEMM
    efficiency probe, per-op × per-backend × shape-grid timings, and with
    ``islands=`` the per-island backend × chunk sweeps) and returns a
    ``CalibrationTable``. Without a mesh it builds a ``(4,)`` mesh of
    virtual ranks on the device (the GPU unless told otherwise).
``CalibrationTable``
    The persisted artifact: a ``Fingerprint`` of the device it was measured
    on, the fitted ``corrections`` and the ``measurements``.
    ``table.spec(hw)`` is the corrected ``HardwareSpec``;
    ``table.best_backend(...)`` answers dispatch queries from the rows.
``find_table(hw_name)``
    Resolution used by ``CommContext``: the user cache
    (``$REPRO_CACHE_DIR`` or ``~/.cache/repro``, file
    ``autotune-torch-<hw>-<torch>.json``) first, then the seed tables under
    ``core/calibrations/`` (``h100_sxm.json``, measured on one H100 by
    ``python -m repro_torch.autotune calibrate``). A table whose
    fingerprint does not match the live device is skipped, and the measured
    policy degrades to the analytic one.

The port's tables have a schema of their own and a cache file name of their
own: the JAX package's tables (``repro-autotune/v1``, fingerprinted by jax
version and TPU or emulated-CPU devices) are refused with ``ValueError``,
never read as the port's, and neither package finds the other's cache
file. On one card the mesh's ranks are virtual: a collective is HBM
traffic, so the "link" rate fitted here is the card's copy rate between
rank slabs, not NVLink's, and a row's ``us`` is the wall time of the whole
mesh (one launch covers every rank), as JAX's rows are a whole mesh's.

CLI (``python -m repro_torch.autotune``): ``calibrate`` / ``show`` /
``diff`` / ``check``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time
import warnings
from pathlib import Path
from typing import Any, Sequence

import torch

SCHEMA = "repro_torch-autotune/v1"
SCHEMA_VERSION = 1


def island_key(name: str, op: str, dtype_bytes: int = 2) -> str:
    """Stable calibration-row key for one island's declared collective.

    Derived from the island's name plus the ``Comm`` coordinates that change
    which backend wins (op kind and element width); NOT from (m, n, k),
    which stays a lookup coordinate so nearby shapes can share rows. Two
    islands with different layouts or dtypes at the same (m, n, k) get
    different keys and can dispatch differently."""
    return f"{name}|{op}|b{int(dtype_bytes)}"


@dataclasses.dataclass(frozen=True)
class IslandSweep:
    """One island's coordinates for the ``calibrate(islands=...)`` sweep:
    the exact (op, m, n, k, dtype) its ``CommContext`` dispatch queries
    with, plus the key the measured rows are tagged with.

    GEMM×collective islands carry the global GEMM (m, n, k). ``all_to_all``
    islands (Ulysses re-sharding, MoE dispatch) also carry the local payload
    ``shape`` and split/concat axes; their (m, n, k) follow
    ``CommContext.a2a_coords`` (payload elements, split extent, concat
    extent), so the rows land where the a2a chunk policy queries."""

    island: str            # island_key(...) the rows carry
    op: str                # a GEMM_OPS member or "all_to_all"
    m: int
    n: int
    k: int
    dtype_bytes: int = 2
    shape: tuple[int, ...] | None = None    # a2a local payload shape
    split_axis: int | None = None
    concat_axis: int | None = None


#: ops the calibrator sweeps; the GEMM×collective keys of comms.OP_BACKENDS.
GEMM_OPS = ("all_gather_matmul", "matmul_reduce_scatter", "matmul_all_reduce")
DEFAULT_OPS = GEMM_OPS + ("psum",)

#: per-device square sizes of the GEMM-op grid: "tiny" for the CPU tests,
#: "small" the CLI default, "full" for the card.
GRIDS: dict[str, tuple[int, ...]] = {
    "tiny": (128,),
    "small": (128, 256, 512),
    "full": (256, 512, 1024, 2048, 4096),
}

_SEED_DIR = Path(__file__).parent / "calibrations"


def cache_dir() -> Path:
    env = os.environ.get("REPRO_CACHE_DIR")
    if env:
        return Path(env).expanduser()
    return Path("~/.cache/repro").expanduser()


# ---------------------------------------------------------------------------
# Fingerprint
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """Identity of (spec being corrected, software, device) for one table."""

    hw: str             # HardwareSpec.name the corrections apply to
    torch_version: str
    backend: str        # "cuda" or "cpu"
    device_kind: str    # torch.cuda.get_device_name(), or "cpu"
    n_devices: int      # the mesh's rank count

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Fingerprint":
        return cls(hw=d["hw"], torch_version=d["torch_version"],
                   backend=d["backend"], device_kind=d["device_kind"],
                   n_devices=int(d["n_devices"]))

    @staticmethod
    def _torch_mm(v: str) -> str:
        return ".".join(v.split(".")[:2])

    def compatible(self, live: "Fingerprint", *, strict: bool = False) -> bool:
        """Can a table stamped `self` serve a process that looks like `live`?

        Non-strict (the dispatch default) requires the same corrected spec,
        backend, device kind and torch major.minor — what the corrections
        depend on. Strict also pins the exact torch version and the rank
        count (``diff`` refuses apples-to-oranges comparisons with it)."""
        base = (self.hw == live.hw and self.backend == live.backend
                and self.device_kind == live.device_kind
                and self._torch_mm(self.torch_version)
                == self._torch_mm(live.torch_version))
        if not strict:
            return base
        return (base and self.torch_version == live.torch_version
                and self.n_devices == live.n_devices)


def live_fingerprint(hw_name: str, mesh=None, *, device=None) -> Fingerprint:
    """Fingerprint of this process on ``mesh``'s device (else ``device``,
    else the GPU when there is one)."""
    from repro_torch.launch.mesh import device_fingerprint

    d = device_fingerprint(mesh, device=device)
    return Fingerprint(hw=hw_name, torch_version=torch.__version__,
                       backend=d["backend"], device_kind=d["device_kind"],
                       n_devices=d["n_devices"])


def cache_path(fp: Fingerprint) -> Path:
    """``<cache_dir>/autotune-torch-<hw>-<torch>.json`` for this
    fingerprint (the JAX package's file is ``autotune-<hw>-<jax>.json``)."""
    return cache_dir() / f"autotune-torch-{fp.hw}-{fp.torch_version}.json"


# ---------------------------------------------------------------------------
# CalibrationTable
# ---------------------------------------------------------------------------


def _memo_lookup(fn):
    """Memoize a table lookup on the table: the measured policy asks the
    same question on every call of an island (JAX asks once, at trace
    time). The key holds the arguments, the row count (rows appended after
    a lookup are seen) and the corrections; rows edited in place are not."""

    @functools.wraps(fn)
    def lookup(self, *args, **kw):
        key = (fn.__name__, len(self.measurements),
               tuple(sorted(self.corrections.items())), args,
               tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                            for k, v in kw.items())))
        try:
            return self._memo[key]
        except KeyError:
            out = self._memo[key] = fn(self, *args, **kw)
            return out
    return lookup


@dataclasses.dataclass(eq=False)
class CalibrationTable:
    """Measured corrections + raw micro-benchmark rows for one device.

    ``corrections`` maps ``HardwareSpec`` field names to fitted values
    (``ici_bandwidth``, ``remote_sync_s``, ``gemm_efficiency``,
    ``kernel_launch_s``). ``measurements`` rows are ``{op, backend,
    axis_size, m, n, k, us}`` (with ``dtype_bytes``, ``n_chunks`` and an
    ``island`` key where swept) with (m, n, k) the *global* GEMM shape — the
    coordinates ``CommContext.auto_gemm_backend`` receives."""

    fingerprint: Fingerprint
    corrections: dict[str, float]
    measurements: list[dict] = dataclasses.field(default_factory=list)
    version: int = SCHEMA_VERSION
    created: str = ""
    notes: str = ""
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False)

    # -- persistence -------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA,
            "version": self.version,
            "created": self.created,
            "notes": self.notes,
            "fingerprint": self.fingerprint.to_dict(),
            "corrections": dict(self.corrections),
            "measurements": list(self.measurements),
        }

    @classmethod
    def from_json(cls, doc: dict) -> "CalibrationTable":
        if doc.get("schema") != SCHEMA:
            raise ValueError(
                f"not a {SCHEMA} document (schema={doc.get('schema')!r})")
        return cls(fingerprint=Fingerprint.from_dict(doc["fingerprint"]),
                   corrections={k: float(v)
                                for k, v in doc["corrections"].items()},
                   measurements=list(doc.get("measurements", [])),
                   version=int(doc.get("version", SCHEMA_VERSION)),
                   created=doc.get("created", ""),
                   notes=doc.get("notes", ""))

    def save(self, path: str | Path) -> Path:
        path = Path(path).expanduser()
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_json(), indent=1, sort_keys=True))
        return path

    @classmethod
    def load(cls, path: str | Path) -> "CalibrationTable":
        return cls.from_json(json.loads(Path(path).expanduser().read_text()))

    # -- consumption -------------------------------------------------------

    @_memo_lookup
    def spec(self, base):
        """`base` HardwareSpec with this table's corrections applied."""
        return base.calibrated(**self.corrections)

    @staticmethod
    def _log_dist(m: int, n: int, k: int, row_m, row_n, row_k) -> float:
        return max(abs(math.log(max(m, 1) / max(row_m, 1))),
                   abs(math.log(max(n, 1) / max(row_n, 1))),
                   abs(math.log(max(k, 1) / max(row_k, 1))))

    def _rows_for(self, op: str, *, island: str | None,
                  axis_size: int | None, dtype_bytes: int | None,
                  island_only: bool = False):
        """Measurement rows of `op` usable for a dispatch query, in island
        precedence order: rows tagged with the caller's island key first,
        then the global (untagged) rows. Rows of a *different* island never
        match. At most two non-empty tiers; ``island_only`` drops the global
        tier (callers that must not mix tiers, e.g. a hidden-fraction
        delta)."""
        tiers: list[list[dict]] = [[], []]
        for row in self.measurements:
            if row["op"] != op:
                continue
            if axis_size is not None and row["axis_size"] != axis_size:
                continue
            if dtype_bytes is not None:
                row_b = row.get("dtype_bytes")
                if row_b is None:
                    # legacy rows predate the dtype axis: they may serve any
                    # full-precision query, never a quantized-wire (b1) one
                    if dtype_bytes < 2:
                        continue
                elif row_b != dtype_bytes:
                    continue
            tag = row.get("island")
            if tag is None:
                tiers[1].append(row)
            elif island is not None and tag == island:
                tiers[0].append(row)
        if island_only and island is not None:
            tiers = tiers[:1]
        return [t for t in tiers if t]

    def _argmin_at_nearest(self, tier, m: int, n: int, k: int,
                           key_of_row, max_ratio: float):
        """argmin of ``us`` over ``key_of_row(row)`` groups at the single
        nearest (m, n, k) grid point where >= 2 distinct keys were measured
        (one key is not a comparison), or None past ``max_ratio`` log
        distance. Shared by ``best_backend`` and ``best_chunks``."""
        pts: dict[tuple, dict] = {}
        for row in tier:
            key = key_of_row(row)
            if key is None:
                continue
            point = (row["m"], row["n"], row["k"])
            timed = pts.setdefault(point, {})
            timed[key] = min(timed.get(key, math.inf), float(row["us"]))
        best_point, best_d = None, math.inf
        for point, timed in pts.items():
            if len(timed) < 2:
                continue
            d = self._log_dist(m, n, k, *point)
            if d < best_d:
                best_point, best_d = point, d
        if best_point is None or best_d > math.log(max_ratio):
            return None
        timed = pts[best_point]
        return min(timed, key=timed.get)

    @_memo_lookup
    def measured_us(self, op: str, backend: str, m: int, n: int, k: int,
                    *, axis_size: int | None = None,
                    dtype_bytes: int | None = None,
                    island: str | None = None, island_only: bool = False,
                    max_ratio: float = 4.0) -> float | None:
        """The measurement for (op, backend) at the nearest grid point, or
        None when that point is more than ``max_ratio`` away in every-
        dimension log distance. ``dtype_bytes`` filters to rows of that
        element width (legacy rows without one serve full-precision queries
        only); ``island`` prefers its own rows, then the global ones
        (``island_only`` disables the fallback)."""
        for tier in self._rows_for(op, island=island, axis_size=axis_size,
                                   dtype_bytes=dtype_bytes,
                                   island_only=island_only):
            best, best_d = None, math.inf
            for row in tier:
                if row["backend"] != backend:
                    continue
                d = self._log_dist(m, n, k, row["m"], row["n"], row["k"])
                # equal-distance tie (chunk-count variants at one point):
                # the backend's best configuration represents it
                if d < best_d or (best is not None and d == best_d
                                  and float(row["us"]) < float(best["us"])):
                    best, best_d = row, d
            if best is not None and best_d <= math.log(max_ratio):
                return float(best["us"])
        return None

    @_memo_lookup
    def best_backend(self, op: str, m: int, n: int, k: int, *,
                     allowed: Sequence[str],
                     axis_size: int | None = None,
                     dtype_bytes: int | None = None,
                     island: str | None = None,
                     max_ratio: float = 4.0) -> str | None:
        """argmin over measured backends of `op` near (m, n, k), restricted
        to `allowed`. Backends are compared **at a single shared grid
        point** — the nearest (m, n, k) where at least two allowed backends
        were measured — so a backend measured only at a smaller shape cannot
        win on size. Island rows first, then the global rows; None when no
        shared point is within ``max_ratio`` (the caller goes analytic)."""
        for tier in self._rows_for(op, island=island, axis_size=axis_size,
                                   dtype_bytes=dtype_bytes):
            best = self._argmin_at_nearest(
                tier, m, n, k,
                lambda r: r["backend"] if r["backend"] in allowed else None,
                max_ratio)
            if best is not None:
                return best
        return None

    @_memo_lookup
    def best_chunks(self, op: str, backend: str, m: int, n: int, k: int, *,
                    axis_size: int | None = None,
                    dtype_bytes: int | None = None,
                    island: str | None = None,
                    max_ratio: float = 4.0) -> int | None:
        """Measured sub-chunk count: the argmin-us ``n_chunks`` among this
        (op, backend)'s rows at the nearest point where at least two
        distinct counts were measured; None otherwise (the analytic chunk
        scheduler decides). Same tiers as ``best_backend``."""
        for tier in self._rows_for(op, island=island, axis_size=axis_size,
                                   dtype_bytes=dtype_bytes):
            best = self._argmin_at_nearest(
                tier, m, n, k,
                lambda r: (int(r.get("n_chunks", 1) or 1)
                           if r["backend"] == backend else None),
                max_ratio)
            if best is not None:
                return best
        return None

    def ops_covered(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for row in self.measurements:
            out[row["op"]] = out.get(row["op"], 0) + 1
        return out


# ---------------------------------------------------------------------------
# Table resolution (cache -> in-repo seeds), used by CommContext.
# ---------------------------------------------------------------------------

_warned: set[str] = set()
#: bumped by clear_caches(): resolve_table's verdicts memoized on a table
#: are computed again, with their warnings
_generation = [0]


def _warn_once(key: str, msg: str) -> None:
    if key not in _warned:
        _warned.add(key)
        warnings.warn(msg, stacklevel=3)


def _candidate_paths(fp: Fingerprint) -> list[Path]:
    paths = [cache_path(fp)]
    if _SEED_DIR.is_dir():
        paths.extend(sorted(_SEED_DIR.glob("*.json")))
    return paths


def _device_type(device) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def find_table(hw_name: str, *, device=None) -> CalibrationTable | None:
    """The calibration table ``policy="measured"|"auto"`` dispatches from.

    Search order: the user cache for this (hw, torch) pair, then the seed
    tables. The first table whose fingerprint is compatible with the live
    device (``device``, else the GPU when there is one) wins; incompatible
    and unreadable tables are skipped (the latter with a one-shot warning
    naming the file)."""
    live = live_fingerprint(hw_name, device=_device_type(device))
    for path in _candidate_paths(live):
        if not path.is_file():
            continue
        try:
            table = CalibrationTable.load(path)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            _warn_once(f"unreadable:{path}",
                       f"ignoring unreadable calibration table {path}: {e}")
            continue
        if table.fingerprint.compatible(live):
            return table
    return None


def clear_caches() -> None:
    """Reset memoized lookups (tests; after writing a new cache table)."""
    _load_cached.cache_clear()
    _find_cached.cache_clear()
    _live_cached.cache_clear()
    _warned.clear()
    _generation[0] += 1


_load_cached = functools.lru_cache(maxsize=32)(CalibrationTable.load)
_find_cached = functools.lru_cache(maxsize=8)(find_table)
# a device's fingerprint never changes within a process; memoized so every
# policy-routed collective does not query the driver again
_live_cached = functools.lru_cache(maxsize=8)(live_fingerprint)


def resolve_table(calibration: Any, hw_name: str, policy: str, *,
                  device=None) -> CalibrationTable | None:
    """Map a ``CommContext`` (policy, calibration) pair to a usable table.

    ``calibration`` may be a ``CalibrationTable``, a path, or None (search
    cache + seeds). ``device`` is the device the context runs on (its
    mesh's; None: the GPU when there is one), whose fingerprint the table
    must match. Under ``policy="measured"`` a missing or mismatched table
    warns once and returns None — the context then runs the analytic
    policy; under ``"auto"`` the same fallback is silent, except for an
    explicitly given table or path."""
    if policy == "analytic":
        return None
    if policy not in ("measured", "auto"):
        raise ValueError(
            f"unknown comm policy {policy!r}; expected 'analytic', "
            "'measured' or 'auto'")
    dev = _device_type(device)
    table: CalibrationTable | None
    if isinstance(calibration, CalibrationTable):
        table = calibration
    elif calibration is not None:
        try:
            table = _load_cached(str(calibration))
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            # an explicitly configured path that does not load warns under
            # "auto" too: auto's silence covers implicit search misses
            _warn_once(f"load:{calibration}",
                       f"calibration table {calibration!r} could not be "
                       f"loaded ({e}); falling back to analytic costs")
            return None
    else:
        table = _find_cached(hw_name, device=dev)
        if table is None:
            if policy == "measured":
                _warn_once(f"missing:{hw_name}:{dev}",
                           "policy='measured' but no calibration table found "
                           f"for hw={hw_name!r} on {dev} (searched "
                           f"{cache_path(_live_cached(hw_name, device=dev))}"
                           f" and {_SEED_DIR}); run `python -m "
                           "repro_torch.autotune calibrate`; falling back "
                           "to analytic costs")
            return None
    # the verdict is memoized on the table until clear_caches(): a measured
    # context resolves its table on every collective it dispatches
    explicit = calibration is not None
    key = ("verdict", _generation[0], hw_name, policy, dev, explicit,
           table.created)
    ok = table._memo.get(key)
    if ok is None:
        ok = table._memo[key] = _usable(table, hw_name, policy, dev,
                                        explicit)
    return table if ok else None


def _usable(table: CalibrationTable, hw_name: str, policy: str, dev: str,
            explicit: bool) -> bool:
    """Whether ``resolve_table`` may dispatch from ``table``: its
    fingerprint matches the live device (else a warning, under "auto" only
    for an explicitly given table); under "measured" an old table warns
    and is used."""
    live = _live_cached(hw_name, device=dev)
    if not table.fingerprint.compatible(live):
        # an explicitly supplied table that is rejected warns under "auto"
        # too; only tables found by the implicit search are skipped quietly
        if policy == "measured" or explicit:
            _warn_once(f"fingerprint:{hw_name}:{table.fingerprint}",
                       f"calibration table fingerprint {table.fingerprint} "
                       f"does not match this process {live}; falling back "
                       "to analytic costs")
        return False
    if policy == "measured":
        # measurements can rot in place (driver, clocks, power limit): the
        # table is still USED; its age is a warning, not a rejection
        age = table_age_days(table)
        if age is not None and age > STALE_AFTER_DAYS:
            _warn_once(f"stale:{hw_name}",
                       f"calibration table for hw={hw_name!r} is "
                       f"{age:.0f} days old (> {STALE_AFTER_DAYS:.0f}); "
                       "its measurements may no longer reflect this device "
                       "— re-run `python -m repro_torch.autotune "
                       "calibrate`, or audit with `python -m "
                       "repro_torch.autotune check`")
    return True


# ---------------------------------------------------------------------------
# Staleness audit (the `python -m repro_torch.autotune check` backend)
# ---------------------------------------------------------------------------

#: age past which a fingerprint-compatible table warns under
#: ``policy="measured"`` (and fails ``repro_torch.autotune check``)
STALE_AFTER_DAYS = 30.0


def table_age_days(table: CalibrationTable) -> float | None:
    """Days since the table's ``created`` stamp; None when unparseable."""
    if not table.created:
        return None
    try:
        t = time.mktime(time.strptime(table.created, "%Y-%m-%dT%H:%M:%S"))
    except ValueError:
        return None
    return max(0.0, (time.time() - t) / 86400.0)


def staleness(table: CalibrationTable, *,
              max_age_days: float = STALE_AFTER_DAYS,
              drift_threshold: float = 0.5, probe: bool = True,
              reps: int = 3, device=None) -> list[str]:
    """Reasons this table should be re-calibrated; empty = looks fresh.

    Two checks: the ``created`` stamp's age against ``max_age_days``, and
    (with ``probe``) a spot re-measurement of the device-local corrections
    — launch overhead and sustained GEMM efficiency — against the table's
    at ``drift_threshold`` relative drift. The probe runs on ``device``
    (default: the device kind the table was measured on; the GPU for a
    card's table, which must exist)."""
    msgs: list[str] = []
    age = table_age_days(table)
    if age is None:
        msgs.append("table has no parseable 'created' timestamp — age "
                    "cannot be checked")
    elif age > max_age_days:
        msgs.append(f"table is {age:.0f} days old "
                    f"(threshold {max_age_days:.0f})")
    if not probe:
        return msgs
    from repro_torch.compat import resolve_device
    from repro_torch.core import costmodel as cm

    if device is None and table.fingerprint.backend != "cuda":
        device = table.fingerprint.backend
    dev = resolve_device(device)
    hw = getattr(cm, table.fingerprint.hw.upper(), cm.H100_SXM)
    probes = {"kernel_launch_s": _measure_launch(reps, dev),
              "gemm_efficiency": _measure_gemm_efficiency(hw, reps, dev)}
    for key, now in probes.items():
        old = table.corrections.get(key)
        if not old:
            continue
        drift = abs(now - old) / old
        if drift > drift_threshold:
            msgs.append(f"{key} drifted {drift * 100:.0f}% vs spot probe "
                        f"(table {old:.3g}, now {now:.3g}; threshold "
                        f"{drift_threshold * 100:.0f}%)")
    return msgs


# ---------------------------------------------------------------------------
# Micro-benchmarks. Operands are stacked (R, *local) tensors on the mesh's
# device; every backend is pinned per call and runs under no_grad (the fused
# AG×GEMM and GEMM×RS are forward-only, ROADMAP C9).
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, *args, reps: int = 3, warmup: int = 1, device="cpu") -> float:
    """Median wall seconds a call: ``warmup`` calls first (a kernel's first
    use builds it there, never in a timed rep), then ``reps`` calls, each
    ended by a device synchronize (JAX's ``block_until_ready``)."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _time_row(fn, *args, reps: int, device, log, label: str) -> float | None:
    """``_timeit`` of one sweep row. On the CPU a row that raises is logged
    and left out (JAX skips such rows). On a CUDA device it raises: a
    kernel that does not build or launch at a sweep's shape must stop the
    calibration, not leave its rows out of the table, where the measured
    policy would then quietly send that site to the plain backends."""
    try:
        return _timeit(fn, *args, reps=reps, device=device)
    except Exception as e:  # noqa: BLE001 — skipped on the CPU only
        if _device_type(device) == "cuda":
            raise RuntimeError(f"calibration row {label} failed on "
                               f"{device}: {type(e).__name__}: {e}") from e
        log(f"  {label}: SKIPPED ({type(e).__name__}: {e})")
        return None


def _device_seconds(fn, *args, reps: int = 3, calls: int = 10,
                    device="cpu") -> float:
    """Median device seconds a call, free of the host's launch path.

    On CUDA the stream first spins (``torch.cuda._sleep``) while the host
    queues ``calls`` calls behind the spin, so CUDA events around them
    time the device's work back to back; the spin is lengthened until it
    outlasts the host's queueing. On the CPU there is no such split:
    ``_timeit``'s wall time."""
    if torch.device(device).type != "cuda":
        return _timeit(fn, *args, reps=reps, device=device)
    fn(*args)                            # a kernel's first use builds it
    torch.cuda.synchronize(device)
    cycles, times = 1 << 24, []
    while len(times) < reps:
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        host = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize(device)
        if spin.elapsed_time(start) * 1e-3 < 1.5 * host:
            if cycles >= 1 << 34:
                raise RuntimeError("the host could not queue the calls "
                                   "inside a spin of the stream")
            cycles *= 4                  # the device caught up: spin longer
            continue
        times.append(start.elapsed_time(end) * 1e-3 / calls)
    times.sort()
    return times[len(times) // 2]


def _fit_line(xs: Sequence[float], ys: Sequence[float]) -> tuple[float, float]:
    """Least-squares y = a + b*x; returns (a, b)."""
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx == 0.0:
        return my, 0.0
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    return my - b * mx, b


def _measure_link(mesh, axis_name: str, reps: int) -> tuple[float, float]:
    """(achieved bytes/s per rank, per-hop overhead seconds).

    Times the bulk one-hop ``ring_shift`` of a stacked payload over JAX's
    sizes (16 KiB .. 4 MiB a rank) and fits t = overhead + bytes/B. On one
    card the ranks are slabs of one allocation, so B is the card's copy
    rate between them (HBM), not NVLink's, and the intercept is the
    launch-and-sync cost of one hop."""
    from repro_torch.core.comms import CommContext

    ctx = CommContext(axis_name=axis_name, mesh=mesh)
    sizes = (2 ** 14, 2 ** 18, 2 ** 22)
    xs, ys = [], []
    for nbytes in sizes:
        x = torch.ones((mesh.shape[axis_name], nbytes // 4),
                       dtype=torch.float32, device=mesh.device)
        t = _timeit(lambda t: ctx.ring_shift(t, backend="bulk"), x,
                    reps=reps, device=mesh.device)
        xs.append(float(nbytes))
        ys.append(t)
    overhead, inv_bw = _fit_line(xs, ys)
    bw = (1.0 / inv_bw) if inv_bw > 0 else xs[-1] / max(ys[-1], 1e-12)
    return max(bw, 1.0), max(overhead, 1e-9)


def _measure_gemm_efficiency(hw, reps: int, device="cpu") -> float:
    """Sustained local-GEMM fraction of ``hw.peak_flops_bf16``: the B1 GEMM
    (``kernels/matmul.py::matmul``, the mainloop every fused kernel shares)
    at 512² bf16, timed on the device alone (``_device_seconds``): the cost
    model prices a GEMM's compute with it, and the host's launch path is
    priced apart (``kernel_launch_s``). On the CPU it is the plain
    version's wall time, far below 1.0."""
    from repro_torch.kernels.matmul import matmul

    n = 512
    a = torch.ones((n, n), dtype=torch.bfloat16, device=device)
    t = _device_seconds(matmul, a, a, reps=reps, device=device)
    achieved = 2.0 * n ** 3 / max(t, 1e-12)
    return min(max(achieved / hw.peak_flops_bf16, 1e-9), 1.0)


def _measure_launch(reps: int, device="cpu") -> float:
    """Wall time of a trivial device op (the T_launch analogue)."""
    x = torch.ones((8,), dtype=torch.float32, device=device)
    return max(_timeit(lambda t: t + 1.0, x, reps=reps, device=device), 1e-9)


def _randn(shape, dtype, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)


def _gemm_case(op: str, nsz: int, n_dev: int, device="cpu"):
    """(stacked (x, w), (m, n, k)) for one grid point of `op`.

    (m, n, k) MUST be the exact coordinates ``CommContext``'s dispatch
    queries with (``auto_gemm_backend``'s arguments): for AG+GEMM the
    gathered GEMM's global m (the sharded rows' total, nsz); for RS/AR
    (global m, n, local k). Rows stored in any other coordinate system
    would never be found by the 4x log-distance lookup."""
    if op == "all_gather_matmul":
        x = _randn((n_dev, nsz // n_dev, nsz // 4), torch.bfloat16, 0,
                   device)
        w = _randn((nsz // 4, nsz // 4), torch.bfloat16, 1, device)
        w = w.unsqueeze(0).expand(n_dev, -1, -1).contiguous()
        return (x, w), (nsz, nsz // 4, nsz // 4)
    x = _randn((n_dev, nsz, nsz // 8), torch.bfloat16, 0, device)
    w = _randn((n_dev, nsz // 8, nsz // 4), torch.bfloat16, 1, device)
    return (x, w), (nsz, nsz // 4, nsz // 8)


def _feasible(op: str, backend: str, n_dev: int, nsz: int,
              available: Sequence[str], device=None) -> bool:
    if backend not in available:
        return False
    if backend == "ring_bidir":
        # the bidirectional ring splits the local shard across the two
        # directions: >= 2 local rows and an even axis, or the impl runs the
        # one-way ring and the row would be mislabelled
        return (op == "all_gather_matmul" and n_dev % 2 == 0
                and nsz // n_dev >= 2)
    if backend == "fused":
        # timed only on a CUDA device: on the CPU it runs the kernels'
        # plain versions, whose times would poison the table (JAX likewise
        # times no interpret-mode kernel)
        return _device_type(device) == "cuda"
    return True


def _sweep_gemm_ops(ctx, mesh, axis_name: str, sizes: Sequence[int],
                    reps: int, log, *, dtype_bytes: int = 2) -> list[dict]:
    """One pass over the GEMM-op grid at one wire width.

    ``dtype_bytes=2`` is the bf16 sweep. ``dtype_bytes=1`` measures the
    *int8 wire*: operands stay bf16, ring backends run ``wire="int8"``, the
    bulk baseline is timed unquantized but recorded under the same ``b1``
    width (a b1 query compares the int8 ring against the bulk it would
    replace). Fused is excluded at b1: its kernels ship full precision."""
    n_dev = mesh.shape[axis_name]
    wire = "int8" if dtype_bytes == 1 else None
    rows: list[dict] = []
    for op in GEMM_OPS:
        avail = ctx.available_backends(op)
        for nsz in sizes:
            args, (m, n, k) = _gemm_case(op, nsz, n_dev, mesh.device)
            for be in ("bulk", "ring", "ring_bidir", "fused"):
                if be == "fused" and wire is not None:
                    continue
                if not _feasible(op, be, n_dev, nsz, avail, mesh.device):
                    continue
                # the global grid pins the 1-chunk ring; chunk variants are
                # swept per island (calibrate --per-island)
                fn = functools.partial(getattr(ctx, op), backend=be,
                                       n_chunks=1, wire=wire)
                t = _time_row(fn, *args, reps=reps, device=mesh.device,
                              log=log, label=f"{op}/{be}/N={nsz}/"
                                             f"b{dtype_bytes}")
                if t is None:
                    continue
                rows.append({"op": op, "backend": be, "axis_size": n_dev,
                             "m": m, "n": n, "k": k,
                             "dtype_bytes": dtype_bytes,
                             "n_chunks": 1, "us": t * 1e6})
                log(f"  {op}/{be}/N={nsz}/b{dtype_bytes}: {t * 1e6:.1f} us")
    return rows


#: sub-chunk counts the per-island sweep measures for each ring backend.
ISLAND_CHUNK_SWEEP = (1, 2, 4)

#: sub-chunk counts the per-island sweep measures for the fused backend,
#: one octave more than the rings (``costmodel.fused_pipeline_cost``).
ISLAND_FUSED_CHUNK_SWEEP = (1, 2, 4, 8)


def island_sweep_cases(sw: IslandSweep, n_dev: int,
                       available: Sequence[str],
                       device=None) -> list[tuple[str, int]]:
    """The (backend, n_chunks) grid the per-island GEMM sweep times for one
    island, as a pure function:

    * ``bulk`` always, at 1 chunk;
    * ``ring`` over :data:`ISLAND_CHUNK_SWEEP`; ``ring_bidir`` joins it for
      AG×GEMM on an even axis with >= 2 local rows;
    * ``fused`` over :data:`ISLAND_FUSED_CHUNK_SWEEP` on a CUDA ``device``
      (default: the GPU when there is one) and a full-precision sweep."""
    backends = ["bulk", "ring"]
    if (sw.op == "all_gather_matmul" and sw.m // n_dev >= 2
            and n_dev % 2 == 0):
        backends.append("ring_bidir")
    if sw.dtype_bytes != 1 and _feasible(sw.op, "fused", n_dev, sw.m,
                                         available, device):
        backends.append("fused")
    cases: list[tuple[str, int]] = []
    for be in backends:
        if be == "bulk":
            counts: Sequence[int] = (1,)
        elif be == "fused":
            counts = ISLAND_FUSED_CHUNK_SWEEP
        else:
            counts = ISLAND_CHUNK_SWEEP
        cases += [(be, c) for c in counts]
    return cases


def a2a_sweep_cases(sw: IslandSweep, n_dev: int) -> list[tuple[str, int]]:
    """The (backend, n_chunks) grid the per-island all-to-all sweep times:
    ``bulk``, then ``chunked`` at each count of :data:`ISLAND_CHUNK_SWEEP`
    past 1 that a bystander dim of the payload splits into (each fitted
    count once); none when the split dim does not divide over the axis."""
    from repro_torch.core.schedule import a2a_chunk_axis

    shape = tuple(sw.shape)
    if shape[sw.split_axis] % n_dev != 0:
        return []
    cases = [("bulk", 1)]
    seen = {1}
    for c in ISLAND_CHUNK_SWEEP[1:]:
        fit = a2a_chunk_axis(shape, sw.split_axis, sw.concat_axis, c)
        if fit is None or fit[1] in seen:
            continue
        seen.add(fit[1])
        cases.append(("chunked", fit[1]))
    return cases


def _sweep_a2a_island(ctx, mesh, axis_name: str, sw: IslandSweep,
                      reps: int, log) -> list[dict]:
    """Bulk vs chunked all-to-all at one island's exact payload shape, rows
    tagged with its key and stored under ``CommContext.a2a_coords`` so
    ``a2a_chunk_schedule`` finds them. Chunked rows launch the all-to-all
    kernel of ``kernels/pk_comm.py`` on the card, one launch a chunk."""
    n_dev = mesh.shape[axis_name]
    shape = tuple(sw.shape)
    sa, ca = sw.split_axis, sw.concat_axis
    cases = a2a_sweep_cases(sw, n_dev)
    if not cases:
        log(f"  island {sw.island}: a2a split dim {shape[sa]} not divisible "
            f"by {n_dev}-rank axis, skipped")
        return []
    dtype = torch.bfloat16 if sw.dtype_bytes == 2 else torch.float32
    x = _randn((n_dev, *shape), dtype, 0, mesh.device)
    rows: list[dict] = []
    for be, c in cases:
        fn = functools.partial(ctx.all_to_all, split_axis=sa, concat_axis=ca,
                               backend=be, n_chunks=c)
        t = _time_row(fn, x, reps=reps, device=mesh.device, log=log,
                      label=f"{sw.island}/{be}/c={c}")
        if t is None:
            continue
        rows.append({"op": "all_to_all", "backend": be, "axis_size": n_dev,
                     "m": sw.m, "n": sw.n, "k": sw.k,
                     "dtype_bytes": sw.dtype_bytes, "n_chunks": c,
                     "island": sw.island, "us": t * 1e6})
        log(f"  {sw.island}/{be}/c={c}: {t * 1e6:.1f} us")
    return rows


def _sweep_islands(ctx, mesh, axis_name: str, sweeps: Sequence[IslandSweep],
                   reps: int, log) -> list[dict]:
    """Every feasible backend × chunk count at each island's exact declared
    coordinates, rows tagged with the island key, so
    ``CommContext(island=...)`` dispatch and ``Island.plan()`` prefer them
    over the shape grid."""
    n_dev = mesh.shape[axis_name]
    dev = mesh.device
    rows: list[dict] = []
    for sw in sweeps:
        if sw.op == "all_to_all" and sw.shape is not None:
            rows += _sweep_a2a_island(ctx, mesh, axis_name, sw, reps, log)
            continue
        if sw.op not in GEMM_OPS:
            log(f"  island {sw.island}: op {sw.op} not sweepable, skipped")
            continue
        if sw.m % n_dev != 0:
            log(f"  island {sw.island}: m={sw.m} not divisible by "
                f"{n_dev}-rank axis, skipped")
            continue
        # dtype_bytes=1: bf16 operands, rings quantized (wire="int8"), bulk
        # unquantized under the same b1 key
        wire = "int8" if sw.dtype_bytes == 1 else None
        dtype = torch.float32 if sw.dtype_bytes == 4 else torch.bfloat16
        if sw.op == "all_gather_matmul":
            x = _randn((n_dev, sw.m // n_dev, sw.k), dtype, 0, dev)
            w = _randn((sw.k, sw.n), dtype, 1, dev)
            w = w.unsqueeze(0).expand(n_dev, -1, -1).contiguous()
        else:
            x = _randn((n_dev, sw.m, sw.k), dtype, 0, dev)
            w = _randn((n_dev, sw.k, sw.n), dtype, 1, dev)
        for be, c in island_sweep_cases(sw, n_dev,
                                        ctx.available_backends(sw.op), dev):
            fused = be == "fused"
            fn = functools.partial(getattr(ctx, sw.op), backend=be,
                                   n_chunks=c, wire=None if fused else wire)
            t = _time_row(fn, x, w, reps=reps, device=dev, log=log,
                          label=f"{sw.island}/{be}/c={c}")
            if t is None:
                continue
            rows.append({"op": sw.op, "backend": be, "axis_size": n_dev,
                         "m": sw.m, "n": sw.n, "k": sw.k,
                         "dtype_bytes": sw.dtype_bytes, "n_chunks": c,
                         "island": sw.island, "us": t * 1e6})
            log(f"  {sw.island}/{be}/c={c}: {t * 1e6:.1f} us")
    return rows


def _sweep_psum(ctx, mesh, axis_name: str, sizes: Sequence[int],
                reps: int, log) -> list[dict]:
    """psum bulk vs ring of an (n_dev, nsz) bf16 payload a rank, stored at
    (m, n, k) = (n_dev, nsz, 1): psum's dispatch coordinates."""
    n_dev = mesh.shape[axis_name]
    rows: list[dict] = []
    for nsz in sizes:
        x = torch.ones((n_dev, n_dev, nsz), dtype=torch.bfloat16,
                       device=mesh.device)
        for be in ("bulk", "ring"):
            fn = functools.partial(ctx.psum, backend=be)
            t = _time_row(fn, x, reps=reps, device=mesh.device, log=log,
                          label=f"psum/{be}/N={nsz}")
            if t is None:
                continue
            rows.append({"op": "psum", "backend": be, "axis_size": n_dev,
                         "m": n_dev, "n": nsz, "k": 1, "dtype_bytes": 2,
                         "us": t * 1e6})
            log(f"  psum/{be}/N={nsz}: {t * 1e6:.1f} us")
    return rows


def calibrate(mesh=None, *, axis_name: str = "x", hw=None,
              grid: str | Sequence[int] = "small", reps: int = 3,
              notes: str = "", verbose: bool = False,
              islands: Sequence[IslandSweep] = (),
              dtypes: Sequence[int] = (2,),
              device=None) -> CalibrationTable:
    """Run the micro-benchmark suite and fit a ``CalibrationTable``.

    With ``mesh=None`` a ``(4,)`` mesh of virtual ranks named
    ``axis_name`` is built on ``device`` (the GPU unless told otherwise).
    The table is NOT saved; ``table.save(autotune.cache_path(
    table.fingerprint))`` puts it where the measured policy searches.
    ``islands`` adds per-island sweeps (backend × chunk count at each
    island's exact coordinates, rows tagged with its key). ``dtypes`` is
    the wire-width axis: each entry runs the GEMM-op grid once at that
    width (``2`` = bf16; ``1`` = the int8 wire)."""
    from repro_torch.compat import resolve_device
    from repro_torch.core import costmodel as cm
    from repro_torch.core.comms import CommContext
    from repro_torch.launch.mesh import make_mesh

    hw = hw if hw is not None else cm.H100_SXM
    log = print if verbose else (lambda *_: None)
    if mesh is None:
        mesh = make_mesh((4,), (axis_name,), resolve_device(device))
    sizes = GRIDS[grid] if isinstance(grid, str) else tuple(grid)
    # every microbench pins its backend (the policy stays analytic: a
    # measured policy would consult the very table being built)
    ctx = CommContext(axis_name=axis_name, mesh=mesh, hw=hw)

    log(f"calibrating on {mesh}, grid={sizes} ...")
    with torch.no_grad():
        bw, hop_overhead = _measure_link(mesh, axis_name, reps)
        log(f"  link: {bw / 1e9:.3f} GB/s achieved, "
            f"{hop_overhead * 1e6:.1f} us/hop overhead")
        eff = _measure_gemm_efficiency(hw, reps, mesh.device)
        log(f"  gemm: {eff:.2e} of {hw.name} peak sustained (device "
            "time)")
        launch = _measure_launch(reps, mesh.device)
        log(f"  launch: {launch * 1e6:.1f} us")

        rows: list[dict] = []
        for db in dtypes:
            rows += _sweep_gemm_ops(ctx, mesh, axis_name, sizes, reps, log,
                                    dtype_bytes=int(db))
        rows += _sweep_psum(ctx, mesh, axis_name, sizes, reps, log)
        if islands:
            log(f"per-island sweep ({len(tuple(islands))} islands) ...")
            rows += _sweep_islands(ctx, mesh, axis_name, tuple(islands),
                                   reps, log)

    return CalibrationTable(
        fingerprint=live_fingerprint(hw.name, mesh),
        corrections={
            "ici_bandwidth": bw,
            "remote_sync_s": hop_overhead,
            "gemm_efficiency": eff,
            "kernel_launch_s": launch,
        },
        measurements=rows,
        created=time.strftime("%Y-%m-%dT%H:%M:%S"),
        notes=notes,
    )
