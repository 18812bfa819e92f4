"""The port's roofline layer (``repro_torch/roofline``) against the JAX
package's (``repro/roofline``), exactly.

* ``model_flops`` for every arch × cell, and ``build`` on the same counts,
  on TPU v5e's and H100 SXM's numbers (each package's ``costmodel``
  holds both): every field equal.
* The comm trace: records priced by ``ring_bytes`` and rendered as HLO
  lines priced by JAX's ``collective_bytes`` give the same bytes — the
  five ops of ``tests/test_roofline.py``'s fixture, and every record of a
  forward and backward of the reduced tinyllama on (2, 4) with FSDP and the
  fused backends; ``collective_bytes`` sums a trace a device.
* The report: ``roofline_table`` and ``dryrun_table`` of the same rows
  (JAX's format, and the port's) give the same data rows on the same
  hardware; a JAX row of ``parser_version`` 1 has its AR/RS bytes halved
  by both reports, a port row never.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import cells_for as jax_cells_for  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import costmodel as JCM  # noqa: E402
from repro.roofline import hlo as JH  # noqa: E402
from repro.roofline import model as JM  # noqa: E402
from repro.roofline import report as JR  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, cells_for, get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core import costmodel as TCM  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.roofline import counters  # noqa: E402
from repro_torch.roofline import hlo as TH  # noqa: E402
from repro_torch.roofline import model as TM  # noqa: E402
from repro_torch.roofline import report as TR  # noqa: E402

torch.set_num_threads(1)

CELLS = [(a, c) for a in ARCH_IDS for c in cells_for(a)]


def test_registries_match():
    assert tuple(ARCH_IDS) == tuple(JAX_ARCHS)
    for a in ARCH_IDS:
        assert cells_for(a) == jax_cells_for(a)


@pytest.mark.parametrize("arch,cell", CELLS)
def test_model_flops_and_build_match_jax(arch, cell):
    got = TM.model_flops(get_config(arch), SHAPES[cell])
    want = JM.model_flops(jax_config(arch), JSHAPES[cell])
    assert got == want
    kinds = {"all-gather": (3.0e9, 40), "all-reduce": (1.5e9, 12)}
    jst = JH.CollectiveStats(by_kind=kinds, total_bytes=4.5e9, op_count=52)
    tst = TH.CollectiveStats(by_kind=kinds, total_bytes=4.5e9, op_count=52)
    for jhw, thw in ((JCM.TPU_V5E, TCM.TPU_V5E), (JCM.H100_SXM,
                                                   TCM.H100_SXM)):
        kw = dict(flops=3.7e14, hbm_bytes=2.1e12, model_flops_total=got,
                  n_chips=256, args_bytes=4.2e10, ici_links=1)
        j = JM.build(arch, cell, "16x16", coll=jst, hw=jhw, **kw)
        t = TM.build(arch, cell, "16x16", coll=tst, hw=thw, **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # the port's default hardware is the card's published peaks
    t = TM.build(arch, cell, "16x16", flops=1e15, hbm_bytes=1e12, coll=tst,
                 model_flops_total=got, n_chips=256)
    assert t.t_compute == 1e15 / 989e12 and t.t_memory == 1e12 / 3.35e12


#: the five ops of tests/test_roofline.py's HLO fixture, as comm records:
#: (kind, a rank's output bytes, group size)
FIXTURE = [("all-gather", 16 * 1024 * 512 * 2, 16),
           ("all-reduce", 4096 * 2048 * 4, 4),
           ("reduce-scatter", 256 * 128 * 2, 8),
           ("collective-permute", 64 * 64 * 2, 2),
           ("all-to-all", 8 * 8 * 8 * 4, 8)]


def _hlo_line(i, rec) -> str:
    """A comm record as a line of compiled HLO, ``u8`` elements."""
    return (f"  %c{i} = u8[{int(rec.out_bytes)}]{{0}} {rec.kind}(%x{i}), "
            f"replica_groups=[{rec.lanes},{rec.n}]<=[{rec.lanes * rec.n}]")


def _jax_bytes(records) -> dict:
    text = "\n".join(_hlo_line(i, r) for i, r in enumerate(records))
    return {k: v for k, (v, _) in JH.collective_bytes(text).by_kind.items()}


def test_ring_formulas_match_jax_on_the_fixture():
    from test_roofline import HLO
    want = JH.collective_bytes(HLO)
    recs = [counters.CommRecord(k, b, n) for k, b, n in FIXTURE]
    for r in recs:
        assert TH.ring_bytes(r.kind, r.out_bytes, r.n) == \
            want.by_kind[r.kind][0]
        assert TH.ring_bytes(r.kind, r.out_bytes, r.n) == \
            _jax_bytes([r])[r.kind]
    # one device of a mesh that each record spans whole
    for r in recs:
        st = TH.collective_bytes([r], n_devices=r.n * r.lanes)
        assert st.by_kind[r.kind] == (want.by_kind[r.kind][0], 1)


def test_traced_step_records_price_like_jax():
    """Every collective a forward and backward of the reduced tinyllama on
    (2, 4) with FSDP records, rendered as HLO: the same bytes a line."""
    cfg = get_config("tinyllama-1.1b").reduced()
    run = RunConfig(fsdp=True, comm_backend="fused")
    rules = ShardingRules(VirtualMesh((2, 4), ("data", "model")), run)
    params = T.init_params(T.param_template(cfg, run, rules),
                           torch.Generator().manual_seed(0), cfg.d_model,
                           rules=rules, device="cpu")
    g = torch.Generator().manual_seed(1)
    bt = {"tokens": torch.randint(0, 256, (4, 32), generator=g),
          "targets": torch.randint(0, 256, (4, 32), generator=g),
          "weights": torch.ones(4, 32)}
    for _, p in T.leaves(params):
        p.requires_grad_(True)
    with counters.StepCounter() as c:
        loss, _ = T.forward_train(params, bt, cfg, run, rules)
        loss.backward()
    kinds = {r.kind for r in c.comms}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    for r in c.comms:
        assert float(r.out_bytes).is_integer()
        assert _jax_bytes([r])[r.kind] == TH.ring_bytes(r.kind, r.out_bytes,
                                                        r.n)
    st = TH.collective_bytes(c.comms, n_devices=8)
    want = sum(TH.ring_bytes(r.kind, r.out_bytes, r.n) * r.n * r.lanes / 8
               for r in c.comms)
    assert abs(st.total_bytes - want) <= 1e-6 * want


def _rows():
    """Two rows in the dry-run's format: a JAX row of parser_version 1 and
    a port row."""
    base = {
        "cell": "train_4k", "mesh": "16x16", "t_compile_s": 12.5,
        "t_lower_s": 3.5,
        "memory": {"argument_bytes": 2.5e9, "temp_bytes": 7.5e9},
        "cost": {"flops": 3.0e14, "bytes_accessed": 9.0e11},
        "collectives": {"all-reduce": {"bytes": 4.0e10, "ops": 40},
                        "all-gather": {"bytes": 1.0e10, "ops": 20},
                        "reduce-scatter": {"bytes": 2.0e10, "ops": 20}},
        "roofline": {"model_flops_per_device": 2.0e14,
                     "bottleneck": "collective"}}
    jax_row = dict(base, arch="tinyllama-1.1b", parser_version=1)
    port_row = dict(base, arch="moonshot-v1-16b-a3b", parser_version=2,
                    producer="repro_torch")
    return [jax_row, port_row]


def test_report_tables_match_jax_on_the_same_rows():
    rows = _rows()
    # on JAX's hardware the roofline rows are JAX's, digit for digit
    jt = JR.roofline_table(rows).splitlines()[2:]
    tt = TR.roofline_table(rows, hw=TCM.TPU_V5E).splitlines()[2:]
    assert tt == jt
    # the dry-run table: the same row but the time column (JAX's compile
    # seconds, the port's counted step)
    jd = JR.dryrun_table(rows).splitlines()[2:]
    td = TR.dryrun_table(rows, hw=TCM.TPU_V5E).splitlines()[2:]
    for a, b in zip(jd, td):
        ja, tb = a.split(" | "), b.split(" | ")
        assert ja[:3] == tb[:3] and ja[4:] == tb[4:]
    # the halving: JAX's parser_version 1 row in both, never the port's
    j0, t0 = JR.recompute(rows[0]), TR.recompute(rows[0], hw=TCM.TPU_V5E)
    assert t0.coll_bytes == j0.coll_bytes == 4.0e10
    t1 = TR.recompute(rows[1], hw=TCM.TPU_V5E)
    assert t1.coll_bytes == 7.0e10
    assert JR.recompute(rows[1]).coll_bytes == 7.0e10   # v2: JAX too


def test_report_main_renders_both_tables(tmp_path, capsys):
    import json
    for r in _rows():
        fn = tmp_path / f"{r['arch']}__{r['cell']}__{r['mesh']}.json"
        fn.write_text(json.dumps(r))
    (tmp_path / "tagged__train_4k__16x16_nopk.json").write_text("{}")
    TR.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "### Dry-run table" in out and "### Roofline table" in out
    assert out.count("| tinyllama-1.1b |") == 2
    assert "modelled" in out
