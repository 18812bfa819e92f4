"""The port's dry-run (``launch/specs.py``, ``launch/dryrun.py``,
``make_production_mesh``) and its counter (``roofline/counters.py``)
against the JAX package, on the CPU.

* The specs: ``batch_specs``, ``train_state_specs`` and ``decode_specs``
  against JAX's ``SP.*`` for every arch × cell on a (2, 4) mesh — global
  shapes, dtypes and ``PartitionSpec``s leaf for leaf, the long-context
  cache's spec over ("data", "model") included — and the argument bytes a
  device against shard arithmetic on JAX's specs; ``materialize`` lays a
  tree out as stored, on ``meta``.
* ``run_config_for`` for every arch × mesh × kind equal to JAX's.
* Every hand-written kernel's ``meta`` branch returns its CPU branch's
  shape, dtype and row layout, records its own formula and, on the
  counter, the launches the card makes (two launches for 16 stacked GEMM
  slabs), leaving the wrappers' ``.launches`` to the card.
* A dense train step on ``meta`` (the reduced tinyllama, no mesh, no
  remat) counts exactly the analytic tally of its GEMMs and attention.
* ``lower_cell`` on production decode cells (16 x 16, and h2o-danube's
  long_500k): JAX's result keys, the extrapolation from 1 and 2 periods
  equal to the full count (``calibrate``), per-device arguments from the
  specs; the multi-pod mesh's FSDP gathers run over ("pod", "data").
"""

import ast
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, cells_for, get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.roofline import counters  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
CELLS = [(a, c) for a in ARCH_IDS for c in cells_for(a)]
MESH = ((2, 4), ("data", "model"))


def _jax_dryrun():
    """JAX's dry-run module, imported without letting its 512-device
    ``XLA_FLAGS`` reach anything: the backend is up already, and the flag
    is put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as JD
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return JD


def _rules(run_kw=None):
    kw = dict(run_kw or {})
    jrun, trun = JaxRun(**kw), RunConfig(**kw)
    jrules = JaxRules(compat.make_mesh(*MESH), jrun)
    return jrules, ShardingRules(VirtualMesh(*MESH), trun)


def _flat(tree, prefix=()):
    """(path, leaf) pairs of nested dicts and named tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            if k == "grad_state":       # the port's own extra field
                continue
            yield from _flat(getattr(tree, k), prefix + (k,))
    else:
        yield prefix, tree


_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32,
       "int32": torch.int32, "int8": torch.int8}


def _same_leaves(jtree, ttree, jspecs, tspecs):
    jl = dict(_flat(jtree))
    tl = dict(_flat(ttree))
    assert set(jl) == set(tl)
    js, ts = dict(_flat(jspecs)), dict(_flat(tspecs))
    assert set(js) == set(ts) == set(jl)
    for path, j in jl.items():
        t = tl[path]
        assert tuple(j.shape) == tuple(t.shape), path
        assert _DT[jnp.dtype(j.dtype).name] == t.dtype, path
        assert tuple(js[path]) == tuple(ts[path]) == tuple(t.spec), path
    return jl, js


def _shard_bytes(leaves, specs, mesh_shape) -> float:
    sizes = dict(zip(MESH[1], mesh_shape))
    total = 0.0
    for path, leaf in leaves.items():
        n = 1
        for d in leaf.shape:
            n *= d
        shards = 1
        for e in specs[path]:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                shards *= sizes[a]
        total += n * jnp.dtype(leaf.dtype).itemsize / shards
    return total


@pytest.mark.parametrize("arch,cell", CELLS)
def test_specs_match_jax(arch, cell):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    kw = {"fsdp": SHAPES[cell].kind != "decode"}
    jrules, trules = _rules(kw)
    jcell, tcell = JSHAPES[cell], SHAPES[cell]
    if tcell.kind == "decode":
        (jp, jc, jt), (jps, jcs, jts) = JSP.decode_specs(
            jcfg, jrules.run, jrules, jcell)
        (tp, tc, tt), (tps, tcs, tts) = SP.decode_specs(
            tcfg, trules.run, trules, tcell)
        jl, js = _same_leaves({"p": jp, "c": jc, "t": jt},
                              {"p": tp, "c": tc, "t": tt},
                              {"p": jps, "c": jcs, "t": jts},
                              {"p": tps, "c": tcs, "t": tts})
        args = (tp, tc, tt)
        if cell == "long_500k" and "k" in tc["blocks"]["pos0"]:
            k = tc["blocks"]["pos0"]["k"]
            assert tuple(k.spec) == (None, None, None, ("data", "model"),
                                     None)
    else:
        for moment in (torch.float32, torch.bfloat16):
            jst, jss = JSP.train_state_specs(
                jcfg, jrules.run, jrules,
                jnp.bfloat16 if moment == torch.bfloat16 else jnp.float32)
            tst, tss = SP.train_state_specs(tcfg, trules.run, trules, moment)
            _same_leaves(jst, tst, jss, tss)
        jb, jbs = JSP.batch_specs(jcfg, jcell, jrules)
        tb, tbs = SP.batch_specs(tcfg, tcell, trules)
        _same_leaves(jb, tb, jbs, tbs)
        jl, js = _same_leaves({"s": jst, "b": jb}, {"s": tst, "b": tb},
                              {"s": jss, "b": jbs}, {"s": tss, "b": tbs})
        args = (tst, tb)
    # a device's argument bytes: shard arithmetic on JAX's specs
    want = _shard_bytes(jl, js, MESH[0])
    assert SP.device_bytes(args, trules) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_config_for_matches_jax(arch, multi_pod):
    JD = _jax_dryrun()
    for kind in ("train", "prefill", "decode"):
        for mb in (None, 3):
            kw = dict(multi_pod=multi_pod, microbatches=mb,
                      serving=kind == "decode")
            j = JD.run_config_for(jax_config(arch), **kw)
            t = D.run_config_for(get_config(arch), **kw)
            for f in ("dp_axes", "fsdp", "pk_overlap", "microbatches",
                      "optimizer_moment_dtype"):
                assert getattr(t, f) == getattr(j, f), (f, kind)


def test_materialize_and_production_mesh():
    mesh = make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16} and mesh.device.type \
        == "meta"
    pod = make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model") and pod.size == 512
    cfg = get_config("whisper-medium")
    run = D.run_config_for(cfg, multi_pod=True)
    rules = ShardingRules(pod, run)
    st, _ = SP.train_state_specs(cfg, run, rules)
    tree = SP.materialize(st.params, rules)
    for path, pd in T.leaves(st.params):
        t = tree
        for k in path:
            t = t[k]
        assert t.is_meta and tuple(t.shape) == T.stored_shape(pd, rules)
        if pd.aligned:                      # 16-byte rows, as stored
            assert t.stride(-2) % 8 == 0 and t.stride(-2) >= t.shape[-1]


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

def _kernel_cases():
    from repro_torch.kernels import (collective_matmul as CM,
                                     decode_attention as DA,
                                     flash_attention as FA,
                                     grouped_matmul as GM, lcsc as LC,
                                     mamba_scan as MS, matmul as MM,
                                     pk_comm as PK)
    bf = torch.bfloat16

    def r(*shape, dtype=bf):
        return torch.randn(*shape).to(dtype)

    return [
        ("matmul", MM.matmul, (r(8, 32), r(32, 13)), {},
         MM.cost(8, 13, 32, 1), 1),
        ("matmul", MM.matmul_stacked, (r(8, 32), r(16, 32, 24)), {},
         MM.cost(8, 24, 32, 16), 2),
        ("flash_attention", FA.flash_attention,
         (r(2, 4, 16, 120), r(2, 2, 16, 120), r(2, 2, 16, 120)),
         {"causal": True, "window": 5},
         FA.cost((2, 4, 16, 120), (2, 2, 16, 120), True, 5), 1),
        ("flash_attention_hop", FA.flash_attention_hop,
         (r(4, 4, 8, 64), r(4, 2, 8, 64), r(4, 2, 8, 64)),
         {"ranks": 2, "hop": 1},
         FA.cost((4, 4, 8, 64), (4, 2, 8, 64), True, None, ranks=2, hop=1),
         1),
        ("grouped_matmul", GM.grouped_matmul, (r(4, 6, 16), r(4, 16, 24)),
         {"out_dtype": torch.float32}, GM.cost(4, 6, 24, 16, 2, 4), 1),
        ("mamba_scan", MS.mamba_scan,
         (r(2, 8, 16, dtype=torch.float32), r(2, 8, 4), r(2, 8, 4),
          r(2, 8, 16), -r(16, 4, dtype=torch.float32).abs(),
          torch.zeros(2, 16, 4)), {}, MS.cost(2, 8, 16, 4, 2), 1),
        ("mamba_scan_bwd", MS.mamba_scan_bwd,
         (r(2, 8, 16, dtype=torch.float32), r(2, 8, 4), r(2, 8, 4),
          r(2, 8, 16), -r(16, 4, dtype=torch.float32).abs(),
          torch.zeros(2, 16, 4), r(2, 8, 16, dtype=torch.float32)), {},
         MS.cost(2, 8, 16, 4, 2, backward=True), 1),
        ("ring_all_gather", PK.ring_all_gather, (r(4, 3, 8),), {},
         (0, (96 + 4 * 96) * 2), 1),
        ("ring_all_gather", PK.all_gather_along, (r(4, 3, 8),),
         {"axis": 1, "order": (1, 0)}, (0, (96 + 4 * 96) * 2), 1),
        ("ring_reduce_scatter", PK.ring_reduce_scatter, (r(4, 4, 3, 8),),
         {}, (3 * 96, (384 + 96) * 2), 1),
        ("p2p_ring_shift", PK.p2p_ring_shift, (r(4, 3, 8),), {},
         (0, 2 * 96 * 2), 1),
        ("all_to_all", PK.all_to_all, (r(4, 8, 4, 6), 0, 2),
         {"n_chunks": 2}, (0, 2 * 768 * 2), 2),
        ("lcsc_ring_all_gather", LC.lcsc_ring_all_gather, (r(4, 3, 8),),
         {}, (0, (96 + 4 * 96) * 2), 1),
        ("matmul_ar_fused", CM.matmul_ar_fused, (r(4, 8, 16), r(4, 16, 24)),
         {}, CM.cost(4, 8, 24, 16, 8, 4), 1),
        ("matmul_rs_fused", CM.matmul_rs_fused, (r(4, 8, 16), r(4, 16, 24)),
         {}, CM.cost(4, 8, 24, 16, 2, 4), 1),
        ("ag_matmul_fused", CM.ag_matmul_fused, (r(4, 2, 16), r(4, 16, 24)),
         {}, CM.cost(4, 8, 24, 16, 8, 2), 1),
        ("decode_attention", DA.decode_attention,
         (r(2, 3, 4, 1, 16), r(2, 3, 2, 8, 16), r(2, 3, 2, 8, 16),
          r(2, 3, 2, 1, 16), r(2, 3, 2, 1, 16), torch.tensor([1, 9, 20])),
         {}, DA.cost(2, 3, 4, 2, 8, 16, 2), 1),
        # B = 1: the keys split, and the splits' merge is a second launch
        ("decode_attention", DA.decode_attention,
         (r(2, 1, 4, 1, 16), r(2, 1, 2, 512, 16), r(2, 1, 2, 512, 16),
          r(2, 1, 2, 1, 16), r(2, 1, 2, 1, 16), torch.tensor(700)),
         {"window": 100}, DA.cost(2, 1, 4, 2, 512, 16, 2), 2),
    ]


def _outs(o):
    return o if isinstance(o, tuple) else (o,)


@pytest.mark.parametrize("case", range(18))
def test_kernel_meta_branches(case):
    name, fn, args, kw, cost, n_launch = _kernel_cases()[case]
    with torch.no_grad():
        with counters.StepCounter() as c_cpu:
            want = _outs(fn(*args, **kw))
        margs = tuple(a.to("meta") if torch.is_tensor(a) else a
                      for a in args)
        before = counters.launch_counts()
        with counters.StepCounter("meta") as c_meta:
            got = _outs(fn(*margs, **kw))
        after = counters.launch_counts()
    for g, w in zip(got, want):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype
    if name == "matmul":                     # rows padded to 16 bytes
        assert got[0].stride(-2) % 8 == 0
    for c in (c_cpu, c_meta):
        assert c.kernels[name] == [cost[0], cost[1], 1]
        assert (c.flops, c.bytes) == tuple(cost)   # the plain ops not counted
    key = {"matmul_stacked": "matmul",
           "all_gather_along": "ring_all_gather"}.get(fn.__name__,
                                                      fn.__name__)
    # the meta branch records the card's launches on the counter; the
    # wrappers' .launches count only launches on the card
    assert dict(c_meta.launches) == {key: n_launch}
    assert not c_cpu.launches and after == before


def test_live_bytes_leave_the_arguments_out():
    """An in-place update of an argument (an optimizer's) or a view of it
    is no new storage: ``ignore`` keeps a step's arguments out of the
    live bytes; what the step creates counts until it is freed."""
    p = torch.zeros(1024, device="meta")
    with counters.StepCounter("meta").ignore([p]) as c:
        p.add_(1.0)
        q = p.view(32, 32)
        t = p * 2.0                                      # 4 KB, freed below
        del t
        u = q + 1.0                                      # 4 KB, kept
    assert c.peak_bytes == 4096 and c.live_bytes == 4096
    with counters.StepCounter("meta") as c2:
        p.add_(1.0)
    assert c2.peak_bytes == 4096                         # not ignored
    del u


def test_meta_branches_keep_the_card_rank_limit():
    from repro_torch.kernels import collective_matmul as CM
    from repro_torch.kernels import pk_comm as PK
    with pytest.raises(ValueError, match="at most"):
        PK.all_to_all(torch.empty(16, 16, 4, device="meta"), 0, 1)
    with pytest.raises(ValueError, match="at most"):
        CM.matmul_ar_fused(torch.empty(16, 32, 16, device="meta",
                                       dtype=torch.bfloat16),
                           torch.empty(16, 16, 8, device="meta",
                                       dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# the counter on a whole step
# ---------------------------------------------------------------------------

def _pairs(s):
    return s * (s + 1) // 2


def test_dense_train_step_flops_equal_the_gemm_tally():
    cfg = get_config("tinyllama-1.1b").reduced()
    run = RunConfig(remat=False, microbatches=1)
    b, s = 2, 64
    tmpl = T.param_template(cfg, run, None)
    params = SP.materialize(tmpl, None)
    for _, p in T.leaves(params):
        p.requires_grad_(True)
    batch = {"tokens": torch.zeros(b, s, dtype=torch.int32, device="meta"),
             "targets": torch.zeros(b, s, dtype=torch.int32, device="meta"),
             "weights": torch.ones(b, s, device="meta")}
    with counters.StepCounter("meta") as c:
        loss, _ = T.forward_train(params, batch, cfg, run, None)
        loss.backward()
    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.d_ff)
    v = cfg.padded_vocab(16)
    tok = b * s
    gemm = 2 * tok * (d * (hq + 2 * hkv) * hd + hq * hd * d + 3 * d * ff)
    attn = 4 * hq * hd * b * _pairs(s)                  # the flash kernel
    attn_bwd = 12 * b * hq * s * s * hd                 # plain recompute
    per_layer = 3 * gemm + attn + attn_bwd
    loss_gemm = 3 * 2 * tok * d * v
    assert c.flops == cfg.n_layers * per_layer + loss_gemm
    assert c.kernels["flash_attention"][0] == cfg.n_layers * attn
    assert c.kernels["matmul"][0] == 2 * tok * d * v


@pytest.fixture(scope="module")
def long_cell():
    return D.lower_cell("h2o-danube-3-4b", "long_500k", multi_pod=False,
                        calibrate=True)


def _jax_result_keys():
    """The keys of JAX's ``lower_cell`` result, read from its source."""
    src = open(os.path.join(ROOT, "src", "repro", "launch",
                            "dryrun.py")).read()
    keys = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == "result" and \
                    isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if isinstance(tgt, ast.Subscript) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "result":
                keys.add(tgt.slice.value)
    return keys


def test_lower_cell_long_context_returns_jax_keys(long_cell):
    r = long_cell
    jkeys = _jax_result_keys()
    assert {"memory", "cost", "collectives", "islands", "serving",
            "roofline"} <= jkeys
    assert jkeys <= set(r)
    assert r["producer"] == "repro_torch" and r["mesh"] == "16x16"
    for k in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_per_device_gb"):
        assert k in r["memory"]
    assert r["cost"]["flops"] == r["cost"]["raw_flops_uncorrected"] > 0
    # the decode island spans every rank: one all-reduce group of 256
    assert r["collectives"]["all-reduce"]["bytes"] > 0
    assert r["launches"]["matmul"] == 2       # 16 stacked slabs: 2 launches
    assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                           "collective")
    # arguments a device from the specs: the cache over all 256 ranks
    cfg = get_config("h2o-danube-3-4b")
    run = D.run_config_for(cfg, multi_pod=False, serving=True)
    rules = ShardingRules(make_production_mesh(), run)
    _, (tp, tc, tt), = None, SP.decode_specs(cfg, run, rules,
                                             SHAPES["long_500k"])[0]
    assert r["memory"]["argument_bytes"] == SP.device_bytes((tp, tc, tt),
                                                            rules)


def test_lower_cell_extrapolation_equals_the_full_count():
    """``calibrate`` raises unless the count from 1 and 2 periods
    extrapolates to the full count exactly; a train cell on the multi-pod
    mesh gathers over ("pod", "data")."""
    r = D.lower_cell("tinyllama-1.1b", "prefill_32k", multi_pod=True,
                     calibrate=True)
    assert r["mesh"] == "2x16x16" and r["cost"]["flops"] > 0
    assert r["collectives"]["all-gather"]["bytes"] > 0   # FSDP over 32
    r = D.lower_cell("whisper-medium", "decode_32k", multi_pod=False,
                     calibrate=True)
    assert r["launches"]["matmul"] > 0
    assert set(r["serving"]) >= {"buckets"} or r["serving"]


def test_main_writes_files_the_report_reads(tmp_path, capsys):
    from repro_torch.roofline import report
    rc = D.main(["--arch", "h2o-danube-3-4b", "--cell", "long_500k",
                 "--mesh", "single", "--out", str(tmp_path)])
    assert rc == 0
    assert "dry-run complete: 1 ok, 0 failed" in capsys.readouterr().out
    rc = D.main(["--arch", "tinyllama-1.1b", "--cell", "long_500k",
                 "--out", str(tmp_path)])
    assert rc == 0 and "SKIP" in capsys.readouterr().out
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("| h2o-danube-3-4b | long_500k | 16x16 |") == 2


_BOTH_PATHS = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig, ShapeCell
from repro_torch.core.pgl import VirtualMesh
from repro_torch.launch import dryrun as D
from repro_torch.models.sharding import ShardingRules
from repro_torch.roofline import counters
from repro_torch.roofline import hlo as HLO

def counts():
    rows = []
    for arch, kind in (("tinyllama-1.1b", "train"),
                       ("tinyllama-1.1b", "decode"),
                       ("moonshot-v1-16b-a3b", "train")):
        cfg = get_config(arch).reduced()
        run = RunConfig(fsdp=kind == "train", comm_backend="fused",
                        microbatches=1)
        rules = ShardingRules(VirtualMesh((2, 4), ("data", "model"),
                                          device="meta"), run)
        cell = ShapeCell(kind, 64, 4, kind)
        step, args, _ = D.build_step(cfg, cell, run, rules)
        sc = D.count_step(step, args, grad=kind == "train")
        rows.append([sc.flops, sc.bytes, sc.peak_bytes, sc.output_bytes,
                     sc.launches,
                     HLO.collective_bytes(sc.comms, 8).by_kind])
    return rows

python_meta = counts()
moved = counters.use_native_meta_kernels()
print(json.dumps({"python": python_meta, "native": counts(),
                  "moved": moved}))
"""


def test_python_and_native_meta_count_the_same():
    """The tests count under PyTorch's Python meta functions; the command
    line (``dryrun.cli``) and chip_smoke's dry-run workers under ATen's C++
    meta kernels. Both paths give one count — FLOPs, bytes, the peak of
    live storages, output bytes, launches, collective bytes by kind — for
    a train, a decode and an MoE train step on (2, 4), in a process of its
    own (the switch lasts for the rest of its process)."""
    import json
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _BOTH_PATHS], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["moved"] > 0                  # the native path was taken
    assert got["python"] == got["native"]
    for flops, nbytes, peak, _, launches, coll in got["python"]:
        assert flops > 0 and nbytes > 0 and peak > 0
        assert launches.get("matmul", 0) > 0
