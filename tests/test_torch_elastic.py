"""Elastic restore of the port (``repro_torch.runtime.elastic``) against
the JAX package's:

* ``moe_converter`` on the cases of ``tests/test_ckpt_ft.py`` (expert
  counts the tp axis divides and does not, w1 and w2, stacked periods,
  round trips, keys passed through, the identity cases): the port's
  converted arrays equal JAX's;
* ``elastic_restore`` of dense (tinyllama-1.1b) and MoE
  (moonshot-v1-16b-a3b) ``.reduced()`` checkpoints, bf16, across meshes —
  no mesh, (1, 2), (1, 4), (2, 2), (2, 4): the same parameters saved by
  each package's ``CheckpointManager`` (JAX's logical, the port's stored
  stacked), restored onto the new mesh; the port's, assembled to their
  logical shapes, equal JAX's ``elastic_restore`` bit for bit. The
  snapshot's tp size and mesh come from the checkpoint's ``extra``, or
  from ``old_model_size``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import compat  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JaxCkpt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import ShardingRules as JaxRules  # noqa: E402
from repro.runtime import elastic as JE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.moe_layout import logical_to_dm  # noqa: E402
from repro_torch.core.pgl import VirtualMesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.runtime import elastic as TE  # noqa: E402

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# moe_converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,m1,m2", [(8, 4, 2), (16, 4, 8), (8, 2, 8),
                                     (4, 8, 2), (6, 4, 2), (6, 2, 4),
                                     (12, 8, 2)])
def test_moe_converter_matches_jax(e, m1, m2):
    cfg = types.SimpleNamespace(is_moe=True, n_experts=e)
    d, ff, periods = 4, 16, 2
    rng = np.random.default_rng(e * 100 + m1 * 10 + m2)
    log_w1 = rng.normal(size=(e, d, ff)).astype(np.float32)
    log_w2 = rng.normal(size=(e, ff, d)).astype(np.float32)
    arrs = {"blocks/pos0/moe/w1": np.stack([logical_to_dm(log_w1, m1)] * 2),
            "blocks/pos0/moe/w3": np.stack([logical_to_dm(log_w1, m1)] * 2),
            "blocks/pos0/moe/w2": np.stack(
                [logical_to_dm(log_w2, m1, w2=True)] * periods),
            "blocks/pos0/attn/wq": rng.normal(size=(3, 5)),
            "blocks/pos0/moe/router": rng.normal(size=(3, 5))}
    fwd_t, fwd_j = TE.moe_converter(cfg, m1, m2), JE.moe_converter(cfg, m1,
                                                                    m2)
    bwd_t = TE.moe_converter(cfg, m2, m1)
    for key, arr in arrs.items():
        got, want = fwd_t(key, arr), fwd_j(key, arr)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(bwd_t(key, got), arr)
        if "w" not in key.split("/")[-1] or "moe" not in key:
            assert got is arr                 # passed through untouched


def test_moe_converter_identity_cases_match_jax():
    for ns, a, b in ((types.SimpleNamespace(is_moe=True, n_experts=8), 4, 4),
                     (types.SimpleNamespace(is_moe=False, n_experts=0), 4,
                      2)):
        assert TE.moe_converter(ns, a, b) is None
        assert JE.moe_converter(ns, a, b) is None


# ---------------------------------------------------------------------------
# elastic_restore across meshes
# ---------------------------------------------------------------------------

_RUN = dict(fsdp=False, decode_seq_shard=True)


def _jax_side(arch, mesh_shape):
    cfg = jax_config(arch).reduced()
    run = JaxRun(**_RUN)
    mesh = (compat.make_mesh(mesh_shape, ("data", "model"))
            if mesh_shape else None)
    rules = JaxRules(mesh, run) if mesh is not None else None
    return cfg, run, mesh, rules


def _port_side(arch, mesh_shape):
    cfg = get_config(arch).reduced()
    run = RunConfig(**_RUN)
    mesh = VirtualMesh(mesh_shape, ("data", "model")) if mesh_shape \
        else None
    rules = ShardingRules(mesh, run) if mesh is not None else None
    return cfg, run, mesh, rules


@pytest.mark.parametrize("arch,old,new", [
    ("tinyllama-1.1b", (1, 4), (2, 2)),
    ("tinyllama-1.1b", None, (1, 4)),
    ("tinyllama-1.1b", (2, 2), None),
    ("moonshot-v1-16b-a3b", (1, 4), (1, 2)),
    ("moonshot-v1-16b-a3b", (1, 2), (2, 4)),
    ("moonshot-v1-16b-a3b", None, (1, 4))])
def test_elastic_restore_matches_jax(arch, old, new, tmp_path):
    jcfg, jrun, jmesh, jrules = _jax_side(arch, old)
    tmpl = JT.param_template(jcfg, jrun, jrules)
    params = JT.init_params(tmpl, jax.random.PRNGKey(1), jcfg.d_model)
    old_m = jmesh.shape["model"] if jmesh is not None else 1
    if jrules is not None:
        params = jax.tree.map(jax.device_put, params,
                              JSP.named(jmesh, JT.param_specs(tmpl)))
    JaxCkpt(tmp_path / "jax", async_save=False).save(5, params)
    host = jax.tree.map(np.asarray, params)
    tcfg, trun, tmesh, trules = _port_side(arch, old)
    CheckpointManager(tmp_path / "port", async_save=False).save(
        5, convert.params_from_jax(host, tcfg, trun, trules),
        extra={"tp": old_m,
               "mesh_shape": list(old) if old else None,
               "mesh_axes": ["data", "model"] if old else None})

    njcfg, njrun, njmesh, _ = _jax_side(arch, new or (1, 1))
    want, _ = JE.elastic_restore(str(tmp_path / "jax"), njcfg, njrun,
                                 njmesh, old_model_size=old_m)
    ncfg, nrun, nmesh, nrules = _port_side(arch, new)
    got, extra = TE.elastic_restore(str(tmp_path / "port"), ncfg, nrun,
                                    nmesh, device="cpu")
    assert extra["tp"] == old_m and extra["step"] == 5
    ntmpl = T.param_template(ncfg, nrun, nrules)
    for path, pd in T.leaves(ntmpl):        # the stored layout of new
        leaf = convert._get(got, path)
        assert tuple(leaf.shape) == T.stored_shape(pd, nrules)
        assert leaf.dtype == pd.dtype
    got_np = convert.tree_to_numpy(got, ntmpl, nrules)
    for path, _ in T.leaves(ntmpl):
        w = np.asarray(convert._get(want, path)).astype(np.float32)
        np.testing.assert_array_equal(convert._get(got_np, path), w,
                                      err_msg="/".join(path))


def test_elastic_restore_reads_old_model_size(tmp_path):
    """A checkpoint whose extra names no mesh: the tp size given (or the
    extra's ``tp``) decides the stored layout read."""
    tcfg, trun, tmesh, trules = _port_side("moonshot-v1-16b-a3b", (1, 4))
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(T.param_template(tcfg, trun, trules), gen,
                           tcfg.d_model, rules=trules, device="cpu")
    CheckpointManager(tmp_path, async_save=False).save(1, params,
                                                       extra={"tp": 4})
    ncfg, nrun, nmesh, nrules = _port_side("moonshot-v1-16b-a3b", (1, 2))
    a, _ = TE.elastic_restore(str(tmp_path), ncfg, nrun, nmesh)
    b, _ = TE.elastic_restore(str(tmp_path), ncfg, nrun, nmesh,
                              old_model_size=4)
    back, _ = TE.elastic_restore(str(tmp_path), tcfg, trun, tmesh)
    for path, _ in T.leaves(T.param_template(ncfg, nrun, nrules)):
        assert torch.equal(convert._get(a, path), convert._get(b, path))
    for path, _ in T.leaves(T.param_template(tcfg, trun, trules)):
        assert torch.equal(convert._get(back, path),
                           convert._get(params, path))
    assert TE.elastic_restore(str(tmp_path / "none"), ncfg, nrun,
                              nmesh) == (None, None)
